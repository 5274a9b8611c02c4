"""Run one cell several times, each a fresh process as the benchmark's
check runs it, and summarise the spread of each metric.

    python3 benchmark/sets.py --workload <cell> --seeds 11 12 13 \
        [--seconds S] [--trace 0|1] [--out chiprun_out/<file>.jsonl]

Each run's result line (or its failure, with the end of its standard
error) goes to `--out` as one JSON line.  The summary gives each
metric's median and the spread of its runs: the distance between the
first and the third quartile (`statistics.quantiles(values, n=4)`) as a
share of the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values: list) -> float:
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", str(args.trace)], cwd=ROOT, capture_output=True,
            text=True)
        row = {"seed": seed, "rc": p.returncode,
               "wall_s": time.perf_counter() - t0,
               "stderr_tail": p.stderr[-3000:]}
        lines = p.stdout.strip().splitlines()
        if p.returncode == 0 and lines:
            row["line"] = json.loads(lines[-1])
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "stderr_tail"}), flush=True)
        if "line" not in row:
            print(p.stderr[-3000:], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    done = [r["line"] for r in rows if "line" in r]
    summary = {"workload": args.workload, "runs": len(rows),
               "correct": sum(bool(d["correct"]) for d in done)}
    names = sorted({k for d in done for k in d["metrics"]})
    for name in names:
        vals = [d["metrics"][name]["value"] for d in done
                if name in d["metrics"]]
        summary[name] = {"median": statistics.median(vals),
                         "spread": spread(vals) if len(vals) > 1 else None,
                         "values": vals}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
