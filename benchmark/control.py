"""The control of a cell's comparison: the reference, in the precision
below the one the configuration states, put in the program's place.
Its numbers have to fail the cell's limits; they set the limits' upper
readings.  The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--out chiprun_out/<file>.jsonl]

Each seed prints one JSON line: the numbers, the cell's limits, and
whether the limits would call it correct (they must not).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.run import Context  # noqa: E402


def numbers(bench, cell_name: str, seed: int, device) -> dict:
    import torch

    cell = bench.cell(cell_name)
    ctx = Context(bench=bench, cell=cell, config=bench.config(cell["config"]),
                  traffic=bench.traffic(cell["traffic"]), seed=seed,
                  seconds=0.0, trace=False, device=torch.device(device),
                  t_start=time.perf_counter())
    return bench.mode(cell["mode"]).control(ctx)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench()
    limits = bench.cell(args.workload)["check"]["limits"]
    for seed in args.seeds:
        got = numbers(bench, args.workload, seed, "cuda")
        row = {"workload": args.workload, "seed": seed, "numbers": got,
               "limits": limits, "passes": compare.judge(got, limits),
               "card": harness.card()}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
