"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 -m benchmark.run ...            (the same)

A fresh process sets up, warms up, measures for `--seconds`, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output (the numbers it compared, each beside its
limit, last on standard error too).  `--trace 0` reports the cell's
end-to-end metrics, `--trace 1` its per-layer ones, read from a profiled
sub-window after the timed one.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a mode gets: the cell, its configuration and traffic, the
    seed, the window's length, whether to trace, the device, the time
    the process started (perf_counter), and a log to standard error."""

    bench: harness.Bench
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout.  The port builds
    its CUDA libraries into its own `_build/` there already."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "benchmark", "_cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "benchmark", "_cache",
                                       "torch_extensions"))


def execute(args, *, root: str = harness.ROOT, device=None,
            t_start: float = T_START):
    """Run the cell: (outcome, the result's metrics, the device record).
    `device` None means the card, which must be there; tests pass the
    CPU."""
    import torch

    bench = harness.Bench(root)
    cell = bench.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} CUDA "
                             f"card(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    ctx = Context(bench=bench, cell=cell,
                  config=bench.config(cell["config"]),
                  traffic=bench.traffic(cell["traffic"]), seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device(device), t_start=t_start)
    outcome = bench.mode(cell["mode"]).run(ctx)
    if args.trace:
        metrics = {}
        for m in bench.per_layer(args.workload):
            value = bench.reader(m["name"]).read(outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in bench.end_to_end(args.workload)}
    on_card = ctx.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if on_card
           else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": outcome.memory_peak_bytes}
    if args.trace:
        dev["busy_s"] = outcome.busy_s
        dev["window_s"] = outcome.window_s
    if on_card:
        dev["card"] = harness.card()
    return outcome, metrics, dev


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(harness.ROOT)
    try:
        outcome, metrics, dev = execute(args)
    except SystemExit as e:
        print(e, file=sys.stderr, flush=True)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not be loaded are loaded: {found}",
              file=sys.stderr, flush=True)
        return 3
    print(f"card: {dev.get('card', dev['kind'])}", file=sys.stderr)
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(outcome, metrics, dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
