"""What every run shares: finding a cell's files by name, the seed's
streams, the card's identity, the check on loaded modules, and the
result line.

Everything that belongs to one configuration, traffic mix, mode or
per-layer metric is a file of its own under the benchmark's folder,
found by the name that `BENCHMARK.json` gives it:

    benchmark/configs/<config>.json      sizes, precision, weight recipe
    benchmark/traffic/<traffic>.json     the mix's parameters
    benchmark/workloads/<cell>.json      config, mode, traffic, check
    benchmark/modes/<mode>.py            run(ctx) -> Outcome
    benchmark/metrics/<metric>.py        read(record) -> number or None
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "darknet_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """A checkout's benchmark: `BENCHMARK.json` and the files under
    `benchmark/`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = read_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "benchmark")

    def _file(self, kind: str, name: str, ext: str = ".json") -> str:
        path = os.path.join(self.dir, kind, name + ext)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        return path

    def cell(self, name: str) -> dict:
        """The cell's `BENCHMARK.json` entry merged with its own file."""
        entry = next((w for w in self.spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"{name!r} is not a workload of BENCHMARK.json")
        return {**read_json(self._file("workloads", name)), **entry}

    def config(self, name: str) -> dict:
        cfg = read_json(self._file("configs", name))
        with open(os.path.join(self.dir, "configs", cfg["cfg"])) as f:
            cfg["cfg_text"] = f.read()
        return cfg

    def traffic(self, name: str) -> dict:
        return read_json(self._file("traffic", name))

    def mode(self, name: str):
        return load_module(self._file("modes", name, ".py"),
                           f"benchmark_mode_{name}")

    def reader(self, name: str):
        return load_module(self._file("metrics", name, ".py"),
                           "benchmark_metric_" + name.replace(".", "_"))

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics that list the cell."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def streams(seed: int, n: int) -> list:
    """`n` independent 63-bit seeds drawn from `seed` (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for c in ss.spawn(n)]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    """What a mode hands back.  `metrics`: end-to-end values by name;
    `record`: what the per-layer readers read; `checks`: {name: (value,
    limit)} of the comparison with the reference."""

    correct: bool
    attempted: int
    failed: int
    metrics: dict
    checks: dict
    memory_peak_bytes: int
    record: dict = dataclasses.field(default_factory=dict)
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def result_line(outcome: Outcome, metrics: dict, device: dict) -> str:
    """The run's last line; the compared numbers come last."""
    line = {"correct": bool(outcome.correct),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": metrics,
            "device": device}
    if outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return json.dumps(line)
