"""Shared pieces of the benchmark's CPU tests.

`tiny_root` is a copy of the benchmark with small cells added as files
only (configurations at 96 px in float32, a traffic mix of batch 4, a
cell each), the way a later change adds a cell: nothing already in the
copy is edited but `BENCHMARK.json`.  Tests that need the card take the
`cuda` fixture, which skips without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time

import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
PX = 96
TINY = {"yolov4": ("yolov4-608", "tiny-yolov4.serve"),
        "gaussian": ("gaussian-yolov3-512-int8", "tiny-gaussian.serve")}
# a 96 px Gaussian head has 28 times fewer candidates than a 512 px one:
# a higher objectness centre keeps about as many boxes an image
TINY_WEIGHTS = {"yolov4": {}, "gaussian": {"obj_mean": -4.0}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _copy(dst: str) -> None:
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)


def add_tiny(root: str) -> dict:
    """Add the small configurations, traffic and cells as new files and
    `BENCHMARK.json` entries; {kind: cell name}."""
    d = os.path.join(root, "benchmark")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    with open(os.path.join(d, "traffic", "tiny.json"), "w") as f:
        json.dump({"batch": 4, "pool_batches": 2, "warmup_requests": 1,
                   "profiled_requests": 1, "thresh": 0.25, "nms": 0.45,
                   "top_k": 64}, f)
    cells = {}
    for kind, (base, cell) in TINY.items():
        name = cell.split(".")[0]
        with open(os.path.join(d, "configs", base + ".json")) as f:
            cfg = json.load(f)
        with open(os.path.join(d, "configs", cfg["cfg"])) as f:
            text = f.read()
        text = re.sub(r"(?m)^width=\d+", f"width={PX}", text)
        text = re.sub(r"(?m)^height=\d+", f"height={PX}", text)
        with open(os.path.join(d, "configs", name + ".cfg"), "w") as f:
            f.write(text)
        # float32 serving, so the program's plain paths on the CPU meet
        # the reference within rounding; more frames for the statistics
        # of maps this small
        cfg.update(name=name, cfg=name + ".cfg", compute="f32")
        cfg["weights"] = dict(cfg["weights"], frames=8, **TINY_WEIGHTS[kind])
        with open(os.path.join(d, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        full = base + (".serve-b8" if kind == "yolov4" else ".serve-b32")
        with open(os.path.join(d, "workloads", full + ".json")) as f:
            wl = json.load(f)
        wl.update(config=name, traffic="tiny")
        wl["check"] = dict(wl["check"], sample_requests=2)
        with open(os.path.join(d, "workloads", cell + ".json"), "w") as f:
            json.dump(wl, f)
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": ["width", "height"],
                                "why": "CPU test size"})
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": "tiny", "chips": 1,
                                  "why": "CPU test size"})
        # the metrics of the cell it copies
        for m in spec["end_to_end"] + spec["per_layer"]:
            if full in m.get("workloads", ()):
                m["workloads"].append(cell)
        cells[kind] = cell
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)
    return cells


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    _copy(root)
    return root, add_tiny(root)


def run_cell(root: str, cell: str, *, seed: int = 3000000019,
             seconds: float = 1.0, trace: int = 0, device="cpu"):
    """One run of a cell, on the CPU unless told: (outcome, metrics,
    device)."""
    from benchmark import run

    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return run.execute(args, root=root, device=device,
                       t_start=time.perf_counter())
