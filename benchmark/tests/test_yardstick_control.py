"""The control of each cell's comparison: the reference in the
precision below the configuration's, in the program's place, fails the
cell's limits.  On the CPU at a small size; at the cell's own size on
the card (`python3 benchmark/control.py` gives the readings)."""

from __future__ import annotations

import pytest

from conftest import REPO

from benchmark import control, harness
from benchmark.reference import compare


@pytest.mark.parametrize("kind", ["yolov4", "gaussian"])
def test_control_fails_small(tiny_root, kind):
    root, cells = tiny_root
    bench = harness.Bench(root)
    got = control.numbers(bench, cells[kind], 5, "cpu")
    assert not compare.judge(got, bench.cell(cells[kind])["check"]["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yolov4-608.serve-b8",
                                  "gaussian-yolov3-512-int8.serve-b32"])
def test_control_fails_on_card(cuda, cell):
    bench = harness.Bench(REPO)
    limits = bench.cell(cell)["check"]["limits"]
    for seed in (3000000101, 3000000102, 3000000103):
        assert not compare.judge(control.numbers(bench, cell, seed, "cuda"),
                                 limits)
