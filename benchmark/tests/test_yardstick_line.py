"""The result line's shape, and a run without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import REPO, run_cell


def test_line_shape(tiny_root):
    from benchmark import harness

    root, cells = tiny_root
    out, metrics, dev = run_cell(root, cells["gaussian"], trace=0)
    line = json.loads(harness.result_line(out, metrics, dev))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
        assert c["value"] <= c["limit"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "yolov4-608.serve-b8", "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
