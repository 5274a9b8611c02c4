"""The `fused_epilogue_share` reader: the program's `conv_epilogues_fused`
over its `conv_epilogues`, a request, over the profiled requests; None
where the program counts no conv epilogue (a tree without the counters),
and on the CPU tiny cell, where no conv runs the card's one-pass epilogue,
0."""

from __future__ import annotations

import pytest

from conftest import REPO, run_cell

from benchmark import harness


@pytest.fixture
def spans():
    from darknet_tpu_torch.utils import spans

    spans.clear()
    yield spans
    spans.clear()


def _reader():
    return harness.Bench(REPO).reader("fused_epilogue_share")


def test_share_of_the_profiled_requests(spans, monkeypatch):
    reqs = [spans.Request(0, [], {"conv_epilogues": 93,
                                  "conv_epilogues_fused": 93}),
            spans.Request(1, [], {"conv_epilogues": 93,
                                  "conv_epilogues_fused": 90}),
            spans.Request(2, [], {"conv_epilogues": 93})]
    monkeypatch.setattr(spans, "requests", lambda: reqs)
    read = _reader().read
    assert read({"traffic": {"profiled_requests": 2}}) == 100 * 183 / 186
    assert read({"traffic": {"profiled_requests": 3}}) == 100 * 183 / 279
    assert read({"traffic": {"profiled_requests": 4}}) is None
    reqs[:] = [spans.Request(0, [], {"nms_rounds": 3})]
    assert read({"traffic": {"profiled_requests": 1}}) is None


def test_cpu_tiny_cell_reads_zero(tiny_root, spans):
    root, cells = tiny_root
    out, _metrics, _dev = run_cell(root, cells["yolov4"], trace=1)
    assert out.correct, out.checks
    assert _reader().read(out.record) == 0.0
