"""The readers of the program's own spans and counts
(`served_spans.py`; `upload_host_ms`, `forward_enqueue_ms`,
`nms_host_ms`, `nms_rounds`, `host_syncs`) on the CPU tiny cell: a
`--trace 1` run reports all five, the host times above 0 and the counts
the store's; a `--trace 0` run leaves the store empty; and the files the
benchmark had are as they were."""

from __future__ import annotations

import pytest

from conftest import run_cell
from test_yardstick_discovery import _unchanged

TIMES = ("upload_host_ms", "forward_enqueue_ms", "nms_host_ms")
COUNTS = {"nms_rounds": "nms_rounds", "host_syncs": "host_syncs"}
UNITS = {"upload_host_ms": "ms/req", "forward_enqueue_ms": "ms/req",
         "nms_host_ms": "ms/req", "nms_rounds": "rounds/req",
         "host_syncs": "syncs/req"}


@pytest.fixture
def store():
    from darknet_tpu_torch.utils import spans

    spans.clear()
    yield spans
    spans.clear()


def test_traced_run_reads_the_spans(tiny_root, store):
    root, cells = tiny_root
    _unchanged(root)
    out, metrics, _dev = run_cell(root, cells["yolov4"], trace=1)
    assert out.correct, out.checks
    assert {k: metrics[k]["unit"] for k in UNITS} == UNITS
    assert all(metrics[k]["value"] > 0 for k in TIMES)
    (req,) = store.requests()[:out.record["traffic"]["profiled_requests"]]
    assert metrics["forward_enqueue_ms"]["value"] == req.ms("serve_forward")
    for name, counter in COUNTS.items():
        value = metrics[name]["value"]
        assert value == int(value) == req.counts[counter] > 0
    assert metrics["host_syncs"]["value"] == \
        metrics["nms_rounds"]["value"] + 2


def test_untraced_run_records_nothing(tiny_root, store):
    root, cells = tiny_root
    out, metrics, _dev = run_cell(root, cells["gaussian"], trace=0)
    assert out.correct, out.checks
    assert store.requests() == []
    assert not set(UNITS) & set(metrics)
