"""A configuration, a traffic mix, a cell and a per-layer metric added
as files plus `BENCHMARK.json` entries run with no edit to any file the
benchmark already has."""

from __future__ import annotations

import filecmp
import json
import os

from conftest import REPO, run_cell

from benchmark import harness

METRIC = '''"""Images the window served (a test metric)."""

LAYER = "test"
UNIT = "img"
MOVES = "serve_img_s"


def read(record):
    return float(record["window"]["images"])
'''


def _unchanged(root: str) -> None:
    """Every file of the repository's benchmark is in the copy, as it is."""
    src = os.path.join(REPO, "benchmark")
    for dirpath, dirnames, files in os.walk(src):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_cache", "tests")]
        for f in files:
            if f.endswith(".pyc"):
                continue
            a = os.path.join(dirpath, f)
            b = os.path.join(root, "benchmark", os.path.relpath(a, src))
            assert filecmp.cmp(a, b, shallow=False), b


def test_added_cell_and_metric_run(tiny_root):
    root, cells = tiny_root
    with open(os.path.join(root, "benchmark", "metrics",
                           "images_served.py"), "w") as f:
        f.write(METRIC)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["per_layer"].append({
        "name": "images_served", "unit": "img", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "serve_img_s",
        "workloads": [cells["yolov4"]]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    _unchanged(root)

    out, metrics, dev = run_cell(root, cells["yolov4"], trace=0)
    assert out.correct, out.checks
    assert set(metrics) == {m["name"] for m in harness.Bench(root).end_to_end(
        cells["yolov4"])} == {"serve_img_s", "serve_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in metrics.values())
    assert dev["platform"] == "cpu" and dev["count"] == 1

    out, metrics, dev = run_cell(root, cells["yolov4"], trace=1)
    assert out.correct, out.checks
    assert metrics["images_served"]["value"] == out.record["window"][
        "images"]
    assert metrics["images_served"]["unit"] == "img"
    # on the CPU no device metric has anything to read
    assert "region_roofline_pct" not in metrics
    assert dev["window_s"] > 0
    spec["per_layer"].pop()
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    os.remove(os.path.join(root, "benchmark", "metrics", "images_served.py"))
