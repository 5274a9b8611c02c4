"""Operation counts from the cfg's shapes, and `BENCHMARK.json` against
the files it names."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import REPO

from benchmark import flops, harness
from benchmark.reference import darknet

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _model(config: str):
    return darknet.Model(harness.Bench(REPO).config(config)["cfg_text"])


def test_yolov4_region_prefix_flops():
    # layers 0-10 of yolov4-608 at batch 8: 92.93 GFLOP by the cfg's
    # shapes.  The kernel's own plan counts 129.46: its space-to-depth
    # stem computes layers 0 and 1 as convs over 2x2 pixel blocks, whose
    # taps include 36.53 GFLOP of structural zeros.
    m = _model("yolov4-608")
    gflop = 8 * sum(2 * flops.conv_macs(l) for l in m.layers[:11]
                    if l.kind == "convolutional") / 1e9
    assert gflop == pytest.approx(92.93, abs=0.005)
    l0, l1 = m.layers[0], m.layers[1]
    s2d = 304 * 304 * (9 * 12 * 128 + 4 * 128 * 64)
    assert 8 * 2 * (s2d - flops.conv_macs(l0) - flops.conv_macs(l1)) / 1e9 \
        == pytest.approx(129.46 - 92.93, abs=0.01)
    assert len(m.layers) == 162


def test_quantized_convs():
    # yolov4-608's 91 quantized convs: 429.26 GMAC at batch 8
    m = _model("yolov4-608")
    q = m.int8_convs()
    assert len(q) == 91
    gmac = 8 * sum(flops.conv_macs(m.layers[i]) for i in q) / 1e9
    assert gmac == pytest.approx(429.26, abs=0.005)
    assert len(_model("gaussian-yolov3-512-int8").int8_convs()) == 63


def test_least_time_sums_the_convs():
    m = _model("yolov4-608")
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    macs = sum(flops.conv_macs(l) for l in m.convs())
    assert flops.forward_least_s(m, peak=peak) == pytest.approx(
        2 * macs / peak["bf16_flops_s"])
    assert flops.scope_layers("L000-023_region") == (0, 23)
    assert flops.scope_layers("L105_convolutional") == (105, 105)
    assert flops.scope_layers("optimizer_update") is None


def test_benchmark_json_names_its_files():
    bench = harness.Bench(REPO)
    spec = bench.spec
    assert spec["command"][0] == "python3"
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e == {"serve_img_s", "serve_p95_ms", "setup_s"}
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert bench.config(c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert bench.mode(cell["mode"]).run
        assert bench.traffic(w["traffic"])["batch"] >= 1
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(w["name"])
    for m in spec["per_layer"]:
        reader = bench.reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])
        assert m["moves"] in e2e
    assert len(json.dumps(spec)) < 64 * 1024
