"""The plain reference held to the port at a small size on the CPU: the
same weights and frames through both, float32 and int8."""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import compare, darknet, postprocess


def _setup(root, config, seed=11):
    bench = harness.Bench(root)
    cfg = bench.config(config)
    model = darknet.Model(cfg["cfg_text"])
    raw = weights.make(model, cfg["weights"], seed, "cpu")
    return cfg, model, raw


def _program(cfg, model, raw, tmp_path, int8=False):
    from darknet_tpu_torch import Network

    path = os.path.join(tmp_path, "w.weights")
    weights.write(model, raw, path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Network.from_cfg(cfg["cfg_text"], weights=path, device="cpu",
                                int8=int8)


@pytest.mark.parametrize("kind", ["yolov4", "gaussian"])
def test_heads_match_the_port(tiny_root, tmp_path, kind):
    root, _cells = tiny_root
    name = {"yolov4": "tiny-yolov4", "gaussian": "tiny-gaussian"}[kind]
    cfg, model, raw = _setup(root, name)
    net = _program(cfg, model, raw, tmp_path)
    x = traffic.to_unit(traffic.frames(2, model, 5, "cpu"), "cpu")
    with torch.no_grad():
        got = net._fwd(net.forward_params, x)["raw_heads"]
        want = darknet.forward(darknet.Weights(model, raw), x)
    # float32 on both sides; the sums run in other orders (the stem fold,
    # the CPU's conv algorithms), and 100 and more layers grow rounding
    # of 1e-7 to about 1e-4 of the heads' scale
    for g, w in zip(got, want):
        w = w.permute(0, 2, 3, 1)
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-3 * scale


def test_int8_matches_the_port(tiny_root, tmp_path):
    root, _cells = tiny_root
    cfg, model, raw = _setup(root, "tiny-gaussian")
    net = _program(cfg, model, raw, tmp_path, int8=True)
    calib = traffic.frames(4, model, 6, "cpu")
    net.calibrate_int8([traffic.to_unit(calib, "cpu").numpy()])
    ref = darknet.Weights(model, raw, "int8", model.int8_convs())
    ref.calibrate([traffic.to_unit(calib, "cpu")])
    # the same quantized convs; int8 weights that differ by a step only
    # where the two folds of batch norm differ by an ulp at a half step;
    # scales that agree where no int8 conv runs upstream (further down,
    # rounding that flips a quantization step moves a later input's
    # maximum by about a step's share of it)
    assert {i for i, p in enumerate(net.params) if "w_q" in p} \
        == ref.quantized
    first = min(ref.quantized)
    for i in ref.quantized:
        assert float(net.params[i]["x_scale"]) == pytest.approx(
            float(ref.x_scale[i]), rel=1e-5 if i == first else 5e-2)
        wq = net.params[i]["w_q"].float()
        d = (wq - ref.q[i][0].permute(0, 2, 3, 1).reshape(wq.shape[0], -1))
        assert float(d.abs().max()) <= 1 and int((d != 0).sum()) \
            <= 1e-4 * d.numel()
    # with the program's scales, the first int8 conv gives the program's
    # output within an output step or so (a few inputs sit at half a
    # step, where float32 rounding decides)
    ref.x_scale = {i: net.params[i]["x_scale"].reshape(())
                   for i in ref.quantized}
    x = traffic.to_unit(traffic.frames(2, model, 7, "cpu"), "cpu")
    outs = {}

    def conv(l, y):
        out = darknet.activate(darknet._conv(ref, l, y, None), l.act)
        outs[l.index] = out
        return out

    with torch.no_grad():
        want = darknet.walk(model, x, conv)
        got_first = net._fwd(net.forward_params, x, _hi=first + 1)["output"]
        got = net._fwd(net.forward_params, x)["raw_heads"]
        f32 = darknet.forward(darknet.Weights(model, raw), x)
    w = outs[first].permute(0, 2, 3, 1)
    assert float((got_first - w).abs().max()) <= 2e-3 * float(w.abs().max())
    # flipped steps spread through the int8 chain: two correct int8 runs
    # part at the heads about as far as int8 parts from float32, so the
    # heads are held to that yardstick
    for g, w, f in zip(got, want, f32):
        w, f = w.permute(0, 2, 3, 1), f.permute(0, 2, 3, 1)
        yardstick = float((w - f).pow(2).mean().sqrt())
        assert float((g - w).pow(2).mean().sqrt()) <= 2 * yardstick


@pytest.mark.parametrize("kind", ["yolov4", "gaussian"])
def test_served_triples_match_the_port(tiny_root, tmp_path, kind):
    root, _cells = tiny_root
    name = {"yolov4": "tiny-yolov4", "gaussian": "tiny-gaussian"}[kind]
    cfg, model, raw = _setup(root, name)
    net = _program(cfg, model, raw, tmp_path)
    frames = traffic.frames(2, model, 8, "cpu")
    got = net.submit_detect_device(frames, thresh=0.25, nms=0.45, top_k=64)
    with torch.no_grad():
        cand = darknet.decode(model, darknet.forward(
            darknet.Weights(model, raw), traffic.to_unit(frames, "cpu")))
    ref = postprocess.serve(*cand, thresh=0.25, nms=0.45, top_k=64)
    assert compare.well_formed(got, 2, 64, model.heads[0].classes)
    n = compare.gaps(got, ref, cand, darknet.grid_sizes(model, "cpu"),
                     thresh=0.25, nms=0.45, box_tol=0.1)
    # the heads' 1e-4 of float32 rounding (above), through the sigmoid
    assert n["box_gap"] < 1e-2
    assert n["prob_gap"] < 2e-3
    assert n["missed"] <= 0.02 * n["decisive"] and n["nms_overlap"] == 0


def test_nms_matches_the_port():
    from darknet_tpu_torch.ops import nms as pnms

    rng = np.random.default_rng(0)
    boxes = rng.uniform(0.2, 0.8, (3, 40, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.4
    probs = rng.uniform(0, 1, (3, 40, 5)).astype(np.float32)
    probs[probs < 0.5] = 0
    got = postprocess.greedy_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(probs), 0.45)
    for b in range(3):
        want = pnms.nms_numpy(boxes[b], probs[b], 0.45)
        assert np.array_equal(got[b].numpy(), want)


def test_weights_file_loads_back(tiny_root, tmp_path):
    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.weights import io

    root, _cells = tiny_root
    cfg, model, raw = _setup(root, "tiny-yolov4")
    path = os.path.join(tmp_path, "w.weights")
    weights.write(model, raw, path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loaded, _seen, _v = io.load_weights(build_graph(cfg["cfg_text"]),
                                            path)
    for l in model.convs():
        p = loaded[l.index]
        assert np.array_equal(p["w"], raw[l.index]["w"].permute(
            2, 3, 1, 0).numpy())
        for k in ("b", "scales", "mean", "var"):
            if k in raw[l.index]:
                assert np.array_equal(p[k], raw[l.index][k].numpy())
