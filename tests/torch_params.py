"""Helpers of the port's tests: numpy yolov4 params whose heads are not
saturated, and the slot matcher that compares two served triples, and chip_smoke.py's
test graphs, and a benchmark cell's network on a card.

At random init a deep yolov4 damps its heads to sigmoid(~1e-6), where
every score ties and a served kept set is decided by sum-order noise.
`lively_params` raises the BN scales to 1.5 and scales the three head
convs so that the head logits spread over O(1).  A [Gaussian_yolo]
head's class scores are scaled by 1 - mean(sigmas): its sigma channels
read no input and take fixed biases (SIGMA_BIAS, one per coordinate,
shifted per anchor), so that the sigmas cannot move a class score across
a threshold, while each (anchor, coordinate) sigma differs and a
misplaced uc shows.  Imports no jax.
"""

import importlib.util
import os
import pathlib
import sys
import tempfile
import warnings

import numpy as np

from darknet_tpu_torch.nn import params as tparams

HEAD_GAIN = {138: 30.0, 149: 280.0, 160: 1300.0}     # yolov4's head convs
SIGMA_BIAS = (-2.0, -1.5, -1.0, -0.5)     # logits of sig_x, sig_y, sig_w, sig_h


def lively_params(graph, seed=0, bn_scale=1.5, head_gain=None):
    """Unfused numpy params whose heads are not saturated at 0.5: BN
    scales times `bn_scale`, head conv i's weights times head_gain[i]
    (default: yolov4's HEAD_GAIN); a Gaussian head's sigma channels read
    no input and take SIGMA_BIAS (plus 0.25 per anchor)."""
    head_gain = HEAD_GAIN if head_gain is None else head_gain
    p = tparams.init_params(graph, seed=seed)
    for i, d in enumerate(p):
        if "scales" in d:
            d["scales"] = d["scales"] * np.float32(bn_scale)
        if i in head_gain:
            d["w"] = d["w"] * np.float32(head_gain[i])
    for l in graph.layers:
        if l.kind == "gaussian_yolo":
            d = p[l.index - 1]
            e = 9 + l.classes
            for a in range(l.n):
                for k, bias in enumerate(SIGMA_BIAS):
                    d["w"][..., a * e + 2 * k + 1] = 0.0
                    d["b"][a * e + 2 * k + 1] = bias + 0.25 * a
    return p


def spread_params(graph, x, bn_scale, spread=2.0):
    """lively_params with each head conv's gain set so that its
    objectness logits (entry 4 of a [yolo] head's anchor, 8 of a
    [Gaussian_yolo] head's) on the frames `x` spread by about `spread`
    (their standard deviation, on the CPU)."""
    import torch

    from darknet_tpu_torch.nn.emit import make_forward

    p = lively_params(graph, bn_scale=bn_scale, head_gain={})
    tp = tparams.params_to_torch(graph, tparams.fuse_conv_batchnorm(graph, p),
                                 "cpu")
    raw = make_forward(graph)(tp, torch.from_numpy(x))["raw_heads"]
    gains = {}
    for l, h in zip(graph.heads(), raw):
        obj = h.reshape(*h.shape[:3], l.n, -1)[
            ..., 8 if l.kind == "gaussian_yolo" else 4]
        gains[l.index - 1] = spread / float(obj.std())
    return lively_params(graph, bn_scale=bn_scale, head_gain=gains)


def match_slots(tb, ref_tb):
    """Per image, the reference slot that holds each slot's candidate: the
    one with the nearest box.  The top-k ranks exact objectness ties by
    index, but sum-order noise in one of the two runs can split such a
    tie the other way (yolov4 at 64 px, seed 0, has one), and then the
    two candidates trade slots.  Asserts the match is one-to-one."""
    tb, ref_tb = np.asarray(tb), np.asarray(ref_tb)
    d = np.abs(tb[:, :, None, :] - ref_tb[:, None, :, :]).max(-1)
    slot = d.argmin(-1)
    assert all(len(set(s)) == len(s) for s in slot), "slots match twice"
    return slot


def matched(ref_triple, slot):
    """The reference triple (boxes, objectness, probs) in matched order."""
    tb, ov, probs = (np.asarray(t) for t in ref_triple)
    return (np.take_along_axis(tb, slot[..., None], axis=1),
            np.take_along_axis(ov, slot, axis=1),
            np.take_along_axis(probs, slot[..., None], axis=1))


def chip_smoke():
    """chip_smoke.py as a module, read by file (an installed package named
    `tests` may shadow this directory): its test cfgs NARROW_CSP_CFG,
    conv_stack_cfg and WIDE_LAYERS."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_net(cell, device, seed=3000019001):
    """A network of the benchmark cell's configuration at its size, with
    the weights, frames and int8 calibration the benchmark makes from a
    seed (`benchmark/weights.py`, `benchmark/traffic.py`), a batch of
    its frames and its serving settings."""
    import torch

    from darknet_tpu_torch import Network

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        from benchmark import harness
        from benchmark import traffic as gen
        from benchmark import weights as wgen
        from benchmark.reference import darknet
    finally:
        sys.path.remove(repo)
    bench = harness.Bench(repo)
    c = bench.cell(cell)
    cfg, t = bench.config(c["config"]), bench.traffic(c["traffic"])
    model = darknet.Model(cfg["cfg_text"])
    s_w, s_f, s_c = harness.streams(seed, 3)
    raw = wgen.make(model, cfg["weights"], s_w, device)
    path = os.path.join(tempfile.mkdtemp(), "cell.weights")
    try:
        wgen.write(model, {i: {k: v.cpu() for k, v in p.items()}
                           for i, p in raw.items()}, path)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            net = Network.from_cfg(cfg["cfg_text"], weights=path,
                                   compute_dtype=torch.bfloat16,
                                   device=device, int8=bool(cfg.get("int8")))
    finally:
        os.remove(path)
    if cfg.get("int8"):
        calib = gen.frames(cfg["int8"]["calibration_frames"], model, s_c,
                           device)
        net.calibrate_int8([gen.to_unit(calib, "cpu").numpy()])
    x = gen.pool(t, model, s_f, device)[0]
    return net, x, {k: t[k] for k in ("thresh", "nms", "top_k")}
