"""The serving artifact of darknet_tpu_torch (`Network.export_serving`,
`Network.run_exported_serving`, `torch.export` with the kernels as the
custom ops of `ops/library.py`) against the port's own serving and the
JAX package's jax.export artifact, on the CPU.

- yolov4-tiny at 160 px, b=2, f32 (the cfg of the JAX package's export
  test, `tests/test_device_detect.py`), on the same numpy params in both
  packages (`spread_params`, so that the heads spread): the port's
  artifact, saved and loaded, returns the triple of `submit_detect_device`
  bitwise; it holds 2 region nodes (two hybrid region prefixes); the JAX
  artifact's triple matches it at the port's serving tolerances
  (`test_torch_slice.assert_serving_matches`: slots matched by box,
  objectness within 1e-5, equal kept sets, box sizes at rtol 1e-4).
- The narrow int8 cfg of `tests/test_int8.py`, calibrated by the port and
  the calibration loaded into the JAX network: the same checks, and the
  artifact's int8 conv nodes counted.
- The artifact holds only the params its program reads: a calibrated
  int8 conv's int8 weights and scales, not its float weights; a region's
  step weights (held by the Network, `forward_params`), not its layers'
  own.
- A Gaussian head exports the same triple, its sigmas left behind; a
  network without a decoded head, and a card artifact without a card,
  are refused.
- `RegionPlan.to_json` / `from_json` give an equal plan for every zoo
  plan and its hybrid prefix; `nms_device`'s while_loop keeps the set
  that the Python fixpoint loop it replaced keeps.
"""

import os
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import network as tnetwork
from darknet_tpu_torch.ops import boxes as boxops
from darknet_tpu_torch.ops import fused_region as fr
from darknet_tpu_torch.ops import nms as tnms
from darknet_tpu_torch.weights import io as wio
from tests.test_torch_slice import assert_serving_matches
from tests.torch_params import spread_params

torch.set_num_threads(2)
PX = 160
TINY_CFG = model_zoo.yolov4_tiny_cfg(PX, PX)
INT8_CFG = ("[net]\nbatch=1\nsubdivisions=1\nwidth=32\nheight=32\n"
            "channels=3\n"
            "[convolutional]\nfilters=128\nsize=3\nstride=2\npad=1\n"
            "activation=leaky\n"
            "[convolutional]\nbatch_normalize=1\nfilters=128\nsize=3\n"
            "stride=2\npad=1\nactivation=mish\n"
            "[convolutional]\nfilters=20\nsize=1\nactivation=linear\n"
            "[yolo]\nmask=0,1\nnum=2\nclasses=5\nanchors=10,14, 23,27\n")


def _frames(b, px, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, px, px, 3)).astype(np.float32)


def _op_nodes(path) -> Counter:
    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)

    ep = torch.export.load(path)
    return Counter(str(n.target) for n in ep.graph.nodes
                   if str(n.target).startswith("darknet_tpu_torch."))


def _round_trip(tnet, jnet, x, tmp_path, thresh, nms, top_k):
    """(port's live triple, the port artifact's, the JAX artifact's) and
    the port artifact's path."""
    b = x.shape[0]
    live = tnet.submit_detect_device(x, thresh=thresh, nms=nms, top_k=top_k)
    art = str(tmp_path / "serve.pt2")
    tnet.export_serving(art, batch=b, thresh=thresh, nms=nms, top_k=top_k)
    got = Network.run_exported_serving(art, x)
    jart = str(tmp_path / "serve.jaxexport")
    jnet.export_serving(jart, batch=b, thresh=thresh, nms=nms, top_k=top_k)
    want = [np.asarray(t) for t in JaxNetwork.run_exported_serving(jart, x)]
    return live, got, want, art


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """yolov4-tiny at 160 px, f32, both packages on one .weights file."""
    x = _frames(2, PX)
    path = str(tmp_path_factory.mktemp("w") / "tiny.weights")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(TINY_CFG)
        wio.save_weights(g, spread_params(g, x, 1.5), path)
        jnet = JaxNetwork.from_cfg(TINY_CFG, weights=path)
        tnet = Network.from_cfg(TINY_CFG, weights=path, device="cpu")
    return tnet, jnet, x


def test_export_f32_bitwise_and_as_jax(tiny, tmp_path):
    tnet, jnet, x = tiny
    live, got, want, art = _round_trip(tnet, jnet, x, tmp_path,
                                       thresh=0.2, nms=0.45, top_k=64)
    assert os.path.getsize(art) > 1000
    for a, b in zip(live, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [tuple(t.shape) for t in got] == [(2, 64, 4), (2, 64),
                                            (2, 64, 80)]
    assert_serving_matches(got, want)
    assert _op_nodes(art) == Counter({"darknet_tpu_torch.region.default": 2})


def test_export_loads_in_place_of_the_network(tiny, tmp_path):
    """The artifact serves with no Network around: loaded once per file,
    again after the file changes (another batch), on any frames."""
    tnet, _jnet, x = tiny
    art = str(tmp_path / "s.pt2")
    tnet.export_serving(art, batch=2, thresh=0.2, top_k=32)
    y = _frames(2, PX, seed=5)
    a = Network.run_exported_serving(art, torch.from_numpy(y))
    b = tnet.submit_detect_device(y, thresh=0.2, top_k=32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    tnet.export_serving(art, batch=1, thresh=0.2, top_k=32)
    c = Network.run_exported_serving(art, y[:1])
    assert c[0].shape == (1, 32, 4)
    assert torch.equal(c[2], tnet.submit_detect_device(
        y[:1], thresh=0.2, top_k=32)[2])


def test_export_gaussian_drops_uc(tmp_path):
    """Gaussian heads export the same triple as [yolo] heads (the sigmas
    stay behind), bitwise equal to submit_detect_device's."""
    from tests.torch_params import chip_smoke

    cfg = chip_smoke().GAUSSIAN_TRAIN_CFG
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, seed=1, device="cpu")
    assert {l.kind for l in net.graph.heads()} == {"gaussian_yolo"}
    x = _frames(2, net.net.w, seed=3)
    art = str(tmp_path / "g.pt2")
    net.export_serving(art, batch=2, thresh=0.1, top_k=32)
    got = Network.run_exported_serving(art, x)
    want = net.submit_detect_device(x, thresh=0.1, top_k=32)
    assert len(got) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_export_refuses(tmp_path, monkeypatch):
    """No decoded head: a ValueError before any work.  A card artifact
    without a card: the port's "no CUDA card" error, before loading."""
    cfg = ("[net]\nwidth=32\nheight=32\nchannels=3\n"
           "[convolutional]\nfilters=8\nsize=3\nstride=2\npad=1\n"
           "activation=leaky\n")
    net = Network.from_cfg(cfg, device="cpu")
    art = str(tmp_path / "none.pt2")
    with pytest.raises(ValueError, match="yolo"):
        net.export_serving(art)
    assert not os.path.exists(art)
    net = Network.from_cfg(INT8_CFG, device="cpu")
    net.export_serving(art, batch=1)
    monkeypatch.setattr(tnetwork, "_read_meta",
                        lambda path: {"device": "cuda",
                                      "compute_dtype": "torch.float32"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tnetwork._loaded.clear()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Network.run_exported_serving(art, _frames(1, 32))


def test_export_int8_calibrated_as_jax(tmp_path):
    x = _frames(2, 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tnet = Network.from_cfg(INT8_CFG, int8=True, seed=2, device="cpu")
        jnet = JaxNetwork.from_cfg(INT8_CFG, int8=True, seed=2)
    tnet.calibrate_int8(x)
    calib = str(tmp_path / "scales.cache")
    tnet.save_calibration(calib)
    jnet.load_calibration(calib)
    live, got, want, art = _round_trip(tnet, jnet, x, tmp_path,
                                       thresh=0.1, nms=0.45, top_k=16)
    for a, b in zip(live, got):
        assert torch.equal(a, b)
    assert_serving_matches(got, want)
    n_q = sum("w_q" in p for p in tnet.params)
    assert n_q == 1
    assert _op_nodes(art) == Counter(
        {"darknet_tpu_torch.int8_conv.default": n_q})


def test_export_holds_only_what_it_reads(tiny, tmp_path):
    tnet, _jnet, x = tiny
    art = str(tmp_path / "f32.pt2")
    tnet.export_serving(art, batch=2, thresh=0.2, top_k=32)
    names = set(torch.export.load(art).state_dict)
    plans = tnet._fwd.region_plans
    assert len(plans) == 2
    held = tnet.forward_params
    for a, plan in plans.items():
        steps = [k for k in held[a] if k not in tnet.params[a]]
        assert len(steps) == 2 * len(plan.conv_steps)
        assert {f"p{a}_{k}" for k in steps} <= names
        for s in plan.conv_steps:
            assert f"p{s.li}_w" not in names
    # the eager path reads the same held tensors, made once
    assert tnet.forward_params is held

    q = Network.from_cfg(INT8_CFG, int8=True, seed=2, device="cpu")
    q.calibrate_int8(_frames(2, 32))
    art = str(tmp_path / "int8.pt2")
    q.export_serving(art, batch=2)
    names = set(torch.export.load(art).state_dict)
    calibrated = [i for i, p in enumerate(q.params) if "x_scale" in p]
    assert calibrated == [1]
    assert {"p1_w_q", "p1_w_scale", "p1_x_scale", "p1_b"} <= names
    assert "p1_w" not in names and "p0_w" in names


@pytest.mark.parametrize("name", sorted(model_zoo.MODELS))
@pytest.mark.parametrize("stem", [True, False])
def test_region_plan_json_round_trip(name, stem):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.MODELS[name](416, 416))
    plans = list(fr.plan_graph_regions(g, stem=stem).values())
    plans += [p[0] for p in map(fr.hybrid_prefix, plans) if p is not None]
    for p in plans:
        text = p.to_json()
        q = fr.RegionPlan.from_json(text)
        assert q == p and q.to_json() == text
        assert all(a.w_fn == b.w_fn and a.b_fn == b.b_fn
                   for a, b in zip(q.conv_steps, p.conv_steps))


def _nms_python_loop(boxes, probs, thresh, kind="greedynms", beta=0.6):
    """`nms_device` as it was before the while_loop: the same fixpoint in
    a Python loop."""
    n = boxes.shape[1]
    a, b = boxes[:, :, None, :], boxes[:, None, :, :]
    sim = boxops.iou(a, b) if kind == "greedynms" else boxops.diou(a, b,
                                                                   beta)
    suppress = sim > thresh
    pT = probs.transpose(1, 2)
    lt = torch.ones((n, n), dtype=torch.bool).tril(-1)
    pi, pj = pT[..., :, None], pT[..., None, :]
    P = ((pj > pi) | ((pj == pi) & lt)) & suppress[:, None]
    active = pT > 0

    def step(K):
        return active & ~(P & K[..., None, :]).any(dim=-1)

    lo, hi = torch.zeros_like(active), active
    while bool((lo != hi).any()):
        lo, hi = lo | step(hi), hi & step(lo)
    return torch.where(lo.transpose(1, 2), probs, torch.zeros_like(probs))


@pytest.mark.parametrize("seed", [9, 10, 11])
@pytest.mark.parametrize("kind", ["greedynms", "diounms"])
def test_nms_while_loop_keeps_the_loop_set(kind, seed):
    """The cases of `test_torch_ops.test_nms_host_and_device` (seed 9)
    and two more draws, batched."""
    rng = np.random.default_rng(seed)
    n, c = 48, 3
    centers = rng.uniform(0.3, 0.7, (6, 2))
    boxes = np.concatenate(
        [centers[rng.integers(0, 6, n)] + rng.normal(0, 0.02, (n, 2)),
         rng.uniform(0.1, 0.2, (n, 2))], -1).astype(np.float32)
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32)
    probs[rng.uniform(size=(n, c)) < 0.3] = 0.0
    probs[5] = probs[9]                                   # ties
    tb = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()]))
    tp = torch.from_numpy(np.stack([probs, probs[::-1].copy()]))
    got = tnms.nms_device(tb, tp, 0.45, kind=kind)
    want = _nms_python_loop(tb, tp, 0.45, kind=kind)
    assert torch.equal(got, want)
    assert 0 < int((got > 0).sum()) < int((tp > 0).sum())
