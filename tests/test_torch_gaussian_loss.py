"""The port's Gaussian-YOLO training delta
(`train/gaussian_yolo_loss.gaussian_yolo_head_delta`) against the JAX
package's on the CPU: mse and every IoU loss, max_delta, scale_x_y,
iou_thresh and its kind, label smoothing, class multipliers, a class
map, yolo_point left_top and right_bottom, uc_normalizer != 1; empty
truths, an invalid class id, two truths in one cell, and a zero sigma
(the NLL's in_exp is infinite there); the delta, the cost and every
metric are compared.  Then the JAX package's own Gaussian tests
(tests/test_gaussian_loss.py) as the port's: the literal NLL at the
assigned cell, the IoU branch replacing only the means, and a step that
learns.

Tolerance: 1e-5 of the delta's scale, 1e-4 on the cost and the metrics
(relative, or absolute below 1: f32 sums over hundreds of terms in
another order); the literal NLL as the JAX test holds it (rtol 1e-4).

One metric differs by design, as for [yolo] heads
(tests/test_torch_train_loss.py): with a truth whose class id is out of
range, the JAX package's avg_cat is NaN; the port skips that truth and
reports a finite avg_cat."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.train.gaussian_yolo_loss import \
    gaussian_yolo_head_delta as jdelta
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.gaussian_yolo_loss import \
    gaussian_yolo_head_delta
from darknet_tpu_torch.train.step import init_opt_state, make_train_step

TOL = 1e-5
TOL_SUM = 1e-4
PX = 64
E = 9 + 4
HEAD = """[net]
width={px}
height={px}
channels=3
[convolutional]
filters={filters}
size=1
stride=1
pad=1
activation=linear
[Gaussian_yolo]
mask=0,1,2
anchors=6,8, 14,12, 20,26, 40,36, 60,50, 62,62
classes=4
num=6
ignore_thresh=.5
max_delta={max_delta}
iou_loss={iou_loss}
scale_x_y={scale_x_y}
iou_thresh={iou_thresh}
iou_normalizer=0.5
uc_normalizer={uc}
cls_normalizer=1.0
{extra}
"""

CASES = {
    "mse": dict(iou_loss="mse"),
    "iou": dict(iou_loss="iou"),
    "giou": dict(iou_loss="giou"),
    "diou": dict(iou_loss="diou"),
    "ciou": dict(iou_loss="ciou", max_delta=5),
    "mse_max_delta": dict(iou_loss="mse", max_delta=0.2),
    "scale_x_y": dict(iou_loss="mse", scale_x_y=1.1),
    "iou_thresh": dict(iou_loss="ciou", iou_thresh=0.2),
    "iou_thresh_kind": dict(iou_loss="mse", iou_thresh=0.2,
                            extra="iou_thresh_kind=giou"),
    "label_smooth": dict(iou_loss="mse", extra="label_smooth_eps=0.1"),
    "multipliers": dict(iou_loss="mse", extra="counters_per_class=10,"
                        "20,5,40"),
    "class_map": dict(iou_loss="giou", class_map=(2, 0, 3, 1)),
    "left_top": dict(iou_loss="mse", extra="yolo_point=left_top"),
    "right_bottom": dict(iou_loss="giou", extra="yolo_point=right_bottom"),
    "uc_normalizer": dict(iou_loss="mse", uc=0.3),
}


def head_layers(case):
    kw = dict(px=PX, filters=3 * E, max_delta="inf", iou_loss="mse",
              scale_x_y=1.0, iou_thresh=1.0, uc=1.0, extra="")
    kw.update(CASES[case])
    class_map = kw.pop("class_map", None)
    if kw["max_delta"] == "inf":
        kw["max_delta"] = 3.4e38
    cfg = HEAD.format(**kw)
    lj = jbuild(cfg, train=True).layers[1]
    lt = tbuild(cfg, train=True).layers[1]
    assert lj.kind == lt.kind == "gaussian_yolo"
    if class_map is not None:
        lj.class_map = lt.class_map = class_map
    return lj, lt


def truths_for(kind, b=3, t=12, seed=0):
    rng = np.random.default_rng(seed)
    y = np.zeros((b, t, 5), np.float32)
    for i in range(b):
        n = 0 if (kind == "empty" and i == 1) else int(rng.integers(2, 6))
        for k in range(n):
            w, h = rng.uniform(0.05, 0.6, 2)
            y[i, k] = [rng.uniform(w / 2, 1 - w / 2),
                       rng.uniform(h / 2, 1 - h / 2), w, h,
                       rng.integers(0, 4)]
    if kind == "same_cell":
        # truths of other sizes and classes in one cell of each image
        y[:, 0] = [0.51, 0.52, 0.30, 0.25, 1]
        y[:, 1] = [0.52, 0.51, 0.12, 0.20, 3]
        y[:, 2] = [0.515, 0.515, 0.31, 0.24, 2]
    if kind == "bad_class":
        y[0, 1, 4] = 7          # outside classes=4: skipped
        y[2, 0, 4] = -1
    if kind == "empty":
        y[:] = 0.0
        y[0, 0] = [0.4, 0.5, 0.3, 0.3, 2]
    return y


def raw_for(seed, zero_sigma=False):
    g = PX // 8
    raw = (np.random.default_rng(seed + 100).standard_normal(
        (3, g, g, 3 * E)) * 1.5).astype(np.float32)
    if zero_sigma:
        # sigmoid(-200) is 0 in f32: every sigma of image 0 is zero, so
        # in_exp = d / sig is infinite at its assigned cells
        v = raw.reshape(3, g, g, 3, E)
        v[0, ..., 1:8:2] = -200.0
    return raw


def run_both(case, kind, seed=0, zero_sigma=False):
    lj, lt = head_layers(case)
    raw = raw_for(seed, zero_sigma)
    y = truths_for(kind, seed=seed)
    dj, cj, mj = jdelta(jnp.asarray(raw), jnp.asarray(y), lj, PX, PX)
    dt, ct, mt = gaussian_yolo_head_delta(torch.from_numpy(raw),
                                          torch.from_numpy(y), lt, PX, PX)
    return (np.asarray(dj), float(cj), {k: float(v) for k, v in mj.items()},
            dt.numpy(), float(ct), {k: float(v) for k, v in mt.items()})


def assert_same(dj, cj, mj, dt, ct, mt, skip=()):
    assert dt.shape == dj.shape
    assert np.isfinite(dt).all()
    scale = max(np.abs(dj).max(), 1e-6)
    assert np.abs(dt - dj).max() <= TOL * scale, np.abs(dt - dj).max()
    assert abs(ct - cj) <= TOL_SUM * max(abs(cj), 1.0), (ct, cj)
    assert set(mt) == set(mj)
    for k in set(mj) - set(skip):
        assert abs(mt[k] - mj[k]) <= TOL_SUM * max(abs(mj[k]), 1.0), (
            k, mt[k], mj[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gaussian_delta_matches_jax(case):
    dj, cj, mj, dt, ct, mt = run_both(case, "random", seed=len(case))
    assert mt["count"] > 0 and mt["uc_loss"] > 0
    assert_same(dj, cj, mj, dt, ct, mt)


@pytest.mark.parametrize("kind", ["empty", "bad_class", "same_cell"])
def test_gaussian_delta_truth_edge_cases(kind):
    dj, cj, mj, dt, ct, mt = run_both("ciou", kind, seed=3)
    skip = ()
    if kind == "bad_class":
        assert np.isnan(mj["avg_cat"]) and np.isfinite(mt["avg_cat"])
        skip = ("avg_cat",)
    assert_same(dj, cj, mj, dt, ct, mt, skip)
    if kind == "same_cell":
        assert mt["count"] >= 3
    if kind == "empty":
        assert mt["count"] == mj["count"] <= 2


@pytest.mark.parametrize("case", ["mse", "giou"])
def test_gaussian_delta_zero_sigma(case):
    """A sigma of 0: the NLL's terms are not finite at the assigned cells
    and the NaN guard zeroes them in both packages alike."""
    dj, cj, mj, dt, ct, mt = run_both(case, "random", seed=5,
                                      zero_sigma=True)
    # the guard fired: some sigma delta of image 0 is zero at a hit cell
    hit = dt.reshape(3, -1, E)[0, :, 8] > 0
    assert hit.any()
    assert (dt.reshape(3, -1, E)[0][hit][:, 1:8:2] == 0).any()
    assert_same(dj, cj, mj, dt, ct, mt)


# the JAX package's Gaussian tests (tests/test_gaussian_loss.py), ported
CFG = """[net]
width=32
height=32
channels=3
[convolutional]
filters={filters}
size=8
stride=8
activation=linear
[Gaussian_yolo]
mask=0,1
num=3
classes=3
anchors=6,9, 14,11, 22,25
iou_loss={iou_loss}
ignore_thresh=.5
uc_normalizer=0.7
iou_normalizer=0.6
"""


def _setup(iou_loss="mse"):
    g = tbuild(CFG.format(filters=2 * (3 + 9), iou_loss=iou_loss),
               train=True)
    return g.layers[1], g.net


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def test_gaussian_nll_delta_at_cell(rng):
    l, net = _setup("mse")
    h, w, c = l.out_h, l.out_w, l.out_c           # 4x4 grid
    raw = rng.normal(size=(1, h, w, c)).astype(np.float32) * 0.5
    truth = np.zeros((1, 4, 5), np.float32)
    # center (0.62, 0.38) -> cell i=2, j=1; w,h chosen to match anchor 1
    truth[0, 0] = [0.62, 0.38, 14 / 32, 11 / 32, 2]
    delta, cost, metrics = gaussian_yolo_head_delta(
        torch.from_numpy(raw), torch.from_numpy(truth), l, net.w, net.h)
    assert int(metrics["count"]) == 1
    d = delta.numpy().reshape(h, w, 2, 12)

    a, i, j = 1, 2, 1
    v = raw[0, j, i, a * 12:(a + 1) * 12].astype(np.float64)
    mu_x, sig_x = _sigmoid(v[0]), _sigmoid(v[1])
    in_exp = (truth[0, 0, 0] * w - i - mu_x) / sig_x
    scale = 2 - truth[0, 0, 2] * truth[0, 0, 3]
    normal = math.exp(-0.5 * in_exp ** 2) / (
        math.sqrt(2 * math.pi) * (sig_x + 0.3))
    temp = 0.5 * normal / (normal + 1e-9) * scale
    np.testing.assert_allclose(d[j, i, a, 0], temp * in_exp / sig_x * 0.6,
                               rtol=1e-4)
    np.testing.assert_allclose(
        d[j, i, a, 1], temp * (in_exp ** 2 / sig_x - 1 / (sig_x + 0.3))
        * 0.7, rtol=1e-4)
    np.testing.assert_allclose(d[j, i, a, 8], 1 - _sigmoid(v[8]), rtol=1e-4)
    probs = _sigmoid(v[9:12])
    np.testing.assert_allclose(d[j, i, a, 9 + 2], 1 - probs[2], rtol=1e-4)
    np.testing.assert_allclose(d[j, i, a, 9], -probs[0], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(cost), float((d ** 2).sum()),
                               rtol=1e-5)


def test_gaussian_iou_branch_replaces_mu(rng):
    l, net = _setup("giou")
    h, w, c = l.out_h, l.out_w, l.out_c
    raw = torch.from_numpy(
        rng.normal(size=(1, h, w, c)).astype(np.float32) * 0.5)
    truth = np.zeros((1, 4, 5), np.float32)
    truth[0, 0] = [0.62, 0.38, 14 / 32, 11 / 32, 1]
    truth = torch.from_numpy(truth)
    d_g = gaussian_yolo_head_delta(raw, truth, l, net.w, net.h)[0]
    d_m = gaussian_yolo_head_delta(raw, truth, _setup("mse")[0], net.w,
                                   net.h)[0]
    d_g = d_g.numpy().reshape(h, w, 2, 12)
    d_m = d_m.numpy().reshape(h, w, 2, 12)
    # sigma deltas identical between branches; mu deltas differ
    np.testing.assert_allclose(d_g[1, 2, 1, 1], d_m[1, 2, 1, 1], rtol=1e-5)
    assert not np.allclose(d_g[1, 2, 1, 0], d_m[1, 2, 1, 0])


def test_gaussian_train_step_learns(rng):
    cfg = CFG.format(filters=2 * (3 + 9), iou_loss="mse").replace(
        "[convolutional]", "[convolutional]\nbatch_normalize=1", 1)
    g = tbuild(cfg, train=True)
    params = tparams.train_params_to_torch(
        g, tparams.init_params(g, seed=0), "cpu")
    step = make_train_step(g)
    opt = init_opt_state(g, params)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32))
    truths = np.zeros((2, 4, 5), np.float32)
    truths[:, 0] = [0.6, 0.4, 0.4, 0.35, 1]
    truths = torch.from_numpy(truths)
    costs = []
    for _ in range(25):
        params, opt, cost, _m = step(params, opt, x, truths, 0.01)
        costs.append(float(cost))
    assert np.all(np.isfinite(costs))
    assert costs[-1] < costs[0]
