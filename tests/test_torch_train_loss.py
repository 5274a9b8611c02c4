"""The port's YOLO training delta (`train/yolo_loss.yolo_head_delta`)
against the JAX package's on the CPU: every iou_loss, scale_x_y,
iou_thresh extra matches, truth_thresh, label smoothing, focal loss,
class multipliers, empty truths, an invalid class id, and two truths in
one cell; the delta, the cost and every metric are compared.

Tolerance: 1e-5 of the delta's scale, 1e-4 on the cost and the metrics
(relative, or absolute below 1: f32 sums over hundreds of terms in
another order); `dx_box_iou` to 1e-5.

One metric differs by design: with a truth whose class id is out of
range, the JAX package's avg_cat is NaN (its gather fills the skipped
truth's class probability with NaN and 0 * NaN poisons the sum); the
port skips that truth as the reference does and reports a finite
avg_cat."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.train.yolo_loss import dx_box_iou as jdx_box_iou
from darknet_tpu.train.yolo_loss import yolo_head_delta as jdelta
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.train.yolo_loss import dx_box_iou, yolo_head_delta

TOL = 1e-5
TOL_SUM = 1e-4
PX = 64
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
[yolo]
mask=0,1,2
anchors=6,8, 14,12, 20,26, 40,36, 60,50, 62,62
classes=4
num=6
ignore_thresh=.5
truth_thresh={truth_thresh}
max_delta={max_delta}
iou_loss={iou_loss}
scale_x_y={scale_x_y}
iou_thresh={iou_thresh}
iou_normalizer=0.07
cls_normalizer=1.0
{extra}
"""

CASES = {
    "mse": dict(iou_loss="mse"),
    "iou": dict(iou_loss="iou"),
    "giou": dict(iou_loss="giou"),
    "diou": dict(iou_loss="diou"),
    "ciou": dict(iou_loss="ciou", max_delta=5),
    "scale_x_y": dict(iou_loss="ciou", scale_x_y=1.1),
    "iou_thresh": dict(iou_loss="ciou", iou_thresh=0.2),
    "iou_thresh_kind": dict(iou_loss="diou", iou_thresh=0.2,
                            extra="iou_thresh_kind=giou"),
    "truth_thresh": dict(iou_loss="giou", truth_thresh=0.3),
    "label_smooth": dict(iou_loss="ciou", extra="label_smooth_eps=0.1"),
    "focal": dict(iou_loss="ciou", extra="focal_loss=1"),
    "multipliers": dict(iou_loss="ciou", extra="counters_per_class=10,"
                        "20,5,40"),
}


def head_layers(case):
    kw = dict(px=PX, filters=27, truth_thresh=1, max_delta="inf",
              iou_loss="mse", scale_x_y=1.0, iou_thresh=1.0, extra="")
    kw.update(CASES[case])
    if kw["max_delta"] == "inf":
        kw["max_delta"] = 3.4e38
    cfg = HEAD.format(**kw)
    lj = [l for l in jbuild(cfg, train=True).layers if l.kind == "yolo"][0]
    lt = [l for l in tbuild(cfg, train=True).layers if l.kind == "yolo"][0]
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
        # two truths of other sizes and classes in one cell of each head
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


def run_both(case, kind, seed=0):
    lj, lt = head_layers(case)
    rng = np.random.default_rng(seed + 100)
    g = PX // 8
    raw = (rng.standard_normal((3, g, g, 27)) * 1.5).astype(np.float32)
    y = truths_for(kind, seed=seed)
    dj, cj, mj = jdelta(jnp.asarray(raw), jnp.asarray(y), lj, PX, PX)
    dt, ct, mt = yolo_head_delta(torch.from_numpy(raw), torch.from_numpy(y),
                                 lt, PX, PX)
    return (np.asarray(dj), float(cj), {k: float(v) for k, v in mj.items()},
            dt.numpy(), float(ct), {k: float(v) for k, v in mt.items()})


def assert_same(dj, cj, mj, dt, ct, mt, skip=()):
    assert dt.shape == dj.shape
    scale = max(np.abs(dj).max(), 1e-6)
    assert np.abs(dt - dj).max() <= TOL * scale, np.abs(dt - dj).max()
    assert abs(ct - cj) <= TOL_SUM * max(abs(cj), 1.0), (ct, cj)
    assert set(mt) == set(mj)
    for k in set(mj) - set(skip):
        assert abs(mt[k] - mj[k]) <= TOL_SUM * max(abs(mj[k]), 1.0), (
            k, mt[k], mj[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_yolo_delta_matches_jax(case):
    assert_same(*run_both(case, "random", seed=len(case)))


@pytest.mark.parametrize("kind", ["empty", "bad_class", "same_cell"])
def test_yolo_delta_truth_edge_cases(kind):
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


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_dx_box_iou_matches_jax(kind):
    """DxIou's hand gradient, inverted and disjoint boxes included."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(0.05, 0.7, (200, 4)).astype(np.float32)
    truth = rng.uniform(0.05, 0.7, (200, 4)).astype(np.float32)
    pred[:20, 2] *= -1                        # inverted width
    pred[20:40, :2] += 1.5                    # disjoint
    want = jdx_box_iou(jnp.asarray(pred), jnp.asarray(truth), kind)
    got = dx_box_iou(torch.from_numpy(pred), torch.from_numpy(truth), kind)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= TOL * max(np.abs(b).max(), 1)
