"""The port's `train/step.make_train_step` against the JAX package's on
the CPU, f32, accum 1 and 2, burn_in 0 (so the first steps move the
weights): parameters, updates (after - before) and BN rolling statistics
after 1 and 5 steps on the narrow CSP + SPP graph of chip_smoke.py
(TRAIN_CSP_CFG); updates, momentum buffers and rolling statistics at
each of five steps on yolov4 at 64 px; and one bf16 step (act16) held
loosely to JAX's bf16 step.

Tolerances:
* narrow CSP: after one step every update and every rolling statistic
  within 1e-4 of the largest update (resp. statistic change) of the run
  (measured 1e-6); after five, within 2e-3 or within the yardstick below
  (measured up to 3e-3: a discrete decision of the loss can flip on
  sum-order noise).
* yolov4-64: the full graph is chaotic in training at init.  An input
  changed by 1e-7 (relative) moves the raw heads by ~2e-4 and the
  gradients by 3-4% of the largest update after one step (at 128 px
  too, so the depth of ~110 BN layers does it, not the 2x2 grid); run
  freely for five steps the same change moves the updates by ~50%, so a
  free-running comparison would bound nothing.  Each of the five steps is
  therefore taken by the port from the JAX package's own state before it
  (params, momentum and the iteration counter) and held to JAX's step
  from that state: updates, momentum buffers and rolling statistics
  within YARDSTICK_V4 times the yardstick measured from that state (the
  same step on the changed input) plus 1e-4 of the scale, and never more
  than CAP of the scale, so the bound binds at every step.  Measured: the
  yardstick is 4-7% of the scale at step 1 and 1e-5 to 3e-2 after, and
  the port's error up to 6.6 times the yardstick (one yardstick is one
  draw of the noise).  Costs within 1e-4.
* bf16: the loss within 1% and the updates' cosine similarity >= 0.99.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from torch_params import chip_smoke

CS = chip_smoke()
batch = CS.train_batch        # seeded uniform pixels, three boxes an image
worst = CS.update_gap         # (max |a - b|, the largest change from p0)

TRAINABLE = ("w", "b", "scales")
STATS = ("mean", "var")
TOL_CSP = 2e-3
YARDSTICK = 3.0
YARDSTICK_V4 = 10.0
CAP = 0.3


def run_jax(graph, p0, x, y, accum, steps, dtype=None, step=None):
    """numpy params after each step, and the costs (`step`: a jitted
    step of these shapes to reuse)."""
    step = step or jax_step(graph, accum, dtype)
    p = jax.device_put(p0)
    o = jinit(graph, p)
    snaps, costs = [], []
    for _ in range(steps):
        p, o, c, _m = step(p, o, jnp.asarray(x), jnp.asarray(y), None,
                           jnp.float32(graph.net.lr))
        snaps.append([{k: np.asarray(v) for k, v in d.items()} for d in p])
        costs.append(float(c))
    return snaps, costs


def jax_step(graph, accum, dtype=None):
    return jstep(graph, donate=False, accum=accum, compute_dtype=dtype,
                 train_act_dtype=dtype)


def run_port(graph, p0, x, y, accum, steps, dtype=None):
    step = make_train_step(graph, accum=accum, compute_dtype=dtype,
                           train_act_dtype=dtype)
    p = tparams.train_params_to_torch(graph, p0, "cpu")
    o = init_opt_state(graph, p)
    snaps, costs = [], []
    for _ in range(steps):
        p, o, c, _m = step(p, o, torch.from_numpy(x), torch.from_numpy(y),
                           graph.net.lr)
        snaps.append(tparams.train_params_to_numpy(graph, p))
        costs.append(float(c))
    return snaps, costs


def perturbed(x):
    """x with a relative 1e-7 change: the yardstick's input."""
    noise = np.random.default_rng(99).standard_normal(x.shape)
    return (x * (1 + 1e-7 * noise)).astype(np.float32)


def graphs(cfg):
    cfg = cfg.replace("burn_in=1000", "burn_in=0")
    return jbuild(cfg, train=True), tbuild(cfg, train=True)


@pytest.mark.parametrize("accum", [1, 2])
def test_narrow_csp_matches_jax(accum):
    jg, tg = graphs(CS.TRAIN_CSP_CFG)
    p0 = jparams.init_params(jg, seed=0)
    x, y = batch(jg, 4, seed=accum)
    step = jax_step(jg, accum)
    js, jc = run_jax(jg, p0, x, y, accum, 5, step=step)
    je, _ = run_jax(jg, p0, perturbed(x), y, accum, 5, step=step)
    ts, tc = run_port(tg, p0, x, y, accum, 5)
    for keys in (TRAINABLE, STATS):
        err, scale = worst(js[0], ts[0], p0, keys)
        assert scale > 1e-3 and err <= 1e-4 * scale, (keys, err, scale)
        yard, _ = worst(js[4], je[4], p0, keys)
        err, scale = worst(js[4], ts[4], p0, keys)
        assert err <= max(TOL_CSP * scale, YARDSTICK * yard), (
            keys, err, yard, scale)
    assert abs(tc[0] - jc[0]) <= 1e-5 * abs(jc[0])


def to_numpy(tree):
    return [{k: np.asarray(v) for k, v in d.items()} for d in tree]


def gap(a, b, ref):
    """(max |a - b|, max |a - ref|) over every array of the lists."""
    err = scale = 0.0
    for da, db, dr in zip(a, b, ref):
        for k in da:
            err = max(err, float(np.abs(da[k] - db[k]).max()))
            scale = max(scale, float(np.abs(da[k] - dr[k]).max()))
    return err, scale


@pytest.mark.parametrize("accum", [1, 2])
def test_yolov4_64_matches_jax(accum):
    jg, tg = graphs(model_zoo.yolov4_cfg(64, 64))
    p0 = jparams.init_params(jg, seed=0)
    x, y = batch(jg, 4, seed=10 + accum)
    xj, xe, yj = jnp.asarray(x), jnp.asarray(perturbed(x)), jnp.asarray(y)
    lr = jnp.float32(jg.net.lr)
    step = jax_step(jg, accum)
    port = make_train_step(tg, accum=accum)
    p = jax.device_put(p0)
    o = jinit(jg, p)
    rows = []
    for n in range(1, 6):
        before, u_before = to_numpy(p), to_numpy(o["u"])
        pj, oj, cj, _m = step(p, o, xj, yj, None, lr)
        pe, oe, _c, _m = step(p, o, xe, yj, None, lr)
        pt = tparams.train_params_to_torch(tg, before, "cpu")
        ot = {"t": int(o["t"]),
              "u": tparams.numpy_to_train_layout(tg, u_before, "cpu")}
        pt, ot, ct, _m = port(pt, ot, torch.from_numpy(x),
                              torch.from_numpy(y), jg.net.lr)
        assert ot["t"] == int(oj["t"]) == n
        assert abs(float(ct) - float(cj)) <= 1e-4 * abs(float(cj))
        got = {"params": tparams.train_params_to_numpy(tg, pt),
               "momentum": tparams.train_params_to_numpy(tg, ot["u"])}
        for name, want, moved, ref in (
                ("params", pj, pe, before), ("momentum", oj["u"], oe["u"],
                                             u_before)):
            want, moved = to_numpy(want), to_numpy(moved)
            for keys in ((TRAINABLE, STATS) if name == "params"
                         else (TRAINABLE,)):
                pick = lambda tree: [{k: v for k, v in d.items() if k in keys}
                                     for d in tree]
                yard, scale = gap(pick(want), pick(moved), pick(ref))
                err, _ = gap(pick(want), pick(got[name]), pick(ref))
                rows.append((n, name, keys[0], err, yard, scale))
        assert all(np.isfinite(v).all() for d in got["params"]
                   for v in d.values())
        p, o = pj, oj
    for n, name, key, err, yard, scale in rows:
        assert scale > 0 and err <= min(YARDSTICK_V4 * yard + 1e-4 * scale,
                                        CAP * scale), (
            (n, name, key, err / scale, yard / scale), rows)


def test_bf16_step_close_to_jax():
    """One act16 step (bf16 convs, bf16 interlayer tensors and y_hat,
    accum 2) against JAX's: loss within 1%, updates' cosine >= 0.99."""
    jg, tg = graphs(CS.TRAIN_CSP_CFG)
    p0 = jparams.init_params(jg, seed=0)
    x, y = batch(jg, 4, seed=5)
    js, jc = run_jax(jg, p0, x, y, 2, 1, jnp.bfloat16)
    ts, tc = run_port(tg, p0, x, y, 2, 1, torch.bfloat16)
    assert abs(tc[0] - jc[0]) <= 0.01 * abs(jc[0]), (tc, jc)
    ua, ub = [], []
    for da, db, d0 in zip(js[0], ts[0], p0):
        for k in sorted(d0):
            if k in TRAINABLE:
                ua.append((da[k] - d0[k]).ravel())
                ub.append((db[k] - d0[k]).ravel())
    ua, ub = np.concatenate(ua), np.concatenate(ub)
    cos = ua @ ub / (np.linalg.norm(ua) * np.linalg.norm(ub))
    assert np.isfinite(ub).all() and cos >= 0.99, cos

