"""Training options of the port's `train/step.make_train_step` against
the JAX package's on the CPU, one f32 step (accum 2) of chip_smoke.py's
narrow CSP + SPP graph each: remat, stopbackward, onlyforward,
train_only_bn and Adam."""

import numpy as np
import pytest
import torch

from darknet_tpu.nn import params as jparams
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from test_torch_train_step import (CS, STATS, TRAINABLE, batch, graphs,
                                   run_jax, worst)


def _with_flag(cfg, section_no, flag):
    """cfg with `flag` added to its section_no-th layer section."""
    parts = cfg.split("\n[")
    parts[section_no] += "\n" + flag
    return "\n[".join(parts)


@pytest.mark.parametrize("option", ["remat", "stopbackward", "onlyforward",
                                    "train_only_bn", "adam"])
def test_step_options_match_jax(option):
    """One step of the narrow graph with a training option, f32, accum 2:
    remat (each conv block recomputed in the backward), stopbackward and
    onlyforward on the strided conv (nothing below it learns),
    train_only_bn there (frozen, its rolling statistics move), and Adam;
    updates and statistics within 1e-4 of the largest change (Adam's
    updates within 1e-2)."""
    cfg = CS.TRAIN_CSP_CFG
    if option in ("stopbackward", "onlyforward", "train_only_bn"):
        cfg = _with_flag(cfg, 2, f"{option}=1")
    if option == "adam":
        cfg = cfg.replace("burn_in=0", "burn_in=0\nadam=1")
    jg, tg = graphs(cfg)
    p0 = jparams.init_params(jg, seed=0)
    x, y = batch(jg, 4, seed=7)
    remat = option == "remat"
    jstep_ = jstep(jg, donate=False, accum=2, remat=remat)
    js, jc = run_jax(jg, p0, x, y, 2, 1, step=jstep_)
    step = make_train_step(tg, accum=2, remat=remat)
    p = tparams.train_params_to_torch(tg, p0, "cpu")
    o = init_opt_state(tg, p)
    p, o, c, _m = step(p, o, torch.from_numpy(x), torch.from_numpy(y),
                       tg.net.lr)
    ts = tparams.train_params_to_numpy(tg, p)
    assert abs(float(c) - jc[0]) <= 1e-5 * abs(jc[0])
    # Adam moves every element by about lr * m / sqrt(v), so a gradient
    # within sum-order noise of zero moves by a visible share of lr:
    # measured 1.5e-3 of the largest update
    tol = 1e-2 if option == "adam" else 1e-4
    for keys in (TRAINABLE, STATS):
        err, scale = worst(js[0], ts, p0, keys)
        assert scale > 0 and err <= tol * scale, (keys, err, scale)
    if option in ("stopbackward", "onlyforward", "train_only_bn"):
        # layers 0-1: no gradient reaches them; under train_only_bn they
        # do not move, under the stop flags only the weight decay does
        net = tg.net
        for d, d0 in zip(ts[:2], p0[:2]):
            if option == "train_only_bn":
                np.testing.assert_array_equal(d["w"], d0["w"])
            else:
                np.testing.assert_allclose(
                    d["w"], d0["w"] * (1 - net.lr * net.decay), rtol=1e-6,
                    atol=1e-9)
