"""The port's darknet optimizers (`train/optimizer.py`) and LR schedule
(`train/schedule.get_lr`) against the JAX package's on the CPU.

Five updates of seeded params with seeded ascent directions, under the
update gates (dont_update, burnin_update, train_only_bn), clip=,
learning_rate= (the per-layer scale), and a NaN/inf in a weight and in a
gradient (the "w" scrub), for SGD + momentum and for Adam; every param
and every optimizer slot after each update is compared at 1e-6 of its
scale (the same f32 ops; Adam's bias correction is a pow computed by
numpy here and by XLA there).  `get_lr` must equal the JAX package's for
every policy, burn-in included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.train import optimizer as jopt
from darknet_tpu.train.schedule import get_lr as jget_lr
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train import optimizer as topt
from darknet_tpu_torch.train.schedule import get_lr

TOL = 1e-6
CFG = """[net]
batch=4
subdivisions=2
width=16
height=16
channels=3
learning_rate=0.01
momentum=0.9
decay=0.0005
burn_in=2
{adam}
[convolutional]
batch_normalize=1
filters=4
size=3
stride=1
pad=1
activation=leaky
{f0}
[convolutional]
batch_normalize=1
filters=6
size=3
stride=2
pad=1
activation=leaky
{f1}
[convolutional]
filters=16
size=1
activation=linear
{f2}
[yolo]
mask=0,1
num=2
classes=3
anchors=8,8, 16,16
"""
GATES = {
    "plain": ("", "", ""),
    "dont_update": ("dont_update=3", "", ""),
    "burnin_update": ("", "burnin_update=1", ""),
    "train_only_bn": ("", "train_only_bn=1", ""),
    "clip_and_scale": ("clip=0.05", "learning_rate=0.5", "clip=0.02"),
}
ADAM = "adam=1\nB1=0.9\nB2=0.999\neps=0.000001"


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    # a frozen layer keeps its NaN weight in both packages (the scrub runs
    # only when an update applies)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= TOL * scale, (
        np.abs(got - want).max(), scale)


def compare_tree(graph, jtree, ttree):
    tnp = tparams.train_params_to_numpy(graph, ttree)
    for jd, td in zip(jtree, tnp):
        assert set(jd) == set(td)
        for k in jd:
            close(td[k], jd[k])


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_update_matches_jax(gate, adam):
    f0, f1, f2 = GATES[gate]
    cfg = CFG.format(adam=ADAM if adam else "", f0=f0, f1=f1, f2=f2)
    jg, tg = jbuild(cfg, train=True), tbuild(cfg, train=True)
    net = jg.net
    rng = np.random.default_rng(len(gate) + 10 * adam)
    p0 = jparams.init_params(jg, seed=1)
    p0[0]["w"][0, 0, 0, 0] = np.nan            # scrubbed before the apply
    jp = [{k: jnp.asarray(v) for k, v in d.items()} for d in p0]
    tp = tparams.train_params_to_torch(tg, p0, "cpu")
    js = (jopt.init_adam_state(jp, graph=jg) if adam
          else jopt.init_sgd_state(jp))
    ts = (topt.init_adam_state(tp, graph=tg) if adam
          else topt.init_sgd_state(tp))
    for it in range(5):
        g_np = [{k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
                 for k, v in d.items() if k in ("w", "b", "scales")}
                for d in p0]
        if it == 1:
            g_np[2]["w"][0, 0, 0, 1] = np.inf
        jg_ = [{k: jnp.asarray(g.get(k, np.zeros_like(d[k])))
                for k in d} for g, d in zip(g_np, p0)]
        tg_ = tparams.numpy_to_train_layout(tg, g_np, "cpu")
        lr = 0.01 * (it + 1)
        if adam:
            jp, js = jopt.adam_update(jg, jp, jg_, js, lr=lr, B1=net.B1,
                                      B2=net.B2, eps=net.eps, decay=net.decay,
                                      batch=net.optimizer_batch)
            topt.adam_update(tg, tp, tg_, ts, lr=lr, B1=net.B1, B2=net.B2,
                             eps=net.eps, decay=net.decay,
                             batch=net.optimizer_batch)
            slots = ("m", "v", "u")
        else:
            jp, js = jopt.sgd_update(jg, jp, jg_, js, lr=lr,
                                     momentum=net.momentum, decay=net.decay,
                                     batch=net.optimizer_batch)
            topt.sgd_update(tg, tp, tg_, ts, lr=lr, momentum=net.momentum,
                            decay=net.decay, batch=net.optimizer_batch)
            slots = ("u",)
        assert int(js["t"]) == ts["t"] == it + 1
        compare_tree(tg, jp, tp)
        for slot in slots:
            compare_tree(tg, js[slot], ts[slot])
    if gate not in ("dont_update", "train_only_bn"):
        assert all(torch.isfinite(v).all() for d in tp for v in d.values())


POLICIES = [
    "policy=constant\nburn_in=100\npower=4",
    "policy=step\nstep=100\nscale=0.5",
    "policy=steps\nsteps=0.8,0.9\nscales=.1,.1\nmax_batches=1000",
    "policy=exp\ngamma=0.99",
    "policy=poly\npower=2",
    "policy=sigmoid\ngamma=0.1\nstep=50",
    "policy=sgdr\nsgdr_cycle=100\nsgdr_mult=2\nsteps=0.5\nscales=1",
    "policy=random\npower=2",
]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.split("\n")[0])
def test_get_lr_matches_jax(policy):
    text = ("[net]\nwidth=32\nheight=32\nchannels=3\nlearning_rate=0.1\n"
            "max_epoch=3\n" + policy + "\n[avgpool]\n")
    jnet, tnet = jbuild(text, train=True).net, tbuild(text, train=True).net
    jnet.max_iter = tnet.max_iter = 1000
    for it in (0, 1, 37, 99, 100, 101, 250, 499, 800, 901, 999, 1000):
        r = float(np.random.default_rng(it).uniform())
        assert get_lr(tnet, it, rand01=r) == jget_lr(jnet, it, rand01=r)
