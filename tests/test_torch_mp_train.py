"""Model-parallel training over processes (`darknet_tpu_torch/parallel/
{spatial,tensor,pipeline}.py`, `ops/train_epilogue.bn_act_train_parts`;
ROADMAP A7c item 4) on the CPU: one world of 4 gloo ranks
(`parallel/multihost.spawn`, the rank functions in tests/
torch_parallel_workers.py), each case on a grid over 2, 3 or 4 of them
(`parallel/mesh.world_mesh(ranks=)`): one f32 step of yolov4-tiny-128 on
sp=2, (dp=2, sp=2), tp=2, (dp=2, tp=2), (sp=2, tp=2) and 2- and 4-stage
pipelines, of yolov4-tiny-96 on sp=2 (a 3-row map: uneven slabs), of
the antialiased random cfg on a 3-stage pipeline (ROADMAP C5's cut), one
bf16/act16 step on (dp=2, sp=2), and `bn_act_train_parts` with 2 parts
a rank over a 2-rank group, in f32 and bf16.

Each case is held two ways:
* to the port's one-process mesh of the same shape, in the same rank:
  bitwise where the sums keep their order (the pipelines, whose stages
  run the one-process ops on the same micro-batches in the same order,
  and the sp=2, tp and (sp=2, tp=2) steps, where every sum over ranks
  has two terms; measured equal), else every param within 1e-5 of the
  largest update (the (dp=2, sp=2) step: the batch statistics sum 4
  ranks' parts over the group where one process sums them in part
  order; measured 6.1e-7), bf16 within 2e-2 of it (tests/
  test_torch_parallel_train.py's bound for a sum in another order that
  flips a bf16 rounding; measured 1.0e-2);
* to the JAX package's jitted step over a mesh of the same shape
  (`make_train_step` with `P("dp", "sp")` inputs, `make_tp_train_step`,
  `PipelineTrain`) at the tolerances of the one-process tests: cost rtol
  1e-5 and params rtol 1e-4 / atol 2e-4 (tests/test_torch_spatial_train.
  py, test_torch_tensor_train.py), the pipelines cost rtol 1e-4 / atol
  1e-5 and params rtol 2e-4 / atol 5e-5 (tests/test_torch_pipeline_train.
  py), the antialiased cfg against the JAX unsharded step (the JAX
  pipeline hands its cut the wrong tensor, ROADMAP C5); bf16 as tests/
  test_torch_parallel_train.py holds it (cost within 1%, the updates'
  cosine >= 0.99);
* the 3-stage pipeline with a generator (dropout in stages 1 and 2, a
  dropblock in stage 1; the generator's state crosses the cuts): bitwise
  the one-process pipeline, the generator left in the same state, and
  bitwise the port's unsharded step given the same seed (tests/
  test_torch_pipeline_train.py holds the pipelines to it bitwise); not
  to the JAX package, which draws its masks from its own keys;
* `bn_act_train_parts`: against one process holding all 4 parts, f32
  outputs and gradients within 1e-5 of each tensor's largest, bf16
  outputs within one bf16 ulp of the largest (2^-7), gradients within
  1e-5 (tests/test_torch_spatial_train.py's bounds: the parts' sums add
  in another order).

The batches are the one-process tests' quiet ones: seed 5 for
yolov4-tiny-128, seed 15 for accum 2 on (dp=2, sp=2) (tests/
test_torch_spatial_train.py's pair) and seed 10 for the 4-stage pipeline
(tests/test_torch_pipeline_train.py's).  Seed 5 at accum 2 on (dp=2,
sp=2) holds a near-tie (a leaky input or a maxpool window within f32
noise) that the 4 ranks' sum order tips: 1.6e-5 of the update against
the one-process mesh.  Seed 5 on 4 stages at 4 micro-batches takes one
the other way from the JAX package's pipeline (7.8e-5 at 2 of layer 0's
864 weights against an atol of 5e-5; the port's world and one-process
pipelines agree bitwise there too).  The JAX package's tp step over a
(dp=1, sp=2, tp=2) mesh moves the rolling means twice as far as its
unsharded step, and its step jitted with P("dp", "sp") inputs over that
mesh moves layer 0's "w" by 0.013 from it (the port's one-process and
world (sp=2, tp=2) steps are within 1.6e-5 of the port's unsharded
step, of an update of 0.21): so (sp=2, tp=2) is held to the JAX
package's unsharded jitted step, as the antialiased cfg is.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.parallel import pipeline as jpipe
from darknet_tpu.parallel import tensor as jtensor
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.parallel import multihost as tmulti
from tests.test_reference_fuzz import random_cfg
from test_torch_pipeline_train import drop_cfg
import torch_parallel_workers as workers

torch.set_num_threads(2)
SPAWN_S = 240
# name: (kind, mesh shape, model, bf16, accum, batch seed)
CASES = {
    "sp2": ("mesh", {"dp": 1, "sp": 2}, "tiny", False, 1, 5),
    "dp2sp2": ("mesh", {"dp": 2, "sp": 2}, "tiny", False, 2, 15),
    "tp2": ("mesh", {"dp": 1, "tp": 2}, "tiny", False, 1, 5),
    "dp2tp2": ("mesh", {"dp": 2, "tp": 2}, "tiny", False, 1, 5),
    "sp2tp2": ("mesh", {"sp": 2, "tp": 2}, "tiny", False, 1, 5),
    "pipe2": ("pipe", {"pp": 2}, "tiny", False, 2, 5),
    "pipe4": ("pipe", {"pp": 4}, "tiny", False, 2, 10),
    "sp2-tiny96": ("mesh", {"dp": 1, "sp": 2}, "tiny96", False, 1, 5),
    "pipe3-aa": ("pipe", {"pp": 3}, "aa", False, 2, 0),
    "dp2sp2-bf16": ("mesh", {"dp": 2, "sp": 2}, "tiny", True, 1, 5),
    "pipe3-drop": ("pipe", {"pp": 3}, "drop", False, 2, 6),
}
# cases that step with a generator of this seed
GEN_SEED = {"pipe3-drop": 3}
BITWISE = {"sp2", "sp2-tiny96", "tp2", "dp2tp2", "sp2tp2", "pipe2", "pipe4",
           "pipe3-aa", "pipe3-drop"}
MODELS = {"tiny": 128, "tiny96": 96, "aa": 64, "drop": 64}



def _cfg(model, accum):
    px = MODELS[model]
    if model == "aa":
        return random_cfg(294, 64).replace("batch=1", "batch=4").replace(
            "subdivisions=1", f"subdivisions={accum}")
    if model == "drop":
        return drop_cfg(accum)
    return model_zoo.yolov4_tiny_cfg(px, px, batch=4, subdiv=accum)


def _graphs(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg, train=True), jbuild(cfg, train=True)


def _cases(names):
    cases, half = [], 0
    for name, (kind, shape, model, bf16, accum, seed) in CASES.items():
        if name not in names:
            continue
        cfg = _cfg(model, accum)
        g, _jg = _graphs(cfg)
        px = MODELS[model]
        x = np.random.default_rng(seed).uniform(0, 1, (4, px, px, 3)).astype(
            np.float32)
        y = np.zeros((4, 8, 5), np.float32)
        y[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
        n = int(np.prod(list(shape.values())))
        ranks = list(range(n)) if n > 2 else [2 * half, 2 * half + 1]
        half = 1 - half if n == 2 else half
        cases.append({"name": name, "kind": kind, "shape": shape,
                      "ranks": ranks, "cfg": cfg, "bf16": bf16,
                      "accum": accum, "x": x, "y": y,
                      "gen": GEN_SEED.get(name),
                      "p0": tparams.init_params(g, seed=0)})
    rng = np.random.default_rng(7)
    for name, bf16 in (("bn-f32", False), ("bn-bf16", True)):
        if name not in names:
            continue
        cases.append({
            "name": name, "kind": "bn", "shape": {"dp": 2},
            "ranks": [0, 1] if not bf16 else [2, 3], "bf16": bf16,
            "parts": [rng.normal(0.3, 1.5, (2, r, 6, 8)).astype(np.float32)
                      for r in (3, 5, 4, 2)],
            "grads": [rng.normal(0, 1, (2, r, 6, 8)).astype(np.float32)
                      for r in (3, 5, 4, 2)],
            "scales": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "beta": rng.normal(0, 0.5, 8).astype(np.float32)})
    return cases


def run_world(tmp_path_factory, names):
    """The cases `names` run in one world of 4 ranks: ({name: case},
    {name: {rank: its saved results}})."""
    cases = _cases(names)
    out = str(tmp_path_factory.mktemp("mp_train"))
    tmulti.spawn(workers.mp_train_ranks, ["cpu"] * 4, out, cases,
                 timeout_s=SPAWN_S)
    res = {c["name"]: {r: dict(np.load(os.path.join(
        out, f"{c['name']}_{r}.npz"))) for r in c["ranks"]} for c in cases}
    return {c["name"]: c for c in cases}, res


# this file's cases; the tp steps and the bn parts are
# tests/test_torch_mp_train_tp.py's, the pipelines
# tests/test_torch_mp_train_pipe.py's (a world and its JAX steps a file,
# so that each file stays within about a minute and a half)
SPATIAL = ["sp2", "dp2sp2", "sp2-tiny96", "dp2sp2-bf16"]
TP = ["tp2", "dp2tp2", "sp2tp2"]
PIPE = ["pipe2", "pipe4", "pipe3-aa"]
GEN = ["pipe3-drop"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory, SPATIAL)


def _unflat(d, prefix, like):
    return [{k: d[f"{prefix}/{i}/{k}"] for k in p} for i, p in enumerate(like)]


def _gap(got, want, p0):
    err = max(float(np.abs(a[k] - w[k]).max())
              for a, w in zip(got, want) for k in w)
    scale = max(float(np.abs(w[k] - q[k]).max())
                for w, q in zip(want, p0) for k in w)
    return err, scale


def check_one_process(world, name):
    """Every rank's params, cost and metrics against the one-process mesh
    of the same shape (the module docstring); the ranks agree bitwise."""
    cases, res = world
    c = cases[name]
    first = None
    for r, d in res[name].items():
        got = _unflat(d, "got", c["p0"])
        want = _unflat(d, "want", c["p0"])
        if name in BITWISE:
            for a, w in zip(got, want):
                for k in w:
                    assert np.array_equal(a[k], w[k]), (r, k)
            assert float(d["cost"]) == float(d["wcost"])
            assert np.array_equal(d["met"], d["wmet"])
        else:
            err, scale = _gap(got, want, c["p0"])
            assert scale > 0 and err <= (2e-2 if c["bf16"] else 1e-5) * \
                scale, (err, scale)
            np.testing.assert_allclose(float(d["cost"]), float(d["wcost"]),
                                       rtol=1e-2 if c["bf16"] else 1e-6)
        if "gstate" in d:
            assert np.array_equal(d["gstate"], d["wgstate"]), r
        if first is None:
            first = got
        else:
            for a, w in zip(got, first):
                for k in w:
                    assert np.array_equal(a[k], w[k]), (r, k)


def _jax_step(c):
    """(params, cost) of the JAX package's jitted step over a mesh of the
    case's shape."""
    _g, jg = _graphs(c["cfg"])
    shape, accum, p0 = c["shape"], c["accum"], c["p0"]
    x, y, lr = c["x"], c["y"], jnp.float32(1e-3)
    key = jax.random.PRNGKey(0)
    if c["name"] in ("pipe3-aa", "sp2tp2"):
        p, o = jax.device_put(p0), jinit(jg, p0)
        p, _o, cost, _m = jstep(jg, donate=False, accum=accum)(
            p, o, jnp.asarray(x), jnp.asarray(y), key, lr)
    elif c["kind"] == "pipe":
        jpt = jpipe.PipelineTrain(jg, p0, jax.devices()[:shape["pp"]],
                                  microbatches=accum)
        cost, _m = jpt.step(x, y, key, 1e-3)
        p = jpt.gather_params()
    elif "tp" in shape and "sp" not in shape:
        mesh = Mesh(np.array(jax.devices()[:shape["dp"] * shape["tp"]])
                    .reshape(shape["dp"], shape["tp"]), ("dp", "tp"))
        step, place = jtensor.make_tp_train_step(jg, mesh)
        pm, om, xm, tm = place(p0, jinit(jg, p0), x, y)
        p, _o, cost, _m = step(pm, om, xm, tm, key, lr)
    else:
        dt = jnp.bfloat16 if c["bf16"] else None
        mesh = Mesh(np.array(jax.devices()[:shape["dp"] * shape["sp"]])
                    .reshape(shape["dp"], shape["sp"]), ("dp", "sp"))
        rep = NamedSharding(mesh, P())
        x_sh = NamedSharding(mesh, P("dp", "sp", None, None))
        t_sh = NamedSharding(mesh, P("dp"))
        jf = jax.jit(jstep(jg, jit=False, accum=accum, compute_dtype=dt,
                           train_act_dtype=dt),
                     in_shardings=(rep, rep, x_sh, t_sh, rep, rep),
                     out_shardings=(rep, rep, rep, rep))
        p, _o, cost, _m = jf(jax.device_put(p0, rep),
                             jax.device_put(jinit(jg, p0), rep),
                             jax.device_put(x, x_sh), jax.device_put(y, t_sh),
                             key, lr)
    return [{k: np.asarray(v) for k, v in d.items()} for d in p], float(cost)


def check_jax(world, name):
    """The case's step against the JAX package's (the module
    docstring)."""
    cases, res = world
    c = cases[name]
    d = res[name][c["ranks"][0]]
    got = _unflat(d, "got", c["p0"])
    want, jcost = _jax_step(c)
    if c["bf16"]:
        np.testing.assert_allclose(float(d["cost"]), jcost, rtol=1e-2)
        da = np.concatenate([(a[k] - q[k]).ravel() for a, q in
                             zip(got, c["p0"]) for k in q]).astype(np.float64)
        db = np.concatenate([(w[k] - q[k]).ravel() for w, q in
                             zip(want, c["p0"]) for k in q]).astype(np.float64)
        assert float(da @ db) / float(np.linalg.norm(da) *
                                      np.linalg.norm(db)) >= 0.99
        return
    pipe = c["kind"] == "pipe" and name != "pipe3-aa"
    np.testing.assert_allclose(float(d["cost"]), jcost,
                               rtol=1e-4 if pipe else 1e-5,
                               atol=1e-5 if pipe else 0)
    for i, (a, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(a[k], w[k],
                                       rtol=2e-4 if pipe else 1e-4,
                                       atol=5e-5 if pipe else 2e-4,
                                       err_msg=f"layer {i} {k}")


def check_bn_parts(world, name):
    """bn_act_train_parts over the group against one process holding
    every part (the module docstring)."""
    cases, res = world
    bf16 = cases[name]["bf16"]
    for r, d in res[name].items():
        for key in [k[len("got/"):] for k in d if k.startswith("got/")]:
            a, w = d[f"got/{key}"], d[f"want/{key}"]
            scale = float(np.abs(w).max())
            tol = 2.0 ** -7 if bf16 and key.startswith("out") else 1e-5
            assert float(np.abs(a - w).max()) <= tol * scale, (r, key)


@pytest.mark.parametrize("name", SPATIAL)
def test_equals_one_process_mesh(world, name):
    check_one_process(world, name)


@pytest.mark.parametrize("name", SPATIAL)
def test_matches_jax(world, name):
    check_jax(world, name)
