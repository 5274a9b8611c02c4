"""Model-parallel serving over processes (`darknet_tpu_torch/parallel/
{mesh,spatial,tensor,pipeline}.py`, `nn/network.py`; ROADMAP A7c item 4)
on the CPU: one world of 4 gloo ranks (`parallel/multihost.spawn`, the
rank functions in tests/torch_parallel_workers.py), each case on a grid
over 2, 3 or 4 of its ranks (`parallel/mesh.world_mesh(ranks=)`): sp=2
and (dp=2, sp=2) through the Network, tp=2 and (dp=2, tp=2) through
`make_tp_forward`, and 2- and 4-stage `PipelineForward`s, in f32, bf16
and dynamic and calibrated int8; and 2- and 3-stage `PipelineForward`s
of a cfg with a weight-shared conv (share_index, whose owner's params
the borrower's stage holds) in f32.

Each case is held two ways:
* to the port's one-process mesh of the same shape, run in the same rank
  (the same threads): bitwise, heads and served triples (measured
  equal: every rank runs each layer's own op on the rows one device of
  the one-process mesh runs it on, the exchanges copy, and the sums keep
  their order);
* to the JAX package: f32 against its forward over a mesh of the same
  shape (`make_spatial_forward`, `make_tp_forward`, `PipelineForward`)
  at the tolerances of the one-process tests (decoded outputs rtol 2e-4
  / atol 2e-5, tests/test_torch_spatial.py and test_torch_tensor.py;
  pipeline heads rtol 1e-4 / atol 1e-5 of each head's largest,
  tests/test_torch_pipeline.py), the antialiased random cfg against its
  unsharded forward instead (the JAX pipeline hands that cut the wrong
  tensor, ROADMAP C5); bf16 against the JAX Network's bf16 heads within
  2e-2 of each head's largest (ROADMAP C3,
  tests/test_torch_rare_kinds.py); int8 against the JAX Network's int8
  heads within HEAD_ATOL and on average HEAD_MEAN_ATOL
  (tests/test_torch_int8.py: the chain of quantized convs amplifies
  sub-ulp differences), the calibrated scales loaded from the port's
  calibration file.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.emit import make_forward as jax_forward
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.parallel import pipeline as jpipe
from darknet_tpu.parallel import spatial as jspatial
from darknet_tpu.parallel import tensor as jtensor
from darknet_tpu.parallel.mesh import replicate as jreplicate
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.parallel import multihost as tmulti
from darknet_tpu_torch.parallel.spatial import _decode
from darknet_tpu_torch.weights import io as wio
from tests.test_reference_fuzz import random_cfg
from test_torch_pipeline import SHARE_CFG
from tests.torch_params import spread_params
import torch_parallel_workers as workers

torch.set_num_threads(2)
HEAD_ATOL, HEAD_MEAN_ATOL = 0.75, 0.04       # tests/test_torch_int8.py
BF16_SHARE = 2e-2                            # ROADMAP C3
SPAWN_S = 240
DTYPES = ("f32", "bf16", "int8", "int8cal")
MESHES = {                 # name: (kind, shape, micro-batches)
    "sp2": ("sp", {"dp": 1, "sp": 2}, None),
    "dp2sp2": ("sp", {"dp": 2, "sp": 2}, None),
    "tp2": ("tp", {"dp": 1, "tp": 2}, None),
    "dp2tp2": ("tp", {"dp": 2, "tp": 2}, None),
    "pipe2": ("pipe", {"pp": 2}, 2),
    "pipe4": ("pipe", {"pp": 4}, 4),
}


def _graph(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg)


def _frames(b, h, w=None, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, h, w or h, 3)).astype(np.float32)


def _model(tmp, name, cfg, px, spread=True):
    """(cfg, weights path, unfused numpy params, folded params): heads
    spread over O(1) (`spread_params`), or the plain init."""
    g = _graph(cfg)
    unfused = spread_params(g, _frames(2, px), 1.5) if spread else \
        tparams.init_params(g, seed=1)
    path = str(tmp / f"{name}.weights")
    wio.save_weights(g, unfused, path)
    return cfg, path, unfused, jparams.fuse_conv_batchnorm(g, unfused)


def _cases(tmp):
    tiny = _model(tmp, "tiny", model_zoo.yolov4_tiny_cfg(128, 128), 128)
    v4 = _model(tmp, "v4", model_zoo.yolov4_cfg(64, 64), 64)
    aa = _model(tmp, "aa", random_cfg(294, 64), 64, spread=False)
    share = _model(tmp, "share", SHARE_CFG, 64, spread=False)
    models = {"tiny": tiny, "v4": v4, "aa": aa, "share": share}
    x = {"tiny": _frames(4, 128, seed=2), "v4": _frames(4, 64, seed=3),
         "aa": _frames(4, 64, seed=4), "share": _frames(4, 64, seed=5)}
    calib = {k: _frames(1, v.shape[1], seed=8) for k, v in x.items()}
    plan = [(m, "tiny", d) for m in MESHES for d in DTYPES]
    plan += [("sp2", "v4", "f32"), ("pipe2", "v4", "f32"),
             ("pipe3", "aa", "f32"), ("pipe2", "share", "f32"),
             ("pipe3", "share", "f32")]
    cases, half = [], 0
    for mesh, model, dtype in plan:
        kind, shape, mb = MESHES.get(mesh, ("pipe", {"pp": 3}, 2))
        n = int(np.prod(list(shape.values())))
        # two-rank cases take the halves of the world in turn
        ranks = list(range(n)) if n > 2 else [2 * half, 2 * half + 1]
        half = 1 - half if n == 2 else half
        cfg, path = models[model][:2]
        cases.append({"name": f"{mesh}-{model}-{dtype}", "kind": kind,
                      "shape": shape, "mb": mb, "ranks": ranks, "cfg": cfg,
                      "weights": path, "dtype": dtype, "x": x[model],
                      "calib": calib[model], "model": model,
                      "triple": kind == "sp" and dtype == "f32"})
    return cases, models


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases, their models and each rank's saved results."""
    tmp = tmp_path_factory.mktemp("mp_serve")
    cases, models = _cases(tmp)
    out = str(tmp / "out")
    os.makedirs(out)
    tmulti.spawn(workers.mp_serve_ranks, ["cpu"] * 4, out, cases,
                 timeout_s=SPAWN_S)
    res = {}
    for c in cases:
        res[c["name"]] = {r: dict(np.load(os.path.join(
            out, f"{c['name']}_{r}.npz"))) for r in c["ranks"]}
    return {c["name"]: c for c in cases}, models, res, tmp


NAMES = [f"{m}-tiny-{d}" for m in MESHES for d in DTYPES] + \
    ["sp2-v4-f32", "pipe2-v4-f32", "pipe3-aa-f32", "pipe2-share-f32",
     "pipe3-share-f32"]


def _heads(d, key):
    return [d[f"{key}{k}"] for k in range(sum(1 for n in d
                                              if n.startswith(key)
                                              and n[len(key):].isdigit()))]


@pytest.mark.parametrize("name", NAMES)
def test_equals_one_process_mesh(world, name):
    """Every rank's heads (and the Network's served triple) bitwise those
    of the one-process mesh of the same shape; the pipeline's on stage
    0's rank alone, None on the others."""
    cases, _m, res, _t = world
    c = cases[name]
    for r, d in res[name].items():
        got, want = _heads(d, "got"), _heads(d, "want")
        if c["kind"] == "pipe" and r != c["ranks"][0]:
            assert got == want == []
            continue
        assert len(got) == len(want) > 0, (r, len(got))
        for a, b in zip(got, want):
            assert a.shape == b.shape and np.array_equal(a, b), (name, r)
        for k in range(3 if c["triple"] else 0):
            assert np.array_equal(d[f"tgot{k}"], d[f"twant{k}"]), (name, k)


@pytest.fixture(scope="module")
def jax_refs(world):
    """The JAX package's unsharded heads of each (model, dtype) but f32,
    from the same weights (int8 calibrated: the port's calibration
    file)."""
    cases, models, _res, tmp = world
    refs = {}
    for c in cases.values():
        key = (c["model"], c["dtype"])
        if c["dtype"] == "f32" or key in refs:
            continue
        cfg, path = models[c["model"]][:2]
        kw = {"bf16": dict(compute_dtype=jnp.bfloat16)}.get(
            c["dtype"], dict(int8=True))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jn = JaxNetwork.from_cfg(cfg, weights=path, **kw)
            if c["dtype"] == "int8cal":
                tn = Network.from_cfg(cfg, weights=path, device="cpu",
                                      int8=True)
                tn.calibrate_int8(list(c["calib"]))
                cal = str(tmp / f"{c['model']}.cache")
                tn.save_calibration(cal)
                jn.load_calibration(cal)
        refs[key] = [np.asarray(h, np.float32)
                     for h in jn.forward_heads(c["x"])[0]]
    return refs


def _jax_f32(c, g, npar):
    """The JAX package's f32 forward of the case over a mesh of its shape:
    decoded outputs (sp, tp) or heads (pipeline)."""
    x, shape = c["x"], c["shape"]
    if c["kind"] == "sp":
        jm = jspatial.make_spatial_mesh(shape["dp"], shape["sp"])
        return jspatial.make_spatial_forward(g, jm, fused_bn=True)(
            jreplicate(jm, npar), jspatial.shard_spatial(jm, x))
    if c["kind"] == "tp":
        jm = jtensor.make_tp_mesh(shape["dp"], shape["tp"])
        return jtensor.make_tp_forward(g, jm, fused_bn=True)(npar, x)
    if c["model"] == "aa":
        return jax_forward(g, fused_bn=True)(npar, x)["heads"]
    return jpipe.PipelineForward(g, npar, jax.devices()[:shape["pp"]],
                                 microbatches=c["mb"])(x)


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax(world, jax_refs, name):
    cases, models, res, _t = world
    c = cases[name]
    r = c["ranks"][0]
    d = res[name][r]
    got = _heads(d, "got")
    lo, hi = d["rows"]
    g = _graph(c["cfg"])
    if c["dtype"] == "f32":
        want = _jax_f32(c, g, models[c["model"]][3])
        if c["kind"] == "pipe":
            for a, b in zip(got, want):
                b = np.asarray(b)
                np.testing.assert_allclose(a, b, rtol=1e-4,
                                           atol=1e-5 * float(np.abs(b).max()))
            return
        dec = _decode([torch.from_numpy(h) for h in got], g)
        assert float(np.std(np.asarray(want[1]))) > 0.05
        for a, b in zip(dec, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b)[lo:hi],
                                       rtol=2e-4, atol=2e-5)
        return
    want = [h[lo:hi] for h in jax_refs[(c["model"], c["dtype"])]]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        if c["dtype"] == "bf16":
            share = float(np.abs(a - b).max()) / float(np.abs(b).max())
            assert share <= BF16_SHARE, share
        else:
            assert float(np.abs(a - b).max()) <= HEAD_ATOL
            assert float(np.abs(a - b).mean()) < HEAD_MEAN_ATOL
