"""The port's spatial partitioning (`darknet_tpu_torch/parallel/spatial.py`)
and the Network's ("dp", "sp") serving mesh on the CPU, against the JAX
package's GSPMD-partitioned forward and against the port's own unsharded
forward; and dynamic int8 over a mesh (the scale of the whole batch).

The JAX side runs on tests/conftest.py's CPU devices; the port names the
CPU as many times (its kernels' plain versions).  Numpy makes every input
and the params (`tests/torch_params`), the same arrays for both.

Tolerances, each with its reason:
* against the JAX package: rtol 2e-4 / atol 2e-5, the tolerance of
  tests/test_spatial.py (the sharded forward against the unsharded one
  within one package; here two packages' sum orders as well);
* against the port's unsharded forward, f32: rtol 1e-5 / atol 1e-6.  A
  slab runs each layer's own op on fewer rows, which may sum in another
  order (oneDNN, like cuDNN, picks its algorithm by shape; measured 0 on
  these cfgs but for one ulp of yolov4-96's dp=2 blocks);
* bf16: within 2e-2 of each head's largest value, the bound of ROADMAP
  C3 (`tests/test_torch_rare_kinds.py::test_fuzz_cfg_serves_bf16_as_jax`):
  a bf16 sum that lands within f32 noise of a rounding boundary rounds
  one ulp the other way (tests/test_torch_bf16.py), and the chain carries
  it;
* dynamic int8: every conv's scale exactly; the heads within the int8
  slice's HEAD_ATOL / HEAD_MEAN_ATOL of tests/test_torch_int8.py (the
  chain of quantized convs amplifies sub-ulp differences; blocks of
  another size sum the float convs in another order);
* served triples: slots matched by box (`torch_params.match_slots`),
  boxes at rtol 1e-4 (exp of a logit times an anchor), scores at rtol
  1e-5 / atol 1e-6, the kept sets equal.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.emit import make_forward as jax_forward
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.parallel import spatial as jspatial
from darknet_tpu.parallel.mesh import replicate as jreplicate
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.ops import conv as convmod
from darknet_tpu_torch.ops import fused_region as fr
from darknet_tpu_torch.parallel import multihost as tmulti
from darknet_tpu_torch.parallel.mesh import make_mesh
from darknet_tpu_torch.parallel.spatial import (make_spatial_forward,
                                                make_spatial_mesh,
                                                shard_spatial, slab_rows)
from darknet_tpu_torch.weights import io as wio
from tests.test_reference_fuzz import random_cfg
from tests.torch_params import (chip_smoke, match_slots, matched,
                                spread_params)
import torch_parallel_workers as workers

torch.set_num_threads(2)
HEAD_ATOL, HEAD_MEAN_ATOL = 0.75, 0.04       # tests/test_torch_int8.py
SPAWN_S = 240


def _graph(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg)


def _frames(b, h, w=None, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, h, w or h, 3)).astype(np.float32)


def _params(g, seed=1):
    """Folded numpy params whose heads spread (`spread_params`)."""
    x = _frames(2, g.net.h, g.net.w, seed=seed)
    return jparams.fuse_conv_batchnorm(g, spread_params(g, x, 1.5))


def _unsharded(g, npar, x, dtype=None):
    tp = tparams.params_to_torch(g, npar, "cpu", dtype or torch.float32)
    with torch.inference_mode():
        return tp, make_forward(g, compute_dtype=dtype)(
            tp, torch.from_numpy(x))["heads"]


def _close(got, want, rtol, atol):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------ partition
def test_slab_rows_rule():
    assert slab_rows(19, 2) == [(0, 9), (9, 19)]
    assert slab_rows(19, 4) == [(0, 4), (4, 9), (9, 14), (14, 19)]
    assert slab_rows(3, 4) == [(0, 0), (0, 1), (1, 2), (2, 3)]
    assert slab_rows(608, 3) == [(0, 202), (202, 405), (405, 608)]
    m = make_spatial_mesh(2, 3, device="cpu")
    x = torch.arange(4 * 10 * 2 * 1.0).reshape(4, 10, 2, 1)
    parts = shard_spatial(m, x)
    assert [[p.shape[1] for p in b] for b in parts] == [[3, 3, 4]] * 2
    assert torch.equal(torch.cat(parts[1], 1), x[2:])


# ------------------------------------------------------ against the JAX
def test_spatial_matches_jax_yolov4_tiny():
    """(2, 4) mesh, yolov4-tiny-128 (grids 4 and 8: one row a device at
    sp=4), against the JAX package's make_spatial_forward."""
    g = _graph(model_zoo.yolov4_tiny_cfg(128, 128))
    npar = _params(g)
    x = _frames(2, 128)
    jm = jspatial.make_spatial_mesh(2, 4)
    jf = jspatial.make_spatial_forward(g, jm, fused_bn=True)
    want = jf(jreplicate(jm, npar), jspatial.shard_spatial(jm, x))
    f = make_spatial_forward(g, make_spatial_mesh(2, 4, device="cpu"))
    got = f(tparams.params_to_torch(g, npar, "cpu"), x)
    assert float(np.std(np.asarray(want[1]))) > 0.05
    _close(got, want, 2e-4, 2e-5)


@pytest.fixture(scope="module")
def yolov4_96():
    """yolov4-96 (maps of 48 down to 3 rows: sp=4 leaves a slab empty;
    SPP's 5/9/13 pools; the neck's back-references), its folded params,
    frames and the JAX package's unsharded heads."""
    g = _graph(model_zoo.yolov4_cfg(96, 96))
    npar = _params(g)
    x = _frames(2, 96, seed=3)
    want = jax_forward(g, fused_bn=True, fuse_regions=False)(
        npar, jnp.asarray(x))["heads"]
    return g, npar, x, [np.asarray(h) for h in want]


@pytest.mark.parametrize("n_sp", [2, 3, 4])
def test_spatial_yolov4_96_matches_jax(yolov4_96, n_sp):
    g, npar, x, want = yolov4_96
    f = make_spatial_forward(g, make_spatial_mesh(1, n_sp, device="cpu"),
                             decode=False)
    got = f(tparams.params_to_torch(g, npar, "cpu"), x)
    _close(got, want, 2e-4, 2e-5)


# ----------------------------------------------- against the port itself
CASES = [("yolov4", 160, 1, 3),      # s2d slab edges at odd pixel rows
         ("yolov4", 96, 2, 4),       # an empty slab at 3 rows
         ("yolov4-tiny", 128, 2, 4),
         ("yolov3", 96, 1, 4),
         ("yolov3-tiny", 64, 2, 2)]


@pytest.fixture(scope="module")
def yolov4_160():
    g = _graph(model_zoo.yolov4_cfg(160, 160))
    return g, _params(g)


@pytest.mark.parametrize("name,px,n_dp,n_sp", CASES)
def test_spatial_equals_unsharded(name, px, n_dp, n_sp, yolov4_160):
    if (name, px) == ("yolov4", 160):
        g, npar = yolov4_160
    else:
        g = _graph(model_zoo.MODELS[name](px, px))
        npar = _params(g)
    x = _frames(2 * n_dp, px, seed=5)
    tp, want = _unsharded(g, npar, x)
    f = make_spatial_forward(g, make_spatial_mesh(n_dp, n_sp, device="cpu"),
                             decode=False)
    _close(f(tp, torch.from_numpy(x)), want, 1e-5, 1e-6)


@pytest.mark.parametrize("n_sp", [2, 3, 4])
def test_region_prefix_on_extended_slabs(n_sp, yolov4_160):
    """yolov4-160's stem region: the kernel prefix's plain version on each
    slab extended by the plan's halo (rt, rb s2d rows) gives exactly the
    unsharded prefix's rows of that slab."""
    g, npar = yolov4_160
    tp = tparams.params_to_torch(g, npar, "cpu")
    fwd = make_forward(g)
    (run,) = fwd.runners.values()
    sub = run.prefix
    assert sub.stem and (sub.rt, sub.rb) == (3, 2) and sub.h == 80
    x = torch.from_numpy(_frames(2, 160, seed=7))
    whole = fr.region_plain(sub, x, *[w[:len(sub.conv_steps)]
                                      for w in fr.step_weights(
                                          sub.steps, tp, torch.float32)])
    torch.testing.assert_close(run.run_prefix(tp, x, sub.h), whole,
                               rtol=0, atol=0)
    for lo, hi in slab_rows(sub.h, n_sp):
        e_lo, e_hi = max(0, lo - sub.rt), min(sub.h, hi + sub.rb)
        y = run.run_prefix(tp, x[:, 2 * e_lo:2 * e_hi], e_hi - e_lo)
        torch.testing.assert_close(y[:, lo - e_lo:hi - e_lo],
                                   whole[:, lo:hi], rtol=1e-5, atol=1e-6)


# seeds of the JAX package's fuzz generator: 12 (an antialiased maxpool
# read back by [scale_channels] under an [avgpool] gate, [reorg3d],
# upsample), 9 (maxpool_depth, reverse upsample, [avgpool]), 26
# ([shortcut]), 7 (the legacy [reorg], grouped convs), 4 and 8
# (antialiased convs, dilation)
FUZZ = [12, 9, 26, 7, 4, 8]


@pytest.mark.parametrize("seed", FUZZ)
@pytest.mark.parametrize("size,width", [(64, None), (48, 64)])
def test_fuzz_cfg_spatial_equals_unsharded(seed, size, width):
    g = _graph(random_cfg(seed, size=size, width=width))
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=seed))
    x = _frames(2, size, width, seed=seed)
    tp, want = _unsharded(g, npar, x)
    for n_sp in (2, 3, 4):
        f = make_spatial_forward(g, make_spatial_mesh(1, n_sp,
                                                      device="cpu"),
                                 decode=False)
        _close(f(tp, torch.from_numpy(x)), want, 1e-5, 1e-6)


def test_v1_rare_kinds_spatial_equals_unsharded():
    """chip_smoke.py's narrow YOLOv1 ([local], [connected], [dropout], the
    [detection] flatten: the whole map gathered first) and its rare-kinds
    cfg (the legacy [reorg], [reorg3d] both ways, [avgpool] gates)."""
    cs = chip_smoke()
    for cfg in (cs.NARROW_V1_CFG, cs.RARE_KINDS_CFG):
        g = _graph(cfg)
        npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=3))
        x = _frames(2, g.net.h, g.net.w, seed=3)
        tp, want = _unsharded(g, npar, x)
        for n_sp in (2, 3, 4):
            f = make_spatial_forward(g, make_spatial_mesh(1, n_sp,
                                                          device="cpu"),
                                     decode=False)
            _close(f(tp, torch.from_numpy(x)), want, 1e-5, 1e-6)


def test_spatial_bf16_within_c3():
    g = _graph(model_zoo.yolov4_cfg(96, 96))
    npar = _params(g)
    x = _frames(2, 96, seed=4)
    tp, want = _unsharded(g, npar, x, torch.bfloat16)
    f = make_spatial_forward(g, make_spatial_mesh(1, 3, device="cpu"),
                             compute_dtype=torch.bfloat16, decode=False)
    for a, b in zip(f(tp, torch.from_numpy(x)), want):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


# ------------------------------------------------------- the Network's sp
@pytest.fixture(scope="module")
def tiny_nets(tmp_path_factory):
    """(port Network, JAX Network) of yolov3-tiny-64 from one weights
    file."""
    cfg = model_zoo.MODELS["yolov3-tiny"](64, 64, classes=4)
    g = _graph(cfg)
    path = str(tmp_path_factory.mktemp("sp") / "w.weights")
    wio.save_weights(g, spread_params(g, _frames(2, 64), 1.5), path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (Network.from_cfg(cfg, weights=path, device="cpu"),
                JaxNetwork.from_cfg(cfg, weights=path))


def _same_triple(got, want, kept_only=False):
    got = [t.float().numpy() for t in got]
    want = [np.asarray(t, np.float32) for t in want]
    slot = match_slots(got[0], want[0])
    tb, ov, probs = matched(want, slot)
    np.testing.assert_allclose(got[0], tb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], ov, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], probs, rtol=1e-5, atol=1e-6)
    assert ((got[2] > 0) == (probs > 0)).all() and (got[2] > 0).sum() > 0


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_network_sp_mesh_matches_jax_and_unsharded(tiny_nets, dtype):
    tnet, jnet = tiny_nets
    x = _frames(4, 64, seed=2)
    if dtype == "uint8":
        x = (x * 255).astype(np.uint8)
    mesh = make_spatial_mesh(2, 2, device="cpu")
    jm = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    got = tnet.submit_detect_device(x, thresh=0.1, mesh=mesh)
    _same_triple(got, jnet.submit_detect_device(x, thresh=0.1, mesh=jm))
    _same_triple(got, tnet.submit_detect_device(x, thresh=0.1))
    dets = tnet.detect_batch_device(x, thresh=0.1, mesh=mesh)
    assert [len(d) for d in dets] == \
        [len(d) for d in tnet.detect_batch_device(x, thresh=0.1)]
    host = tnet.detect_batch(x, thresh=0.1, mesh=mesh)
    want = tnet.detect_batch(x, thresh=0.1)
    assert [len(d) for d in host] == [len(d) for d in want]
    for gi, wi in zip(host, want):
        for a, b in zip(gi, wi):
            np.testing.assert_allclose(a.bbox, b.bbox, rtol=1e-5)
            np.testing.assert_allclose(a.prob, b.prob, rtol=1e-5, atol=1e-7)


def test_network_sp_mesh_yolov4_region(yolov4_64):
    """yolov4-64 on {"dp": 2, "sp": 2}: the stem region's prefix runs once
    a slab; the triple equals the unsharded one; another axis is
    ignored (a "tp" axis of 2 leaves each block on its first device)."""
    cfg, path, _net, x = yolov4_64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, weights=path, device="cpu")
    calls = []
    (run,) = net._fwd.runners.values()
    orig = run.run_prefix
    run.run_prefix = lambda *a: calls.append(a[1].shape) or orig(*a)
    want = net.submit_detect_device(x, thresh=0.1)
    _same_triple(net.submit_detect_device(
        x, thresh=0.1, mesh=make_spatial_mesh(2, 2, device="cpu")), want)
    # each slab of 16 s2d rows with its halo: rows [0, 18) and [13, 32)
    assert [tuple(s) for s in calls] == [(2, 36, 64, 3), (2, 38, 64, 3)] * 2
    from darknet_tpu_torch.parallel.mesh import grid_mesh
    other = grid_mesh({"dp": 2, "tp": 2}, device="cpu")
    _same_triple(net.submit_detect_device(x, thresh=0.1, mesh=other), want)


# ------------------------------------------------- dynamic int8 on a mesh
@pytest.fixture(scope="module")
def yolov4_64(tmp_path_factory):
    """yolov4-64 on weights whose heads spread, a batch of 4 whose frame
    0 is at a quarter of the range (the blocks' maxima differ), and the
    dynamic int8 network on those weights."""
    cfg = model_zoo.yolov4_cfg(64, 64)
    g = _graph(cfg)
    x = _frames(4, 64, seed=8)
    x[0] *= 0.25
    path = str(tmp_path_factory.mktemp("v4") / "w.weights")
    wio.save_weights(g, spread_params(g, x, 1.5), path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, weights=path, device="cpu", int8=True)
    return cfg, path, net, x


class _Scales:
    """Inside the block, every int8 conv's input block and the scale it
    quantized with, by conv (its int8 weights)."""

    def __enter__(self):
        self.orig, self.calls = convmod.conv2d_int8, {}

        def spy(x, p, **kw):
            scale = p["x_scale"] if "x_scale" in p else \
                convmod.input_scale(x.float())
            self.calls.setdefault(p["w_q"].data_ptr(), []).append(
                (x.float().abs().amax(), torch.as_tensor(scale).reshape(())))
            return self.orig(x, p, **kw)

        convmod.conv2d_int8 = spy
        return self

    def __exit__(self, *exc):
        convmod.conv2d_int8 = self.orig

    def whole_batch(self):
        """Per conv, whether every block's scale is max|x| of the whole
        batch's input to the conv over 127, exactly."""
        out = []
        for calls in self.calls.values():
            m = torch.clamp_min(torch.stack([c[0] for c in calls]).amax(),
                                1e-8)
            want = convmod.input_scale(m, absmax=m)
            out.append(all(torch.equal(c[1], want) for c in calls))
        return out


@pytest.mark.parametrize("n", [2, 4])
def test_dynamic_int8_mesh_takes_the_batch_scale(yolov4_64, n):
    """R1 (ROADMAP C4): on a dp mesh, dynamic int8 quantizes every conv
    with max|x| over the whole batch, as the JAX package's GSPMD program
    does.  On the parent tree each block took its own maximum: frame 0
    at a quarter of the range gave block 0 a smaller scale at the first
    int8 convs, so these equalities failed there for at least one conv."""
    _cfg, _path, net, x = yolov4_64
    with _Scales() as rec:
        want = net.forward_heads(x)[0]
    assert len(rec.calls) == 90 and all(rec.whole_batch())
    mesh = make_mesh(n, device="cpu")
    with _Scales() as rec:
        got = net._over_mesh(mesh, torch.from_numpy(x),
                             lambda p, u, xs, heads: tuple(heads))
    assert len(rec.calls) == 90
    assert all(len(c) == n for c in rec.calls.values())
    assert all(rec.whole_batch())
    err = [np.abs(a.float().numpy() - b) for a, b in zip(got, want)]
    assert max(float(e.max()) for e in err) <= HEAD_ATOL
    assert max(float(e.mean()) for e in err) <= HEAD_MEAN_ATOL


def test_dynamic_int8_over_two_ranks(yolov4_64, tmp_path):
    """R1 over two gloo ranks: each conv's scale is the group's maximum
    (`ops/collective.group_max`), equal on both ranks, the heads within
    the int8 tolerance of the unsharded network's."""
    cfg, path, net, x = yolov4_64
    want = net.forward_heads(x)[0]
    tmulti.spawn(workers.int8_mesh_ranks, ["cpu", "cpu"], str(tmp_path),
                 cfg, path, x, timeout_s=SPAWN_S)
    r0, r1 = (np.load(os.path.join(tmp_path, f"int8_{r}.npz"))
              for r in range(2))
    assert r0["scales"].shape == (90,) and r0["ok"].all()
    np.testing.assert_array_equal(r0["scales"], r1["scales"])
    for k, w in enumerate(want):
        e = np.abs(r0[f"head{k}"] - w)
        assert e.max() <= HEAD_ATOL and e.mean() <= HEAD_MEAN_ATOL
