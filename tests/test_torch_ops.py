"""darknet_tpu_torch ops and params against darknet_tpu's, on the CPU.

Inputs are drawn with numpy from a seed and go through both packages.
Tolerances: params are compared byte for byte; f32 elementwise ops at
rtol 1e-6 (one op, a few ulps of exp/tanh); convs at rtol 1e-5 (the two
libraries sum in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu import model_zoo
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as jparams
from darknet_tpu.ops import activations as jact
from darknet_tpu.ops import boxes as jboxes
from darknet_tpu.ops import conv as jconv
from darknet_tpu.ops import nms as jnms
from darknet_tpu.ops import pooling as jpool
from darknet_tpu.ops import shapes as jshapes
from darknet_tpu.ops import stem as jstem
from darknet_tpu.ops import yolo as jyolo
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops import activations as tact
from darknet_tpu_torch.ops import boxes as tboxes
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops import nms as tnms
from darknet_tpu_torch.ops import pooling as tpool
from darknet_tpu_torch.ops import shapes as tshapes
from darknet_tpu_torch.ops import stem as tstem
from darknet_tpu_torch.ops import yolo as tyolo
from darknet_tpu_torch.ops.fused_region import ELEMENTWISE_ACTS

torch.set_num_threads(2)

TINY = build_graph(model_zoo.yolov4_cfg(64, 64))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 7])
def test_init_and_fold_are_byte_identical(seed):
    a = jparams.init_params(TINY, seed=seed)
    b = tparams.init_params(TINY, seed=seed)
    fa = jparams.fuse_conv_batchnorm(TINY, a)
    fb = tparams.fuse_conv_batchnorm(TINY, b)
    for pa, pb in zip(a + fa, b + fb):
        assert pa.keys() == pb.keys()
        for k in pa:
            assert pa[k].dtype == pb[k].dtype
            assert pa[k].tobytes() == pb[k].tobytes(), k


def test_fold_uses_rolling_stats():
    rng = np.random.default_rng(3)
    p = tparams.init_params(TINY, seed=1)
    for d in p:
        if "scales" in d:
            for k in ("scales", "mean", "b"):
                d[k] = rng.normal(size=d[k].shape).astype(np.float32)
            d["var"] = rng.uniform(0.5, 2, d["var"].shape).astype(np.float32)
    fa = jparams.fuse_conv_batchnorm(TINY, p)
    fb = tparams.fuse_conv_batchnorm(TINY, p)
    for pa, pb in zip(fa, fb):
        for k in pa:
            assert pa[k].tobytes() == pb[k].tobytes()


def test_params_to_torch_layout():
    p = tparams.fuse_conv_batchnorm(TINY, tparams.init_params(TINY, seed=0))
    t = tparams.params_to_torch(TINY, p, "cpu")
    w = p[5]["w"]                                       # HWIO
    np.testing.assert_array_equal(t[5]["w"].permute(2, 3, 1, 0).numpy(), w)
    assert t[5]["b"].dtype == torch.float32
    # unfolded params keep their BN (make_forward(fused_bn=False)), f32
    raw = tparams.init_params(TINY, seed=0)
    u = tparams.params_to_torch(TINY, raw, "cpu", torch.bfloat16)
    for k in ("scales", "mean", "var"):
        assert u[5][k].dtype == torch.float32
        np.testing.assert_array_equal(u[5][k].numpy(), raw[5][k])


@pytest.mark.parametrize("act", sorted(set(tact.ACTIVATION_FNS)
                                       - {"normalize_channels",
                                          "normalize_channels_softmax",
                                          "normalize_channels_softmax_maxval"}))
def test_activation_matches(act):
    x = np.linspace(-30, 30, 601, dtype=np.float32)
    want = np.asarray(jact.apply_activation(jnp.asarray(x), act))
    got = tact.apply_activation(_t(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               err_msg=act)


def test_kernel_activation_set_is_covered():
    assert ELEMENTWISE_ACTS <= set(tact.ACTIVATION_FNS)
    assert "logistic" in ELEMENTWISE_ACTS
    # leaky's slope is darknet's 0.1, not torch's 0.01
    assert float(tact.leaky(torch.tensor(-1.0))) == pytest.approx(-0.1)


def test_channel_normalising_activations():
    x = np.random.default_rng(0).normal(size=(2, 3, 3, 8)).astype(
        np.float32)
    for act in ("normalize_channels", "normalize_channels_softmax",
                "normalize_channels_softmax_maxval"):
        np.testing.assert_allclose(
            tact.apply_activation(_t(x), act).numpy(),
            np.asarray(jact.apply_activation(jnp.asarray(x), act)),
            rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("stride,size,pad", [(1, 3, 1), (2, 3, 1),
                                             (1, 2, 1), (2, 1, 0)])
def test_conv_asymmetric_padding(stride, size, pad):
    rng = np.random.default_rng(stride * 10 + size)
    h, w, c, n = 9, 10, 5, 6
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    wt = rng.normal(size=(size, size, c, n)).astype(np.float32)
    out_h = (h + 2 * pad - size) // stride + 1
    out_w = (w + 2 * pad - size) // stride + 1
    padding = jconv.darknet_conv_padding(size, pad, 1, (h, w),
                                         (stride, stride), (out_h, out_w))
    assert padding == tconv.darknet_conv_padding(
        size, pad, 1, (h, w), (stride, stride), (out_h, out_w))
    want = np.asarray(jconv.conv2d_raw(jnp.asarray(x), jnp.asarray(wt),
                                       stride=(stride, stride),
                                       padding=padding))
    got = tconv.conv2d_raw(_t(x), _t(wt).permute(3, 2, 0, 1),
                           stride=(stride, stride), padding=padding)
    assert tuple(got.shape) == want.shape == (2, out_h, out_w, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", [108, 110, 112])
def test_spp_maxpools(layer):
    g = build_graph(model_zoo.yolov4_cfg(128, 128))
    l = g.layers[layer]
    assert l.kind == "maxpool" and l.stride_x == 1
    x = np.random.default_rng(layer).normal(
        size=(2, l.h, l.w, 8)).astype(np.float32)
    want = np.asarray(jpool.maxpool_block(jnp.asarray(x), l))
    got = tpool.maxpool_block(_t(x), l).numpy()
    np.testing.assert_array_equal(got, want)


def test_strided_maxpool():
    cfg = ("[net]\nwidth=13\nheight=13\nchannels=3\n"
           "[maxpool]\nsize=2\nstride=2\n")
    l = build_graph(cfg).layers[0]
    x = np.random.default_rng(2).normal(size=(1, 13, 13, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tpool.maxpool(_t(x), l).numpy(),
        np.asarray(jpool.maxpool(jnp.asarray(x), l)))


@pytest.mark.parametrize("c_in,c_from", [(8, 8), (8, 5), (5, 8)])
def test_shortcut_channel_prefix(c_in, c_from):
    rng = np.random.default_rng(c_in * 3 + c_from)
    a = rng.normal(size=(2, 4, 4, c_in)).astype(np.float32)
    b = rng.normal(size=(2, 4, 4, c_from)).astype(np.float32)
    for act in ("linear", "leaky"):
        np.testing.assert_allclose(
            tshapes.shortcut(_t(a), _t(b), act).numpy(),
            np.asarray(jshapes.shortcut(jnp.asarray(a), jnp.asarray(b),
                                        act)), rtol=1e-7)


def test_route_and_upsample():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(1, 4, 4, 6)).astype(np.float32)
    b = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    for groups, gid in ((1, 0), (2, 1)):
        np.testing.assert_array_equal(
            tshapes.route([_t(a), _t(b)], groups, gid).numpy(),
            np.asarray(jshapes.route([jnp.asarray(a), jnp.asarray(b)],
                                     groups, gid)))
    np.testing.assert_array_equal(
        tshapes.upsample(_t(a), 2, 0.5).numpy(),
        np.asarray(jshapes.upsample(jnp.asarray(a), 2, 0.5)))


def test_stem_packing():
    rng = np.random.default_rng(11)
    w0 = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tstem.pack_w0(_t(w0)).numpy(),
                                  np.asarray(jstem.pack_w0(w0)))
    np.testing.assert_array_equal(tstem.pack_w1(_t(w1)).numpy(),
                                  np.asarray(jstem.pack_w1(w1)))
    np.testing.assert_array_equal(tstem.space_to_depth(_t(x)).numpy(),
                                  np.asarray(jstem.space_to_depth(x)))
    assert tstem.stem_pattern(TINY) == jstem.stem_pattern(TINY)


def _boxes(rng, n):
    xy = rng.uniform(0.2, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def test_iou_diou():
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 64), _boxes(rng, 64)
    np.testing.assert_allclose(
        tboxes.iou(_t(a), _t(b)).numpy(),
        np.asarray(jboxes.iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(
        tboxes.diou(_t(a), _t(b), 0.6).numpy(),
        np.asarray(jboxes.diou(jnp.asarray(a), jnp.asarray(b), 0.6)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("order", ["reference", "native"])
def test_yolo_activate_decode(order):
    l = TINY.layers[139]
    assert l.kind == "yolo"
    x = np.random.default_rng(8).normal(
        size=(2, l.h, l.w, l.n * (5 + l.classes))).astype(np.float32)
    ja = jyolo.yolo_activate(jnp.asarray(x), l)
    ta = tyolo.yolo_activate(_t(x), l)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-7)
    want = jyolo.yolo_decode(ja, l, 64, 64, order=order)
    got = tyolo.yolo_decode(ta, l, 64, 64, order=order)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-7)
    bf = tyolo.yolo_decode(ta, l, 64, 64, order=order,
                           score_dtype=torch.bfloat16)
    assert bf[0].dtype == torch.float32 and bf[2].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["greedynms", "diounms"])
def test_nms_host_and_device(kind):
    rng = np.random.default_rng(9)
    n, c = 48, 3
    centers = rng.uniform(0.3, 0.7, (6, 2))
    boxes = np.concatenate(
        [centers[rng.integers(0, 6, n)] + rng.normal(0, 0.02, (n, 2)),
         rng.uniform(0.1, 0.2, (n, 2))], -1).astype(np.float32)
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32)
    probs[rng.uniform(size=(n, c)) < 0.3] = 0.0
    probs[5] = probs[9]                                   # ties
    want = jnms.nms_numpy(boxes, probs, 0.45, kind=kind, allow_native=False)
    got = tnms.nms_numpy(boxes, probs, 0.45, kind=kind)
    np.testing.assert_array_equal(got, want)
    jdev = np.asarray(jnms.nms_device(jnp.asarray(boxes), jnp.asarray(probs),
                                      0.45, kind=kind))
    tdev = tnms.nms_device(_t(boxes)[None], _t(probs)[None], 0.45,
                           kind=kind)[0].numpy()
    np.testing.assert_array_equal(tdev, jdev)
    np.testing.assert_array_equal(tdev > 0, want > 0)
