"""The port's training ops against the JAX package on the CPU: the BN +
activation epilogue (`ops/train_epilogue.bn_act_train`, forward, VJP and
Bessel's variance), autograd of the activations against `jax.vjp`, the
training maxpool on tied inputs, the training conv block, and the IoU
family of `ops/boxes`.

Tolerances: f32 results agree to 1e-5 of their scale (sum-order noise);
bf16 results to 2e-2 of their scale (a few bf16 ulps: JAX rounds at
every op, torch at the end of each); the maxpool is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.ops import activations as jact
from darknet_tpu.ops import boxes as jboxes
from darknet_tpu.ops.conv import conv_block as jconv_block
from darknet_tpu.ops.pooling import maxpool as jmaxpool
from darknet_tpu.ops.train_epilogue import bn_act_train as jbn_act_train
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.ops import activations as tact
from darknet_tpu_torch.ops import boxes as tboxes
from darknet_tpu_torch.ops.conv import batch_mean_var, conv_block
from darknet_tpu_torch.ops.pooling import maxpool as tmaxpool
from darknet_tpu_torch.ops.train_epilogue import bn_act_train

ACTS = ("mish", "leaky", "linear", "logistic")
TOL_F32 = 1e-5
TOL_BF16 = 2e-2


def close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def f32(t):
    return np.asarray(t.detach().float().numpy() if torch.is_tensor(t)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("act", ACTS)
def test_activation_vjp_matches_jax(act):
    """Autograd of the port's activations against jax.vjp of the JAX
    forms, the closed-form mish's +-20 tails included."""
    x = np.concatenate([np.linspace(-30, 30, 241), [-20.0, 20.0, -20.01,
                                                   20.01, -19.99, 19.99,
                                                   0.0]]).astype(np.float32)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    yj, vjp = jax.vjp(lambda t: jact.apply_activation(t, act), jnp.asarray(x))
    (dj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tact.apply_activation(xt, act)
    (dt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    close(yt.detach(), yj, TOL_F32)
    close(dt, dj, TOL_F32)


def _bn_inputs(seed, shape=(2, 5, 6, 8)):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return y, scales, beta, g


@pytest.mark.parametrize("act", ACTS)
def test_bn_act_train_f32_matches_jax(act):
    y, scales, beta, g = _bn_inputs(0)
    (oj, (mj, vj)), vjp = jax.vjp(
        lambda a, b, c: jbn_act_train(act, 1, None, None, a, b, c),
        jnp.asarray(y), jnp.asarray(scales), jnp.asarray(beta))
    dyj, dsj, dbj = vjp((jnp.asarray(g), (jnp.zeros(8), jnp.zeros(8))))
    yt, st, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (y, scales, beta))
    ot, (mt, vt) = bn_act_train(act, None, None, yt, st, bt)
    ot.backward(torch.from_numpy(g))
    for got, want in ((ot, oj), (mt, mj), (vt, vj), (yt.grad, dyj),
                      (st.grad, dsj), (bt.grad, dbj)):
        close(f32(got), f32(want), TOL_F32)


@pytest.mark.parametrize("act", ACTS)
def test_bn_act_train_bf16_matches_jax(act):
    """The act16 path: a bf16 conv output, single-pass statistics, the
    y_hat residual and the output in bf16."""
    y, scales, beta, g = _bn_inputs(1)
    yb = jnp.asarray(y, jnp.bfloat16)
    (oj, (mj, vj)), vjp = jax.vjp(
        lambda a, b, c: jbn_act_train(act, 1, jnp.bfloat16, jnp.bfloat16,
                                      a, b, c),
        yb, jnp.asarray(scales), jnp.asarray(beta))
    dyj, dsj, dbj = vjp((jnp.asarray(g, jnp.bfloat16),
                         (jnp.zeros(8), jnp.zeros(8))))
    yt = torch.from_numpy(np.array(yb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scales, beta))
    ot, (mt, vt) = bn_act_train(act, torch.bfloat16, torch.bfloat16, yt, st,
                                bt)
    assert ot.dtype == torch.bfloat16
    ot.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert yt.grad.dtype == torch.bfloat16
    close(f32(mt), f32(mj), TOL_F32)
    close(f32(vt), f32(vj), TOL_F32)
    for got, want in ((ot, oj), (yt.grad, dyj), (st.grad, dsj),
                      (bt.grad, dbj)):
        close(f32(got), f32(want), TOL_BF16)


def test_bn_act_train_bessel():
    """Darknet normalises by the batch variance WITH Bessel's 1/(M-1)
    (blas.c:164-201), which F.batch_norm does not: forward and returned
    variance against a float64 numpy formula, and F.batch_norm differs."""
    y, scales, beta, _g = _bn_inputs(2, (2, 3, 2, 4))
    m = y.shape[0] * y.shape[1] * y.shape[2]
    y64 = y.astype(np.float64)
    mean = y64.mean((0, 1, 2))
    var = ((y64 - mean) ** 2).sum((0, 1, 2)) / (m - 1)
    want = (y64 - mean) / np.sqrt(var + 1e-5) * scales + beta
    out, (mt, vt) = bn_act_train("linear", None, None, torch.from_numpy(y),
                                 torch.from_numpy(scales),
                                 torch.from_numpy(beta))
    np.testing.assert_allclose(vt.numpy(), var, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    bm, bv = batch_mean_var(torch.from_numpy(y), (0, 1, 2))
    np.testing.assert_allclose(bv.numpy(), var, rtol=1e-5)
    np.testing.assert_allclose(bm.numpy(), mean, rtol=1e-5, atol=1e-6)
    torch_bn = torch.nn.functional.batch_norm(
        torch.from_numpy(y).permute(0, 3, 1, 2), None, None,
        torch.from_numpy(scales), torch.from_numpy(beta), training=True,
        eps=1e-5).permute(0, 2, 3, 1)
    assert np.abs(torch_bn.numpy() - want).max() > 1e-3


POOLS = ((5, 1), (9, 1), (13, 1), (2, 2), (3, 2), (2, 1))


@pytest.mark.parametrize("size,stride", POOLS)
def test_train_maxpool_ties_match_jax(size, stride):
    """Integer inputs tie in most windows: the stride-1 pools give the
    full cotangent to every position equal to the window max (separable,
    H then W), the strided ones split a tie evenly at each maximum of the
    chain, as jnp.maximum does.  Exact."""
    cfg = (f"[net]\nwidth=15\nheight=15\nchannels=4\n[maxpool]\n"
           f"size={size}\nstride={stride}\n")
    lj, lt = jbuild(cfg).layers[0], tbuild(cfg).layers[0]
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.integers(0, 3, (2, 15, 15, 4)).astype(np.float32)
    g = rng.standard_normal((2, lj.out_h, lj.out_w, 4)).astype(np.float32)
    yj, vjp = jax.vjp(lambda t: jmaxpool(t, lj, train=True), jnp.asarray(x))
    (dj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tmaxpool(xt, lt, train=True)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dj))


CONV_CFG = """[net]
width=12
height=12
channels=6
[convolutional]
batch_normalize={bn}
filters=8
size=3
stride={stride}
pad=1
activation={act}
"""


@pytest.mark.parametrize("bn,stride,act", [(1, 1, "mish"), (1, 2, "leaky"),
                                           (0, 1, "linear"),
                                           (0, 2, "logistic")])
def test_conv_block_train_matches_jax(bn, stride, act):
    """conv_block(train=True): conv, live BN + activation (or bias +
    activation), its VJP to x and every param, f32 with TF32 off."""
    cfg = CONV_CFG.format(bn=bn, stride=stride, act=act)
    lj, lt = jbuild(cfg, train=True).layers[0], tbuild(cfg, train=True).layers[0]
    rng = np.random.default_rng(stride + 3 * bn)
    x = rng.uniform(-1, 1, (2, 12, 12, 6)).astype(np.float32)
    p = {"w": rng.uniform(-0.3, 0.3, (3, 3, 6, 8)).astype(np.float32),
         "b": rng.uniform(-0.2, 0.2, 8).astype(np.float32)}
    if bn:
        p["scales"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    g = rng.standard_normal((2, lj.out_h, lj.out_w, 8)).astype(np.float32)

    def jf(xx, pp):
        return jconv_block(xx, pp, lj, train=True)

    (yj, stj), vjp = jax.vjp(jf, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()})
    zero = (jnp.zeros(8), jnp.zeros(8)) if bn else None
    dxj, dpj = vjp((jnp.asarray(g), zero))
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(np.transpose(v, (3, 2, 0, 1)).copy()
                              if k == "w" else v.copy()).requires_grad_()
          for k, v in p.items()}
    yt, stt = conv_block(xt, pt, lt, train=True)
    yt.backward(torch.from_numpy(g))
    close(f32(yt), f32(yj), TOL_F32)
    close(xt.grad, f32(dxj), TOL_F32)
    close(np.transpose(pt["w"].grad.numpy(), (2, 3, 1, 0)),
          f32(dpj["w"]), TOL_F32)
    for k in p:
        if k != "w":
            close(pt[k].grad, f32(dpj[k]), TOL_F32)
    if bn:
        close(stt[0], f32(stj[0]), TOL_F32)
        close(stt[1], f32(stj[1]), TOL_F32)
    else:
        assert stt is None and stj is None


def test_conv_block_train_bf16_close_to_jax():
    """bf16 training conv (keep_lp: a bf16 conv output straight into the
    epilogue, y_hat kept in bf16): within a few bf16 ulps of JAX's."""
    cfg = CONV_CFG.format(bn=1, stride=1, act="mish")
    lj, lt = jbuild(cfg, train=True).layers[0], tbuild(cfg, train=True).layers[0]
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 12, 12, 6)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (3, 3, 6, 8)).astype(np.float32)
    b = np.zeros(8, np.float32)
    s = np.ones(8, np.float32)
    yj, _ = jconv_block(jnp.asarray(x), {"w": jnp.asarray(w),
                                         "b": jnp.asarray(b),
                                         "scales": jnp.asarray(s)}, lj,
                        train=True, compute_dtype=jnp.bfloat16,
                        res_dtype=jnp.bfloat16)
    yt, _ = conv_block(torch.from_numpy(x),
                       {"w": torch.from_numpy(np.transpose(w, (3, 2, 0, 1))
                                              .copy()),
                        "b": torch.from_numpy(b), "scales": torch.from_numpy(s)},
                       lt, train=True, compute_dtype=torch.bfloat16,
                       res_dtype=torch.bfloat16)
    assert yt.dtype == torch.bfloat16
    close(f32(yt), f32(yj), TOL_BF16)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou", "mse"])
def test_iou_family_matches_jax(kind):
    """ops/boxes iou/giou/diou/ciou/rmse (iou_kind) on random, disjoint,
    nested and zero-size boxes."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.05, 0.6, (64, 4)).astype(np.float32)
    b = rng.uniform(0.05, 0.6, (64, 4)).astype(np.float32)
    b[:8, :2] += 2.0                       # disjoint
    b[8:16] = a[8:16] * [1, 1, 0.5, 0.5]   # nested
    a[16:20, 2:] = 0.0                     # zero-size
    b[20:24] = a[20:24]                    # identical
    want = jboxes.iou_kind(jnp.asarray(a), jnp.asarray(b), kind)
    got = tboxes.iou_kind(torch.from_numpy(a), torch.from_numpy(b), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
