"""The rare layer kinds of darknet_tpu_torch against darknet_tpu on the CPU:
[connected], [batchnorm], [local], antialiased convs and maxpools (with
the back-referenced view of a stride-2 one), maxpool_depth, [avgpool],
reverse upsample, reorg3d both ways, reorg_old, scale_channels (channel
and scale_wh), dropout, dropblock and [crop]; chip_smoke.py's rare-kind
cfgs (RARE_KINDS_CFG, RARE_COST_CFG) served and stepped; and the JAX
package's fuzz cfgs (`tests/test_reference_fuzz.random_cfg`) served and,
for the `train_safe` seeds, stepped.

Inputs and params are drawn with numpy from a seed and go through both
packages.  Tolerances:
* data movement (reorg, reorg_old, upsample, crop, maxpool_depth,
  scale_channels' product, dropout and dropblock given the JAX package's
  draw, the back-referenced view): exact;
* sums (blur, reverse upsample, avgpool, BN statistics) and the f32
  products (connected, local, convs): rtol 1e-5 with atol 1e-6 of the
  output's scale (the two libraries sum in another order); bf16 connected
  (exact bf16 products summed in f32): the same;
* the random draws cannot equal `jax.random`'s: the arithmetic is held
  given the JAX package's draw (the keep mask, the seed map, the offsets
  and flip), and the port's draws by their statistics: shares within 5
  binomial standard deviations, every crop offset in range and each
  reached;
* served nets in f32: heads within 1e-5 of their scale (max |head|) and
  the fuzz gate's pre-NMS counts (objectness over .2) equal; bf16 within
  2^-7 of the scale (one bf16 ulp: each package rounds a conv's f32 sum
  to bf16 once, in another order, so an element may land one ulp apart);
* training steps (f32, rng=None / generator=None, burn_in 0): updates,
  momentum and rolling statistics within 1e-4 of the largest change, or
  within 3 times what a 1e-7 relative change of the input moves the JAX
  step (measured: at most 1e-4 of the scale on these graphs).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import emit as jemit
from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.network import Network as JNetwork
from darknet_tpu.ops import conv as jconv
from darknet_tpu.ops import pooling as jpool
from darknet_tpu.ops import shapes as jshapes
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu_torch import Network
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import emit as temit
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops import pooling as tpool
from darknet_tpu_torch.ops import shapes as tshapes
from darknet_tpu_torch.train.step import make_train_step
from tests.test_reference_fuzz import random_cfg
from tests.test_torch_train_step import CS, to_numpy

torch.set_num_threads(2)

RTOL = 1e-5
BF16_ULP = 2.0 ** -7
SIGMAS = 5.0
YARDSTICK = 3.0
STEP_TOL = 1e-4

# the JAX fuzz gate's seeds (tests/test_reference_fuzz.py), square 64 px
# and 48x64; and its train_safe seeds (test_reference_training_parity)
FUZZ_SERVE = ([("sq", s) for s in (
    11, 23, 37, 41, 59, 67, 101, 137, 211, 251, 263, 307, 331, 389, 401,
    433, 467, 499, 523, 571, 601, 643, 677, 709, 751, 773, 809, 857, 907,
    953, 977, 1009, 1049, 1091, 1123, 1181, 1213, 1259, 1297, 1327, 1381,
    1423, 1453, 1489, 1531, 1579, 1613)]
    + [("rect", s) for s in (
        17, 73, 131, 197, 229, 283, 353, 419, 461, 509, 547, 587, 613, 653,
        691, 727, 757, 787, 821, 853, 883, 919, 947)])
FUZZ_TRAIN = (13, 29, 43, 71, 97, 113, 149, 181, 199, 239, 271, 313, 337,
              367, 433, 457)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quiet(build, cfg, train=False):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build(cfg, train=train)


def _layers(cfg, train=False):
    """The same cfg's layers from both builders: (JAX, port)."""
    return (_quiet(jbuild, cfg, train).layers,
            _quiet(tbuild, cfg, train).layers)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _net(h=16, w=12, c=5):
    return f"[net]\nwidth={w}\nheight={h}\nchannels={c}\n"


# ------------------------------------------------------------ [connected]

CONNECTED = ("[convolutional]\nfilters=6\nsize=3\nstride=1\npad=1\n"
             "activation=linear\n[connected]\noutput=7\nbatch_normalize={bn}\n"
             "activation=leaky\n")


@pytest.mark.parametrize("bn", [0, 1])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_connected_block(bn, train, dtype):
    """A spatial (16x12x6) input flattens CHW; BN from the batch (train,
    with the statistics) or the rolling statistics."""
    jl, tl = _layers(_net() + CONNECTED.format(bn=bn))
    rng = np.random.default_rng(bn + 2 * train)
    x = rng.normal(size=(3, 16, 12, 6)).astype(np.float32)
    p = {"w": rng.normal(size=(16 * 12 * 6, 7)).astype(np.float32) * 0.1,
         "b": rng.normal(size=7).astype(np.float32)}
    if bn:
        p.update(scales=rng.uniform(0.5, 2, 7).astype(np.float32),
                 mean=rng.normal(size=7).astype(np.float32),
                 var=rng.uniform(0.5, 2, 7).astype(np.float32))
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    want, wst = jconv.connected_block(jnp.asarray(x), p, jl[1], train=train,
                                      compute_dtype=jd)
    got, gst = tconv.connected_block(
        _t(x), {k: _t(v) for k, v in p.items()}, tl[1], train=train,
        compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)
    assert (gst is None) == (wst is None)
    if gst is not None:
        for a, b in zip(gst, wst):
            _close(a, b)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_block(train):
    jl, tl = _layers(_net() + "[batchnorm]\n")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16, 12, 5)).astype(np.float32)
    p = {"b": rng.normal(size=5), "scales": rng.uniform(0.5, 2, 5),
         "mean": rng.normal(size=5), "var": rng.uniform(0.5, 2, 5)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want, wst = jconv.batchnorm_block(jnp.asarray(x), p, jl[0], train=train)
    got, gst = tconv.batchnorm_block(_t(x), {k: _t(v) for k, v in p.items()},
                                     tl[0], train=train)
    _close(got, want)
    if train:
        for a, b in zip(gst, wst):
            _close(a, b)
    else:
        assert gst is None and wst is None


# ---------------------------------------------------------------- [local]

@pytest.mark.parametrize("spec", [(3, 1, 1), (3, 2, 0), (2, 1, 0)])
def test_local_block(spec):
    """Channel-major patches, per-location weights, CHW biases."""
    size, stride, pad = spec
    cfg = _net() + (f"[local]\nsize={size}\nstride={stride}\npad={pad}\n"
                    f"filters=4\nactivation=leaky\n")
    jl, tl = _layers(cfg)
    l = tl[0]
    rng = np.random.default_rng(size + stride)
    x = rng.normal(size=(2, 16, 12, 5)).astype(np.float32)
    p = {"w": rng.normal(size=(l.out_h * l.out_w, 4, size * size * 5)
                         ).astype(np.float32),
         "b": rng.normal(size=l.outputs).astype(np.float32)}
    want = jemit.local_block(jnp.asarray(x), p, jl[0])
    got = temit.local_block(_t(x), {k: _t(v) for k, v in p.items()}, l)
    _close(got, want)


# ---------------------------------------------------------- antialiasing

AA_CONV = ("[convolutional]\nbatch_normalize=1\nfilters=6\nsize=3\n"
           "stride_x={sx}\nstride_y={sy}\npad=1\nantialiasing={aa}\n"
           "activation=leaky\n")


def _conv_params(l, rng):
    return {"w": (rng.normal(size=(3, 3, l.c, l.n)) * 0.3).astype(
        np.float32),
        "b": rng.normal(size=l.n).astype(np.float32),
        "scales": rng.uniform(0.5, 2, l.n).astype(np.float32),
        "mean": rng.normal(size=l.n).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 2, l.n).astype(np.float32)}


@pytest.mark.parametrize("aa,sx,sy", [(1, 2, 2), (2, 2, 2), (1, 1, 1),
                                      (1, 2, 1)])
def test_antialias_blur_and_backref_view(aa, sx, sy):
    jl, tl = _layers(_net() + AA_CONV.format(aa=aa, sx=sx, sy=sy))
    rng = np.random.default_rng(aa * 10 + sx)
    y = rng.normal(size=(2, 16, 12, 6)).astype(np.float32)
    jb = jconv.antialias_blur(jnp.asarray(y), jl[0])
    tb = tconv.antialias_blur(_t(y), tl[0])
    _close(tb, jb)
    # the view is data movement: exact given the same blur
    want = jconv.antialias_backref_view(jnp.asarray(y), jb, jl[0])
    got = tconv.antialias_backref_view(_t(y), _t(jb), tl[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["f32", "bf16", "train", "int8"])
def test_antialiased_conv_block(mode):
    """The blur after the activation, in every conv path (int8 given the
    reference's quantized input: the int32 sums are exact)."""
    jl, tl = _layers(_net(c=4) + AA_CONV.format(aa=1, sx=2, sy=2),
                     train=mode == "train")
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 16, 12, 4)).astype(np.float32)
    p = _conv_params(tl[0], rng)
    if mode == "train":
        want, wst = jconv.conv_block(jnp.asarray(x), p, jl[0], train=True)
        tp = tparams.train_params_to_torch(tbuild(_net(c=4) + AA_CONV.format(
            aa=1, sx=2, sy=2), train=True), [p], "cpu")[0]
        got, gst = tconv.conv_block(_t(x), tp, tl[0], train=True)
        for a, b in zip(gst, wst):
            _close(a, b)
        _close(got.detach(), want)
        return
    fp = jparams.fuse_conv_batchnorm(_quiet(jbuild, _net(c=4) + AA_CONV.format(
        aa=1, sx=2, sy=2)), [p])
    g = _quiet(tbuild, _net(c=4) + AA_CONV.format(aa=1, sx=2, sy=2))
    if mode == "int8":
        fp = jparams.quantize_conv_params(g, fp, min_ch=1)
        want = jconv.conv_block_int8(jnp.asarray(x), fp[0], jl[0],
                                     compute_dtype=jnp.float32)
        got = tconv.conv_block_int8(
            _t(x), tparams.params_to_torch(g, fp, "cpu")[0], tl[0])
        _close(got, want)
        return
    jd = jnp.bfloat16 if mode == "bf16" else None
    td = torch.bfloat16 if mode == "bf16" else torch.float32
    want, _ = jconv.conv_block(jnp.asarray(x), fp[0], jl[0],
                               compute_dtype=jd)
    got = tconv.conv_block(_t(x), tparams.params_to_torch(g, fp, "cpu",
                                                          td)[0],
                           tl[0], compute_dtype=td)
    assert got.dtype == torch.float32          # the blur sums in f32
    _close(got, want, BF16_ULP if mode == "bf16" else RTOL)


# ------------------------------------------------------------- pooling

@pytest.mark.parametrize("c,out_c", [(8, 4), (6, 4), (9, 3)])
@pytest.mark.parametrize("train", [False, True])
def test_maxpool_depth(c, out_c, train):
    cfg = (_net(c=c) + f"[maxpool]\nmaxpool_depth=1\nout_channels={out_c}\n"
           "size=2\nstride=1\n")
    jl, tl = _layers(cfg)
    x = np.random.default_rng(c).normal(size=(2, 16, 12, c)).astype(
        np.float32)
    want = jpool.maxpool(jnp.asarray(x), jl[0], train=train)
    got = tpool.maxpool(_t(x), tl[0], train=train)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("aa", [1, 2])
@pytest.mark.parametrize("train", [False, True])
def test_antialiased_maxpool(aa, train):
    cfg = _net() + f"[maxpool]\nsize=2\nstride=2\nantialiasing={aa}\n"
    jl, tl = _layers(cfg)
    x = np.random.default_rng(aa).normal(size=(2, 16, 12, 5)).astype(
        np.float32)
    want = jpool.maxpool_block(jnp.asarray(x), jl[0], train=train)
    got = tpool.maxpool_block(_t(x), tl[0], train=train)
    _close(got, want)


def test_global_avgpool():
    x = np.random.default_rng(0).normal(size=(2, 7, 5, 3)).astype(np.float32)
    _close(tpool.global_avgpool(_t(x)), jpool.global_avgpool(jnp.asarray(x)))


# -------------------------------------------------------------- shapes

@pytest.mark.parametrize("stride,scale", [(2, 1.0), (2, 0.5), (4, 1.0)])
def test_upsample_reverse(stride, scale):
    x = np.random.default_rng(stride).normal(size=(2, 16, 12, 3)).astype(
        np.float32)
    _close(tshapes.upsample_reverse(_t(x), stride, scale),
           jshapes.upsample_reverse(jnp.asarray(x), stride, scale))


@pytest.mark.parametrize("op", ["reorg3d", "reorg_old"])
@pytest.mark.parametrize("reverse", [False, True])
def test_reorg(op, reverse):
    """Both reorgs in both directions, exact: reorg_old's permutation is
    the old flat-reinterpretation quirk over the input dims.  (The reverse
    reorg3d's loop bounds are its output dims, so its channels must hold
    stride^4 at least: `reorg_cpu` divides them by stride^2 twice.)"""
    section = "[reorg3d]" if op == "reorg3d" else "[reorg]"
    cfg = _net(c=32) + f"{section}\nstride=2\nreverse={int(reverse)}\n"
    jl, tl = _layers(cfg)
    l = tl[0]
    x = np.random.default_rng(int(reverse)).normal(
        size=(2, 16, 12, 32)).astype(np.float32)
    out = (l.out_h, l.out_w, l.out_c)
    want = getattr(jshapes, op)(jnp.asarray(x), 2, reverse, out)
    got = getattr(tshapes, op)(_t(x), 2, reverse, out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [2, 3, 4, 5, 6, 7, 8, 12])
def test_reorg_old_channels(c):
    """A legacy [reorg] at stride 2 needs C >= 4 input channels, because
    darknet's reorg_cpu divides by C // stride^2.  Below that the port
    refuses the cfg when the forward is built, naming the layer, where the
    JAX package serves NaN (`jnp.take` fills the out-of-range gathers: a
    standing deviation); from 4 up both give the same output, bitwise."""
    cfg = _net(c=c) + "[reorg]\nstride=2\n"
    jg, tg = _quiet(jbuild, cfg), _quiet(tbuild, cfg)
    x = np.random.default_rng(c).normal(size=(2, 16, 12, c)).astype(
        np.float32)
    want = np.asarray(jemit.make_forward(jg, fused_bn=True)(
        [{}], jnp.asarray(x))["output"])
    if c < 4:
        with pytest.raises(ValueError, match=r"layer 0: \[reorg\] .* C >= "
                           r"stride\^2 = 4 .* got C = " + str(c)):
            temit.make_forward(tg)
        assert np.isnan(want).any()
        return
    got = temit.make_forward(tg)([{}], _t(x))["output"]
    np.testing.assert_array_equal(got.numpy(), want)


# the fuzz seeds whose [reorg] (stride 2) reads 2 channels
FUZZ_REORG_FEW = [("sq", 415), ("rect", 415), ("sq", 1616), ("rect", 1616),
                  ("sq", 2114)]


@pytest.mark.parametrize("shape,seed", FUZZ_REORG_FEW,
                         ids=[f"{a}{s}" for a, s in FUZZ_REORG_FEW])
def test_fuzz_reorg_few_channels_refused(tmp_path, shape, seed):
    """The fuzz cfgs with such a [reorg]: the port's Network raises the
    ValueError before any work; the JAX package's heads are all NaN."""
    size, width = (64, None) if shape == "sq" else (48, 64)
    cfg = random_cfg(seed, size=size, width=width)
    path = str(tmp_path / "m.weights")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JNetwork.from_cfg(cfg, train=True, fuse=False,
                          seed=11).save_weights(path)
        jn = JNetwork.from_cfg(cfg, weights=path)
        x = np.random.default_rng(seed).uniform(
            0, 1, (1, size, width or size, 3)).astype(np.float32)
        jh, _jd = jn.forward_heads(x)
    assert all(np.isnan(np.asarray(h)).all() for h in jh)
    with pytest.raises(ValueError, match=r"layer \d+: \[reorg\] .* got C "
                       r"= 2"):
        Network.from_cfg(cfg, weights=path, device="cpu")


def test_reorg_old_no_user_warning():
    """reorg_old's gather table is a writable array: torch.from_numpy
    warns on a read-only one, and no UserWarning may come out."""
    tshapes._reorg_perm_chw.cache_clear()
    x = _t(np.random.default_rng(0).normal(size=(1, 8, 8, 8)).astype(
        np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        tshapes.reorg_old(x, 2, False)
        tshapes.reorg_old(x, 2, True)


@pytest.mark.parametrize("scale_wh", [False, True])
def test_scale_channels(scale_wh):
    rng = np.random.default_rng(int(scale_wh))
    feat = rng.normal(size=(2, 16, 12, 5)).astype(np.float32)
    gate = rng.uniform(0, 1, (2, 16, 12, 1) if scale_wh else (2, 1, 1, 5)
                       ).astype(np.float32)
    want = jshapes.scale_channels(jnp.asarray(gate), jnp.asarray(feat),
                                  scale_wh, "leaky")
    got = tshapes.scale_channels(_t(gate), _t(feat), scale_wh, "leaky")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _vjp_jax(f, x, g):
    y, back = jax.vjp(f, jnp.asarray(x))
    return np.asarray(y), np.asarray(back(jnp.asarray(g))[0])


def _vjp_torch(f, x, g):
    xt = _t(x).requires_grad_(True)
    y = f(xt)
    y.backward(_t(g))
    return y.detach().numpy(), xt.grad.numpy()


def test_dropout_given_the_jax_mask():
    """The port's arithmetic on the JAX package's keep mask: output and
    gradient exact."""
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 4)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - 0.3, x.shape))
    wy, wg = _vjp_jax(lambda a: jshapes.dropout(a, key, 0.3), x, g)
    gy, gg = _vjp_torch(lambda a: tshapes.dropout_apply(a, _t(keep), 0.3),
                        x, g)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gg, wg)


@pytest.mark.parametrize("abs_size,rel", [(3, 0.0), (0, 0.25), (20, 0.0)])
def test_dropblock_given_the_jax_seeds(abs_size, rel):
    key = jax.random.PRNGKey(5)
    x = np.random.default_rng(2).normal(size=(2, 16, 12, 4)).astype(
        np.float32)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    bs = tshapes.dropblock_size(16, 12, abs_size, rel)
    seeds = np.asarray(jax.random.bernoulli(
        key, 0.4 / float(bs * bs), (2, 16, 12, 1)).astype(jnp.float32))
    wy, wg = _vjp_jax(lambda a: jshapes.dropblock(a, key, 0.4, abs_size, rel),
                      x, g)
    gy, gg = _vjp_torch(lambda a: tshapes.dropblock_apply(a, _t(seeds), bs),
                        x, g)
    _close(gy, wy)
    _close(gg, wg)


@pytest.mark.parametrize("flip", [0, 1])
@pytest.mark.parametrize("noadjust", [0, 1])
def test_crop_given_the_jax_draw(flip, noadjust):
    cfg = (_net() + f"[crop]\ncrop_height=10\ncrop_width=7\nflip={flip}\n"
           f"noadjust={noadjust}\n")
    jl, tl = _layers(cfg)
    x = np.random.default_rng(flip).normal(size=(2, 16, 12, 5)).astype(
        np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        kf, kh, kw = jax.random.split(key, 3)
        dh = int(jax.random.randint(kh, (), 0, 16 - 10 + 1))
        dw = int(jax.random.randint(kw, (), 0, 12 - 7 + 1))
        fl = bool(flip) and bool(jax.random.bernoulli(kf))
        want = jshapes.crop_layer(jnp.asarray(x), jl[0], train=True, rng=key)
        got = tshapes.crop_apply(_t(x), tl[0], dh, dw, fl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # inference, and training without a generator: the centre crop
    want = jshapes.crop_layer(jnp.asarray(x), jl[0], train=False)
    for train in (False, True):
        got = tshapes.crop_layer(_t(x), tl[0], train=train)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- the port's own draws

def _within(count, n, p):
    return abs(count - n * p) <= SIGMAS * np.sqrt(n * p * (1 - p))


def test_dropout_keep_share():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, 32, 32, 16)
    keep = tshapes.dropout_keep(x, 0.3, gen)
    assert _within(int(keep.sum()), keep.numel(), 0.7)
    y = tshapes.dropout(x, torch.Generator().manual_seed(0), 0.3)
    assert torch.equal(y, tshapes.dropout_apply(x, keep, 0.3))


def test_dropblock_seed_rate_and_blocks():
    """Seeds at p / block^2, and each lone seed drops one block x block
    square at rows i - block//2 ... (the JAX package's padding)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.ones(32, 40, 40, 2)
    block = tshapes.dropblock_size(40, 40, 5, 0.0)
    seeds = tshapes.dropblock_seeds(x, 0.5, block, gen)
    assert block == 5 and seeds.shape == (32, 40, 40, 1)
    assert _within(int(seeds.sum()), seeds.numel(), 0.5 / 25)
    one = torch.zeros(1, 12, 12, 1)
    one[0, 6, 4, 0] = 1.0
    y = tshapes.dropblock_apply(torch.ones(1, 12, 12, 3), one, block)
    dropped = (y[0, :, :, 0] == 0).nonzero().numpy()
    assert len(dropped) == 25
    assert (dropped.min(0) == [4, 2]).all() and (dropped.max(0) == [8, 6]
                                                 ).all()
    np.testing.assert_allclose(float(y.max()), 144 / (144 - 25), rtol=1e-6)


def test_crop_draws_cover_their_range():
    l = _quiet(tbuild, _net() + "[crop]\ncrop_height=10\ncrop_width=7\n"
               "flip=1\n").layers[0]
    gen = torch.Generator().manual_seed(2)
    x = torch.zeros(1, 16, 12, 1)
    draws = [tshapes.crop_draw(x, l, gen) for _ in range(600)]
    dh = {d[0] for d in draws}
    dw = {d[1] for d in draws}
    assert dh == set(range(7)) and dw == set(range(6))
    assert _within(sum(d[2] for d in draws), 600, 0.5)
    noflip = dataclasses.replace(l, flip=False)
    assert not any(tshapes.crop_draw(x, noflip, gen)[2] for _ in range(50))


# ----------------------------------------------- chip_smoke's rare cfgs

def _weights(tmp_path, cfg, seed=0):
    """A .weights file of the JAX package's init (BN scales 1.5)."""
    g = _quiet(jbuild, cfg)
    p = jparams.init_params(g, seed=seed)
    for d in p:
        if "scales" in d:
            d["scales"] = d["scales"] * np.float32(1.5)
    from darknet_tpu.weights import io as jwio

    path = str(tmp_path / "m.weights")
    jwio.save_weights(g, p, path)
    return path


@pytest.mark.parametrize("name", ["RARE_KINDS_CFG", "RARE_COST_CFG"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rare_cfg_serves_as_jax(tmp_path, name, dtype):
    """The region planned at layers 1-3 runs its plain version on the CPU;
    the output and heads against the JAX package's forward."""
    cfg = getattr(CS, name)
    path = _weights(tmp_path, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jn = JNetwork.from_cfg(cfg, weights=path,
                               compute_dtype=jnp.bfloat16
                               if dtype == "bfloat16" else None)
        tn = Network.from_cfg(cfg, weights=path, device="cpu",
                              compute_dtype=getattr(torch, dtype))
    assert list(tn._fwd.region_plans) == [1]
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    tol = BF16_ULP if dtype == "bfloat16" else RTOL
    _close(tn.predict(x), np.asarray(jn.predict(x), np.float32), tol)
    jh, jd = jn.forward_heads(x)
    th, td = tn.forward_heads(x)
    assert len(th) == len(jh) == (name == "RARE_KINDS_CFG")
    for a, b in zip(th, jh):
        _close(a, np.asarray(b, np.float32), tol)


def test_rare_int8_antialiased_conv_as_jax(tmp_path):
    """int8 quantizes the antialiased 128 -> 128 conv (layer 10); given the
    JAX package's input to it, the port's int8 conv and blur give the JAX
    package's output."""
    cfg = CS.RARE_KINDS_CFG
    path = _weights(tmp_path, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jn = JNetwork.from_cfg(cfg, weights=path, int8=True)
        tn = Network.from_cfg(cfg, weights=path, device="cpu", int8=True)
    quantized = [i for i, p in enumerate(tn.params) if "w_q" in p]
    assert quantized == [10] and tn.graph.layers[10].antialiasing
    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    fwd = jemit.make_forward(jn.graph, fused_bn=True, fuse_regions=False)
    r = jax.jit(lambda p, a: fwd(p, a, _hi=10))(jn.params, jnp.asarray(x))
    xin = np.asarray(r["output"], np.float32)
    l = jn.graph.layers[10]
    want = jconv.conv_block_int8(jnp.asarray(xin), jn.params[10], l,
                                 compute_dtype=jnp.float32)
    got = tconv.conv_block_int8(_t(xin), tn.params[10], tn.graph.layers[10])
    _close(got, want)
    assert np.isfinite(tn.predict(x)).all()


def _step_case(cfg, seed):
    """(JAX graph, port graph, init params, x, truths) of one step."""
    jg, tg = _quiet(jbuild, cfg, True), _quiet(tbuild, cfg, True)
    p0 = jparams.init_params(jg, seed=0)
    return (jg, tg, p0) + CS.train_batch(jg, 4, seed)


def _hold_step(jg, tg, p0, x, y, accum=1):
    """One f32 step of both packages from p0 (rng=None, generator=None):
    updates, momentum and rolling statistics within STEP_TOL of the
    largest change or YARDSTICK yardsticks; the costs within 1e-5."""
    noise = np.random.default_rng(99).standard_normal(x.shape)
    xe = (x * (1 + 1e-7 * noise)).astype(np.float32)
    step = jstep(jg, donate=False, accum=accum)
    lr = jnp.float32(jg.net.lr)
    p = jax.device_put(p0)
    o = jinit(jg, p)
    pj, oj, cj, _ = step(p, o, jnp.asarray(x), jnp.asarray(y), None, lr)
    pe, oe, _, _ = step(p, o, jnp.asarray(xe), jnp.asarray(y), None, lr)
    pt = tparams.train_params_to_torch(tg, p0, "cpu")
    ot = {"t": 0, "u": tparams.numpy_to_train_layout(tg, to_numpy(o["u"]),
                                                     "cpu")}
    pt, ot, ct, _m = make_train_step(tg, accum=accum)(
        pt, ot, _t(x), _t(y), jg.net.lr)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
    got = {"params": tparams.train_params_to_numpy(tg, pt),
           "momentum": tparams.train_params_to_numpy(tg, ot["u"])}
    zero_u = to_numpy(o["u"])
    for name, want, moved, ref, keysets in (
            ("params", pj, pe, p0, (("w", "b", "scales"), ("mean", "var"))),
            ("momentum", oj["u"], oe["u"], zero_u, (("w", "b", "scales"),))):
        for keys in keysets:
            want_n, moved_n = to_numpy(want), to_numpy(moved)
            err, scale = CS.update_gap(want_n, got[name], ref, keys)
            yard, _ = CS.update_gap(want_n, moved_n, ref, keys)
            if scale == 0:
                continue
            assert err <= max(STEP_TOL * scale, YARDSTICK * yard), (
                name, keys, err / scale, yard / scale)


@pytest.mark.parametrize("accum", [1, 2])
def test_rare_kinds_step_as_jax(accum):
    _hold_step(*_step_case(CS.RARE_KINDS_CFG, 30 + accum), accum=accum)


@pytest.mark.parametrize("kind", ["sse", "smooth", "masked"])
def test_cost_head_step_as_jax(kind):
    """[cost] in a step: the deltas are the flat target minus the output
    (sse 2d, smooth L1, masked entries at SECRET_NUM), times cost_scale;
    the crop and dropblock run deterministically without a generator."""
    cfg = CS.RARE_COST_CFG.replace("type=sse", f"type={kind}\nscale=0.5")
    jg, tg, p0, x, y = _step_case(cfg, 3)
    if kind == "masked":
        y[:, ::7] = -1234.0
    _hold_step(jg, tg, p0, x, y)


# --------------------------------------------------------------- fuzz

@pytest.mark.parametrize("shape,seed", FUZZ_SERVE,
                         ids=[f"{a}{s}" for a, s in FUZZ_SERVE])
def test_fuzz_cfg_serves_as_jax(tmp_path, shape, seed):
    """The fuzz gate's form (tests/test_reference_fuzz._compare): init
    weights of seed 11 through a .weights file, folded; the last head and
    the pre-NMS count (objectness over .2) against the JAX package's."""
    size, width = (64, None) if shape == "sq" else (48, 64)
    cfg = random_cfg(seed, size=size, width=width)
    path = str(tmp_path / "m.weights")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JNetwork.from_cfg(cfg, train=True, fuse=False,
                          seed=11).save_weights(path)
        jn = JNetwork.from_cfg(cfg, weights=path)
        tn = Network.from_cfg(cfg, weights=path, device="cpu")
    x = np.random.default_rng(seed).uniform(
        0, 1, (1, size, width or size, 3)).astype(np.float32)
    jh, jd = jn.forward_heads(x)
    th, td = tn.forward_heads(x)
    _close(th[-1], np.asarray(jh[-1]))
    jobj, tobj = np.asarray(jd[1]), td[1].numpy()
    _close(tobj, jobj)
    assert int((tobj[0] > 0.2).sum()) == int((jobj[0] > 0.2).sum())


# bf16 heads against the JAX package's, as a share of each head's largest
# |value|: measured at most 1.52e-2 over FUZZ_SERVE (median 1.13e-2; one
# bf16 ulp is 2^-7 = 7.8e-3)
FUZZ_BF16_TOL = 2.0e-2


@pytest.mark.parametrize("shape,seed", FUZZ_SERVE,
                         ids=[f"{a}{s}" for a, s in FUZZ_SERVE])
def test_fuzz_cfg_serves_bf16_as_jax(tmp_path, shape, seed):
    """The bf16 twin of test_fuzz_cfg_serves_as_jax: every head against
    the JAX package's bf16 heads within FUZZ_BF16_TOL of the head's
    largest |value|, and the decoded objectness within 2^-8 (one bf16 ulp
    below 1; measured at most 2^-8).  The port rounds each activation
    once where the JAX package rounds at every bf16 op (ROADMAP C, "bf16
    activations round once"); through these chains that moves a head by
    1-2 ulps of its scale, and the tolerance fails if it grows past 2.6."""
    size, width = (64, None) if shape == "sq" else (48, 64)
    cfg = random_cfg(seed, size=size, width=width)
    path = str(tmp_path / "m.weights")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JNetwork.from_cfg(cfg, train=True, fuse=False,
                          seed=11).save_weights(path)
        jn = JNetwork.from_cfg(cfg, weights=path,
                               compute_dtype=jnp.bfloat16)
        tn = Network.from_cfg(cfg, weights=path, device="cpu",
                              compute_dtype=torch.bfloat16)
    x = np.random.default_rng(seed).uniform(
        0, 1, (1, size, width or size, 3)).astype(np.float32)
    jh, jd = jn.forward_heads(x)
    th, td = tn.forward_heads(x)
    assert len(th) == len(jh) > 0
    for a, b in zip(th, jh):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        share = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
        assert share <= FUZZ_BF16_TOL, share
    np.testing.assert_allclose(td[1].float().numpy(),
                               np.asarray(jd[1], np.float32), rtol=0,
                               atol=2.0 ** -8)


KINKED = ("leaky", "relu", "relie", "ramp", "relu6")


def _kink_free(cfg, p0, x, tol=1e-6):
    """True when no layer with a kinked activation (leaky's slope changes
    at 0) has a nonzero pre-activation within `tol` of its largest |value|
    of 0: there sum-order noise can put the two packages on either side of
    the kink (ROADMAP C, "Leaky's kink at f32 noise"); an exact 0 (a sum
    of zeros) is 0 in both.  Each such layer's
    pre-activation comes from the port's training forward over the cfg cut
    after it, with that layer's activation made linear."""
    sections = cfg.split("\n[")
    g = _quiet(tbuild, cfg, True)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    for i, l in enumerate(g.layers):
        if getattr(l, "activation", None) not in KINKED:
            continue
        last = sections[i + 1].replace(f"activation={l.activation}",
                                       "activation=linear")
        cut = _quiet(tbuild, "\n[".join(sections[:i + 1] + [last]), True)
        with torch.no_grad():
            out = temit.make_forward(cut, train=True)(p[:i + 1],
                                                      _t(x))["output"]
        a = out.abs()
        if bool(((a > 0) & (a <= tol * float(a.max()))).any()):
            return False
    return True


@pytest.mark.parametrize("seed", FUZZ_TRAIN)
def test_fuzz_train_safe_step_as_jax(seed):
    """One f32 step of a train_safe fuzz cfg (the training fuzz's truths:
    three boxes, two images) against the JAX package's step.  The batch
    is the first of seeds seed + 1, seed + 1001, ... whose kinked
    activations all lie clear of 0 (`_kink_free`; seeds 13, 113 and 239
    take a later batch): seed 13's first batch has a leaky
    [scale_channels] input 1.8e-7 from 0 among 32,768, whose slope the two
    packages take on either side (6% of layer 3's update, every layer
    after the gate within 1e-6)."""
    cfg = random_cfg(seed, no_dropout=True)
    for k in range(5):
        jg, tg, p0, x, y = _step_case(cfg, seed + 1 + 1000 * k)
        if _kink_free(cfg, p0, x[:2]):
            break
    else:
        pytest.fail("no kink-free batch in five seeds")
    _hold_step(jg, tg, p0, x[:2], y[:2])
