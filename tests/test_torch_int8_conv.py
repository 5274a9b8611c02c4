"""int8_conv (the implicit-GEMM int8 convolution) on the CPU: its plain
version against darknet_tpu's int8 conv, and a torch emulation of the
CUDA kernel's addressing (`csrc/int8_gemm.cu`) against the plain version;
`conv_block_int8`, whose leaky convs take the activation from the GEMM's
epilogue, against the previous cast then `apply_activation` (the card's
case is in tests/test_torch_conv_epilogue.py, which imports no jax).

Numpy makes every input.  Tolerances: none: the quantized input and the
int32 sums are exact, and the f32 epilogue is the same rounded ops, so
every comparison is bitwise.

The emulation follows the kernel step by step: the wrapper's channel
padding to a multiple of 128; 128 x BN block tiles; K steps of 128
bytes; A by a TMA box of the (M, K) matrix (1x1 stride 1) or by TMA's
im2col mode (a K step is one (tap, 128-channel block); 128 window
corners traversed from the first pixel's inside the descriptor's
bounding box, read at the tap's offset, zeros outside); the weights by
TMA boxes (zeros outside); every tile in the 128-byte-swizzled layout
(chunk j of row r at chunk j ^ (r % 8)); the consumers' wgmma reads of
the swizzled tiles, 64 rows a warpgroup and 32 bytes of K an
instruction; the epilogue's rounded ops, the cast, leaky, and the
staging rows (64 columns, padded stride) written out as 16-byte chunks
with the ragged edges masked.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from darknet_tpu.ops import conv as jconv
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops import quant_matmul as tqm
from tests.test_torch_int8 import CONV_CFG

torch.set_num_threads(2)

BM, BK, EPI_COLS = 128, 128, 64


@pytest.fixture(scope="module")
def convs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(CONV_CFG)
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=7))
    return g, tparams.quantize_conv_params(g, npar, min_ch=1,
                                           skip_heads=False)


def _geometry(l):
    padding = tconv.darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    return {"size": l.size, "stride": (l.stride_y, l.stride_x),
            "padding": padding, "out_hw": (l.out_h, l.out_w)}


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("li", [0, 1, 2, 3])
def test_int8_conv_plain_matches_jax(convs, li, out_dtype):
    """x_q and the int32 sums equal JAX's int8 conv (1x1, 3x3/1, 3x3/2);
    the output is the reference epilogue, cast once."""
    g, qp = convs
    l, p = g.layers[li], qp[li]
    x = np.random.default_rng(li).normal(
        size=(2, l.h, l.w, l.c)).astype(np.float32)
    xs = np.float32(1.1 * np.abs(x).max() / 127.0)
    jx_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / xs), -127,
                               127).astype(jnp.int8))
    x_q = tqm.quantize_int8(torch.from_numpy(x), torch.tensor([xs]))
    np.testing.assert_array_equal(x_q.numpy(), jx_q)
    geo = _geometry(l)
    jacc = np.asarray(lax.conv_general_dilated(
        jnp.asarray(jx_q), jnp.asarray(p["w_q"]), geo["stride"],
        geo["padding"], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    tp = tparams.params_to_torch(g, [{}] * li + [p], "cpu")[li]
    cols = tqm.im2col_int8(x_q, l.size, l.size, geo["stride"],
                           geo["padding"], geo["out_hw"])
    acc = (cols.long() @ tp["w_q"].long().T).reshape(jacc.shape)
    np.testing.assert_array_equal(acc.numpy(), jacc)
    dt = getattr(torch, out_dtype)
    before = tqm.launches
    got = tqm.int8_conv(x_q, tp["w_q"], tp["w_scale"], tp["b"],
                        torch.tensor([xs]), out_dtype=dt, **geo)
    assert tqm.launches == before and got.dtype == dt
    want = jacc.astype(np.float32) * (xs * p["w_scale"]) + p["b"]
    np.testing.assert_array_equal(
        got.numpy() if dt == torch.float32 else got.float().numpy(),
        want if dt == torch.float32
        else torch.from_numpy(want).to(dt).float().numpy())


# --------------------------------------------------------------------------
# The kernel's addressing, emulated
# --------------------------------------------------------------------------


def _swizzled(row, chunk):
    """Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-
    swizzled tile (TMA's SWIZZLE_128B, wgmma's 128B layout)."""
    return row * BK + ((chunk ^ (row & 7)) << 4)


def _tma_box(mat, r0, k0, rows, smem):
    """A (rows, 128-byte) TMA box of an (R, K) int8 matrix at (r0, k0),
    zeros outside, into a swizzled tile."""
    r_all, k_all = mat.shape
    rr = torch.arange(rows)[:, None, None]
    jj = torch.arange(8)[None, :, None]
    bb = torch.arange(16)[None, None, :]
    gr, gk = r0 + rr, k0 + jj * 16 + bb
    ok = (gr < r_all) & (gk < k_all)
    val = mat.reshape(-1)[(gr * k_all + gk).clamp(0, mat.numel() - 1)]
    smem[_swizzled(rr, jj) + bb] = torch.where(ok, val, 0)


def _im2col_a(x_q, geo, m0, i, smem):
    """The producer's TMA im2col load of K step i of the A tile at m0:
    the first pixel's window corner (w0, h0) in image n, then 128 corners
    traversed along W, H and N with the conv's strides inside the
    bounding box [lower, dim - 1 + upper] (the descriptor's corners), each
    read at filter tap (kx, ky) over one 128-channel block, zeros outside
    the tensor."""
    b, h, w, c = x_q.shape
    kw = geo["size"]
    (sy, sx), (oh, ow) = geo["stride"], geo["out_hw"]
    pt, pl = geo["padding"][0][0], geo["padding"][1][0]
    lower = (-pl, -pt)                                     # w, h
    upper = ((ow - 1) * sx - pl - (w - 1), (oh - 1) * sy - pt - (h - 1))
    img, rem = divmod(m0, oh * ow)
    oy, ox = divmod(rem, ow)
    cw, ch, cn = ox * sx - pl, oy * sy - pt, img
    tap, cb = divmod(i, c // BK)
    ky, kx = divmod(tap, kw)
    for r in range(BM):
        yy, xx = ch + ky, cw + kx
        row = torch.zeros(BK, dtype=torch.int8)
        if 0 <= cn < b and 0 <= yy < h and 0 <= xx < w:
            row = x_q[cn, yy, xx, cb * BK:(cb + 1) * BK]
        jj = torch.arange(8)
        smem[(_swizzled(r, jj)[:, None] + torch.arange(16)).reshape(-1)] = \
            row.reshape(8, 16).reshape(-1)
        cw += sx                                            # next corner
        if cw > w - 1 + upper[0]:
            cw, ch = lower[0], ch + sy
            if ch > h - 1 + upper[1]:
                ch, cn = lower[1], cn + 1


def emulate(x_q, w_q, ws, bias, xs, geo, out_dtype, bn, leaky):
    x_q, w_q = tqm.pad_channels(x_q, w_q, geo["size"])     # as the wrapper
    b, h, w, c = x_q.shape
    n = w_q.shape[0]
    (oh, ow) = geo["out_hw"]
    m_all, k_all = b * oh * ow, w_q.shape[1]
    tma_a = (geo["size"] == 1 and geo["stride"] == (1, 1)
             and (geo["padding"][0][0], geo["padding"][1][0]) == (0, 0)
             and geo["out_hw"] == (h, w))
    nk = -(-k_all // BK)
    elem = torch.tensor([], dtype=out_dtype).element_size()
    sw = EPI_COLS * elem // 4 + (8 if elem == 4 else 4)     # words a row
    per = 16 // elem                                         # outputs a chunk
    out = torch.full((m_all, n), float("nan"), dtype=out_dtype)
    xs = float(xs)
    for m0 in range(0, m_all, BM):
        for n0 in range(0, n, bn):
            acc = torch.zeros((BM, bn), dtype=torch.int64)
            for i in range(nk):
                a_s = torch.full((BM * BK,), -128, dtype=torch.int8)
                b_s = torch.full((bn * BK,), -128, dtype=torch.int8)
                if tma_a:
                    _tma_box(x_q.reshape(-1, c), m0, i * BK, BM, a_s)
                else:
                    _im2col_a(x_q, geo, m0, i, a_s)
                _tma_box(w_q, n0, i * BK, bn, b_s)
                for wg in range(2):
                    for k in range(BK // 32):
                        rr = torch.arange(64)[:, None] + 64 * wg
                        kb = 32 * k + torch.arange(32)[None, :]
                        a = a_s[_swizzled(rr, kb >> 4) + (kb & 15)]
                        nr = torch.arange(bn)[:, None]
                        bt = b_s[_swizzled(nr, kb >> 4) + (kb & 15)]
                        acc[64 * wg:64 * wg + 64] += a.long() @ bt.long().T
            cols = n0 + torch.arange(bn)
            inb = cols < n
            s = torch.where(inb, torch.tensor(xs, dtype=torch.float32)
                            * ws[cols.clamp(max=n - 1)], 0)
            bi = torch.where(inb, bias[cols.clamp(max=n - 1)], 0)
            y = (acc.float() * s + bi).to(out_dtype)
            if leaky:
                y = torch.where(y > 0, y, 0.1 * y)
            for wg in range(2):
                for ec in range(bn // EPI_COLS):
                    raw = torch.zeros((64, sw * 4), dtype=torch.uint8)
                    blk = y[64 * wg:64 * wg + 64,
                            ec * EPI_COLS:(ec + 1) * EPI_COLS].contiguous()
                    raw[:, :EPI_COLS * elem] = blk.view(torch.uint8).reshape(
                        64, -1)
                    for r in range(64):
                        m = m0 + 64 * wg + r
                        if m >= m_all:
                            continue
                        for chk in range(EPI_COLS // per):
                            nn = n0 + ec * EPI_COLS + chk * per
                            if nn >= n:
                                continue
                            v = raw[r, chk * 16:(chk + 1) * 16].view(
                                out_dtype)
                            k_end = min(per, n - nn)
                            out[m, nn:nn + k_end] = v[:k_end]
    return out.reshape(b, oh, ow, n)


def _operands(b, h, w, c, n, size, stride, seed):
    rng = np.random.default_rng(seed)
    pad = size // 2
    oh = (h + 2 * pad - size) // stride + 1
    ow = (w + 2 * pad - size) // stride + 1
    geo = {"size": size, "stride": (stride, stride), "out_hw": (oh, ow),
           "padding": tconv.darknet_conv_padding(
               size, pad, 1, (h, w), (stride, stride), (oh, ow))}
    x_q = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c),
                                        dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (n, size * size * c),
                                        dtype=np.int8))
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return (x_q, w_q, ws, bias, torch.tensor([0.0039])), geo


@pytest.mark.parametrize("case", [
    # (b, h, w, c, n, size, stride, out, bn, leaky)
    (2, 9, 7, 128, 200, 3, 1, "bfloat16", 128, False),   # im2col, ragged M
    (2, 12, 10, 256, 96, 3, 2, "float32", 256, True),    # im2col 3x3/2
    (3, 7, 5, 128, 64, 1, 2, "bfloat16", 128, False),    # im2col 1x1/2
    (2, 12, 10, 48, 70, 3, 2, "float32", 128, True),     # C padded to 128
    (1, 10, 13, 32, 256, 3, 1, "bfloat16", 256, True),   # C padded, BN 256
    (3, 6, 9, 144, 40, 1, 1, "float32", 128, False),     # 1x1: TMA matrix
    (2, 11, 11, 64, 130, 1, 2, "bfloat16", 128, False),  # 1x1/2, C padded
])
def test_kernel_addressing_matches_plain(case):
    b, h, w, c, n, size, stride, out, bn, leaky = case
    ops, geo = _operands(b, h, w, c, n, size, stride, seed=b * h + c + n)
    dt = getattr(torch, out)
    want = tqm.int8_conv_plain(*ops, out_dtype=dt, leaky=leaky, **geo)
    got = emulate(*ops, geo, dt, bn, leaky)
    assert not torch.isnan(got.float()).any()
    assert torch.equal(got, want)


def test_int8_conv_dispatch():
    """A CPU tensor runs the plain version and launches nothing; any other
    non-CUDA device raises."""
    ops, geo = _operands(1, 5, 5, 16, 8, 3, 1, seed=0)
    before = tqm.launches
    got = tqm.int8_conv(*ops, **geo)
    assert tqm.launches == before
    assert torch.equal(got, tqm.int8_conv_plain(*ops, **geo))
    with pytest.raises(ValueError):
        tqm.int8_conv(*(t.to("meta") for t in ops), **geo)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("li", [0, 1, 2, 3])
def test_conv_block_int8_leaky_in_the_epilogue(convs, li, out_dtype, static,
                                               monkeypatch):
    """conv_block_int8 (mish, leaky, linear, leaky convs) equals the
    previous `int8_conv` with no activation, then `apply_activation`,
    bitwise; a leaky conv goes through `int8_conv_plain(leaky=True)`."""
    from darknet_tpu_torch.ops.activations import apply_activation

    g, qp = convs
    l, p = g.layers[li], dict(qp[li])
    if not static:
        p.pop("x_scale", None)
    elif "x_scale" not in p:
        p["x_scale"] = np.float32(0.05)
    tp = tparams.params_to_torch(g, [{}] * li + [p], "cpu")[li]
    x = torch.from_numpy(np.random.default_rng(li + 10).normal(
        size=(2, l.h, l.w, l.c)).astype(np.float32))
    dt = getattr(torch, out_dtype)
    leaky = []
    real = tqm.int8_conv_plain

    def plain(*a, **kw):
        leaky.append(kw.get("leaky", False))
        return real(*a, **kw)

    monkeypatch.setattr(tqm, "int8_conv_plain", plain)
    got = tconv.conv_block_int8(x, tp, l, compute_dtype=dt)
    monkeypatch.undo()
    assert leaky == [l.activation == "leaky"]
    geo = _geometry(l)
    want = apply_activation(tconv.conv2d_int8(x, tp, out_dtype=dt, **geo),
                            l.activation)
    assert got.dtype == want.dtype == dt
    assert torch.equal(got, want)
