"""Inference convolution blocks (`darknet_tpu/ops/conv.py`) in torch.

Tensors are NHWC at every public function, as in the JAX package.  A NHWC
tensor viewed as NCHW (`permute(0, 3, 1, 2)`) is a `channels_last` tensor,
which is the layout cuDNN runs fastest, so the views cost no copy.  Conv
weights are OIHW (see `nn/params.params_to_torch`).

Numerics:
* darknet padding is asymmetric: explicit (lo, hi) pairs per edge;
* the f32 path is full float32: TF32 is switched off around every f32
  conv (the JAX f32 path is `Precision.HIGHEST`);
* BN is folded into w/b beforehand (`nn/params.fuse_conv_batchnorm`);
* conv, then the bias added in f32 and the sum cast to the compute dtype
  once, then the activation (`ops/conv.py:200-210` of the reference).  In
  f32 this is the reference's order.  In bf16, cuDNN has already rounded
  its f32 accumulator to bf16 before the bias is added, so the sum rounds
  twice where the reference (and the region kernel) round once: single
  elements may differ by a bf16 ulp.
* int8 (`conv_block_int8`): the int32 sum is exact, and the f32
  epilogue is the reference's, so given the same quantized input the
  pre-activation equals the reference's to the bit; the cast and the
  activation follow in the reference's order.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.quant_matmul import (input_scale, int8_matmul,
                                                quantize_int8)


def darknet_conv_padding(size: int, pad: int, dilation: int,
                         in_hw, stride, out_hw) -> tuple:
    """Explicit ((lo, hi), (lo, hi)) padding reproducing darknet's output
    size: the low edge gets `pad * dilation`, the high edge what the output
    size needs (see darknet_tpu.ops.conv.darknet_conv_padding)."""
    (in_h, in_w), (s_y, s_x), (out_h, out_w) = in_hw, stride, out_hw
    eff = dilation * (size - 1) + 1
    lo = pad * dilation
    hi_h = (out_h - 1) * s_y + eff - in_h - lo
    hi_w = (out_w - 1) * s_x + eff - in_w - lo
    return ((lo, max(hi_h, 0)), (lo, max(hi_w, 0)))


def precise(dtype):
    """Context that keeps an f32 conv in full float32 on cuDNN."""
    if dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


def _nchw_padding(x, padding, k, stride, dilation):
    """Turn ((lo,hi),(lo,hi)) into a symmetric `padding=` argument when
    that gives the same windows, else pad `x` (NCHW) explicitly."""
    (lo_h, hi_h), (lo_w, hi_w) = padding
    h, w = x.shape[2], x.shape[3]
    eff = dilation * (k[0] - 1) + 1, dilation * (k[1] - 1) + 1
    out_h = (h + lo_h + hi_h - eff[0]) // stride[0] + 1
    out_w = (w + lo_w + hi_w - eff[1]) // stride[1] + 1
    if ((h + 2 * lo_h - eff[0]) // stride[0] + 1 == out_h
            and (w + 2 * lo_w - eff[1]) // stride[1] + 1 == out_w):
        # windows start at the same places; padding beyond the last
        # window is never read
        return x, (lo_h, lo_w)
    return F.pad(x, (lo_w, hi_w, lo_h, hi_h)), (0, 0)


def conv2d_raw(x, w, b=None, *, stride=(1, 1), padding=((0, 0), (0, 0)),
               dilation=(1, 1), groups=1, compute_dtype=None):
    """NHWC x OIHW -> NHWC.  compute_dtype None runs full f32 (the parity
    path); bf16 runs the tensor-core path with f32 accumulation and a
    bf16 result.  `b` (optional) is added in f32 and the sum rounded once
    to the compute dtype."""
    cd = compute_dtype or torch.float32
    xn = x.to(cd).permute(0, 3, 1, 2)
    xn, pad = _nchw_padding(xn, padding, w.shape[2:], stride, dilation[0])
    with precise(cd):
        y = F.conv2d(xn, w.to(cd), None, stride=stride, padding=pad,
                     dilation=dilation, groups=groups)
    if b is not None:
        # in place on a bf16 y with an f32 b: computed in f32, cast once
        y.add_(b.float().view(-1, 1, 1))
    return y.permute(0, 2, 3, 1)


def im2col_int8(x_q, kh, kw, stride, padding, out_hw):
    """(B,H,W,C) int8 -> (B*OH*OW, kh*kw*C) int8, K ordered (kh, kw, c)
    like the stored "w_q" (`nn/params.params_to_torch`).  Zero padding is
    exact: a zero input quantizes to 0.  A 1x1 stride-1 conv is a view."""
    (lo_h, hi_h), (lo_w, hi_w) = padding
    b, h, w, c = x_q.shape
    (oh, ow), (sy, sx) = out_hw, stride
    if (kh, kw, sy, sx, lo_h, lo_w, oh, ow) == (1, 1, 1, 1, 0, 0, h, w):
        return x_q.reshape(-1, c)
    xp = F.pad(x_q, (0, 0, lo_w, hi_w, lo_h, hi_h))
    cols = [xp[:, ky:ky + sy * (oh - 1) + 1:sy, kx:kx + sx * (ow - 1) + 1:sx]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(cols, dim=3).reshape(b * oh * ow, kh * kw * c)


def conv2d_int8(x, p, *, size, stride, padding, out_hw):
    """The int8 product of `conv_block_int8`: NHWC x -> NHWC float32
    `acc * (x_scale * w_scale) + b`, before the cast and the activation.

    The scale is static (p["x_scale"], calibrated) or dynamic: max|x|
    over the whole batch, kept on the device.  x quantizes from float32
    with a true division; the int8 GEMM (`int8_matmul`, the CUDA kernel
    for a CUDA tensor) takes the im2col and p["w_q"] (n, K)."""
    xf = x.float()
    x_scale = p["x_scale"] if "x_scale" in p else input_scale(xf)
    x_q = quantize_int8(xf, x_scale)
    a = im2col_int8(x_q, size, size, stride, padding, out_hw)
    y = int8_matmul(a, p["w_q"], p["w_scale"], p["b"], x_scale)
    return y.reshape(x.shape[0], out_hw[0], out_hw[1], -1)


def conv_block_int8(x, p, l, *, compute_dtype=None):
    """Quantized inference conv (`darknet_tpu/ops/conv.py:107-150`):
    per-tensor int8 activations x per-output-channel int8 weights, exact
    int32 sums, the f32 dequant + bias epilogue, a cast to the compute
    dtype, then the activation.  `p` carries "w_q" and "w_scale"
    (`nn/params.quantize_conv_params`), BN folded, and optionally a
    static "x_scale"."""
    if getattr(l, "antialiasing", 0) or l.groups != 1 or l.dilation != 1:
        raise NotImplementedError(
            "int8 conv: antialiasing, groups and dilation are not ported")
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    y = conv2d_int8(x, p, size=l.size, stride=(l.stride_y, l.stride_x),
                    padding=padding, out_hw=(l.out_h, l.out_w))
    return apply_activation(y.to(compute_dtype or torch.float32),
                            l.activation)


def conv_block(x, p, l, *, compute_dtype=None):
    """Inference darknet conv layer with folded BN: conv + bias, cast to
    the compute dtype, activation."""
    if getattr(l, "antialiasing", 0):
        raise NotImplementedError("antialiased conv is not ported yet")
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    y = conv2d_raw(x, p["w"], p["b"], stride=(l.stride_y, l.stride_x),
                   padding=padding, dilation=(l.dilation, l.dilation),
                   groups=l.groups, compute_dtype=compute_dtype)
    return apply_activation(y, l.activation)
