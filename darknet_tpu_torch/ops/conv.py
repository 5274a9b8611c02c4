"""Convolution blocks (`darknet_tpu/ops/conv.py`) in torch: inference
(`conv_block`, `conv_block_int8`) and training (`conv_block(train=True)`),
the antialiasing blur, and the `[connected]` and `[batchnorm]` layers.

Tensors are NHWC at every public function, as in the JAX package.  A NHWC
tensor viewed as NCHW (`permute(0, 3, 1, 2)`) is a `channels_last` tensor,
which is the layout cuDNN runs fastest, so the views cost no copy.  Conv
weights are OIHW (see `nn/params.params_to_torch`).

Numerics:
* darknet padding is asymmetric: explicit (lo, hi) pairs per edge;
* the f32 path is full float32: TF32 is switched off around every f32
  conv (the JAX f32 path is `Precision.HIGHEST`);
* BN is folded into w/b beforehand (`nn/params.fuse_conv_batchnorm`), or
  applied from its rolling statistics after the conv (`fuse=False`);
* conv, then the bias added in f32 and the sum cast to the compute dtype
  once, then the activation (`ops/conv.py:200-210` of the reference).  In
  bf16 the conv runs on f32 copies of the bf16-rounded input and weights
  with TF32 on: a bf16 value is exact in TF32, so the tensor cores form
  exact products and sum them in f32; the f32 bias is added and the sum
  rounds to bf16 once, as the reference's `preferred_element_type` conv
  and the region kernel do.
* int8 (`conv_block_int8`): the int32 sum is exact, and the f32
  epilogue is the reference's, so given the same quantized input the
  pre-activation equals the reference's to the bit; the cast (fused into
  the kernel's epilogue on the card) and the activation follow in the
  reference's order.
* antialiasing (`antialias_blur`): the layer runs at stride 1, then a
  fixed depthwise blur at its original stride, after the activation,
  summed in f32 over the activation's values (exact products: the blur
  weights are powers of two), as the reference's `preferred_element_type`
  conv does; its output is f32.
* `[connected]` multiplies in f32 with TF32 off (`precise_matmul`); in
  bf16 its operands are rounded to bf16 first and their exact products
  summed in f32, the reference's bf16 `jnp.dot` with f32 output.  Its
  output, BN and activation stay f32, as the reference's do.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.collective import group_size, group_sum_grad
from darknet_tpu_torch.ops.quant_matmul import (input_scale, int8_conv,
                                                quantize_int8)

BN_EPS = 1e-5


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
    """Context for a conv that serves `dtype`: full float32 on cuDNN for
    the f32 path; TF32 for the bf16 path, whose f32 operands hold bf16
    values (exact in TF32)."""
    if dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    if dtype == torch.bfloat16:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)
    return contextlib.nullcontext()


@contextlib.contextmanager
def precise_matmul(dtype):
    """Context for a matrix product that serves `dtype`: TF32 off for the
    f32 path (the reference's `Precision.HIGHEST`), on for the bf16 path,
    whose f32 operands hold bf16 values (exact in TF32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dtype == torch.bfloat16
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


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
               dilation=(1, 1), groups=1, compute_dtype=None, out_dtype=None):
    """NHWC x OIHW -> NHWC.  compute_dtype None runs full f32 (the parity
    path).  bf16 rounds x to bf16 and sums the exact products of bf16
    values in f32 (TF32 tensor cores over f32 copies); `w` must hold bf16
    values already: a bf16 tensor, or the f32 copy that
    `nn/params.params_to_torch` keeps for a bf16 network.  `b` (optional)
    is added to the f32 sum, which then rounds once to out_dtype (the
    compute dtype unless given)."""
    cd = compute_dtype or torch.float32
    if cd == torch.bfloat16:
        xn, wn = x.to(cd).float(), w.float()
    else:
        xn, wn = x.to(cd), w.to(cd)
    xn = xn.permute(0, 3, 1, 2)
    xn, pad = _nchw_padding(xn, padding, w.shape[2:], stride, dilation[0])
    with precise(cd):
        y = F.conv2d(xn, wn, None, stride=stride, padding=pad,
                     dilation=dilation, groups=groups)
    if b is not None:
        y.add_(b.float().view(-1, 1, 1))
    return y.to(out_dtype or cd).permute(0, 2, 3, 1)


def conv2d_int8(x, p, *, size, stride, padding, out_hw,
                out_dtype=torch.float32):
    """The int8 product of `conv_block_int8`: NHWC x -> NHWC out_dtype
    `acc * (x_scale * w_scale) + b` (computed in f32, rounded once),
    before the activation.

    The scale is static (p["x_scale"], calibrated) or dynamic: max|x|
    over the whole batch, kept on the device.  x quantizes from float32
    with a true division; `int8_conv` (the implicit-GEMM CUDA kernel for
    a CUDA tensor, which reads x_q in place) takes it and p["w_q"]
    (n, K)."""
    xf = x.float()
    x_scale = p["x_scale"] if "x_scale" in p else input_scale(xf)
    x_q = quantize_int8(xf, x_scale)
    return int8_conv(x_q, p["w_q"], p["w_scale"], p["b"], x_scale, size=size,
                     stride=stride, padding=padding, out_hw=out_hw,
                     out_dtype=out_dtype)


def conv_block_int8(x, p, l, *, compute_dtype=None):
    """Quantized inference conv (`darknet_tpu/ops/conv.py:107-150`):
    per-tensor int8 activations x per-output-channel int8 weights, exact
    int32 sums, the f32 dequant + bias epilogue, a cast to the compute
    dtype, then the activation.  `p` carries "w_q" and "w_scale"
    (`nn/params.quantize_conv_params`), BN folded, and optionally a
    static "x_scale".  An antialiased conv blurs after the activation.
    `quantize_conv_params` quantizes no grouped or dilated conv, and
    neither does this."""
    if l.groups != 1 or l.dilation != 1:
        raise NotImplementedError(
            "int8 conv: groups and dilation are never quantized")
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    y = conv2d_int8(x, p, size=l.size, stride=(l.stride_y, l.stride_x),
                    padding=padding, out_hw=(l.out_h, l.out_w),
                    out_dtype=compute_dtype or torch.float32)
    y = apply_activation(y, l.activation)
    if getattr(l, "antialiasing", 0):
        y = antialias_blur(y, l)
    return y


def conv_block(x, p, l, *, compute_dtype=None, train: bool = False,
               res_dtype=None, stats_group=None):
    """Inference darknet conv layer: conv + bias with folded BN, or, when
    `p` carries the unfolded "scales"/"mean"/"var" of a batch-normalised
    conv, conv then the rolling-statistics BN in f32
    (`darknet_tpu/ops/conv.py:200-202`); cast to the compute dtype,
    activation, then an antialiased conv's blur.  train=True is the
    training layer (`_conv_block_train`), which returns (y, bn_stats),
    its statistics taken over `stats_group` (sync-BN) where one is given."""
    if train:
        return _conv_block_train(x, p, l, compute_dtype=compute_dtype,
                                 res_dtype=res_dtype,
                                 stats_group=stats_group)
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    geom = dict(stride=(l.stride_y, l.stride_x), padding=padding,
                dilation=(l.dilation, l.dilation), groups=l.groups,
                compute_dtype=compute_dtype)
    if l.batch_normalize and "scales" in p:
        y = conv2d_raw(x, p["w"], out_dtype=torch.float32, **geom)
        y = ((y - p["mean"]) * torch.rsqrt(p["var"] + BN_EPS) * p["scales"]
             + p["b"]).to(compute_dtype or torch.float32)
    else:
        y = conv2d_raw(x, p["w"], p["b"], **geom)
    y = apply_activation(y, l.activation)
    if getattr(l, "antialiasing", 0):
        y = antialias_blur(y, l)
    return y


def batch_mean_var(y, dims, group=None, count=None):
    """Batch statistics of mean_cpu/variance_cpu (blas.c:164-201): the
    mean over `dims`, the variance with Bessel's 1/(N-1).  `dims` are the
    leading dims; with a process `group` (sync-BN, `ops/collective`) the
    two passes sum over its ranks as well, differentiably, and N counts
    every rank's share: `count` where given (shares of unequal size),
    else this rank's times the group's size."""
    n = 1
    for d in dims:
        n *= y.shape[d]
    ranks = group_size(group)
    if ranks == 1:
        mean = y.mean(dims, keepdim=True)
        var = (y - mean).square().sum(dims) / max(n - 1, 1)
        return mean.squeeze(dims), var
    n = count if count is not None else n * ranks
    mean = group_sum_grad(y.sum(dims), group) / n
    var = group_sum_grad((y - mean).square().sum(dims), group) / max(n - 1,
                                                                     1)
    return mean, var


def sum_on(vals, home):
    """The tensors `vals` (one a part, on any devices) summed in order on
    `home`."""
    total = None
    for v in vals:
        v = v.to(home, non_blocking=True)
        total = v if total is None else total + v
    return total


def batch_mean_var_parts(ys, home, group=None, count=None):
    """`batch_mean_var` over the leading dims of every tensor in `ys`
    together (parts of one micro-batch, on any devices; a part may be
    empty): the two passes, each one sum over the parts in order, taken on
    `home`, then over the ranks of `group` where one is given,
    differentiably (N: `count` where given, else the parts' rows times
    the group's size).  Returns (mean, var) on `home`."""
    dims = tuple(range(ys[0].dim() - 1))
    ranks = group_size(group)
    n = count if count is not None else \
        sum(y.numel() // y.shape[-1] for y in ys) * ranks

    def total(vals):
        s = sum_on(vals, home)
        return group_sum_grad(s, group) if ranks > 1 else s

    mean = total([y.sum(dims) for y in ys]) / n
    var = total([(y - mean.to(y.device, non_blocking=True)).square()
                 .sum(dims) for y in ys])
    return mean, var / max(n - 1, 1)


def train_keeps_lp(p, l, compute_dtype, res_dtype) -> bool:
    """Whether a training conv hands its bf16 output straight to the
    epilogue (keep_lp: a bf16 conv of a batch-normalised layer whose
    residual dtype is set), rather than an f32 copy."""
    cd = None if compute_dtype in (None, torch.float32) else compute_dtype
    return (res_dtype is not None and cd is not None
            and bool(l.batch_normalize) and "scales" in p)


def conv_train_pre(x, p, l, *, compute_dtype=None, res_dtype=None):
    """The first half of the training conv layer: the conv alone, no bias,
    NHWC, in the dtype the epilogue reads (f32, or bf16 under keep_lp,
    `train_keeps_lp`).  Its padding and output size come from the layer's
    fields (h, out_h, ...), so a slab of rows runs with its own."""
    cd = None if compute_dtype in (None, torch.float32) else compute_dtype
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    w = p["w"]
    xn = x.to(cd or torch.float32).permute(0, 3, 1, 2)
    xn, pad = _nchw_padding(xn, padding, w.shape[2:], (l.stride_y, l.stride_x),
                            l.dilation)
    with precise(torch.float32):
        y = F.conv2d(xn, w.to(cd or torch.float32), None,
                     stride=(l.stride_y, l.stride_x), padding=pad,
                     dilation=(l.dilation, l.dilation), groups=l.groups)
    y = y.permute(0, 2, 3, 1)
    if cd is not None and not train_keeps_lp(p, l, compute_dtype, res_dtype):
        y = y.float()
    return y


def conv_train_post(y, p, l, *, compute_dtype=None, res_dtype=None,
                    stats_group=None):
    """The second half: live batch norm + activation through
    `ops/train_epilogue.bn_act_train` (its statistics over `stats_group`
    where one is given), or bias + activation.  No blur.  Returns (y,
    (batch mean, batch var) or None)."""
    if l.batch_normalize and "scales" in p:
        from darknet_tpu_torch.ops.train_epilogue import bn_act_train

        keep_lp = train_keeps_lp(p, l, compute_dtype, res_dtype)
        return bn_act_train(l.activation, res_dtype if keep_lp else None,
                            res_dtype, y, p["scales"], p["b"], stats_group)
    return apply_activation(y + p["b"], l.activation), None


def _conv_block_train(x, p, l, *, compute_dtype=None, res_dtype=None,
                      stats_group=None):
    """Training darknet conv layer (`darknet_tpu/ops/conv.py:153-213`,
    train=True): `conv_train_pre`, then `conv_train_post` (live batch
    norm + activation through `ops/train_epilogue.bn_act_train`, or bias
    + activation).  Returns (y, (batch mean, batch var) or None).

    compute_dtype None (or float32) is full f32 with TF32 off.  bf16 runs a
    bf16 conv (f32 accumulation, bf16 out; its backward is cuDNN's bf16
    backward); the epilogue then runs in f32, unless `res_dtype` is set
    on a batch-normalised conv (keep_lp): then the bf16 conv output goes
    straight into the epilogue, which keeps y_hat and its output at
    res_dtype.  p holds unfolded OIHW params ("w", "b"[, "scales"]).  An
    antialiased conv blurs after the activation."""
    y = conv_train_pre(x, p, l, compute_dtype=compute_dtype,
                       res_dtype=res_dtype)
    y, stats = conv_train_post(y, p, l, compute_dtype=compute_dtype,
                               res_dtype=res_dtype, stats_group=stats_group)
    if getattr(l, "antialiasing", 0):
        y = antialias_blur(y, l)
    return y, stats


def _blur_kernel(c: int, antialiasing: int, device):
    """Depthwise blur weights (convolutional_layer.cpp:744-801), OIHW
    (c, 1, kh, kw): a 2x2 box for antialiasing=2, else the 3x3 binomial."""
    if antialiasing == 2:
        k = torch.full((2, 2), 0.25)
    else:
        k1 = torch.tensor([1.0, 2.0, 1.0]) / 4.0
        k = torch.outer(k1, k1)
    return k[None, None].repeat(c, 1, 1, 1).to(device)


def antialias_blur(y, l):
    """The fixed depthwise blur at the layer's original stride
    (`darknet_tpu/ops/conv.py:248-265`): NHWC in, NHWC f32 out."""
    c = y.shape[-1]
    size, pad = (2, 0) if l.antialiasing == 2 else (3, 1)
    in_h, in_w = y.shape[1], y.shape[2]
    stride = (l.blur_stride_y, l.blur_stride_x)
    out_hw = ((in_h + 2 * pad - size) // stride[0] + 1,
              (in_w + 2 * pad - size) // stride[1] + 1)
    padding = darknet_conv_padding(size, pad, 1, (in_h, in_w), stride,
                                   out_hw)
    xn, pd = _nchw_padding(y.float().permute(0, 3, 1, 2), padding,
                           (size, size), stride, 1)
    with precise(torch.float32):
        out = F.conv2d(xn, _blur_kernel(c, l.antialiasing, y.device), None,
                       stride=stride, padding=pd, groups=c)
    return out.permute(0, 2, 3, 1)


def antialias_backref_view(y_act, blur, l):
    """The antialiased layer's output as back-references see it
    (`darknet_tpu/ops/conv.py:227-245`): the reference keeps the layer's
    stride-1 (h, w, c) buffer and copies only the blurred output over its
    flat CHW front, so a route, shortcut or scale_channels that reads the
    layer sees the blur followed by the stale stride-1 activations."""
    b, h, w, c = y_act.shape
    flat_full = y_act.permute(0, 3, 1, 2).reshape(b, -1)
    flat_blur = blur.permute(0, 3, 1, 2).reshape(b, -1)
    flat = torch.cat([flat_blur, flat_full[:, flat_blur.shape[1]:].to(
        flat_blur.dtype)], dim=1)
    return flat.reshape(b, c, h, w).permute(0, 2, 3, 1)


def connected_block(x, p, l, *, train: bool = False, compute_dtype=None,
                    stats_group=None):
    """[connected] (`darknet_tpu/ops/conv.py:268-298`): y = x @ w + b, or
    BN from the batch (train) or rolling statistics, then the activation;
    returns (y (B, outputs) f32, (batch mean, batch var) or None).

    A spatial input flattens CHW (NHWC -> NCHW, then reshape), the order
    of the weights in a `.weights` file; p["w"] is (inputs, outputs)."""
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    x2 = x.reshape(x.shape[0], -1)
    cd = compute_dtype or torch.float32
    w = p["w"]
    if cd == torch.bfloat16:
        x2, w = x2.to(cd).float(), w.to(cd).float()
    else:
        x2 = x2.float()
    with precise_matmul(cd):
        y = x2 @ w
    bn_stats = None
    if l.batch_normalize and "scales" in p:
        if train:
            mean, var = bn_stats = batch_mean_var(y, (0,), stats_group)
        else:
            mean, var = p["mean"], p["var"]
        y = (y - mean) * torch.rsqrt(var + BN_EPS) * p["scales"] + p["b"]
    else:
        y = y + p["b"]
    return apply_activation(y, l.activation), bn_stats


def batchnorm_block(x, p, l, *, train: bool = False, stats_group=None):
    """Standalone [batchnorm] (`darknet_tpu/ops/conv.py:301-311`): BN over
    the channels from the batch (train) or rolling statistics; returns
    (y, (batch mean, batch var) or None)."""
    bn_stats = None
    if train:
        mean, var = bn_stats = batch_mean_var(x, (0, 1, 2), stats_group)
    else:
        mean, var = p["mean"], p["var"]
    return ((x - mean) * torch.rsqrt(var + BN_EPS) * p["scales"] + p["b"],
            bn_stats)
