"""Maxpool and global avgpool (`darknet_tpu/ops/pooling.py:40-163`) in
torch.

Darknet pads a maxpool with `lo = pad // 2` before and whatever the output
size needs after, with -inf; the SPP block's stride-1 5/9/13 pools are
the case the serving path runs.

Training (`maxpool(x, l, train=True)`) follows the JAX package's
gradients, not torch's:

* a stride-1 pool is separable (a 1-D max over H, then over W), each pass
  an autograd Function whose backward gives the FULL cotangent of a
  window to every position equal to the window's max (`max_pool2d`'s
  backward picks one position);
* a strided pool is a chain of `torch.maximum` over the size^2 shifted
  strided slices, whose autograd splits a tie evenly between the two
  operands, as `jnp.maximum`'s does.

`maxpool_depth` takes the max over channel groups at each position
(channel k feeds output channel k % out_channels), in serving and in
training alike (`amax` splits a tie's gradient evenly, as `jnp.max`
does).  An antialiased maxpool blurs its output (`ops/conv.antialias_blur`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from darknet_tpu_torch.ops.conv import antialias_blur


def _pads(l):
    lo = l.pad // 2
    hi_h = max((l.out_h - 1) * l.stride_y + l.size - l.h - lo, 0)
    hi_w = max((l.out_w - 1) * l.stride_x + l.size - l.w - lo, 0)
    return lo, hi_h, hi_w


def maxpool(x, l, train: bool = False):
    """Darknet maxpool on NHWC input, per MaxpoolIR `l`."""
    if l.maxpool_depth:
        b, h, w, c = x.shape
        out_c = l.out_channels
        groups = -(-c // out_c)
        if groups * out_c > c:
            x = F.pad(x, (0, groups * out_c - c), value=float("-inf"))
        return x.reshape(b, h, w, groups, out_c).amax(3)
    lo, hi_h, hi_w = _pads(l)
    if train:
        return _maxpool_train(x, l, lo, hi_h, hi_w)
    xn = x.permute(0, 3, 1, 2)
    stride = (l.stride_y, l.stride_x)
    if lo == hi_h == hi_w and 2 * lo <= l.size:
        # torch pads with -inf itself when the padding is symmetric
        y = F.max_pool2d(xn, l.size, stride, padding=lo)
    else:
        xn = F.pad(xn, (lo, hi_w, lo, hi_h), value=float("-inf"))
        y = F.max_pool2d(xn, l.size, stride)
    return y[:, :, :l.out_h, :l.out_w].permute(0, 2, 3, 1)


class _MaxpoolS1Axis(torch.autograd.Function):
    """Stride-1 max over a 1-D window of `size` along `axis` (1 = H,
    2 = W) of an NHWC tensor, padded (lo, hi) with -inf."""

    @staticmethod
    def forward(ctx, x, axis, size, lo, hi):
        xp = _pad_axis(x, axis, lo, hi, float("-inf"))
        n_out = xp.shape[axis] - size + 1
        y = xp.narrow(axis, 0, n_out)
        for o in range(1, size):
            y = torch.maximum(y, xp.narrow(axis, o, n_out))
        ctx.save_for_backward(x, y)
        ctx.cfg = (axis, size, lo)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        axis, size, lo = ctx.cfg
        n = x.shape[axis]
        # input position i is in the windows a = i + lo - o, o < size; pad
        # g and y so that every (i, o) lands in range (padded y is 0 where
        # no window exists, and so is g: a spurious match adds nothing)
        pre, post = size - 1 - lo, n + lo - y.shape[axis]
        gp = _pad_axis(g, axis, pre, post, 0.0)
        yp = _pad_axis(y, axis, pre, post, 0.0)
        dx = torch.zeros_like(x)
        for o in range(size):
            i0 = size - 1 - o
            dx = dx + gp.narrow(axis, i0, n) * (
                x == yp.narrow(axis, i0, n)).to(g.dtype)
        return dx, None, None, None, None


def _pad_axis(x, axis, lo, hi, value):
    """Pad the NHWC axis 1 or 2 with (lo, hi) entries of `value`; a
    negative amount crops."""
    pad = [0, 0, 0, 0, 0, 0]          # (C, W, H) pairs, innermost first
    pad[2 * (3 - axis)] = lo
    pad[2 * (3 - axis) + 1] = hi
    return F.pad(x, pad, value=value)


def _maxpool_train(x, l, lo, hi_h, hi_w):
    if (l.stride_y == 1 and l.stride_x == 1 and lo <= l.size - 1
            and x.shape[1] + lo >= l.out_h and x.shape[2] + lo >= l.out_w):
        y = _MaxpoolS1Axis.apply(x, 1, l.size, lo, hi_h)
        return _MaxpoolS1Axis.apply(y, 2, l.size, lo, hi_w)
    xp = F.pad(x, (0, 0, lo, hi_w, lo, hi_h), value=float("-inf"))
    out = None
    for dy in range(l.size):
        for dx in range(l.size):
            s = xp[:, dy:dy + (l.out_h - 1) * l.stride_y + 1:l.stride_y,
                   dx:dx + (l.out_w - 1) * l.stride_x + 1:l.stride_x, :]
            out = s if out is None else torch.maximum(out, s)
    return out


def maxpool_block(x, l, train: bool = False):
    y = maxpool(x, l, train=train)
    if l.antialiasing:
        y = antialias_blur(y, l)
    return y


def global_avgpool(x):
    """[avgpool]: NHWC -> (N, 1, 1, C), the mean over H and W."""
    return x.mean((1, 2), keepdim=True)
