"""Batch-norm + activation for training with a hand-written backward
(`darknet_tpu/ops/train_epilogue.py:51-140`).

The forward normalises a conv output `y` (NHWC) with its live batch
statistics, applies scale, shift and the activation, and saves ONE
residual: the normalised tensor y_hat, at `res_dtype` (bf16 under act16).
The backward recomputes the activation input from y_hat and applies the
analytic batch-norm backward, Bessel's 1/(M-1) included:

    gp   = act_vjp(g)                  (activation recomputed from y_hat)
    gpg  = gp * gamma
    s1   = sum(gpg);  s2 = sum(gpg * y_hat)        (per channel)
    dy   = inv_std * (gpg - s1/M - y_hat * s2/(M-1))
    dgamma = sum(gp * y_hat);  dbeta = sum(gp)

Darknet's batch variance carries 1/(M-1) in the normalisation itself
(mean_cpu/variance_cpu, blas.c:164-201), which `F.batch_norm` (biased
variance) does not.  Statistics: the exact two-pass formula for an f32 `y`
(the parity path), sum and sum of squares in one pass for a bf16 `y`.
The JAX package's pixel-phase packing (`phases`) exists only for TPU
layouts; here phases is always 1.
"""

from __future__ import annotations

import torch

from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.conv import BN_EPS, batch_mean_var


def batch_stats(y):
    """(mean, var) per channel of an NHWC tensor, accumulated in f32 with
    Bessel's correction: two passes for f32, one for a narrower dtype."""
    cnt = y.numel() // y.shape[-1]
    dims = tuple(range(y.dim() - 1))
    if y.dtype == torch.float32:
        return batch_mean_var(y, dims)
    yf = y.float()
    s1 = yf.sum(dims)
    s2 = yf.square().sum(dims)
    mean = s1 / cnt
    return mean, torch.clamp_min(s2 - s1 * mean, 0.0) / max(cnt - 1, 1)


class _BnActTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scales, beta, act, out_dtype, res_dtype):
        mean, var = batch_stats(y)
        inv = torch.rsqrt(var + BN_EPS)
        y_hat = (y.float() - mean) * inv
        out = apply_activation(y_hat * scales.float() + beta.float(), act)
        if out_dtype is not None:
            out = out.to(out_dtype)
        res = y_hat if res_dtype is None else y_hat.to(res_dtype)
        ctx.save_for_backward(res, inv, scales, beta)
        ctx.act, ctx.y_dtype = act, y.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        res, inv, scales, beta = ctx.saved_tensors
        dims = tuple(range(res.dim() - 1))
        cnt = res.numel() // res.shape[-1]
        y_hat = res.float()
        s_f = scales.float()
        with torch.enable_grad():
            y_norm = (y_hat * s_f + beta.float()).requires_grad_()
            (gp,) = torch.autograd.grad(apply_activation(y_norm, ctx.act),
                                        y_norm, g.float())
        d_beta = gp.sum(dims)
        d_scales = (gp * y_hat).sum(dims)
        gpg = gp * s_f
        s1 = gpg.sum(dims)
        s2 = d_scales * s_f
        dy = inv * (gpg - s1 / cnt - y_hat * (s2 / max(cnt - 1, 1)))
        return (dy.to(ctx.y_dtype), d_scales.to(scales.dtype),
                d_beta.to(beta.dtype), None, None, None)


def bn_act_train(act, out_dtype, res_dtype, y, scales, beta):
    """(out, (mean, var)) = act(batchnorm(y)) with live batch statistics.

    y: (B,H,W,C) conv output (f32, or bf16 on the act16 path); scales,
    beta: (C,).  out is cast to `out_dtype` (None keeps f32); y_hat is
    saved at `res_dtype` (None keeps f32).  mean/var feed the rolling
    statistics and are not differentiated through."""
    out, mean, var = _BnActTrain.apply(y, scales, beta, act, out_dtype,
                                       res_dtype)
    return out, (mean, var)
