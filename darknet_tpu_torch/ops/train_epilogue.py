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

Sync-BN (data parallelism, `parallel/dp.py`): given `group`, a process
group whose ranks each hold an equal share of the micro-batch, every
statistic is the whole micro-batch's, M = the global micro-batch x H x W
(`ops/collective`).  The f32 forward keeps the two passes, one sum over
the group each (the mean, then the centred sum of squares); the bf16
forward sums (s1, s2) over the group at once.  The backward sums its
per-channel s1 and s2 over the group before it forms dy, and returns the
rank's own dgamma and dbeta, which the step's gradient sum then adds up.

Parts (model parallelism, `parallel/spatial.MeshTrain`): the micro-batch
may come as several parts on several devices.  The one autograd node
takes them all, sums every statistic over the parts on scales' device
(then over `group`, where the parts of other ranks make up the rest of
the micro-batch), and in the backward sums s1 and s2 over the parts and
then the group before it forms any part's dy.  One part is the whole
tensor, and then the arithmetic is the one above, bit for bit.
"""

from __future__ import annotations

import torch

from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.collective import group_size, group_sum
from darknet_tpu_torch.ops.conv import (BN_EPS, batch_mean_var,
                                       batch_mean_var_parts, sum_on)


def _count(ys, group, count):
    """The rows the statistics run over: `count`, else the parts' rows
    times the group's size (equal shares)."""
    if count is not None:
        return count
    return sum(y.numel() // y.shape[-1] for y in ys) * group_size(group)


def batch_stats(ys, home, group=None, count=None):
    """(mean, var) per channel over the NHWC parts `ys` of one
    micro-batch, accumulated in f32 with Bessel's correction, on `home`:
    two passes for f32 (`ops/conv.batch_mean_var`, or its parts form),
    (s1, s2) at once for a narrower dtype; over the ranks of `group` too
    where one is given (`count`: the rows of every rank, where their
    shares differ)."""
    n = group_size(group)
    cnt = _count(ys, group, count)
    dims = tuple(range(ys[0].dim() - 1))
    if ys[0].dtype == torch.float32:
        if len(ys) == 1:
            return batch_mean_var(ys[0], dims, group, count)
        return batch_mean_var_parts(ys, home, group, count)
    s = sum_on([torch.stack([y.float().sum(dims),
                             y.float().square().sum(dims)]) for y in ys],
               home)
    if n > 1:
        s = group_sum(s, group)
    mean = s[0] / cnt
    return mean, torch.clamp_min(s[1] - s[0] * mean, 0.0) / max(cnt - 1, 1)


class _BnActTrain(torch.autograd.Function):
    """act(batchnorm(y)) over every part of one micro-batch: one node, so
    that the backward sees every part's s1 and s2 before it forms any
    part's dy."""

    @staticmethod
    def forward(ctx, scales, beta, act, out_dtype, res_dtype, group, count,
                *ys):
        home = scales.device
        mean, var = batch_stats(ys, home, group, count)
        inv = torch.rsqrt(var + BN_EPS)
        outs, saved = [], []
        for y in ys:
            on = [t.to(y.device, non_blocking=True)
                  for t in (mean, inv, scales, beta)]
            y_hat = (y.float() - on[0]) * on[1]
            out = apply_activation(y_hat * on[2].float() + on[3].float(), act)
            if out_dtype is not None:
                out = out.to(out_dtype)
            outs.append(out)
            saved.append(y_hat if res_dtype is None else y_hat.to(res_dtype))
        ctx.save_for_backward(inv, scales, beta, *saved)
        ctx.act, ctx.y_dtype, ctx.group = act, ys[0].dtype, group
        ctx.cnt = _count(ys, group, count)
        ctx.mark_non_differentiable(mean, var)
        return (mean, var, *outs)

    @staticmethod
    def backward(ctx, _g_mean, _g_var, *gs):
        inv, scales, beta, *saved = ctx.saved_tensors
        home, cnt = scales.device, ctx.cnt
        dims = tuple(range(saved[0].dim() - 1))
        parts = []
        for res, g in zip(saved, gs):
            dev = res.device
            s_f = scales.to(dev, non_blocking=True).float()
            y_hat = res.float()
            with torch.enable_grad():
                y_norm = (y_hat * s_f + beta.to(dev, non_blocking=True)
                          .float()).requires_grad_()
                (gp,) = torch.autograd.grad(apply_activation(y_norm, ctx.act),
                                            y_norm, g.float())
            gpg = gp * s_f
            parts.append((y_hat, gpg, gp.sum(dims), (gp * y_hat).sum(dims),
                          gpg.sum(dims)))
        d_beta = sum_on([p[2] for p in parts], home)
        d_scales = sum_on([p[3] for p in parts], home)
        s1 = sum_on([p[4] for p in parts], home)
        s2 = d_scales
        if group_size(ctx.group) > 1:
            s1, s2 = group_sum(torch.stack([s1, s2]), ctx.group)
        s2 = s2 * scales.float()
        dys = []
        for y_hat, gpg, *_sums in parts:
            on = [t.to(y_hat.device, non_blocking=True)
                  for t in (inv, s1, s2)]
            dy = on[0] * (gpg - on[1] / cnt - y_hat * (on[2] / max(cnt - 1,
                                                                   1)))
            dys.append(dy.to(ctx.y_dtype))
        return (d_scales.to(scales.dtype), d_beta.to(beta.dtype), None, None,
                None, None, None, *dys)


def bn_act_train_parts(ys, scales, beta, act, out_dtype=None, res_dtype=None,
                       *, group=None, count=None):
    """([out per part], (mean, var)) = act(batchnorm(y)) with live batch
    statistics, y the micro-batch that the parts `ys` make up.

    ys: the parts (N_i, H_i, W, C), NHWC (f32, or bf16 on the act16 path),
    on any devices, a part possibly empty: the whole tensor, a
    data-parallel block's rows, a spatial slab, or one filter shard's
    channels seen from every block (`parallel/spatial.MeshTrain`).
    scales, beta: (C,).  Each out is cast to `out_dtype` (None keeps
    f32); y_hat is saved at `res_dtype` (None keeps f32).  The statistics
    are the whole micro-batch's, M counting every part's rows (and every
    rank's, over `group`): for f32 two passes, each one sum over the
    parts; for bf16 (s1, s2) summed at once; every sum taken on scales'
    device in part order.  The backward sums its per-channel s1 and s2
    over the parts (and the group) before it forms any part's dy, and
    returns one dgamma and one dbeta, on scales' and beta's device (the
    rank's own under a group, which the step's gradient sum then adds
    up).  mean and var come back on scales' device and are not
    differentiated through.  `group`: the process group the statistics
    are taken over (sync-BN, or the model-parallel meshes across
    processes): each sum runs over the parts in part order, then over the
    group.  `count`: the rows (N x H x W) of the whole micro-batch, where
    the ranks' shares differ (uneven slabs); None counts this rank's parts
    times the group's size."""
    if not ys:
        raise ValueError("bn_act_train_parts needs at least one part")
    mean, var, *outs = _BnActTrain.apply(scales, beta, act, out_dtype,
                                         res_dtype, group, count, *ys)
    return outs, (mean, var)


def bn_act_train(act, out_dtype, res_dtype, y, scales, beta, group=None):
    """(out, (mean, var)): `bn_act_train_parts` over the one part `y`,
    (B,H,W,C), its statistics over `group` (sync-BN) where one is given."""
    outs, stats = bn_act_train_parts([y], scales, beta, act, out_dtype,
                                     res_dtype, group=group)
    return outs[0], stats
