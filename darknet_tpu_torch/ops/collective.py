"""Sums over a `torch.distributed` process group, for the statistics that
data parallelism makes global: the training batch norm's mean and
variance (sync-BN) and what its backward sums per channel; and the
maximum that a dynamic int8 conv's input scale takes over the group
(`parallel/spatial.SpatialForward`).

`group` is a process group whose ranks each hold an equal share of the
batch; None, or a group of one rank, means no collective at all.  Every
rank gets the same bits from a sum (the backends reduce once and hand the
result to everyone).  A failing collective raises; nothing retries.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """The number of ranks the statistics are taken over (1 without a
    group)."""
    return 1 if group is None else dist.get_world_size(group)


def group_sum(t, group):
    """`t` summed over the ranks of `group`, as a new tensor."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def group_max(t, group):
    """`t` maxed over the ranks of `group`, as a new tensor (every rank
    gets the same bits)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _GroupSum(torch.autograd.Function):
    """A differentiable sum over the group: every rank's value feeds every
    rank's result, so the gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g.contiguous(), ctx.group), None


def group_sum_grad(t, group):
    """`group_sum` that autograd differentiates through."""
    return _GroupSum.apply(t, group)
