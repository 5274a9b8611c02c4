"""Sums over a `torch.distributed` process group, for the statistics that
data parallelism makes global: the training batch norm's mean and
variance (sync-BN) and what its backward sums per channel; the maximum
that a dynamic int8 conv's input scale takes over the group
(`parallel/spatial.SpatialForward`); and the point-to-point exchanges of
the model-parallel meshes across processes (below).

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


# ------------------------------------------------------------ exchanges
# Point-to-point exchanges of the model-parallel meshes across processes
# (`parallel/spatial`, `parallel/tensor`, `parallel/pipeline`): every
# rank runs the same lockstep program, so a sender and its receiver reach
# an exchange at the same point of it, and an exchange between two ranks
# is tagged by a counter that both keep for that (sender, receiver) pair.
# A cotangent travels back under its exchange's tag in the other
# direction, so the two autograd engines may run their halves in any
# order: the message a rank waits for is named by its tag, not by the
# order in which its peer posted it.  That needs a backend that matches
# point-to-point messages by tag, which gloo does and NCCL does not (NCCL
# matches a pair's messages in the order they are posted), so the
# exchanges run over gloo and raise under another backend
# (`parallel/multihost.backend_for` picks gloo for a model-parallel grid).
# Under gloo a CUDA tensor travels through the host: gloo moves host
# memory only, so this is the backend's requirement, not a fallback.
# Sends are asynchronous; `flush` waits for every send this process
# posted.  A failing exchange raises.

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
           torch.uint8, torch.int32, torch.int64, torch.float64, torch.bool)
_HEADER = 8
_BACK = 1 << 28                 # cotangents' tags
_pending: list = []
_counters: dict = {}


def _check_backend() -> None:
    backend = dist.get_backend()
    if backend != "gloo":
        raise RuntimeError(
            f"the model-parallel exchanges match messages by tag and run "
            f"over gloo; this world's backend is {backend!r}, which "
            f"matches a pair's messages in posting order")


def _tag(src: int, dst: int) -> int:
    """The next tag of the exchanges from global rank src to dst."""
    n = _counters.get((src, dst), 0)
    _counters[(src, dst)] = n + 1
    return (2 * n) % _BACK


def _post(t, dst: int, tag: int) -> None:
    _check_backend()
    buf = t.detach().contiguous().cpu()
    _pending.append((dist.isend(buf, dst, tag=tag), buf))


def _take(src: int, tag: int, shape, dtype, device):
    _check_backend()
    buf = torch.empty(shape, dtype=dtype)
    dist.recv(buf, src, tag=tag)
    return buf.to(device)


def send(t, dst: int, *, grad: bool = False) -> int:
    """Post `t` to global rank dst, its shape, dtype and `grad` (whether
    the receiver's copy is differentiable) first; returns the exchange's
    tag."""
    _check_backend()
    tag = _tag(dist.get_rank(), dst)
    if t.dim() > _HEADER - 2:
        raise ValueError(f"a tensor of {t.dim()} dims cannot be exchanged")
    head = torch.zeros(_HEADER, dtype=torch.int64)
    head[0] = t.dim()
    head[1] = _DTYPES.index(t.dtype) + (len(_DTYPES) if grad else 0)
    head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    _post(head, dst, tag)
    _post(t, dst, tag + 1)
    return tag


def recv(src: int, device) -> tuple:
    """(the tensor global rank src sends next, on `device`; its tag;
    whether it is differentiable)."""
    _check_backend()
    tag = _tag(src, dist.get_rank())
    head = _take(src, tag, (_HEADER,), torch.int64, "cpu")
    nd, code = int(head[0]), int(head[1])
    shape = tuple(int(v) for v in head[2:2 + nd])
    t = _take(src, tag + 1, shape, _DTYPES[code % len(_DTYPES)], device)
    return t, tag, code >= len(_DTYPES)


def flush() -> None:
    """Wait until every send this process posted has gone."""
    while _pending:
        work, _buf = _pending.pop(0)
        work.wait()


class _Send(torch.autograd.Function):
    """The sending half of a differentiable exchange: its output is a
    scalar token that joins the backward's roots, and its backward takes
    the receiver's cotangent of the rows it sent."""

    @staticmethod
    def forward(ctx, t, dst):
        ctx.dst, ctx.tag = dst, send(t, dst, grad=True)
        ctx.like = (t.shape, t.dtype, t.device)
        return t.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        shape, dtype, device = ctx.like
        g = _take(ctx.dst, _BACK + ctx.tag, shape, dtype, device)
        return g, None


class _Recv(torch.autograd.Function):
    """The receiving half: its backward sends the cotangent back."""

    @staticmethod
    def forward(ctx, _anchor, src, device):
        t, ctx.tag, grad = recv(src, device)
        ctx.src = src
        if not grad:
            ctx.mark_non_differentiable(t)
        return t

    @staticmethod
    def backward(ctx, g):
        _post(g, ctx.src, _BACK + ctx.tag)
        return None, None, None


def zero_root(t, extras) -> None:
    """Append (t, a zero cotangent) to `extras` where t requires grad: a
    root that makes the backward reach t's node on every rank, so that
    an exchange or a sum over ranks in that node's backward runs on every
    rank even where nothing else of this rank reads t."""
    if extras is not None and t.requires_grad:
        extras.append((t, t.new_zeros(()).expand(t.shape)))


def send_grad(t, dst: int, extras) -> None:
    """`send` where no grad is taken (`extras` None, grad mode off, or `t`
    not requiring grad); else the differentiable send, whose token joins
    `extras` with a cotangent of 1 (the backward's roots must take
    them)."""
    if extras is not None and torch.is_grad_enabled() and t.requires_grad:
        tok = _Send.apply(t, dst)
        extras.append((tok, torch.ones_like(tok)))
    else:
        send(t, dst)


def recv_grad(src: int, device, extras):
    """`recv`, differentiable where the sender's tensor is and `extras`
    is given (its backward sends the cotangent back to src)."""
    if extras is not None and torch.is_grad_enabled():
        anchor = torch.zeros((), requires_grad=True)
        t = _Recv.apply(anchor, src, device)
        zero_root(t, extras)
        return t
    return recv(src, device)[0]


class _AllGatherCat(torch.autograd.Function):
    """Every rank's part of `ranks`, concatenated on `dim` in rank order
    on every rank (the parts may differ in size on `dim`).  The backward
    takes this rank's slice of the cotangent: where `reduce`, of the
    cotangents summed over the ranks first (each rank's downstream used
    only some of the whole), else of its own (every rank computed the
    same downstream)."""

    @staticmethod
    def forward(ctx, part, ranks, me, dim, reduce, group):
        parts = []
        for k, r in enumerate(ranks):
            if k != me:
                send(part, r)
        for k, r in enumerate(ranks):
            parts.append(part if k == me else recv(r, part.device)[0]
                         .to(part.dtype))
        ctx.me, ctx.dim, ctx.reduce, ctx.group = me, dim, reduce, group
        ctx.sizes = [p.shape[dim] for p in parts]
        flush()
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = group_sum(g.contiguous(), ctx.group)
        lo = sum(ctx.sizes[:ctx.me])
        return (g.narrow(ctx.dim, lo, ctx.sizes[ctx.me]), None, None, None,
                None, None)


def all_gather_cat(part, ranks: list, me: int, dim: int, *, group=None,
                   reduce: bool = False, extras=None):
    """`_AllGatherCat`: the parts of `ranks` concatenated on `dim` on every
    rank.  `group`: the process group of `ranks`, for the backward's sum
    where `reduce` (then the output joins `extras`, `zero_root`)."""
    if len(ranks) == 1:
        return part
    out = _AllGatherCat.apply(part, list(ranks), me, dim, reduce, group)
    if reduce:
        zero_root(out, extras)
    return out


class _CopyToGroup(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the group: the
    input of a layer whose ranks each compute a part of its output (a
    filter shard), so each rank's cotangent is one part of the whole."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g.contiguous(), ctx.group), None


def copy_to_group(t, group, extras=None):
    """`_CopyToGroup` (no-op without a group of several ranks); its output
    joins `extras` (`zero_root`)."""
    if group_size(group) == 1:
        return t
    out = _CopyToGroup.apply(t, group)
    zero_root(out, extras)
    return out
