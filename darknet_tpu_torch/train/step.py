"""The training step (`darknet_tpu/train/step.py:97-262`): forward, head
deltas ([yolo], [Gaussian_yolo], the YOLOv1 [detection] and [cost]),
backward, optimizer, rolling BN statistics.

The reference trains by filling each head's `delta` (the gradient-ascent
direction with respect to the head's output) and pulling it back through
the graph (TrainNetworkDatum, network.cpp:188-215).  Here the deltas are
computed under `no_grad` (`train/yolo_loss.py`,
`train/gaussian_yolo_loss.py`) and handed to
`torch.autograd.backward(raw_heads, grad_tensors=deltas * loss_scale)`,
which is the JAX package's `vjp_fn(deltas)`: every param's `.grad` is the
ascent direction that darknet's optimizer adds (`train/optimizer.py`).

Subdivisions (`accum`): micro-batch j takes images j, j + accum, ... (the
JAX package's interleaved split), runs forward, deltas and backward, and
frees its graph before the next one starts; `.grad` sums over the
micro-batches; one optimizer update follows.  The batch statistics of
each micro-batch feed the rolling mean/var 0.9/0.1 in sequence
(batchnorm_layer.cpp:221-224), folded into one update applied after the
optimizer.

The deltas and the update run in profiler ranges named as the JAX step's
scopes (`head_delta_{n}`, `optimizer_update`); under
`utils/debug.debug_nans` the backward runs with anomaly detection, and
under `debug_sync_mode` the card is synchronised after the backward and
the update as well as after every layer of the forward.

Data parallelism (`group`, from `parallel/dp.make_dp_train_step`): each
rank of the process group calls the step with its own equal block of the
global batch, and the step equals the single-process step on the global
batch: the batch statistics are the global micro-batch's (sync-BN,
`ops/train_epilogue`); the gradients are summed over the group once, after
the micro-batches, in one flat buffer a dtype (the JAX step's single
`psum`), and the optimizer divides by the global batch as before; the
cost and the head metrics of each micro-batch combine the ranks' as one
global micro-batch would have them (`combine_ranks`).  Every rank then
holds the same params, bit for bit.  On a grid of several axes over the
world, `group` is the dp line through the rank (`parallel/dp`), so the
sum runs over dp only; the model-parallel steps sum over their own
sub-groups (`parallel/spatial.mesh_train_step`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from darknet_tpu_torch.nn.emit import HEAD_KINDS, make_forward, scope
from darknet_tpu_torch.ops.collective import group_size
from darknet_tpu_torch.ops.conv import precise
from darknet_tpu_torch.ops.detection_v1 import (cost_layer,
                                                detection_head_delta,
                                                encode_v1_truth_batch)
from darknet_tpu_torch.train import optimizer as opt
from darknet_tpu_torch.train.gaussian_yolo_loss import \
    gaussian_yolo_head_delta
from darknet_tpu_torch.train.yolo_loss import yolo_head_delta
from darknet_tpu_torch.utils import debug


def detection_delta(raw, truths, l, net_w, net_h):
    """A [detection] head's delta: the (B, max_boxes, 5) box lists encoded
    as v1 grid truths, then `detection_head_delta` on the flat head.  The
    JAX step never passes `seen`, so its random responsible box (seen <
    64000) is never drawn there; nor here."""
    d, c, m = detection_head_delta(raw.reshape(raw.shape[0], -1),
                                   encode_v1_truth_batch(truths, l), l)
    zero = torch.zeros((), device=raw.device)
    return d.reshape(raw.shape), c, dict(m, class_loss=zero, iou_loss=zero)


def cost_delta(raw, truths, l, net_w, net_h):
    """A [cost] layer's delta: the truths are the flat target, and the
    delta is scaled by cost_scale."""
    flat = raw.reshape(raw.shape[0], -1)
    c, d = cost_layer(flat, truths.reshape(truths.shape[0], -1).float(),
                      l.cost_type, l.ratio)
    zero = torch.zeros((), device=raw.device)
    return ((d * l.cost_scale).reshape(raw.shape), c,
            {"loss": c / flat.shape[0], "avg_iou": zero, "count": zero,
             "class_loss": zero, "iou_loss": zero})


# the training delta of each head kind (`darknet_tpu/train/step.py:32-71`)
HEAD_DELTA = {"yolo": yolo_head_delta,
              "gaussian_yolo": gaussian_yolo_head_delta,
              "detection": detection_delta,
              "cost": cost_delta}


# per-truth means: micro-batches combine them weighted by their counts
COUNT_WEIGHTED_METRICS = frozenset(
    {"avg_iou", "avg_obj", "avg_cat", "recall50", "recall75"})


def aggregate_micro_metrics(m_stk):
    """One head's per-micro-batch metrics ({name: (M,) tensor}) combined
    with make_train_step(accum=M) semantics
    (`darknet_tpu/train/step.py:76-94`)."""
    cnt = m_stk.get("count")
    m = {}
    for k, v in m_stk.items():
        if k == "count":
            m[k] = v.sum()
        elif k in COUNT_WEIGHTED_METRICS and cnt is not None:
            m[k] = (v * cnt).sum() / cnt.sum().clamp_min(1.0)
        else:
            m[k] = v.mean()
    return m


def cost_parts(l, d, cost):
    """(the part of a head's cost that sums over images, the part that is
    a mean over the head's truths), from its delta `d` and cost.  Only a
    [yolo] head whose iou_loss is not mse has the second: its cost is
    iou_normalizer x the mean IoU loss of its truths + the class loss
    (`train/yolo_loss.yolo_head_delta`), whose part is recomputed here
    from the delta as that function computes it."""
    if l.kind == "yolo" and l.iou_loss != "mse":
        e = 5 + l.classes
        cls = l.cls_normalizer * d.reshape(d.shape[0], -1, e)[..., 4:] \
            .square().sum()
        return cls, cost - cls
    return cost, torch.zeros_like(cost)


def combine_ranks(stk):
    """One head's cost and metrics for a micro-batch spread over the ranks
    of a group, from each rank's ({name: (ranks,) tensor}: its metrics,
    "sum" and "mean" from `cost_parts`): the counts add, the per-truth
    means weigh by the ranks' counts, the per-image means (each rank holds
    as many images) average, and so does the mean part of the cost, by
    the counts.  Returns (cost, metrics)."""
    cnt = stk["count"]
    m = aggregate_micro_metrics({k: v for k, v in stk.items()
                                 if k not in ("sum", "mean")})
    cost = stk["sum"].sum() + (stk["mean"] * cnt).sum() / \
        cnt.sum().clamp_min(1.0)
    return cost, m


def _gather_rows(vec, group):
    """(ranks, K): every rank's (K,) vector, through one sum over the
    group (each rank adds its own row to zeros, which is exact)."""
    rows = vec.new_zeros((group_size(group),) + vec.shape)
    rows[dist.get_rank(group)] = vec
    dist.all_reduce(rows, group=group)
    return rows


def all_reduce_grads(params, group, *, every: bool = False) -> None:
    """Sum every param's .grad over the group in place: one flat buffer a
    dtype, one all-reduce each.  every=True first gives each param that
    requires grad and has none a zero .grad, for ranks whose backward may
    not reach the same params (an empty slab)."""
    by_dtype: dict = {}
    for p in params:
        for v in p.values():
            if every and v.requires_grad and v.grad is None:
                v.grad = torch.zeros_like(v)
            if v.grad is not None:
                by_dtype.setdefault(v.grad.dtype, []).append(v.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()


def zero_grads(params) -> None:
    for p in params:
        for v in p.values():
            v.grad = None


def head_deltas(raws, heads, truths, net, *, parts: bool = False,
                first: int = 0):
    """Each head's delta on its raw input, under `no_grad`: (costs,
    metrics, roots, cotangents), the roots being the raws that require
    grad and the cotangents their deltas times the cfg's loss_scale.
    `parts`: the metrics also carry the cost's parts ("sum", "mean",
    `cost_parts`) for `combine_ranks`.  `first`: the index of raws[0]
    among the graph's heads (the profiler range's name)."""
    costs, metrics, roots, cts = [], [], [], []
    for hi, (raw, l) in enumerate(zip(raws, heads)):
        with scope(f"head_delta_{first + hi}"):
            d, c, m = HEAD_DELTA[l.kind](raw.detach().float(), truths, l,
                                        net.w, net.h)
        costs.append(c)
        if parts:
            m = dict(m)
            m["sum"], m["mean"] = cost_parts(l, d, c)
        metrics.append(m)
        if raw.requires_grad:
            roots.append(raw)
            cts.append(d.to(raw.dtype) * net.loss_scale)
    return costs, metrics, roots, cts


def backward(roots, cts, compute_dtype, cost) -> None:
    """The backward from `roots` with cotangents `cts`: .grad gains the
    ascent directions."""
    if roots:
        # the backward's f32 convs run without TF32, as the forward's
        with precise(compute_dtype or torch.float32), debug.anomaly():
            torch.autograd.backward(roots, grad_tensors=cts)
        check = debug.layer_check()
        if check is not None:
            check("backward", cost)


def optimizer_update(graph, params, opt_state, lr) -> None:
    """The cfg's optimizer over `params` from their .grad (divided by the
    loss scale; a param without one counts as a zero gradient), in place;
    the grads are cleared after."""
    net = graph.net
    loss_scale = net.loss_scale
    grads = []
    for p in params:
        g = {}
        for k, v in p.items():
            if v.grad is not None:
                g[k] = v.grad / loss_scale if loss_scale != 1.0 else v.grad
        grads.append(g)
    with scope("optimizer_update"):
        if net.adam:
            opt.adam_update(graph, params, grads, opt_state, lr=lr,
                            B1=net.B1, B2=net.B2, eps=net.eps,
                            decay=net.decay, batch=net.optimizer_batch)
        else:
            opt.sgd_update(graph, params, grads, opt_state, lr=lr,
                           momentum=net.momentum, decay=net.decay,
                           batch=net.optimizer_batch)


def roll_bn_stats(params, stats) -> None:
    """The rolling statistics of `params` from each micro-batch's batch
    statistics (`stats`: one {layer index: (mean, var)} a micro-batch,
    in order): 0.9/0.1 per micro-batch in sequence, i.e. 0.9^M * old +
    0.1 * sum_j 0.9^(M-1-j) * stats_j."""
    accum = len(stats)
    with torch.no_grad():
        keep = 0.9 ** accum
        wgts: dict = {}
        for i in stats[0]:
            p = params[i]
            if "mean" not in p:
                continue
            dev = p["mean"].device
            if dev not in wgts:
                wgts[dev] = 0.1 * torch.pow(0.9, torch.arange(
                    accum - 1, -1, -1, dtype=torch.float32, device=dev))
            for slot, k in ((0, "mean"), (1, "var")):
                contrib = torch.tensordot(
                    wgts[dev], torch.stack([s[i][slot] for s in stats]), 1) \
                    if accum > 1 else 0.1 * stats[0][i][slot]
                p[k].mul_(keep).add_(contrib)


def summarize(costs, mets, n_heads):
    """(cost, metrics) of a step from each micro-batch's cost and
    per-head metrics, with make_train_step(accum=M) semantics."""
    accum = len(costs)
    cost = torch.stack(costs).sum()
    metrics_list = [aggregate_micro_metrics(
        {k: torch.stack([mets[j][hi][k] for j in range(accum)])
         for k in mets[0][hi]}) for hi in range(n_heads)]
    metrics = {
        "loss": sum(m["loss"] for m in metrics_list),
        "avg_iou": sum(m["avg_iou"] for m in metrics_list) / n_heads,
        "count": sum(m["count"] for m in metrics_list),
        "class_loss": sum(m["class_loss"] for m in metrics_list),
        "iou_loss_mag": sum(m["iou_loss"] for m in metrics_list),
    }
    return cost, metrics


def finish_step(graph, params, opt_state, lr, cost) -> None:
    """The optimizer update of `params` from their .grad, the grads
    cleared; the debug check after it."""
    optimizer_update(graph, params, opt_state, lr)
    check = debug.layer_check()
    if check is not None:
        check("optimizer_update", cost)
    zero_grads(params)


def micro_batches(x, truths, accum: int):
    """make_train_step's interleaved split: micro-batch j takes images j,
    j + accum, ...; the batch must divide."""
    b = x.shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not divisible by accum {accum}")
    return [(x[j::accum], truths[j::accum]) for j in range(accum)]


def make_train_step(graph, *, compute_dtype=None, remat: bool | str = False,
                    accum: int = 1, train_act_dtype=None, group=None):
    """Build `train_step(params, opt_state, x, truths, lr, generator=None)`,
    which updates `params` (from `nn/params.train_params_to_torch`) and
    `opt_state` in place and returns (params, opt_state, cost, metrics).

    x: (B, H, W, C) on the params' device; truths: (B, max_boxes, 5) (a
    [cost] net's flat targets, reshaped).  `generator` (on x's device)
    feeds dropout, dropblock and [crop], micro-batch after micro-batch;
    None runs them deterministically (`nn/emit._make_train_forward`).
    compute_dtype bf16 runs the convs in bf16 (f32 epilogues);
    train_act_dtype bf16 (act16) stores the interlayer tensors and the BN
    residuals in bf16, the head-feeding convs' outputs excepted.
    remat=True recomputes each conv block in the backward pass.
    group: the process group of data parallelism (the module docstring);
    x and truths are then this rank's block of the global batch.  The
    model-parallel steps (`parallel/{pipeline,tensor,spatial}`) reuse its
    parts: `head_deltas`, `backward`, `summarize`, `optimizer_update`
    and `roll_bn_stats`."""
    net = graph.net
    heads = [l for l in graph.layers if l.kind in HEAD_KINDS]
    fwd = make_forward(graph, train=True, compute_dtype=compute_dtype,
                       remat=remat, train_act_dtype=train_act_dtype,
                       stats_group=group)
    ranks = group_size(group)

    def one_micro_batch(params, x, truths, generator):
        """Forward, deltas and backward of one micro-batch: .grad gains
        its ascent direction.  Returns (cost, metrics per head, stats);
        over a group, the metrics also carry the cost's parts ("sum",
        "mean")."""
        r = fwd(params, x, generator)
        costs, metrics, roots, cts = head_deltas(
            r["raw_heads"], heads, truths, net, parts=ranks > 1)
        cost = torch.stack(costs).sum()
        backward(roots, cts, compute_dtype, cost)
        return cost, metrics, r["bn_stats"]

    def step(params, opt_state, x, truths, lr, generator=None):
        zero_grads(params)
        costs, mets, stats = [], [], []
        for xj, tj in micro_batches(x, truths, accum):
            c, m, s = one_micro_batch(params, xj, tj, generator)
            costs.append(c)
            mets.append(m)
            stats.append(s)
        if group is not None:
            all_reduce_grads(params, group)
        if ranks > 1:
            costs, mets = _over_ranks(mets)
        cost, metrics = summarize(costs, mets, len(heads))
        finish_step(graph, params, opt_state, lr, cost)
        roll_bn_stats(params, stats)
        return params, opt_state, cost, metrics

    def _over_ranks(mets):
        """Each micro-batch's cost and per-head metrics over the group's
        ranks (`combine_ranks`), from every rank's, gathered at once."""
        names = [list(m) for m in mets[0]]
        vec = torch.stack([mets[j][hi][k].float().reshape(())
                           for j in range(accum)
                           for hi in range(len(heads))
                           for k in names[hi]])
        rows = _gather_rows(vec, group)
        costs, out, col = [], [], 0
        for _j in range(accum):
            cj, mj = [], []
            for hi in range(len(heads)):
                stk = {k: rows[:, col + i] for i, k in enumerate(names[hi])}
                col += len(names[hi])
                c, m = combine_ranks(stk)
                cj.append(c)
                mj.append(m)
            costs.append(torch.stack(cj).sum())
            out.append(mj)
        return costs, out

    return step


def init_opt_state(graph, params, *, iter0: int = 0):
    """Optimizer slots for `params`; iter0 is the current iteration when
    resuming from weights (seen / optimizer_batch), which the update gates
    compare against.  SGD or Adam as the cfg's [net] says."""
    return opt.init_adam_state(params, iter0=iter0, graph=graph) \
        if graph.net.adam else opt.init_sgd_state(params, iter0=iter0)
