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
"""

from __future__ import annotations

import torch

from darknet_tpu_torch.nn.emit import HEAD_KINDS, make_forward, scope
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


def make_train_step(graph, *, compute_dtype=None, remat: bool | str = False,
                    accum: int = 1, train_act_dtype=None):
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
    remat=True recomputes each conv block in the backward pass."""
    net = graph.net
    heads = [l for l in graph.layers if l.kind in HEAD_KINDS]
    fwd = make_forward(graph, train=True, compute_dtype=compute_dtype,
                       remat=remat, train_act_dtype=train_act_dtype)
    loss_scale = net.loss_scale

    def one_micro_batch(params, x, truths, generator):
        """Forward, deltas and backward of one micro-batch: .grad gains
        its ascent direction.  Returns (cost, metrics per head, stats)."""
        r = fwd(params, x, generator)
        costs, metrics, roots, cts = [], [], [], []
        for hi, (raw, l) in enumerate(zip(r["raw_heads"], heads)):
            with scope(f"head_delta_{hi}"):
                d, c, m = HEAD_DELTA[l.kind](raw.detach().float(), truths, l,
                                            net.w, net.h)
            costs.append(c)
            metrics.append(m)
            if raw.requires_grad:
                roots.append(raw)
                cts.append(d.to(raw.dtype) * loss_scale)
        cost = torch.stack(costs).sum()
        if roots:
            # the backward's f32 convs run without TF32, as the forward's
            with precise(compute_dtype or torch.float32), debug.anomaly():
                torch.autograd.backward(roots, grad_tensors=cts)
            check = debug.layer_check()
            if check is not None:
                check("backward", cost)
        return cost, metrics, r["bn_stats"]

    def step(params, opt_state, x, truths, lr, generator=None):
        for p in params:
            for v in p.values():
                v.grad = None
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not divisible by accum {accum}")
        costs, mets, stats = [], [], []
        for j in range(accum):
            c, m, s = one_micro_batch(params, x[j::accum], truths[j::accum],
                                      generator)
            costs.append(c)
            mets.append(m)
            stats.append(s)
        cost = torch.stack(costs).sum()
        metrics_list = [aggregate_micro_metrics(
            {k: torch.stack([mets[j][hi][k] for j in range(accum)])
             for k in mets[0][hi]}) for hi in range(len(heads))]
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
        check = debug.layer_check()
        if check is not None:
            check("optimizer_update", cost)
        for p in params:
            for v in p.values():
                v.grad = None

        # rolling statistics: 0.9/0.1 per micro-batch in sequence, i.e.
        # 0.9^M * old + 0.1 * sum_j 0.9^(M-1-j) * stats_j
        with torch.no_grad():
            wgt = 0.1 * torch.pow(0.9, torch.arange(
                accum - 1, -1, -1, dtype=torch.float32, device=x.device))
            keep = 0.9 ** accum
            for i in stats[0]:
                p = params[i]
                if "mean" not in p:
                    continue
                for slot, k in ((0, "mean"), (1, "var")):
                    contrib = torch.tensordot(
                        wgt, torch.stack([s[i][slot] for s in stats]), 1) \
                        if accum > 1 else 0.1 * stats[0][i][slot]
                    p[k].mul_(keep).add_(contrib)

        metrics = {
            "loss": sum(m["loss"] for m in metrics_list),
            "avg_iou": sum(m["avg_iou"] for m in metrics_list) / len(heads),
            "count": sum(m["count"] for m in metrics_list),
            "class_loss": sum(m["class_loss"] for m in metrics_list),
            "iou_loss_mag": sum(m["iou_loss"] for m in metrics_list),
        }
        return params, opt_state, cost, metrics

    return step


def init_opt_state(graph, params, *, iter0: int = 0):
    """Optimizer slots for `params`; iter0 is the current iteration when
    resuming from weights (seen / optimizer_batch), which the update gates
    compare against.  SGD or Adam as the cfg's [net] says."""
    return opt.init_adam_state(params, iter0=iter0, graph=graph) \
        if graph.net.adam else opt.init_sgd_state(params, iter0=iter0)
