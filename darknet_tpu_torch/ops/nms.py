"""NMS (`darknet_tpu/ops/nms.py`): the exact host NmsSort and the device
fixed-size variant.

Reference semantics (box.cpp:372-419): per class, visit detections in
descending prob order and zero the prob of every lower-ranked detection
whose IoU (greedynms) or DIoU (diounms) with a surviving one exceeds the
threshold.  Ties rank by (prob, index): the stable descending sort
(PARITY.md DEVIATION 3).
"""

from __future__ import annotations

import numpy as np
import torch

from darknet_tpu_torch.ops import boxes as boxops
from darknet_tpu_torch.utils import spans


def _np_edges(v):
    return (v[..., 0] - v[..., 2] / 2, v[..., 0] + v[..., 2] / 2,
            v[..., 1] - v[..., 3] / 2, v[..., 1] + v[..., 3] / 2)


def _np_iou(a, b):
    al, ar, at, ab = _np_edges(a)
    bl, br, bt, bb = _np_edges(b)
    w = np.minimum(ar, br) - np.maximum(al, bl)
    h = np.minimum(ab, bb) - np.maximum(at, bt)
    inter = np.where((w < 0) | (h < 0), 0.0, w * h)
    uni = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    eps = np.finfo(np.float32).eps
    out = np.zeros_like(inter)
    ok = (np.abs(inter) >= eps) & (np.abs(uni) >= eps)
    out[ok] = inter[ok] / uni[ok]
    return out


def _np_diou(a, b, beta):
    al, ar, at, ab = _np_edges(a)
    bl, br, bt, bb = _np_edges(b)
    w = np.maximum(ar, br) - np.minimum(al, bl)
    h = np.maximum(ab, bb) - np.minimum(at, bt)
    c = w * w + h * h
    i = _np_iou(a, b)
    d = (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
    out = i.copy()
    ok = np.abs(c) >= np.finfo(np.float32).eps
    out[ok] = i[ok] - np.power(d[ok] / c[ok], beta)
    return out


def nms_numpy(boxes: np.ndarray, probs: np.ndarray, thresh: float,
              kind: str = "greedynms", beta: float = 0.6) -> np.ndarray:
    """Exact NmsSort: boxes (N,4), probs (N,C) -> suppressed probs (N,C),
    in numpy (the host path; serving runs `nms_device`)."""
    boxes = np.asarray(boxes, dtype=np.float32)
    probs = np.asarray(probs, dtype=np.float32).copy()
    n, c = probs.shape
    eps = np.finfo(np.float32).eps
    for k in range(c):
        order = np.argsort(-probs[:, k], kind="stable")
        for oi in range(n):
            i = order[oi]
            if abs(probs[i, k]) < eps:
                continue
            rest = order[oi + 1:]
            if rest.size == 0:
                continue
            if kind == "greedynms":
                sim = _np_iou(boxes[i][None, :], boxes[rest])
            else:
                sim = _np_diou(boxes[i][None, :], boxes[rest], beta)
            probs[rest[sim > thresh], k] = 0.0
    return probs


def nms_device(boxes, probs, thresh: float, kind: str = "greedynms",
               beta: float = 0.6):
    """Batched masked greedy NMS: boxes (B,N,4), probs (B,N,C) -> (B,N,C).

    The exact greedy kept set is the fixpoint of
    f(K)[i] = active[i] & no j with K[j], rank_j < rank_i and sim > thresh,
    where rank_j < rank_i is (p_j > p_i) | (p_j == p_i & j < i).  It is
    squeezed between the monotone bounds Lo' = f(Hi), Hi' = f(Lo), which
    meet after as many rounds as the longest suppression chain.  The
    rounds run under the `while_loop` operator of
    `torch._higher_order_ops`, the counterpart of the JAX package's
    `lax.while_loop` (`darknet_tpu/ops/nms.py:179`): one node of the
    program that `torch.export` records, and its dense implementation, a
    Python loop, when called eagerly.  The operator is called itself, its
    tensors passed in, not through the public `while_loop`, which
    compiles its call with dynamo at every eager call."""
    from torch._higher_order_ops.while_loop import while_loop_op

    n = boxes.shape[1]
    a, b = boxes[:, :, None, :], boxes[:, None, :, :]
    if kind == "greedynms":
        sim = boxops.iou(a, b)
    else:
        sim = boxops.diou(a, b, beta)
    suppress = sim > thresh                                # (B,N,N) [i,j]
    pT = probs.transpose(1, 2)                             # (B,C,N)
    lt = torch.ones((n, n), dtype=torch.bool,
                    device=boxes.device).tril(-1)          # [i,j]: j < i
    pi, pj = pT[..., :, None], pT[..., None, :]
    P = ((pj > pi) | ((pj == pi) & lt)) & suppress[:, None]  # (B,C,N,N)
    active = pT > 0

    def step(K, active, P):
        return active & ~(P & K[..., None, :]).any(dim=-1)

    def unsettled(lo, hi, active, P):
        # called eagerly, the loop reads this flag on the host
        spans.count("host_syncs")
        return (lo != hi).any()

    first = [True]

    def round_(lo, hi, active, P):
        spans.count("nms_rounds")
        if first:
            # eagerly the loop reads its first flag twice (`if not`, then
            # `while`): one wait more
            spans.count("host_syncs")
            first.clear()
        # fresh tensors: a carried value returned as it came in is an
        # alias, which the loop's tracing refuses
        return lo | step(hi, active, P), hi & step(lo, active, P)

    lo, _hi = while_loop_op(unsettled, round_,
                            (torch.zeros_like(active), active.clone()),
                            (active, P))
    return torch.where(lo.transpose(1, 2), probs, torch.zeros_like(probs))
