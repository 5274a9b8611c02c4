"""The serving program's postprocess, plainly: the objectness threshold,
a stable top-k, the class scores and darknet's greedy per-class NMS
(box.cpp do_nms_sort: visit in descending score, ties by index; a
surviving box zeroes every later one whose IoU exceeds the threshold)."""

from __future__ import annotations

import torch

FLT_EPSILON = 1.19209290e-07


def iou(a, b):
    """IoU of centre-format boxes, 0 where the intersection or the union
    is below FLT_EPSILON (box.cpp box_iou)."""
    al, ar = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    at, ab = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bl, br = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    bt, bb = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    w = torch.minimum(ar, br) - torch.maximum(al, bl)
    h = torch.minimum(ab, bb) - torch.maximum(at, bt)
    inter = torch.where((w < 0) | (h < 0), torch.zeros_like(w), w * h)
    uni = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    ok = (inter.abs() >= FLT_EPSILON) & (uni.abs() >= FLT_EPSILON)
    return torch.where(ok, inter / torch.where(ok, uni, torch.ones_like(uni)),
                       torch.zeros_like(inter))


def greedy_nms(boxes, probs, thresh: float):
    """boxes (B,K,4), probs (B,K,C) -> probs with the suppressed zeroed."""
    b, k, c = probs.shape
    sim = iou(boxes[:, :, None], boxes[:, None, :])            # (B,K,K)
    p = probs.transpose(1, 2)                                  # (B,C,K)
    order = torch.sort(p, dim=-1, descending=True, stable=True).indices
    # similarity in each class's visiting order: s[b,c,r,q]
    rows = torch.gather(sim[:, None].expand(b, c, k, k), 2,
                        order[..., None].expand(b, c, k, k))
    s = torch.gather(rows, 3, order[:, :, None, :].expand(b, c, k, k))
    alive = torch.gather(p, 2, order) > 0
    later = torch.ones(k, k, dtype=torch.bool, device=p.device).triu(1)
    for r in range(k):
        hit = alive[..., r:r + 1] & (s[:, :, r] > thresh) & later[r]
        alive = alive & ~hit
    keep = torch.zeros_like(alive).scatter(2, order, alive)
    return torch.where(keep.transpose(1, 2), probs, torch.zeros_like(probs))


def serve(boxes, obj, cls, *, thresh: float, nms: float, top_k: int):
    """Candidates -> the served triple (boxes (B,K,4), objectness (B,K),
    probs (B,K,C))."""
    obj = torch.where(obj > thresh, obj, torch.zeros_like(obj))
    k = min(top_k, obj.shape[1])
    ov, idx = torch.sort(obj, dim=1, descending=True, stable=True)
    ov, idx = ov[:, :k], idx[:, :k]
    tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    tc = torch.gather(cls, 1, idx[..., None].expand(-1, -1, cls.shape[-1]))
    probs = ov[..., None] * tc
    probs = torch.where(probs > thresh, probs, torch.zeros_like(probs))
    if nms > 0:
        probs = greedy_nms(tb, probs, nms)
    return tb, ov, probs
