"""Box similarity (`darknet_tpu/ops/boxes.py`): IoU, GIoU, DIoU and CIoU
on center-format (x, y, w, h) boxes, with the reference's degenerate-box
rules (0 when the intersection or the union is below FLT_EPSILON; plain
IoU where the enclosing box is degenerate)."""

from __future__ import annotations

import math

import torch

_EPS = 1.19209290e-07  # FLT_EPSILON


def _edges(b):
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return x - w / 2, x + w / 2, y - h / 2, y + h / 2


def intersection(a, b):
    al, ar, at, ab_ = _edges(a)
    bl, br, bt, bb = _edges(b)
    w = torch.minimum(ar, br) - torch.maximum(al, bl)
    h = torch.minimum(ab_, bb) - torch.maximum(at, bt)
    return torch.where((w < 0) | (h < 0), torch.zeros_like(w), w * h)


def union(a, b):
    return a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - intersection(a, b)


def iou(a, b):
    i = intersection(a, b)
    u = union(a, b)
    safe = (i.abs() >= _EPS) & (u.abs() >= _EPS)
    return torch.where(safe, i / torch.where(safe, u, torch.ones_like(u)),
                       torch.zeros_like(i))


def _enclose_wh(a, b):
    al, ar, at, ab_ = _edges(a)
    bl, br, bt, bb = _edges(b)
    return (torch.maximum(ar, br) - torch.minimum(al, bl),
            torch.maximum(ab_, bb) - torch.minimum(at, bt))


def _safe_div(n, d, safe):
    return torch.where(safe, n / torch.where(safe, d, torch.ones_like(d)),
                       torch.zeros_like(n))


def giou(a, b):
    w, h = _enclose_wh(a, b)
    c = w * h
    i = iou(a, b)
    safe = c.abs() >= _EPS
    return torch.where(safe, i - _safe_div(c - union(a, b), c, safe), i)


def diou(a, b, beta: float = 0.6):
    w, h = _enclose_wh(a, b)
    c = w * w + h * h
    i = iou(a, b)
    d = (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
    safe = c.abs() >= _EPS
    term = torch.pow(torch.clamp_min(_safe_div(d, c, safe), 0.0), beta)
    return torch.where(safe, i - term, i)


def ciou(a, b):
    w, h = _enclose_wh(a, b)
    c = w * w + h * h
    i = iou(a, b)
    u = (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
    safe = c.abs() >= _EPS
    d = _safe_div(u, c, safe)
    ar_gt = b[..., 2] / torch.clamp_min(b[..., 3], _EPS)
    ar_pred = a[..., 2] / torch.clamp_min(a[..., 3], _EPS)
    ar_loss = (4.0 / (math.pi ** 2)) * (torch.atan(ar_gt)
                                        - torch.atan(ar_pred)) ** 2
    alpha = ar_loss / (1.0 - i + ar_loss + 1e-6)
    return torch.where(safe, i - (d + alpha * ar_loss), i)


def rmse(a, b):
    return torch.sqrt(((a - b) ** 2).sum(-1))


IOU_FNS = {"iou": iou, "giou": giou, "diou": diou, "ciou": ciou,
           "mse": rmse}


def iou_kind(a, b, kind: str):
    return IOU_FNS[kind](a, b)
