"""The YOLOv1 [detection] head and the [cost] layer
(`darknet_tpu/ops/detection_v1.py`, detection_layer.cpp:47-256,
cost_layer.c:64-87) in torch.

A [detection] head's output per image is flat, S = side*side cells of
`num` boxes: ``[S*classes class probs][S*num confidences][S*num*4 boxes]``.
Its training truth is a grid, (B, S, 1+classes+4): [is_obj, one-hot
classes, x, y, w, h] with x, y relative to the cell, times side.
"""

from __future__ import annotations

import numpy as np
import torch

from darknet_tpu_torch.ops import boxes as boxops


def _split(flat, l):
    b = flat.shape[0]
    S = l.side * l.side
    n, classes = l.num, l.classes
    cls = flat[:, :S * classes].reshape(b, S, classes)
    conf = flat[:, S * classes:S * (classes + n)].reshape(b, S, n)
    boxes = flat[:, S * (classes + n):].reshape(b, S, n, 4)
    return cls, conf, boxes


def _cell_rows_cols(l, device):
    S = l.side * l.side
    idx = torch.arange(S, device=device)
    return (idx // l.side).float(), (idx % l.side).float()


def detection_decode(flat, l):
    """(B, outputs) -> (boxes (B, S*n, 4) relative centre format,
    confidences (B, S*n), class probs (B, S*n, classes))
    (GetDetectionDetections:226-256): x = (px + col) / side, w = pw^2
    with sqrt."""
    b = flat.shape[0]
    S, n = l.side * l.side, l.num
    cls, conf, boxes = _split(flat, l)
    rows, cols = _cell_rows_cols(l, flat.device)
    bx = (boxes[..., 0] + cols[None, :, None]) / l.side
    by = (boxes[..., 1] + rows[None, :, None]) / l.side
    bw = boxes[..., 2].square() if l.sqrt else boxes[..., 2]
    bh = boxes[..., 3].square() if l.sqrt else boxes[..., 3]
    out_boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(b, S * n, 4)
    out_cls = cls[:, :, None, :].expand(b, S, n, l.classes).reshape(
        b, S * n, l.classes)
    return out_boxes, conf.reshape(b, S * n), out_cls


def encode_v1_truth(box_list, l):
    """A packed (T, 5) [x, y, w, h, cls] box list (numpy) -> the v1 grid
    truth (S, 1+classes+4); the first box of a cell wins, and the list
    ends at the first x == 0."""
    S = l.side * l.side
    out = np.zeros((S, 1 + l.classes + 4), np.float32)
    for t in range(box_list.shape[0]):
        x, y, w, h, cid = box_list[t]
        if x == 0:
            break
        col = min(int(x * l.side), l.side - 1)
        row = min(int(y * l.side), l.side - 1)
        cell = row * l.side + col
        if out[cell, 0]:
            continue
        out[cell, 0] = 1
        out[cell, 1 + int(cid)] = 1
        out[cell, 1 + l.classes + 0] = x * l.side - col
        out[cell, 1 + l.classes + 1] = y * l.side - row
        out[cell, 1 + l.classes + 2] = w
        out[cell, 1 + l.classes + 3] = h
    return out


def encode_v1_truth_batch(truths, l):
    """Batched (B, T, 5) box lists -> (B, S, 1+classes+4) grid truths on
    their device, as `encode_v1_truth` per image (a box with x == 0 is
    padding and skipped): the boxes are written last to first, so the
    first box of a cell lands last."""
    b, t_max, _ = truths.shape
    S = l.side * l.side
    truths = truths.float()
    bi = torch.arange(b, device=truths.device)
    classes = torch.arange(l.classes, device=truths.device)
    out = truths.new_zeros((b, S, 1 + l.classes + 4))
    for t in range(t_max - 1, -1, -1):
        x, y, w, h = (truths[:, t, k] for k in range(4))
        col = (x * l.side).to(torch.int32).clamp(0, l.side - 1)
        row = (y * l.side).to(torch.int32).clamp(0, l.side - 1)
        cell = (row * l.side + col).long()
        vals = torch.cat([
            torch.ones_like(x)[:, None],
            (truths[:, t, 4].to(torch.int32)[:, None] == classes).float(),
            (x * l.side - col)[:, None], (y * l.side - row)[:, None],
            w[:, None], h[:, None]], dim=1)
        out[bi, cell] = torch.where((x > 0)[:, None], vals, out[bi, cell])
    return out


def detection_head_delta(flat, truth, l, best=None):
    """The [detection] training delta (ForwardDetectionLayer:47-216),
    vectorised: flat (B, outputs), truth (B, S, 1+classes+4).  Returns
    (delta (B, outputs), cost, metrics {"loss", "avg_iou", "count"}).

    The responsible box of a cell is the best IoU, or the best RMSE where
    none overlaps; `forced` takes box 1 for small truths, else 0.  `best`
    (B, S) overrides the choice: the reference's early-training random
    pick (`l->random && seen < 64000`) is drawn by the caller."""
    B = flat.shape[0]
    n = l.num
    cls, conf, pbox = _split(flat, l)
    is_obj = truth[..., 0] > 0
    t_cls = truth[..., 1:1 + l.classes]
    t_box = truth[..., 1 + l.classes:]

    d_conf = l.noobject_scale * (0.0 - conf)
    d_cls = torch.where(is_obj[..., None], l.class_scale * (t_cls - cls),
                        0.0)

    rows, cols = _cell_rows_cols(l, flat.device)
    truth_abs = torch.stack([
        (t_box[..., 0] + cols[None, :]) / l.side,
        (t_box[..., 1] + rows[None, :]) / l.side,
        t_box[..., 2], t_box[..., 3]], dim=-1)
    pw = pbox[..., 2].square() if l.sqrt else pbox[..., 2]
    ph = pbox[..., 3].square() if l.sqrt else pbox[..., 3]
    pred_abs = torch.stack([
        (pbox[..., 0] + cols[None, :, None]) / l.side,
        (pbox[..., 1] + rows[None, :, None]) / l.side,
        pw, ph], dim=-1)

    ious = boxops.iou(pred_abs, truth_abs[:, :, None, :])
    rmses = boxops.rmse(pred_abs, truth_abs[:, :, None, :])
    if best is None:
        best = torch.where((ious > 0).any(-1), ious.argmax(-1),
                           rmses.argmin(-1))
        if l.forced:
            best = ((t_box[..., 2] * t_box[..., 3]) < 0.1).long()
    best = best.long()

    onehot_best = best[..., None] == torch.arange(n, device=flat.device)
    best_iou = torch.gather(ious, -1, best[..., None])[..., 0]
    best_conf = torch.gather(conf, -1, best[..., None])[..., 0]
    obj_target = best_iou if l.rescore else 1.0
    d_conf_obj = l.object_scale * (obj_target - best_conf)
    d_conf = torch.where(is_obj[..., None] & onehot_best,
                         d_conf_obj[..., None], d_conf)

    t_for_box = t_box
    if l.sqrt:
        t_for_box = torch.cat([t_box[..., :2], t_box[..., 2:].sqrt()], -1)
    d_box = l.coord_scale * (t_for_box[:, :, None, :] - pbox)
    d_box = torch.where((is_obj[..., None] & onehot_best)[..., None],
                        d_box, 0.0)

    delta = torch.cat([d_cls.reshape(B, -1), d_conf.reshape(B, -1),
                       d_box.reshape(B, -1)], dim=1)
    cost = delta.square().sum()
    count = is_obj.sum().float()
    metrics = {
        "loss": cost / B,
        "avg_iou": torch.where(is_obj, best_iou, 0.0).sum()
        / count.clamp_min(1.0),
        "count": count,
    }
    return delta, cost, metrics


SECRET_NUM = -1234.0


def cost_layer(x, truth, kind: str = "sse", ratio: float = 0.0):
    """[cost] (cost_layer.c:64-87): returns (cost, delta), delta = truth
    - x (the ascent direction) for sse (the loss d^2, delta 2d), smooth
    L1 ("smooth") and "masked" (entries whose truth is SECRET_NUM count
    as exact).  `ratio` is not used by these kinds, as in the reference's
    forward."""
    if kind == "masked":
        x = torch.where(truth == SECRET_NUM, SECRET_NUM, x)
    d = truth - x
    if kind == "smooth":
        ad = d.abs()
        loss = torch.where(ad < 1, 0.5 * d * d, ad - 0.5)
        delta = torch.where(ad < 1, d, d.sign())
    else:
        loss = d * d
        delta = 2 * d
    return loss.sum(), delta
