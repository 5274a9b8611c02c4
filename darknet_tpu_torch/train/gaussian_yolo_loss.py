"""Gaussian-YOLO training delta (`darknet_tpu/train/gaussian_yolo_loss.py`,
gaussian_yolo_layer.cpp:519-860) as batched torch ops.

The two-phase structure of `train/yolo_loss.py` with 8 box entries, a
mean and a sigma per coordinate, and a Gaussian negative log-likelihood
gradient.  The JAX package's choices are kept:

* the per-coordinate NLL with sigma_const 0.3 and epsi 1e-9
  (delta_gaussian_yolo_box); `temp = 0.5 * normal / (normal + epsi) *
  scale` stays literal, so that a zero sigma gives the same non-finite
  values (then zeroed) as in the JAX package;
* with an IoU-family loss only the mean deltas become the DxIou gradient
  (yolo_point-adjusted, w/h times exp(mu)); the sigma deltas stay NLL;
* NaN guard and the max_delta clip on means and sigmas;
* the objectness and class writes go to the last candidate of a cell in
  the reference's loop order (priority t * total + n); box deltas sum;
* the class writes follow the JAX package's cell-wise form of the
  reference's "already set" guard (which reads class entry 0);
* no truth_thresh branch (the JAX package omits it: 1.0 in every known
  Gaussian cfg);
* box deltas divided by the count of hit classes, and the loss split of
  :775-840, whose "uncertainty" part counts mu_w and mu_h as well.

Inputs are NHWC; truths are (B, max_boxes, 5) [x, y, w, h, class], the
valid prefix ending at the first x == 0.
"""

from __future__ import annotations

import numpy as np
import torch

from darknet_tpu_torch.ops import boxes as boxops
from darknet_tpu_torch.ops.yolo import G_ENTRIES
from darknet_tpu_torch.train.yolo_loss import (_nan0, _one_hot,
                                               anchor_assignment,
                                               cell_constants, dx_box_iou,
                                               truth_iou_lattice)

_SIGMA_CONST = 0.3
_EPSI = 1e-9
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * np.pi)))     # f32, as JAX's


def _gaussian_box_delta(truth, box_v, pred, l, net_w, net_h, anchor_idx,
                        cell_i, cell_j, scale, iou_norm, uc_norm):
    """delta_gaussian_yolo_box over any leading dims.

    box_v: (..., 8) activated entries [mux, sigx, muy, sigy, muw, sigw,
    muh, sigh]; pred, truth (..., 4).  Returns (d_mu (..., 4) in x, y, w,
    h order, d_sig (..., 4), {"iou", "giou"})."""
    anchors = torch.tensor(l.anchors, dtype=torch.float32,
                           device=pred.device).reshape(-1, 2)
    aw, ah = anchors[anchor_idx, 0], anchors[anchor_idx, 1]
    ious = {"iou": boxops.iou(pred, truth), "giou": boxops.giou(pred, truth)}
    pw = torch.where(pred[..., 2] == 0, 1.0, pred[..., 2])
    ph = torch.where(pred[..., 3] == 0, 1.0, pred[..., 3])
    pred = torch.stack([pred[..., 0], pred[..., 1], pw, ph], -1)

    cx, cy = truth[..., 0], truth[..., 1]
    if l.yolo_point == "left_top":
        cx, cy = cx - truth[..., 2] / 2, cy - truth[..., 3] / 2
    elif l.yolo_point == "right_bottom":
        cx, cy = cx + truth[..., 2] / 2, cy + truth[..., 3] / 2
    tgt = torch.stack([cx * l.out_w - cell_i, cy * l.out_h - cell_j,
                       torch.log(truth[..., 2] * net_w / aw),
                       torch.log(truth[..., 3] * net_h / ah)], -1)
    mu, sig = box_v[..., 0::2], box_v[..., 1::2]

    d = tgt - mu
    in_exp = d / sig
    in_exp2 = torch.square(in_exp)
    normal = torch.exp(in_exp2 * -0.5) / (_SQRT_2PI * (sig + _SIGMA_CONST))
    temp = 0.5 * normal / (normal + _EPSI) * scale[..., None]
    d_mu = temp * in_exp / sig
    d_sig = temp * (in_exp2 / sig - 1.0 / (sig + _SIGMA_CONST))

    if l.iou_loss != "mse":
        gx, gy, gw, gh = dx_box_iou(pred, truth, l.iou_loss)
        if l.yolo_point == "left_top":
            gx, gy = gx - gw / 2, gy - gh / 2
        elif l.yolo_point == "right_bottom":
            gx, gy = gx + gw / 2, gy + gh / 2
        d_mu = torch.stack([gx, gy, gw * torch.exp(box_v[..., 4]),
                            gh * torch.exp(box_v[..., 6])], -1)

    d_mu = _nan0(d_mu * iou_norm[..., None])
    d_sig = _nan0(d_sig * uc_norm)
    if l.max_delta != float("inf"):
        d_mu = torch.clamp(d_mu, -l.max_delta, l.max_delta)
        d_sig = torch.clamp(d_sig, -l.max_delta, l.max_delta)
    return d_mu, d_sig, ious


@torch.no_grad()
def gaussian_yolo_head_delta(raw, truths, l, net_w: int, net_h: int):
    """The training delta of one [Gaussian_yolo] head.

    raw: (B, H, W, A*(9+C)) raw head conv output, f32; truths: (B, T, 5).
    Returns (delta (B,H,W,A*E), the gradient-ascent direction with respect
    to raw; cost (scalar tensor); metrics dict of scalar tensors)."""
    dev = raw.device
    e = G_ENTRIES + l.classes
    b, h, w, _ = raw.shape
    A, C, total = l.n, l.classes, l.total
    N = h * w * A
    T = truths.shape[1]
    truths = truths.float()

    # the inference activation, in the raw channel layout
    ch = torch.arange(A * e, device=dev) % e
    v = torch.where((ch == 4) | (ch == 6), raw, torch.sigmoid(raw))
    if l.scale_x_y != 1.0:
        v = torch.where((ch == 0) | (ch == 2),
                        v * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0), v)
    vf = v.reshape(b, N, e)
    cols, rows, awN, ahN = cell_constants(l, h, w, dev)
    cls_mults = (torch.tensor(l.classes_multipliers, dtype=torch.float32,
                              device=dev)
                 if l.classes_multipliers is not None else None)

    tx = truths[..., 0:4]                                    # (B,T,4)
    tcls = truths[..., 4].to(torch.int32)
    prefix = torch.cumprod((tx[..., 0] != 0).to(torch.int32), 1) == 1
    valid = prefix & (tcls >= 0) & (tcls < C)
    if l.class_map is not None:
        cmap = torch.tensor(l.class_map, dtype=torch.int32, device=dev)
        tcls = cmap[tcls.clamp(0, len(l.class_map) - 1).long()]
    tcls_l = tcls.long()
    cmul_t = (cls_mults[tcls_l.clamp(0, C - 1)] if cls_mults is not None
              else torch.ones((b, T), device=dev))

    # GetGaussianYoloBox as coordinate planes (B,N)
    pw = torch.exp(vf[..., 4]) * awN / net_w
    ph = torch.exp(vf[..., 6]) * ahN / net_h
    px = (cols + vf[..., 0]) / w
    py = (rows + vf[..., 2]) / h
    if l.yolo_point == "left_top":
        px, py = px + pw / 2, py + ph / 2
    elif l.yolo_point == "right_bottom":
        px, py = px - pw / 2, py - ph / 2
    obj = _nan0(vf[..., 8])
    cls_prob = vf[..., 9:]                                   # (B,N,C)

    # ---- phase 1: background objectness against the best truth
    best_iou = truth_iou_lattice(px, py, pw, ph, tx, valid).amax(
        1).clamp_min(0.0)                                    # (B,N)
    any_cls = (cls_prob > 0.25).any(-1)
    best_match_iou = torch.where(any_cls, best_iou, 0.0)
    d_obj = l.cls_normalizer * (0.0 - obj)
    d_obj = torch.where(best_match_iou > l.ignore_thresh, 0.0, d_obj)

    # ---- phase 2: per-truth assignment over the (T, total) lattice; the
    # anchor cell follows yolo_point
    cx, cy = tx[..., 0], tx[..., 1]
    if l.yolo_point == "left_top":
        cx, cy = cx - tx[..., 2] / 2, cy - tx[..., 3] / 2
    elif l.yolo_point == "right_bottom":
        cx, cy = cx + tx[..., 2] / 2, cy + tx[..., 3] / 2
    ti = (cx * w).to(torch.int32).clamp(0, w - 1).long()     # (B,T)
    tj = (cy * h).to(torch.int32).clamp(0, h - 1).long()
    apply, cell = anchor_assignment(tx, valid, ti, tj, l, net_w, net_h, w)
    fapply = apply.float()
    arange_tot = torch.arange(total, device=dev)
    state = torch.cat([torch.stack([px, py, pw, ph], -1), vf[..., 0:8],
                       obj[..., None]], -1)                  # (B,N,13)
    st_c = state.gather(1, cell[..., None].expand(-1, -1, 13)).reshape(
        b, T, total, 13)
    pred_c, box_v_c, obj_c = st_c[..., 0:4], st_c[..., 4:12], st_c[..., 12]
    cls_p_c = cls_prob.gather(1, cell[..., None].expand(-1, -1, C)).reshape(
        b, T, total, C)
    cid2 = tcls_l[..., None].expand(b, T, total)

    d_mu, d_sig, ious = _gaussian_box_delta(
        tx[:, :, None].expand(b, T, total, 4), box_v_c, pred_c, l, net_w,
        net_h, arange_tot.expand(b, T, total),
        ti[..., None].expand(b, T, total).float(),
        tj[..., None].expand(b, T, total).float(),
        (2.0 - tx[..., 2] * tx[..., 3])[..., None].expand(b, T, total),
        (l.iou_normalizer * cmul_t)[..., None].expand(b, T, total),
        l.uc_normalizer)
    # interleaved back into the entry order [mux, sigx, muy, sigy, ...]
    box_add = torch.stack([d_mu, d_sig], -1).reshape(b, T, total, 8)
    box_add = torch.where(apply[..., None], box_add, 0.0)
    # segment sums over the cells of the whole batch
    flat = (cell + torch.arange(b, device=dev)[:, None] * N).reshape(-1)
    d_box = torch.zeros((b * N, 8), device=dev).index_add_(
        0, flat, box_add.reshape(-1, 8)).reshape(b, N, 8)

    # objectness / class: the last writer in the reference's loop order
    prio = (torch.arange(T, device=dev)[:, None] * total + arange_tot + 1)
    prio = torch.where(apply, prio, 0).reshape(b, -1)
    win_prio = torch.zeros((b, N), dtype=torch.long,
                           device=dev).scatter_reduce(1, cell, prio, "amax")
    cell_hit = win_prio > 0
    win_t = (win_prio - 1).clamp(0, T * total - 1) // total
    win_cmul = cmul_t.gather(1, win_t)
    d_obj = torch.where(cell_hit, win_cmul * l.cls_normalizer * (1.0 - obj),
                        d_obj)

    class_hit = torch.zeros((b * N, C), device=dev).index_add_(
        0, flat, (_one_hot(cid2, C) * fapply[..., None]).reshape(-1, C)
    ).reshape(b, N, C) > 0
    eps_s = l.label_smooth_eps
    y1 = 1.0 * (1 - eps_s) + 0.5 * eps_s if eps_s else 1.0
    y0 = 0.5 * eps_s if eps_s else 0.0
    tgt = y1 - cls_prob
    if cls_mults is not None:
        tgt = tgt * cls_mults
    d_cls = torch.where(class_hit, tgt,
                        torch.where(cell_hit[..., None], y0 - cls_prob, 0.0))

    iou_c = ious["iou"]
    cat_c = cls_p_c.gather(-1, cid2.clamp(0, C - 1)[..., None])[..., 0]
    count = fapply.sum()
    tot = {"iou": (fapply * iou_c).sum(), "obj": (fapply * obj_c).sum(),
           "cat": (fapply * cat_c).sum(),
           "recall50": (fapply * (iou_c > 0.5)).sum(),
           "recall75": (fapply * (iou_c > 0.75)).sum()}

    # ---- phase 3: box deltas averaged over the classes a cell matched
    n_cls_hit = (d_cls > 0).float().sum(-1, keepdim=True)
    d_box = torch.where(n_cls_hit > 0, d_box / n_cls_hit.clamp_min(1.0),
                        d_box)
    delta = torch.cat([d_box, d_obj[..., None], d_cls], -1)  # (B,N,E)

    # the loss split (gaussian_yolo_layer.cpp:775-840): class_loss is
    # entries 8: (obj and classes); the "uncertainty" part is 4:8, mu_w
    # and mu_h included
    class_loss = delta[..., 8:].square().sum()
    sq_0_4 = delta[..., 0:4].square().sum()
    except_uc = sq_0_4 + class_loss
    full = sq_0_4 + delta[..., 4:8].square().sum() + class_loss
    cnt = count.clamp_min(1.0)
    metrics = {
        "loss": full / b, "class_loss": class_loss / b,
        "uc_loss": (full - except_uc) / b,
        "iou_loss": (except_uc - class_loss) / b,
        "avg_iou": tot["iou"] / cnt, "avg_obj": tot["obj"] / cnt,
        "avg_cat": tot["cat"] / cnt,
        "recall50": tot["recall50"] / cnt, "recall75": tot["recall75"] / cnt,
        "count": count,
    }
    return delta.reshape(b, h, w, A * e), full, metrics
