"""YOLO v3/v4 training delta (`darknet_tpu/train/yolo_loss.py:49-561`) as
batched torch ops.

The reference does not autodiff a scalar loss: it fills a `delta` array
(the gradient-ASCENT direction with respect to the head's raw conv
output) in a nested loop over truths and anchors (`yolo_layer.cpp:
430-692`).  This module computes the same deltas for the whole batch at
once, with the JAX package's semantics kept:

* background objectness with the ignore_thresh / truth_thresh scheme;
* per-truth anchor assignment by the best prior IoU plus the iou_thresh
  extra matches; box deltas by MSE or the IoU-family hand gradient
  (`dx_box_iou`, DxIou box.cpp:153-351, with its quirks);
* objectness and class writes resolved last-writer-wins by the
  priority t * total + n (the reference's loop order); box deltas
  summed; NaN guards; argmax ties to the first index;
* per-box delta averaging over matched classes and the cost assembly.

The deltas are cotangents, computed under `torch.no_grad()`.  Inputs are
NHWC; truths are (B, max_boxes, 5) [x, y, w, h, class], the valid prefix
ending at the first x == 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from darknet_tpu_torch.ops import boxes as boxops

_FLT_EPS = 1.19209290e-07


def _nan0(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _one_hot(idx, n):
    """One-hot rows; an index outside [0, n) gives a zero row (as
    jax.nn.one_hot does)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


def dx_box_iou(pred, truth, kind: str):
    """Box::DxIou (box.cpp:153-351) over any leading dims: the gradient of
    the IoU-family value with respect to pred's (x, y, w, h)."""
    px, py, pw, ph = pred.unbind(-1)
    gx, gy, gw, gh = truth.unbind(-1)
    pt = torch.minimum(py - ph / 2, py + ph / 2)
    pb = torch.maximum(py - ph / 2, py + ph / 2)
    pl = torch.minimum(px - pw / 2, px + pw / 2)
    pr = torch.maximum(px - pw / 2, px + pw / 2)
    gt_t, gt_b = gy - gh / 2, gy + gh / 2
    gt_l, gt_r = gx - gw / 2, gx + gw / 2

    X = (pb - pt) * (pr - pl)
    Xhat = (gt_b - gt_t) * (gt_r - gt_l)
    Ih = torch.minimum(pb, gt_b) - torch.maximum(pt, gt_t)
    Iw = torch.minimum(pr, gt_r) - torch.maximum(pl, gt_l)
    I = Iw * Ih
    U = X + Xhat - I
    S = (px - gx) ** 2 + (py - gy) ** 2
    giou_Cw = torch.maximum(pr, gt_r) - torch.minimum(pl, gt_l)
    giou_Ch = torch.maximum(pb, gt_b) - torch.minimum(pt, gt_t)
    giou_C = giou_Cw * giou_Ch

    dX_t, dX_b = -(pr - pl), (pr - pl)
    dX_l, dX_r = -(pb - pt), (pb - pt)
    dI_t = torch.where(pt > gt_t, -Iw, 0.0)
    dI_b = torch.where(pb < gt_b, Iw, 0.0)
    dI_l = torch.where(pl > gt_l, -Ih, 0.0)
    dI_r = torch.where(pr < gt_r, Ih, 0.0)
    dU_t, dU_b = dX_t - dI_t, dX_b - dI_b
    dU_l, dU_r = dX_l - dI_l, dX_r - dI_r
    dC_t = torch.where(pt < gt_t, -giou_Cw, 0.0)
    dC_b = torch.where(pb > gt_b, giou_Cw, 0.0)
    dC_l = torch.where(pl < gt_l, -giou_Ch, 0.0)
    dC_r = torch.where(pr > gt_r, giou_Ch, 0.0)

    Upos = U > 0
    U2 = torch.where(Upos, U * U, 1.0)
    p_dt = torch.where(Upos, (U * dI_t - I * dU_t) / U2, 0.0)
    p_db = torch.where(Upos, (U * dI_b - I * dU_b) / U2, 0.0)
    p_dl = torch.where(Upos, (U * dI_l - I * dU_l) / U2, 0.0)
    p_dr = torch.where(Upos, (U * dI_r - I * dU_r) / U2, 0.0)
    # corner swap for inverted boxes (box.cpp:209-212): the C swaps t with
    # the already-swapped b, so p_db keeps its value either way
    swap_tb = ~((py - ph / 2) < (py + ph / 2))
    swap_lr = ~((px - pw / 2) < (px + pw / 2))
    p_dt = torch.where(swap_tb, p_db, p_dt)
    p_dl = torch.where(swap_lr, p_dr, p_dl)

    no_inter = (Iw <= 0) | (Ih <= 0)
    if kind == "giou":
        Cpos = giou_C > 0
        C2 = torch.where(Cpos, giou_C * giou_C, 1.0)
        g_t = torch.where(Cpos, (giou_C * dU_t - U * dC_t) / C2, 0.0)
        g_b = torch.where(Cpos, (giou_C * dU_b - U * dC_b) / C2, 0.0)
        g_l = torch.where(Cpos, (giou_C * dU_l - U * dC_l) / C2, 0.0)
        g_r = torch.where(Cpos, (giou_C * dU_r - U * dC_r) / C2, 0.0)
        p_dt = torch.where(no_inter, g_t, p_dt + g_t)
        p_db = torch.where(no_inter, g_b, p_db + g_b)
        p_dl = torch.where(no_inter, g_l, p_dl + g_l)
        p_dr = torch.where(no_inter, g_r, p_dr + g_r)

    # edge gradients to center format (box.cpp:275-283)
    p_dx = p_dl + p_dr
    p_dy = p_dt + p_db
    p_dw = p_dr - p_dl
    p_dh = p_db - p_dt

    if kind in ("diou", "ciou"):
        Ct = torch.minimum(py - ph / 2, gy - gh / 2)
        Cb = torch.maximum(py + ph / 2, gy + gh / 2)
        Cl = torch.minimum(px - pw / 2, gx - gw / 2)
        Cr = torch.maximum(px + pw / 2, gx + gw / 2)
        Cw, Ch = Cr - Cl, Cb - Ct
        C = Cw ** 2 + Ch ** 2

        dCt_dy = torch.where(pt < gt_t, 1.0, 0.0)
        dCt_dh = torch.where(pt < gt_t, -0.5, 0.0)
        dCb_dy = torch.where(pb > gt_b, 1.0, 0.0)
        dCb_dh = torch.where(pb > gt_b, 0.5, 0.0)
        dCl_dx = torch.where(pl < gt_l, 1.0, 0.0)
        dCl_dw = torch.where(pl < gt_l, -0.5, 0.0)
        dCr_dx = torch.where(pr > gt_r, 1.0, 0.0)
        dCr_dw = torch.where(pr > gt_r, 0.5, 0.0)
        dCw_dx, dCw_dw = dCr_dx - dCl_dx, dCr_dw - dCl_dw
        dCh_dy, dCh_dh = dCb_dy - dCt_dy, dCb_dh - dCt_dh

        Cpos = C > 0
        C2 = torch.where(Cpos, C ** 2, 1.0)
        # the hand gradient is for beta = 1 whatever beta_nms is
        d_dx = (2 * (gx - px) * C - (2 * Cw * dCw_dx) * S) / C2
        d_dy = (2 * (gy - py) * C - (2 * Ch * dCh_dy) * S) / C2
        d_dw = (2 * Cw * dCw_dw) * S / C2
        d_dh = (2 * Ch * dCh_dh) * S / C2
        if kind == "ciou":
            inv_pi2 = 4.0 / (math.pi ** 2)
            d_atan = torch.atan(gw / gh) - torch.atan(pw / ph)
            ar_loss = inv_pi2 * d_atan ** 2
            alpha = ar_loss / (1 - I / U + ar_loss + 1e-6)
            # the simplified gradient the CIoU authors released
            d_dw = d_dw + alpha * (2 * inv_pi2 * d_atan * ph)
            d_dh = d_dh + alpha * (-2 * inv_pi2 * d_atan * pw)

        def mix(p, d):
            return torch.where(Cpos & no_inter, d,
                               torch.where(Cpos, p + d, p))
        p_dx, p_dy = mix(p_dx, d_dx), mix(p_dy, d_dy)
        p_dw, p_dh = mix(p_dw, d_dw), mix(p_dh, d_dh)
    return p_dx, p_dy, p_dw, p_dh


def _box_delta_terms(truth, pred, raw_wh, act_xy, cell_ij, l, net_w, net_h,
                     anchor_idx, scale, normalizer):
    """delta_yolo_box (yolo_layer.cpp:172-273) over any leading dims.
    truth/pred (...,4); raw_wh/act_xy (...,2); cell_ij float (i, j);
    anchor_idx indexes l.anchors.  Returns ((dx, dy, dw, dh), ious)."""
    i, j = cell_ij
    anchors = torch.tensor(l.anchors, dtype=torch.float32,
                           device=pred.device).reshape(-1, 2)
    aw, ah = anchors[anchor_idx, 0], anchors[anchor_idx, 1]
    ious = {"iou": boxops.iou(pred, truth), "giou": boxops.giou(pred, truth),
            "diou": boxops.diou(pred, truth, 0.6),
            "ciou": boxops.ciou(pred, truth)}
    # avoid nan in dx_box_iou (yolo_layer.cpp:184-191)
    pw = torch.where(pred[..., 2] == 0, 1.0, pred[..., 2])
    ph = torch.where(pred[..., 3] == 0, 1.0, pred[..., 3])
    pred = torch.stack([pred[..., 0], pred[..., 1], pw, ph], -1)
    if l.iou_loss == "mse":
        tx = truth[..., 0] * l.out_w - i
        ty = truth[..., 1] * l.out_h - j
        tw = torch.log(truth[..., 2] * net_w / aw)
        th = torch.log(truth[..., 3] * net_h / ah)
        return (scale * (tx - act_xy[..., 0]) * normalizer,
                scale * (ty - act_xy[..., 1]) * normalizer,
                scale * (tw - raw_wh[..., 0]) * normalizer,
                scale * (th - raw_wh[..., 1]) * normalizer), ious
    gx, gy, gw, gh = dx_box_iou(pred, truth, l.iou_loss)
    d = (_nan0(gx * normalizer), _nan0(gy * normalizer),
         _nan0(gw * torch.exp(raw_wh[..., 0]) * normalizer),
         _nan0(gh * torch.exp(raw_wh[..., 1]) * normalizer))
    if l.max_delta != float("inf"):
        d = tuple(torch.clamp(t, -l.max_delta, l.max_delta) for t in d)
    return d, ious


def _nan0_keep(new, old):
    """new where it is finite, else old (delta_yolo_class's NaN guard)."""
    return torch.where(torch.isfinite(new), new, old)


def cell_constants(l, h: int, w: int, dev):
    """Per-cell constants of the flat-N layout, N index = (j*W + i)*A + a:
    (column, row, anchor width, anchor height), each (N,) f32."""
    anchors_np = np.asarray(l.anchors, np.float32).reshape(-1, 2)
    n_idx = np.arange(h * w * l.n)
    a_of = np.asarray(l.mask, np.int64)[n_idx % l.n]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        ((n_idx // l.n) % w).astype(np.float32),
        (n_idx // (l.n * w)).astype(np.float32),
        anchors_np[a_of, 0], anchors_np[a_of, 1]))


def truth_iou_lattice(px, py, pw, ph, tx, valid):
    """IoU of every cell's box (coordinate planes (B,N)) against every
    truth (tx (B,T,4)), (B,T,N), in boxes.iou's order of operations; -1
    for the truths that are not valid."""
    pl, pr = px - pw / 2, px + pw / 2
    pt, pb = py - ph / 2, py + ph / 2
    txx, tyy = tx[..., 0:1], tx[..., 1:2]                    # (B,T,1)
    tww, thh = tx[..., 2:3], tx[..., 3:4]
    iw = (torch.minimum(pr[:, None], txx + tww / 2)
          - torch.maximum(pl[:, None], txx - tww / 2))
    ih = (torch.minimum(pb[:, None], tyy + thh / 2)
          - torch.maximum(pt[:, None], tyy - thh / 2))
    inter = torch.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    del iw, ih
    un = (pw * ph)[:, None] + tww * thh - inter
    safe = (inter.abs() >= _FLT_EPS) & (un.abs() >= _FLT_EPS)
    iou_all = torch.where(safe, inter / torch.where(safe, un, 1.0), 0.0)
    return torch.where(valid[..., None], iou_all, -1.0)


def anchor_assignment(tx, valid, ti, tj, l, net_w: int, net_h: int, w: int):
    """Each truth's anchors: the best prior by IoU of sizes, plus the
    iou_thresh extra matches, among the head's mask.  Returns (apply
    (B,T,total) bool, cell (B,T*total): the flat-N cell of truth t and
    anchor n at the truth's grid cell (ti, tj))."""
    dev = tx.device
    anchors_np = np.asarray(l.anchors, np.float32).reshape(-1, 2)
    prior = torch.cat([torch.zeros((l.total, 2)), torch.from_numpy(
        anchors_np / np.asarray([net_w, net_h], np.float32))], 1).to(dev)
    mask_pos = np.full((l.total,), -1, np.int64)
    for mi, mv in enumerate(l.mask):
        mask_pos[mv] = mi
    mask_pos = torch.from_numpy(mask_pos).to(dev)
    truth_shift = torch.cat([torch.zeros_like(tx[..., :2]), tx[..., 2:4]],
                            -1)                              # (B,T,4)
    prior_iou = boxops.iou(prior[None, None], truth_shift[:, :, None])
    best_n = prior_iou.argmax(-1)                            # (B,T)
    is_best = torch.arange(l.total, device=dev) == best_n[..., None]
    if l.iou_thresh < 1.0:
        kind_iou = boxops.iou_kind(prior[None, None], truth_shift[:, :, None],
                                   l.iou_thresh_kind)
        extra = ~is_best & (kind_iou > l.iou_thresh)
    else:
        extra = torch.zeros_like(is_best)
    apply = valid[..., None] & (mask_pos >= 0) & (is_best | extra)
    cell = ((tj * w + ti)[..., None] * l.n
            + mask_pos.clamp_min(0)).reshape(tx.shape[0], -1)
    return apply, cell


@torch.no_grad()
def yolo_head_delta(raw, truths, l, net_w: int, net_h: int):
    """The training delta of one [yolo] head.

    raw: (B, H, W, A*E) raw head conv output, f32; truths: (B, T, 5).
    Returns (delta (B,H,W,A*E), the gradient-ascent direction with respect
    to raw; cost (scalar tensor); metrics dict of scalar tensors)."""
    dev = raw.device
    e = 5 + l.classes
    b, h, w, _ = raw.shape
    A, C, total = l.n, l.classes, l.total
    N = h * w * A
    T = truths.shape[1]
    truths = truths.float()

    # the inference activation, in the raw channel layout
    ch = torch.arange(A * e, device=dev) % e
    v = torch.where((ch < 2) | (ch >= 4), torch.sigmoid(raw), raw)
    if l.scale_x_y != 1.0:
        v = torch.where(ch < 2, v * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0),
                        v)
    vf, vrf = v.reshape(b, N, e), raw.reshape(b, N, e)
    cols, rows, awN, ahN = cell_constants(l, h, w, dev)
    cls_mults = (torch.tensor(l.classes_multipliers, dtype=torch.float32,
                              device=dev)
                 if l.classes_multipliers is not None else None)

    tx = truths[..., 0:4]                                    # (B,T,4)
    tcls = truths[..., 4].to(torch.int32)
    prefix = torch.cumprod((tx[..., 0] != 0).to(torch.int32), 1) == 1
    valid = prefix & (tcls >= 0) & (tcls < C)
    if l.class_map is not None:
        # cfg map=: remaps ids for the class deltas only
        cmap = torch.tensor(l.class_map, dtype=torch.int32, device=dev)
        tcls = cmap[tcls.clamp(0, len(l.class_map) - 1).long()]
    tcls_l = tcls.long()
    cmul_t = (cls_mults[tcls_l.clamp(0, C - 1)] if cls_mults is not None
              else torch.ones((b, T), device=dev))

    # GetYoloBox as coordinate planes (B,N)
    px = (cols + vf[..., 0]) / w
    py = (rows + vf[..., 1]) / h
    pw = torch.exp(vrf[..., 2]) * awN / net_w
    ph = torch.exp(vrf[..., 3]) * ahN / net_h
    obj = _nan0(vf[..., 4])
    cls_prob = vf[..., 5:]                                   # (B,N,C)

    # ---- phase 1: background objectness against the best truth
    iou_all = truth_iou_lattice(px, py, pw, ph, tx, valid)
    best_iou = iou_all.amax(1).clamp_min(0.0)               # (B,N)
    best_t = iou_all.argmax(1)
    del iou_all
    any_cls = (cls_prob > 0.25).any(-1)
    best_match_iou = torch.where(any_cls, best_iou, 0.0)
    d_obj = l.cls_normalizer * (0.0 - obj)
    d_obj = torch.where(best_match_iou > l.ignore_thresh, 0.0, d_obj)
    d_box = torch.zeros((b, N, 4), device=dev)
    d_cls = torch.zeros((b, N, C), device=dev)

    if l.truth_thresh < 1.0:
        hit = best_iou > l.truth_thresh
        d_obj = torch.where(hit, l.cls_normalizer * (1.0 - obj), d_obj)
        bt_cls = tcls_l.gather(1, best_t)                    # (B,N)
        bt_box = tx.gather(1, best_t[..., None].expand(-1, -1, 4))
        cmul = (cls_mults[bt_cls.clamp(0, C - 1)] if cls_mults is not None
                else torch.ones_like(best_iou))
        onehot = _one_hot(bt_cls, C)
        eps = l.label_smooth_eps
        full = (onehot * (1 - eps) + 0.5 * eps if eps else onehot) - cls_prob
        if cls_mults is not None:
            full = torch.where(onehot > 0, full * cmul[..., None], full)
        d_cls = torch.where(hit[..., None], full, d_cls)
        (ddx, ddy, ddw, ddh), _ = _box_delta_terms(
            bt_box, torch.stack([px, py, pw, ph], -1), vrf[..., 2:4],
            vf[..., 0:2], (cols, rows), l, net_w, net_h,
            torch.tensor(l.mask, device=dev).repeat(h * w),
            2.0 - bt_box[..., 2] * bt_box[..., 3],
            l.iou_normalizer * cmul)
        d_box = d_box + torch.where(hit[..., None],
                                    torch.stack([ddx, ddy, ddw, ddh], -1),
                                    0.0)

    # ---- phase 2: per-truth assignment over the (T, total) lattice
    ti = (tx[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()  # (B,T)
    tj = (tx[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
    apply, cell = anchor_assignment(tx, valid, ti, tj, l, net_w, net_h, w)
    fapply = apply.float()
    arange_tot = torch.arange(total, device=dev)
    state = torch.cat([torch.stack([px, py, pw, ph], -1), vrf[..., 2:4],
                       vf[..., 0:2], obj[..., None]], -1)    # (B,N,9)
    st_c = state.gather(1, cell[..., None].expand(-1, -1, 9)).reshape(
        b, T, total, 9)
    pred_c, raw_wh_c, act_xy_c, obj_c = (st_c[..., 0:4], st_c[..., 4:6],
                                         st_c[..., 6:8], st_c[..., 8])
    cls_p_c = cls_prob.gather(1, cell[..., None].expand(-1, -1, C)).reshape(
        b, T, total, C)
    cid2 = tcls_l[..., None].expand(b, T, total)
    ti2 = ti[..., None].expand(b, T, total).float()
    tj2 = tj[..., None].expand(b, T, total).float()

    (ddx, ddy, ddw, ddh), ious = _box_delta_terms(
        tx[:, :, None].expand(b, T, total, 4), pred_c, raw_wh_c, act_xy_c,
        (ti2, tj2), l, net_w, net_h, arange_tot.expand(b, T, total),
        (2.0 - tx[..., 2] * tx[..., 3])[..., None],
        (l.iou_normalizer * cmul_t)[..., None])
    box_add = torch.where(apply[..., None],
                          torch.stack([ddx, ddy, ddw, ddh], -1), 0.0)
    d_box = d_box.scatter_add(1, cell[..., None].expand(-1, -1, 4),
                              box_add.reshape(b, -1, 4))

    # objectness / class: the last writer in the reference's loop order
    prio = (torch.arange(T, device=dev)[:, None] * total + arange_tot + 1)
    prio = torch.where(apply, prio, 0).reshape(b, -1)
    win_prio = torch.zeros((b, N), dtype=torch.long, device=dev).scatter_reduce(
        1, cell, prio, "amax")
    cell_hit = win_prio > 0
    win_t = (win_prio - 1).clamp(0, T * total - 1) // total
    win_cmul = cmul_t.gather(1, win_t)
    win_cid = tcls_l.gather(1, win_t)
    d_obj = torch.where(cell_hit, win_cmul * l.cls_normalizer * (1.0 - obj),
                        d_obj)

    class_hit = torch.zeros((b, N, C), device=dev).scatter_add(
        1, cell[..., None].expand(-1, -1, C),
        (_one_hot(cid2, C) * fapply[..., None]).reshape(b, -1, C)) > 0
    eps_s = l.label_smooth_eps
    y1 = 1.0 * (1 - eps_s) + 0.5 * eps_s if eps_s else 1.0
    y0 = 0.5 * eps_s if eps_s else 0.0
    if l.focal_loss:
        alpha = 0.5
        p_t = cls_prob.gather(-1, win_cid.clamp(0, C - 1)[..., None])[
            ..., 0] + 1e-15
        grad = -(1 - p_t) * (2 * p_t * torch.log(p_t) + p_t - 1)
        focal = (_one_hot(win_cid, C) - cls_prob) * (alpha * grad)[..., None]
        d_cls = torch.where(cell_hit[..., None], focal, d_cls)
    else:
        tgt = _nan0_keep(y1 - cls_prob, d_cls)
        if cls_mults is not None:
            tgt = tgt * cls_mults
        rest = _nan0_keep(y0 - cls_prob, d_cls)
        d_cls = torch.where(class_hit, tgt,
                            torch.where(cell_hit[..., None], rest, d_cls))

    iou_c = ious["iou"]
    cat_c = cls_p_c.gather(-1, cid2.clamp(0, C - 1)[..., None])[..., 0]
    count = fapply.sum()
    tot = {"iou": (fapply * iou_c).sum(),
           "giou_loss": (fapply * (1.0 - ious["giou"])).sum(),
           "iou_loss": (fapply * (1.0 - iou_c)).sum(),
           "obj": (fapply * obj_c).sum(), "cat": (fapply * cat_c).sum(),
           "recall50": (fapply * (iou_c > 0.5)).sum(),
           "recall75": (fapply * (iou_c > 0.75)).sum()}

    # ---- phase 3: box deltas averaged over the classes a cell matched
    n_cls_hit = (d_cls > 0).float().sum(-1, keepdim=True)
    d_box = torch.where(n_cls_hit > 0, d_box / n_cls_hit.clamp_min(1.0),
                        d_box)
    delta = torch.cat([d_box, d_obj[..., None], d_cls], -1)  # (B,N,E)

    cnt = count.clamp_min(1.0)
    classification_loss = l.cls_normalizer * delta[..., 4:].square().sum()
    full_loss = delta.square().sum()
    if l.iou_loss == "mse":
        cost = full_loss
    else:
        key = "giou_loss" if l.iou_loss == "giou" else "iou_loss"
        cost = l.iou_normalizer * (tot[key] / cnt) + classification_loss
    metrics = {
        "avg_iou": tot["iou"] / cnt, "avg_obj": tot["obj"] / cnt,
        "avg_anyobj": obj.sum() / (h * w * A * b),
        "avg_cat": tot["cat"] / cnt,
        "recall50": tot["recall50"] / cnt, "recall75": tot["recall75"] / cnt,
        "count": count, "loss": full_loss / b,
        "class_loss": classification_loss / b,
        "iou_loss": (full_loss - classification_loss) / b,
    }
    return delta.reshape(b, h, w, A * e), cost, metrics
