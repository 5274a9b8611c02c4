"""[yolo] and [Gaussian_yolo] head activation and box decode
(`darknet_tpu/ops/yolo.py:33-189`).

The head conv emits NHWC (B, H, W, A*E), channel a*E + e holding entry e
of anchor a (E = 5 + classes for [yolo]).  Activation: logistic on x, y
(then the scale_x_y affine), obj and classes; w, h stay raw.  Decode gives
relative center-format boxes bx=(col+x)/W, by=(row+y)/H,
bw=exp(tw)*anchor_w/net_w, bh=exp(th)*anchor_h/net_h.

A Gaussian head interleaves a mean and a sigma per coordinate:
[mu_x, sig_x, mu_y, sig_y, mu_w, sig_w, mu_h, sig_h, obj, cls...]
(E = 9 + classes).  Logistic on everything but mu_w and mu_h, scale_x_y
on mu_x and mu_y only; the decode returns the four sigmas as `uc`, scales
the class probabilities by 1 - mean(uc), and shifts the box centre by
half a box for yolo_point left_top / right_bottom.
"""

from __future__ import annotations

import torch

from darknet_tpu_torch.utils import spans


def yolo_activate(x, l):
    e = 5 + l.classes
    b, h, w, c = x.shape
    assert c == l.n * e, (c, l.n, e)
    v = x.reshape(b, h, w, l.n, e)
    xy = torch.sigmoid(v[..., 0:2])
    if l.scale_x_y != 1.0:
        xy = xy * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0)
    out = torch.cat([xy, v[..., 2:4], torch.sigmoid(v[..., 4:])], dim=-1)
    return out.reshape(x.shape)


def _grid(l, h: int, w: int, dev):
    """(cols, rows, anchor w, anchor h), broadcastable to (B, H, W, A)."""
    f32 = torch.float32
    cols = torch.arange(w, dtype=f32, device=dev)[None, None, :, None]
    rows = torch.arange(h, dtype=f32, device=dev)[None, :, None, None]
    anchors = torch.tensor(l.anchors, dtype=f32).reshape(-1, 2)
    sel = anchors[torch.tensor(list(l.mask), dtype=torch.long)]
    spans.count_copy(sel, dev)
    sel = sel.to(dev)
    return cols, rows, sel[:, 0][None, None, None, :], \
        sel[:, 1][None, None, None, :]


def _flatten(order: str, *parts):
    """(B, H, W, A, ...) tensors flattened to (B, N, ...): (H, W, A) as
    stored for order="native", anchor-major (A, H, W) for "reference"."""
    out = []
    for t in parts:
        b, rest = t.shape[0], t.shape[4:]
        if order != "native":
            t = t.permute(0, 3, 1, 2, *range(4, t.dim()))
        out.append(t.reshape(b, -1, *rest))
    return tuple(out)


def yolo_decode(activated, l, net_w: int, net_h: int,
                order: str = "reference", score_dtype=None):
    """Activated head -> (boxes (B,N,4), obj (B,N), cls (B,N,classes)).

    order="reference" flattens anchor-major then row-major, as the
    reference's GetYoloDetections loop; order="native" flattens (H, W, A)
    as stored, for the serving path where the order is immaterial ahead
    of the top-k.  score_dtype casts obj/cls only; boxes stay f32."""
    e = 5 + l.classes
    b, h, w, _ = activated.shape
    v = activated.reshape(b, h, w, l.n, e)
    f32 = torch.float32
    cols, rows, aw, ah = _grid(l, h, w, activated.device)
    bx = (cols + v[..., 0].to(f32)) / w
    by = (rows + v[..., 1].to(f32)) / h
    bw = torch.exp(v[..., 2].to(f32)) * aw / net_w
    bh = torch.exp(v[..., 3].to(f32)) * ah / net_h
    obj = v[..., 4]
    cls = v[..., 5:]
    if score_dtype is not None:
        obj = obj.to(score_dtype)
        cls = cls.to(score_dtype)
    return _flatten(order, torch.stack([bx, by, bw, bh], dim=-1), obj, cls)


G_ENTRIES = 9            # mu/sigma for x, y, w, h, then obj


def gaussian_yolo_activate(x, l):
    """ForwardGaussianYoloLayer's inference activation: logistic on every
    entry but mu_w (4) and mu_h (6), the scale_x_y affine on mu_x (0) and
    mu_y (2)."""
    e = G_ENTRIES + l.classes
    b, h, w, c = x.shape
    assert c == l.n * e, (c, l.n, e)
    v = x.reshape(b, h, w, l.n, e)
    ent = torch.arange(e, device=x.device)
    out = torch.where((ent == 4) | (ent == 6), v, torch.sigmoid(v))
    if l.scale_x_y != 1.0:
        out = torch.where((ent == 0) | (ent == 2),
                          out * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0), out)
    return out.reshape(x.shape)


def gaussian_yolo_decode(activated, l, net_w: int, net_h: int,
                         order: str = "reference", score_dtype=None):
    """Activated Gaussian head -> (boxes (B,N,4), obj (B,N),
    cls (B,N,classes), uc (B,N,4)): uc the four sigmas in f32, cls already
    scaled by 1 - mean(uc) (GetGaussianYoloDetections; the caller
    multiplies by obj).  order and score_dtype as in yolo_decode; the
    scaling is done in f32 before the cast."""
    e = G_ENTRIES + l.classes
    b, h, w, _ = activated.shape
    v = activated.reshape(b, h, w, l.n, e).float()
    cols, rows, aw, ah = _grid(l, h, w, activated.device)
    bw = torch.exp(v[..., 4]) * aw / net_w
    bh = torch.exp(v[..., 6]) * ah / net_h
    bx = (cols + v[..., 0]) / w
    by = (rows + v[..., 2]) / h
    if l.yolo_point == "left_top":
        bx = bx + bw / 2
        by = by + bh / 2
    elif l.yolo_point == "right_bottom":
        bx = bx - bw / 2
        by = by - bh / 2
    obj = v[..., 8]
    uc = v[..., 1:8:2]                                   # the sigmas
    cls = v[..., 9:] * (1.0 - uc.mean(-1, keepdim=True))
    if score_dtype is not None:
        obj = obj.to(score_dtype)
        cls = cls.to(score_dtype)
    return _flatten(order, torch.stack([bx, by, bw, bh], dim=-1), obj, cls,
                    uc)
