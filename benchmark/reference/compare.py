"""The comparison that decides `correct` for a detector's served triples.

Each sampled request's triple (boxes, objectness, probs) from the timed
path is held to the reference's, image by image.  Near-ties, where the
order of two scores or a score against a threshold turns on rounding,
may go either way; each number is built so that they cost little:

* box_gap: for every served entry, the nearest reference candidate in
  (x, y, log w, log h, objectness), by the largest coordinate gap, the
  centre's gaps counted in cells of the candidate's own grid: a served
  box that no candidate of the image explains reads large.  A box one
  cell off reads 1; the logarithms make a size's gap its logit's,
  whatever the anchor; the candidates' objectness is taken before the
  threshold.
* prob_gap: for every served class score above zero, the least gap to
  that class's score (objectness times class probability) of the
  candidates within `box_tol` (the cell's box_gap limit) of its entry
  by box_gap's measure: a score that no candidate near its box gives.
* cell_gap: for each image, the median over its served entries of the
  least gap, by box_gap's measure, to a reference candidate whose centre
  lies in the same cell of its grid as the entry's; the largest over
  the images.  Rounding moves few entries far, and a candidate of
  another cell cannot stand in for the entry's own: answers of another
  frame read the content's difference, not the rounding's.
* kept_miss: the share of decisive kept (box, class) pairs that the
  other side leaves without a kept pair of the same class overlapping it
  by more than the NMS threshold (served against the reference's, and
  back).  A pair is decisive where its score clears the threshold by
  MARGIN and its entry's objectness clears the reference's k-th largest
  by MARGIN, so that rounding decides neither the threshold nor the
  top-k; an NMS near-tie keeps another box of the same cluster, which
  overlaps.
* nms_overlap: kept pairs of one class in one served image that overlap
  by more than the NMS threshold (plus IOU_SLACK for rounding), of which
  greedy NMS leaves none (exact, limit 0).
* malformed: requests whose triple has the wrong shape or a value that
  is not finite (exact, limit 0).
"""

from __future__ import annotations

import torch

BIG = 1e30           # what a gap that is not a finite number reads
MARGIN = 0.1         # how far above the threshold a kept score is decisive
IOU_SLACK = 1e-4     # rounding in an IoU computed on another device
CHUNK = 64


def well_formed(triple, batch: int, top_k: int, classes: int) -> bool:
    tb, ov, probs = triple
    return (tuple(tb.shape) == (batch, top_k, 4)
            and tuple(ov.shape) == (batch, top_k)
            and tuple(probs.shape) == (batch, top_k, classes)
            and all(bool(torch.isfinite(t.float()).all())
                    for t in (tb, ov, probs)))


def _log_wh(b):
    return torch.cat([b[..., :2], torch.log(b[..., 2:])], -1)


def _nearest(q, cand, scale):
    """For each row of q (E,D): the L-inf distance, each coordinate's
    gap times scale (N,D), to every row of cand (N,D), chunk by chunk:
    yields (first row, distances (e,N))."""
    for i in range(0, q.shape[0], CHUNK):
        d = ((q[i:i + CHUNK, None, :] - cand[None]).abs() * scale).amax(-1)
        yield i, torch.nan_to_num(d, nan=BIG, posinf=BIG)


def _cell_nearest(q, cand, scale):
    """For each row of q: its least distance (as `_nearest`) to the rows
    of cand whose centre lies in the same cell of the candidate's own
    grid as the row's centre, BIG where none does."""
    cell = torch.floor(cand[:, :2] * scale[:, :2])
    out = []
    for i, d in _nearest(q, cand, scale):
        same = (torch.floor(q[i:i + CHUNK, None, :2] * scale[None, :, :2])
                == cell[None]).all(-1)
        out.append(torch.where(same, d, torch.full_like(d, BIG)).min(1).values)
    return torch.cat(out) if out else torch.zeros(0, device=q.device)


def _iou(a, b):
    """IoU of every centre-format box of a (P,4) with every box of b."""
    al, ar = a[:, None, 0] - a[:, None, 2] / 2, a[:, None, 0] + a[:, None, 2] / 2
    at, ab = a[:, None, 1] - a[:, None, 3] / 2, a[:, None, 1] + a[:, None, 3] / 2
    bl, br = b[None, :, 0] - b[None, :, 2] / 2, b[None, :, 0] + b[None, :, 2] / 2
    bt, bb = b[None, :, 1] - b[None, :, 3] / 2, b[None, :, 1] + b[None, :, 3] / 2
    w = (torch.minimum(ar, br) - torch.maximum(al, bl)).clamp_min(0)
    h = (torch.minimum(ab, bb) - torch.maximum(at, bt)).clamp_min(0)
    inter = w * h
    uni = (a[:, None, 2] * a[:, None, 3] + b[None, :, 2] * b[None, :, 3]
           - inter)
    return inter / uni.clamp_min(1e-12)


def _kept(boxes, obj, probs):
    """(boxes (P,4), classes (P,), scores (P,), objectness (P,)) of the
    kept pairs."""
    e, c = torch.nonzero(probs > 0, as_tuple=True)
    return boxes[e], c, probs[e, c], obj[e]


def _overlaps(kept, nms: float) -> int:
    """Pairs of one class that overlap beyond the NMS threshold."""
    boxes, cls, _s, _o = kept
    if len(cls) < 2:
        return 0
    over = (_iou(boxes, boxes) > nms + IOU_SLACK) & (cls[:, None] == cls[None])
    return int(over.triu(1).sum())


def _unkept(a, b, cut: float, obj_cut, nms: float) -> tuple:
    """(decisive pairs of `a` for which `b` keeps no overlapping pair of
    the same class, decisive pairs of `a`)."""
    boxes, cls, score, obj = a
    sure = (score > cut) & (obj > obj_cut)
    n = int(sure.sum())
    if n == 0:
        return 0, 0
    bb, bc, _s, _o = b
    if len(bc) == 0:
        return n, n
    hit = (_iou(boxes[sure], bb) > nms) & (cls[sure][:, None] == bc[None])
    return int((~hit.any(1)).sum()), n


def gaps(got, ref, cand, grid, *, thresh: float, nms: float,
         box_tol: float) -> dict:
    """Numbers of one request: `got` and `ref` are served triples, `cand`
    the reference's candidates (boxes, obj, cls) of the same images and
    `grid` (N, 2) each candidate's grid width and height."""
    dev = cand[0].device
    tb, ov, probs = (t.to(dev).float() for t in got)
    rtb, rov, rprobs = ref
    boxes, obj, cls = cand
    kth = torch.sort(obj, dim=1, descending=True).values[:, ov.shape[1] - 1]
    out = {"box_gap": 0.0, "cell_gap": 0.0,
           "prob_gap": 0.0, "missed": 0, "decisive": 0, "nms_overlap": 0,
           "box_worst": []}
    ltb, lboxes = _log_wh(tb), _log_wh(boxes)
    scale = torch.cat([grid, torch.ones_like(grid[:, :1]).expand(-1, 3)], 1)
    for b in range(tb.shape[0]):
        c = torch.cat([lboxes[b], obj[b, :, None]], 1)          # (N,5)
        served = torch.nonzero(ov[b] > 0).flatten()
        q = torch.cat([ltb[b][served], ov[b][served, None]], 1)
        # the served entry of each kept pair, as a row of q
        row = torch.full((ov.shape[1],), -1, dtype=torch.long, device=dev)
        row[served] = torch.arange(len(served), device=dev)
        e, k = torch.nonzero(probs[b] > 0, as_tuple=True)
        for i, d in _nearest(q, c, scale):
            m = d.min(1)
            j = int(torch.argmax(m.values))
            if float(m.values[j]) >= out["box_gap"]:
                out["box_gap"] = float(m.values[j])
                out["box_worst"] = ((q[i + j] - c[m.indices[j]]).abs()
                                    * scale[m.indices[j]]).tolist()
            # each kept pair of these rows against the scores of its class
            # at the candidates near its box
            sel = (row[e] >= i) & (row[e] < i + len(d))
            if bool(sel.any()):
                near = d[row[e[sel]] - i] <= box_tol               # (P,N)
                want = (obj[b, :, None] * cls[b])[:, k[sel]].t()  # (P,N)
                gap = torch.where(near, (probs[b][e[sel], k[sel], None]
                                         - want).abs(),
                                  torch.full_like(want, BIG))
                out["prob_gap"] = max(out["prob_gap"],
                                      float(gap.min(1).values.max()))
        if len(served):
            out["cell_gap"] = max(out["cell_gap"], float(
                _cell_nearest(q, c, scale).median()))
        mine = _kept(tb[b], ov[b], probs[b])
        theirs = _kept(rtb[b].float(), rov[b], rprobs[b])
        out["nms_overlap"] += _overlaps(mine, nms)
        for x, y in ((mine, theirs), (theirs, mine)):
            m, n = _unkept(x, y, thresh + MARGIN, kth[b] + MARGIN, nms)
            out["missed"] += m
            out["decisive"] += n
    return out


def combine(per_request: list, malformed: int) -> dict:
    """The cell's numbers over the sample."""
    out = {"malformed": float(malformed),
           "nms_overlap": float(sum(r["nms_overlap"] for r in per_request))}
    for k in ("box_gap", "cell_gap", "prob_gap"):
        out[k] = max((r[k] for r in per_request), default=0.0)
    out["kept_miss"] = sum(r["missed"] for r in per_request) / max(
        sum(r["decisive"] for r in per_request), 1)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the cell limits at or under its limit."""
    return all(numbers[k] <= lim for k, lim in limits.items())
