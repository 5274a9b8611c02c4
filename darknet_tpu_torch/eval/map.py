"""mAP@IoU validation, ValidateDetector (detector.cpp:326-561): the port
of `darknet_tpu/eval/map.py`.

Semantics preserved:
* detection threshold .005, NMS .45 with the head's nms_kind/beta;
* per-image greedy match: a detection's (class, prob) entry matches the
  highest-IoU same-class GT with IoU > iou_thresh;
* global confidence-sorted PR accumulation with unique-GT TP logic
  (first match in confidence order claims the GT; later ones are FPs);
* AP by right-to-left interpolated precision (Riemann sum over recall
  deltas), mAP = mean over classes; recall mass present from the first
  rank is dropped, as in the reference (detector.cpp:533-542);
* recall/precision reported at the prob=0.5 crossing.

The det/GT matcher is numpy (`_match_rows`), in the float32 arithmetic of
the JAX package's native matcher; the PR accumulation is vectorized over
classes with the reference's per-element operations in its order.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time

import numpy as np

from darknet_tpu_torch.data.image import (load_image_rgb,
                                          resize_image_cv,
                                          resize_image_darknet)
from darknet_tpu_torch.data.labels import image_to_label_path, read_box_annot

#: the COCO challenge's IoU sweep (AP@[.5:.95], step .05)
COCO_IOUS = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))

_EPS = np.finfo(np.float32).eps
# resize="cv" runs torch ops in the loading threads: one at a time, so
# the threads share torch's one intra-op pool instead of each starting a
# team of workers on the host cores the launching thread needs
_TORCH_RESIZE = threading.Lock()


@dataclasses.dataclass
class MapResult:
    map: float
    per_class_ap: np.ndarray
    recall: float
    precision: float
    pred_time_s: float
    imgs_per_s: float
    n_pred: int
    n_gt: int
    # multi-IoU sweep (iou_thresholds=): mAP per threshold, and their
    # mean — the COCO AP@[.5:.95] when thresholds == COCO_IOUS.  The
    # reference evaluates a single threshold only (detector.cpp:326).
    map_by_iou: dict | None = None
    map_mean_iou: float | None = None


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of every (a, b) pair of center-format float32 boxes, (n, m):
    the reference's `_iou_single` (and the native `box_iou`) in float32,
    0 where the boxes do not overlap or the intersection or union is
    below float32 eps."""
    a, b = a[:, None, :], b[None, :, :]
    two = np.float32(2)
    w = (np.minimum(a[..., 0] + a[..., 2] / two, b[..., 0] + b[..., 2] / two)
         - np.maximum(a[..., 0] - a[..., 2] / two,
                      b[..., 0] - b[..., 2] / two))
    h = (np.minimum(a[..., 1] + a[..., 3] / two, b[..., 1] + b[..., 3] / two)
         - np.maximum(a[..., 1] - a[..., 3] / two,
                      b[..., 1] - b[..., 3] / two))
    inter = w * h
    u = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    ok = (w >= 0) & (h >= 0) & (np.abs(inter) >= _EPS) & (np.abs(u) >= _EPS)
    out = np.zeros(inter.shape, np.float32)
    out[ok] = inter[ok] / u[ok]
    return out


def _match_rows(d_boxes: np.ndarray, d_probs: np.ndarray, gt: np.ndarray):
    """The greedy det/GT match at IoU 0 (detector.cpp:388-424): one row
    (prob, cid, gt_idx or -1, best_iou) per detection and class with
    |prob| >= eps, detections in order and each one's classes ascending;
    gt_idx is the first same-class GT of the largest IoU, kept only when
    that IoU exceeds 0.  The match at any threshold t is then gt_idx
    where best_iou > t, so one pass serves a whole IoU sweep."""
    det, cid = np.nonzero(np.abs(d_probs) >= _EPS)
    probs = d_probs[det, cid]
    if not gt.shape[0]:
        return probs, cid, np.full(det.shape, -1), np.zeros(det.shape,
                                                            np.float32)
    iou = _iou_matrix(np.asarray(d_boxes, np.float32),
                      np.asarray(gt[:, 1:5], np.float32))[det]
    same = gt[:, 0].astype(np.int64)[None, :] == cid[:, None]
    iou = np.where(same, iou, np.float32(0))
    best = iou.argmax(axis=1)
    best_iou = iou[np.arange(det.size), best]
    return probs, cid, np.where(best_iou > 0, best, -1), best_iou


def _load_resized(path, w, h, resize: str = "cv"):
    im = load_image_rgb(path)
    if resize == "darknet":
        return resize_image_darknet(im, w, h)
    with _TORCH_RESIZE:
        return resize_image_cv(im, w, h)


def validate_detector(net, img_paths, classes: int, iou_thresh: float = 0.5,
                      thresh: float = 0.005, nms: float = 0.45,
                      batch: int = 1, progress: bool = True,
                      threads: int = 6, resize: str = "cv",
                      mesh=None, iou_thresholds=None) -> MapResult:
    """Run the full mAP pipeline with a `Network` (or anything exposing
    `net.w`/`net.h` and `detect_batch`).

    Image loading is prefetched on a thread pool (the reference overlaps
    load with predict via load_data_in_thread, detector.cpp:358-371): the
    next chunk decodes while the current one runs on the device.  The
    ragged last chunk is zero-padded, so every batch has one shape.

    iou_thresholds (e.g. COCO_IOUS): evaluate additional IoU thresholds
    from the SAME prediction pass; the headline fields stay at
    `iou_thresh`, `map_by_iou` / `map_mean_iou` carry the sweep.

    mesh: shard each forward batch over the mesh's "dp" axis
    (`Network.detect_batch(mesh=)`; batch must divide by the dp size);
    the host NMS and the matching are the single-device path's, so the
    MapResult is too.  Over a mesh that spans processes every rank
    predicts its block and matches the whole batch.  A mesh with an "sp"
    axis also splits each block's feature maps over its devices
    (`parallel/spatial.py`): in one process, or over the ranks of a grid
    that spans the world, where each dp block's ranks predict the whole
    batch (the Network serves the batch it is given over its sp ranks)."""
    det_kw = {} if mesh is None else {"mesh": mesh}
    # thresholds to MATCH at: the headline iou_thresh plus the (deduped)
    # sweep; map_by_iou/map_mean_iou report over exactly iou_thresholds
    extra_ts: list = []
    if iou_thresholds is not None:
        for t in iou_thresholds:
            if float(t) not in extra_ts:
                extra_ts.append(float(t))
    sweep = [float(iou_thresh)] + [t for t in extra_ts
                                   if t != float(iou_thresh)]
    val_boxes = {t: [] for t in sweep}      # t -> (prob, cid, matched, gt_idx)
    num_gt_class = np.zeros(classes, np.int64)
    num_gt = 0
    pred_time = 0.0

    chunks = [img_paths[s:s + batch]
              for s in range(0, len(img_paths), batch)]
    pool = cf.ThreadPoolExecutor(max_workers=threads)

    def submit(chunk):
        return [pool.submit(_load_resized, p, net.net.w, net.net.h, resize)
                for p in chunk]

    try:
        pending = submit(chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            futs = pending
            pending = submit(chunks[ci + 1]) if ci + 1 < len(chunks) else None
            x = np.stack([f.result() for f in futs])
            pad = batch - x.shape[0]
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                                x.dtype)])

            t0 = time.perf_counter()
            dets_batch = net.detect_batch(x, thresh=thresh, nms=nms,
                                          **det_kw)
            pred_time += time.perf_counter() - t0
            dets_batch = dets_batch[: len(chunk)]

            for p, dets in zip(chunk, dets_batch):
                gt = read_box_annot(image_to_label_path(p))
                for row in gt:
                    cid = int(row[0])
                    if 0 <= cid < classes:
                        num_gt_class[cid] += 1
                if dets:
                    rows = _match_rows(
                        np.asarray([d.bbox for d in dets], np.float32),
                        np.stack([np.asarray(d.prob) for d in dets]), gt)
                    for prob, cid, gi, best_iou in zip(*rows):
                        for t in sweep:
                            ok = gi > -1 and best_iou > t
                            val_boxes[t].append(
                                (float(prob), int(cid), bool(ok),
                                 num_gt + int(gi) if ok else -1))
                num_gt += len(gt)
            if progress:
                print(f"\rCalculating mAP for {ci * batch + len(chunk)} "
                      f"samples...", end="", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if progress:
        print()

    res = _pr_from_valboxes(val_boxes[sweep[0]], num_gt_class, num_gt,
                            classes, pred_time, len(img_paths))
    if extra_ts:
        # the sweep mean covers exactly iou_thresholds: the headline
        # iou_thresh contributes only if the caller included it
        by_iou = {}
        for t in extra_ts:
            by_iou[t] = (res.map if t == sweep[0] else _pr_from_valboxes(
                val_boxes[t], num_gt_class, num_gt, classes,
                pred_time, len(img_paths)).map)
        res.map_by_iou = dict(sorted(by_iou.items()))
        res.map_mean_iou = float(np.mean(list(by_iou.values())))
    return res


def _pr_from_valboxes(val_boxes, num_gt_class, num_gt, classes, pred_time,
                      n_imgs) -> MapResult:
    """PR accumulation + AP integration (detector.cpp:436-549).

    `val_boxes`: (prob, cid, matched, gt_idx) rows.  Ranked by descending
    prob (stable), the first matched row of each GT is a TP and every
    other row an FP; precision and recall after each rank are the
    reference's float64 quotients of the running counts, and AP sums
    delta-recall times the running max precision from the last rank to
    the first, class by class, in the reference's order."""
    n = len(val_boxes)
    aps = np.zeros(classes)
    rec_at_50 = prec_at_50 = 0.0
    if n:
        rows = np.asarray([v[:2] for v in val_boxes], np.float64)
        order = np.argsort(-rows[:, 0], kind="stable")
        prob = rows[order, 0]
        cid = rows[order, 1].astype(np.int64)
        matched = np.asarray([val_boxes[i][2] for i in order], bool)
        gt_idx = np.asarray([val_boxes[i][3] for i in order], np.int64)
        hit = np.nonzero(matched)[0]
        _, first = np.unique(gt_idx[hit], return_index=True)
        tp_rank = hit[first]
        # running counts per class after each rank: TPs, and TPs + FPs
        tp = np.zeros((classes, n), np.int64)
        tp[cid[tp_rank], tp_rank] = 1
        np.cumsum(tp, axis=1, out=tp)
        seen = np.zeros((classes, n), np.int64)
        seen[cid, np.arange(n)] = 1
        np.cumsum(seen, axis=1, out=seen)
        gts = num_gt_class[:, None]       # tp + fn, as the reference adds it
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(seen > 0, tp / seen, 0.0)
            recall = np.where(gts > 0, tp / gts, 0.0)
        del tp, seen
        over = np.nonzero(prob > 0.5)[0]
        if over.size:
            # the reference reports the LAST class's PR at the 0.5 crossing
            rec_at_50 = recall[-1, over[-1]] * 100
            prec_at_50 = precision[-1, over[-1]] * 100
        last_recall = recall[:, -1].copy()
        last_precision = precision[:, -1].copy()
        for i in range(n - 1, -1, -1):
            delta = last_recall - recall[:, i]
            last_recall = recall[:, i]
            last_precision = np.maximum(last_precision, precision[:, i])
            aps += delta * last_precision

    m = float(np.mean(aps)) if classes else 0.0
    return MapResult(
        map=m, per_class_ap=aps, recall=rec_at_50, precision=prec_at_50,
        pred_time_s=pred_time,
        imgs_per_s=n_imgs / pred_time if pred_time > 0 else 0.0,
        n_pred=n, n_gt=num_gt)
