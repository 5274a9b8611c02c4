"""Detection and tracking overlays and the training chart
(`darknet_tpu/apps/visualize.py`, a port of `visualize.cpp`), drawn with
the port's raster primitives (`apps/raster`) and written with the port's
PNG codec, so that nothing here needs OpenCV.

Per-class/per-label pseudo-random palette (GetRandColor), detection boxes
with name(prob%) tags, track boxes with name(label, prob%) tags and
thicker borders for STATIONARY tracks, proc-time and frame counters, and
the loss/mAP chart rendered to chart.png (visualize.cpp:172-315).  Every
box, line and tag background falls on OpenCV's pixels; the glyphs inside
the tags are the port's own font (`raster.put_text`).  A live window
(`safe_imshow`) opens only where cv2 imports and a display exists.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from darknet_tpu_torch.apps import raster
from darknet_tpu_torch.apps.tracker import STATIONARY

_gui_broken = False


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def gui_ok() -> bool:
    """Live windows like the reference (imshow + waitKey,
    yolo_core.cpp:211-212,267-268,378-379) where cv2 imports and a display
    exists; headless runs (no DISPLAY on linux, or DARKNET_TPU_NO_GUI=1)
    write files only."""
    if _gui_broken or os.environ.get("DARKNET_TPU_NO_GUI"):
        return False
    if sys.platform not in ("darwin", "win32") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return False
    return _cv2() is not None


def safe_imshow(window: str, img_bgr, wait_ms: int = 1) -> int:
    """imshow + waitKey that survives headless OpenCV builds: the first
    failure disables the GUI for the rest of the run.  Returns the waitKey
    code, or -1 when the GUI is unavailable; wait_ms=0 blocks for a key
    (the reference's image mode, yolo_core.cpp:212)."""
    global _gui_broken
    if not gui_ok():
        return -1
    cv2 = _cv2()
    try:
        cv2.imshow(window, img_bgr)
        return cv2.waitKey(wait_ms)
    except cv2.error:
        _gui_broken = True
        return -1


def get_rand_color(idx: int) -> tuple:
    """Deterministic pseudo-random palette keyed by class/label."""
    rng = np.random.default_rng(idx * 7919 + 17)
    c = rng.integers(64, 256, size=3)
    return int(c[0]), int(c[1]), int(c[2])


def _draw_tagged_box(img, left, top, right, bottom, tag, color, width,
                     font_sz=1.0):
    (tw, th), baseline = raster.text_size(tag, font_sz)
    raster.rectangle(img, (int(left), int(top)), (int(right), int(bottom)),
                     color, width)
    raster.rectangle(img, (int(left), int(top - baseline - th)),
                     (int(left + tw), int(top)), color, -1)
    raster.put_text(img, tag, (int(left), int(top - baseline / 2)), font_sz,
                    (0, 0, 0), 1)


def draw_detections(img, dets, names):
    """DrawYoloDetections: `dets` are tracker.MostProbDet (relative boxes)."""
    h, w = img.shape[:2]
    width = max(1, w // 640)
    for d in dets:
        x, y, bw, bh = d.bbox
        left, right = (x - bw / 2) * w, (x + bw / 2) * w
        top, bottom = (y - bh / 2) * h, (y + bh / 2) * h
        name = names[d.cid] if d.cid < len(names) else str(d.cid)
        tag = f"{name}({d.prob * 100:2.0f}%)"
        _draw_tagged_box(img, left, top, right, bottom, tag,
                         get_rand_color(d.cid), width)
    return img


def draw_trackings(img, tracks, names):
    """DrawYoloTrackings: thicker boxes for STATIONARY tracks."""
    h, w = img.shape[:2]
    base_width = max(1, w // 640)
    for t in tracks:
        x, y, bw, bh = t.bbox
        left, right = (x - bw / 2) * w, (x + bw / 2) * w
        top, bottom = (y - bh / 2) * h, (y + bh / 2) * h
        cid = t.det.cid
        name = names[cid] if cid < len(names) else str(cid)
        tag = f"{name}({t.label},{t.det.prob * 100:2.0f}%)"
        width = base_width * (2 if t.status == STATIONARY else 1)
        _draw_tagged_box(img, left, top, right, bottom, tag,
                         get_rand_color(t.label), width, font_sz=0.5)
    return img


def draw_proc_time(img, millisec: float):
    txt = f"Proc time: {int(millisec)} ms"
    raster.put_text(img, txt, (10, 25), 1.0, (255, 255, 255), 4)
    raster.put_text(img, txt, (10, 25), 1.0, (255, 0, 0), 1)
    return img


def draw_frame_info(img, curr_frame: int, max_frame: int):
    txt = f"Frame: {curr_frame}/{max_frame}"
    raster.put_text(img, txt, (10, 50), 1.0, (255, 255, 255), 4)
    raster.put_text(img, txt, (10, 50), 1.0, (255, 0, 0), 1)
    return img


def draw_loss_chart(iters, avg_losses, map_iters=None, maps=None,
                    max_iter=10000, max_loss=5.0, width=1000, height=720,
                    path="chart.png"):
    """Loss/mAP training chart -> PNG (DrawLossGraph, visualize.cpp:172-315),
    an RGB image written with `data/image.write_png`."""
    from darknet_tpu_torch.data.image import write_png

    margin = 60
    img = np.full((height, width, 3), 255, np.uint8)
    x0, y0 = margin, height - margin
    x1, y1 = width - margin, margin
    grey = (128, 128, 128)
    for frac in np.linspace(0, 1, 11):
        gx = int(x0 + frac * (x1 - x0))
        gy = int(y0 - frac * (y0 - y1))
        raster.line(img, (gx, y1), (gx, y0), (224, 224, 224))
        raster.line(img, (x0, gy), (x1, gy), (224, 224, 224))
        raster.put_text(img, f"{frac * max_loss:.1f}", (5, gy + 5), 0.7, grey)
        raster.put_text(img, f"{int(frac * max_iter)}", (gx - 15, height - 30),
                        0.7, grey)
    raster.rectangle(img, (x0, y1), (x1, y0), (0, 0, 0), 1)

    def to_px(it, val, vmax):
        px = x0 + int((x1 - x0) * min(it / max(max_iter, 1), 1.0))
        # a NaN/inf loss (diverged run) pins to the top of the chart
        frac = min(val / vmax, 1.0) if np.isfinite(val) else 1.0
        py = y0 - int((y0 - y1) * frac)
        return px, py

    pts = [to_px(i, v, max_loss) for i, v in zip(iters, avg_losses)]
    for a, b in zip(pts, pts[1:]):
        raster.line(img, a, b, (255, 0, 0), 1)
    if map_iters and maps:
        mpts = [to_px(i, v, 1.0) for i, v in zip(map_iters, maps)]
        for a, b in zip(mpts, mpts[1:]):
            raster.line(img, a, b, (0, 0, 255), 2)
        raster.put_text(img, "mAP%", (x1 - 60, y1 + 20), 0.7, (0, 0, 255))
    raster.put_text(img, "avg loss", (x0 + 10, y1 + 20), 0.7, (255, 0, 0))
    if path:
        write_png(path, img)
    return img
