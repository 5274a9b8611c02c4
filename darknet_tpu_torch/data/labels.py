"""Label I/O: per-image `.txt` annotations `id x y w h` (normalized);
the port's copy of `darknet_tpu/data/labels.py`.

Mirrors ReadBoxAnnot (data.cpp:78-114) and ReplaceImage2Label (utils):
the label path is derived from the image path by replacing the extension
with .txt (and `images`->`labels` directory convention when present).
"""

from __future__ import annotations

import os

import numpy as np


def image_to_label_path(path: str) -> str:
    base, _ext = os.path.splitext(path)
    # common darknet dataset layout: .../images/... -> .../labels/...
    cand = base + ".txt"
    if os.path.exists(cand):
        return cand
    swapped = base.replace(f"{os.sep}images{os.sep}",
                           f"{os.sep}labels{os.sep}") + ".txt"
    return swapped if os.path.exists(swapped) else cand


def read_box_annot(label_path: str) -> np.ndarray:
    """Read annotations -> (N, 5) float32 [id, x, y, w, h]; missing file
    yields an empty array (the reference logs to bad.list and continues)."""
    rows = []
    try:
        with open(label_path, "r") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                rows.append([float(parts[0]), float(parts[1]),
                             float(parts[2]), float(parts[3]),
                             float(parts[4])])
    except OSError:
        pass
    if not rows:
        return np.zeros((0, 5), np.float32)
    return np.asarray(rows, dtype=np.float32)
