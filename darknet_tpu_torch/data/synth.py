"""Structured synthetic detection dataset (images + darknet labels).

Generates images that are actually LEARNABLE by a small detector —
solid geometric shapes whose class is determined by (color, shape) —
plus darknet `.txt` labels, a train/val split, and `.data`/`.names`
files, all deterministically from a seed.  Serves three purposes:

* end-to-end train-A/B parity gates against the reference binary
  (tests/test_reference_trainloop.py): neither side sees hand-picked
  values, every image is drawn at runtime from the seed, so a gate
  over this data exercises augmentation -> loss -> optimizer -> mAP
  on unseen inputs;
* runnable examples (examples/) that need a dataset without network
  access;
* training smoke/benchmark runs on boxes with no real dataset.

The label format and `.data`/`.names` layout match the reference's
loader contract exactly (the reference's `data.cpp:78-114`
ReadBoxAnnot: `id x y w h` normalized, one `.txt` per image;
`option_list.cpp:13-99` Metadata).

Classes:
  0: red rectangle    1: green rectangle
  2: blue circle      3: yellow circle

The port's copy of `darknet_tpu/data/synth.py`: the same draws from the
same seed, the PNGs written with the standard library
(`data/image.write_png`), so no OpenCV is needed.
"""

from __future__ import annotations

import os

import numpy as np

from darknet_tpu_torch.data.image import write_png

COLORS = {
    0: (210, 40, 40),
    1: (40, 200, 50),
    2: (40, 70, 220),
    3: (230, 220, 50),
}
N_CLASSES = 4
NAMES = ["red_rect", "green_rect", "blue_circle", "yellow_circle"]


def draw_sample(rng: np.random.Generator, w: int, h: int):
    """One RGB uint8 image (H, W, 3) + its [(cls, x, y, w, h)] boxes
    (normalized center format, the darknet label convention)."""
    img = rng.integers(90, 130, (h, w, 3)).astype(np.uint8)  # gray noise bg
    boxes = []
    for _ in range(int(rng.integers(1, 4))):
        cid = int(rng.integers(0, N_CLASSES))
        bw = int(rng.integers(int(0.15 * w), int(0.45 * w)))
        bh = int(rng.integers(int(0.15 * h), int(0.45 * h)))
        x0 = int(rng.integers(0, w - bw))
        y0 = int(rng.integers(0, h - bh))
        col = np.array(COLORS[cid], np.uint8)
        # mild per-instance color jitter so HSV augmentation can't trivially
        # flip classes but the task isn't a pixel-lookup either
        col = np.clip(col.astype(np.int32)
                      + rng.integers(-18, 19, 3), 0, 255).astype(np.uint8)
        if cid in (0, 1):  # rectangle
            img[y0:y0 + bh, x0:x0 + bw] = col
        else:  # ellipse
            yy, xx = np.mgrid[0:h, 0:w]
            cx, cy = x0 + bw / 2, y0 + bh / 2
            mask = (((xx - cx) / (bw / 2)) ** 2
                    + ((yy - cy) / (bh / 2)) ** 2) <= 1.0
            img[mask] = col
        boxes.append((cid, (x0 + bw / 2) / w, (y0 + bh / 2) / h,
                      bw / w, bh / h))
    return img, boxes


def generate(root, n_train: int = 480, n_val: int = 80, seed: int = 1234,
             size_range=((96, 144), (96, 144))):
    """Write the dataset under `root`; returns a dict of file paths
    (train_paths/val_paths/train_list/val_list/data/names)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    (w_lo, w_hi), (h_lo, h_hi) = size_range

    def write_split(prefix, n):
        paths = []
        for i in range(n):
            w = int(rng.integers(w_lo, w_hi + 1))
            h = int(rng.integers(h_lo, h_hi + 1))
            img, boxes = draw_sample(rng, w, h)
            p = os.path.join(root, f"{prefix}{i:04d}.png")
            write_png(p, img)
            with open(os.path.join(root, f"{prefix}{i:04d}.txt"), "w") as f:
                for cid, x, y, bw, bh in boxes:
                    f.write(f"{cid} {x:.6f} {y:.6f} {bw:.6f} {bh:.6f}\n")
            paths.append(p)
        lst = os.path.join(root, f"{prefix.rstrip('_')}.txt")
        with open(lst, "w") as f:
            f.write("\n".join(paths) + "\n")
        return paths, lst

    train_paths, train_list = write_split("tr_", n_train)
    val_paths, val_list = write_split("va_", n_val)

    names = os.path.join(root, "obj.names")
    with open(names, "w") as f:
        f.write("\n".join(NAMES) + "\n")
    data = os.path.join(root, "obj.data")
    with open(data, "w") as f:
        f.write(f"classes = {N_CLASSES}\ntrain = {train_list}\n"
                f"valid = {val_list}\nnames = {names}\n")
    return {
        "train_paths": train_paths, "val_paths": val_paths,
        "train_list": train_list, "val_list": val_list,
        "data": data, "names": names,
    }
