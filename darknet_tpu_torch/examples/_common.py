"""Shared plumbing of the port's walkthroughs: the demo model cfg, the
workdir layout produced by 01_train_synthetic.py and consumed by the
rest, and the parser (the originals' --workdir, plus --device)."""

from __future__ import annotations

import argparse
import os

# A small but real detector for the 4-class shapes data: strided conv
# backbone with BN+leaky, one route/shortcut pair so the graph isn't a
# pure chain, and a [yolo] head — the same cfg dialect the reference
# parses (see docs/MIGRATION.md; swap in any reference cfg you have).
SHAPES_CFG = """[net]
batch=8
subdivisions=1
width=128
height=128
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.002
burn_in=20
policy=constant
max_epoch=100
flip=1
saturation=1.2
exposure=1.2
hue=.05

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters=27
size=1
activation=linear

[yolo]
mask=0,1,2
num=3
classes=4
anchors=26,26, 42,42, 56,40
jitter=0.1
ignore_thresh=0.5
truth_thresh=1
scale_x_y=1.0
nms_kind=greedynms
"""


def workdir_paths(workdir: str) -> dict:
    return {
        "cfg": os.path.join(workdir, "shapes.cfg"),
        "data": os.path.join(workdir, "dataset", "obj.data"),
        "names": os.path.join(workdir, "dataset", "obj.names"),
        "dataset": os.path.join(workdir, "dataset"),
        "backup": os.path.join(workdir, "backup"),
        "weights": os.path.join(workdir, "backup", "shapes_final.weights"),
    }


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--workdir", default="shapes_demo",
                    help="artifact directory shared across the examples")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the CUDA card (default; without one "
                         "the run stops with an error) or cpu")
    return ap


def require_trained(paths: dict) -> None:
    if not os.path.exists(paths["weights"]):
        raise SystemExit(
            f"missing {paths['weights']} — run "
            f"darknet_tpu_torch/examples/01_train_synthetic.py first (or "
            f"pass --cfg/--weights "
            f"pointing at your own reference-format artifacts)")
