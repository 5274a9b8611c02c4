"""The C ABI of darknet_tpu_torch (`darknet_tpu_torch/capi`): the shim
builds with gcc, and the unchanged client `native/capi/demo.c` links
against it and runs end to end on the CPU (DTPU_DEVICE=cpu), with the
assertions of `tests/test_capi.py` (the JAX package's shim).  The images
are PNG, which the port reads without OpenCV; the saved weights are read
back through the port's `weights/io`.  Without DTPU_DEVICE the shim runs
on the card, so with no card `dtpu_load` returns NULL with the port's
"no CUDA card" error.  The demo saves to a fixed /tmp path, which this
build sends to each test's own file (DTPU_DEMO_WEIGHTS, `capi/build.sh`)."""

import os
import site
import subprocess

import numpy as np
import pytest

from darknet_tpu_torch.data.image import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    script = os.path.join(REPO, "darknet_tpu_torch", "capi", "build.sh")
    out = str(tmp_path_factory.mktemp("capi"))
    try:
        r = subprocess.run(["sh", script, out], check=True,
                           capture_output=True, text=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        pytest.skip(f"could not build the port's C ABI shim: {e}")
    return r.stdout.strip().splitlines()[-1]


def _env(tmp_path, device="cpu"):
    env = dict(os.environ)
    env.pop("DTPU_DEVICE", None)
    if device is not None:
        env["DTPU_DEVICE"] = device
    env["DTPU_DEMO_WEIGHTS"] = str(tmp_path / "dtpu_demo.weights")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *site.getsitepackages(), env.get("PYTHONPATH", "")])
    return env


def _images(root, stem, n, size, box, value, rgb):
    """n PNG images with one filled rectangle and its label; the list."""
    root.mkdir()
    paths = []
    for i in range(n):
        img = np.full((*size, 3), value, np.uint8)
        (x0, y0), (x1, y1) = box
        img[y0:y1 + 1, x0:x1 + 1] = rgb
        p = str(root / f"{stem}{i}.png")
        write_png(p, img)
        cx = (x0 + x1 + 1) / 2 / size[1]
        cy = (y0 + y1 + 1) / 2 / size[0]
        bw, bh = (x1 - x0 + 1) / size[1], (y1 - y0 + 1) / size[0]
        with open(str(root / f"{stem}{i}.txt"), "w") as f:
            f.write(f"0 {cx} {cy} {bw} {bh}\n")
        paths.append(p)
    return paths


def test_c_client_end_to_end(demo, fixtures_dir, tmp_path):
    r = subprocess.run(
        [demo, os.path.join(fixtures_dir, "yolov3-tiny.cfg"), "", "0.05"],
        env=_env(tmp_path), capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stderr[-1500:]
    assert "net 416x416x3 classes=80" in r.stdout
    assert "ok" in r.stdout
    n = int([ln for ln in r.stdout.splitlines()
             if ln.startswith("detections:")][0].split()[1])
    assert n > 0
    # Detection2Json analogue produced a frame header with the filename
    assert "json head:" in r.stdout
    # SaveWeights path: fused save refused, train-style load saved, and
    # the stream round-trips through the port's reader
    assert "weights saved" in r.stdout
    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.weights.io import load_weights

    g = build_graph(os.path.join(fixtures_dir, "yolov3-tiny.cfg"),
                    train=True)
    params, seen, _ = load_weights(g, str(tmp_path / "dtpu_demo.weights"))
    assert any(p for p in params)


def test_c_client_validate(demo, fixtures_dir, tmp_path):
    """dtpu_validate: mAP over a .data valid list from the C surface."""
    paths = _images(tmp_path / "ds", "v", 3, (120, 160), ((40, 30), (120, 90)),
                    100, (40, 80, 200))
    (tmp_path / "valid.list").write_text("\n".join(paths))
    names = tmp_path / "names.txt"
    names.write_text("\n".join(f"c{i}" for i in range(80)))
    data = tmp_path / "t.data"
    data.write_text(f"classes=80\nnames={names}\n"
                    f"valid={tmp_path / 'valid.list'}\n")
    r = subprocess.run(
        [demo, os.path.join(fixtures_dir, "yolov3-tiny.cfg"), "", "0.25",
         str(data)],
        env=_env(tmp_path), capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-1500:])
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("mAP:")]
    assert line, r.stdout
    m = float(line[0].split()[1])
    assert 0.0 <= m <= 1.0       # random weights: any valid mAP value


SMALL_CFG = """[net]
batch=4
subdivisions=1
width=96
height=96
channels=3
learning_rate=0.001
burn_in=0
policy=constant
max_epoch=500
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky
[convolutional]
filters=85
size=1
activation=linear
[yolo]
mask=0
num=1
classes=80
anchors=30,30
"""


def test_c_client_tracker_and_train(demo, tmp_path):
    """dtpu_tracker_* and dtpu_train from the C ABI: the demo client
    tracks its own detections over 4 frames (a labeled confirmed track
    must emerge) and runs 2 bounded training iterations over a tiny
    .data-driven dataset."""
    paths = _images(tmp_path / "ds", "t", 4, (96, 96), ((30, 30), (70, 70)),
                    90, (60, 60, 210))
    (tmp_path / "train.list").write_text("\n".join(paths))
    names = tmp_path / "names.txt"
    names.write_text("\n".join(f"c{i}" for i in range(80)))
    data = tmp_path / "t.data"
    data.write_text(f"classes=80\nnames={names}\n"
                    f"train={tmp_path / 'train.list'}\n"
                    f"save={tmp_path / 'bk'}\n")
    cfg = tmp_path / "small.cfg"
    cfg.write_text(SMALL_CFG)
    r = subprocess.run(
        [demo, str(cfg), "", "0.05", "", str(data)],
        env=_env(tmp_path), capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-1500:])
    # tracker: a confirmed track with an assigned label
    tline = [ln for ln in r.stdout.splitlines() if ln.startswith("tracks:")]
    assert tline, r.stdout
    assert int(tline[0].split()[1]) >= 1
    assert "label0=" in tline[0]
    # training ran and checkpointed into the .data save dir
    lline = [ln for ln in r.stdout.splitlines()
             if ln.startswith("train avg loss:")]
    assert lline and float(lline[0].split()[-1]) > 0
    assert (tmp_path / "bk").is_dir()
    assert any(f.endswith(".weights") for f in os.listdir(tmp_path / "bk"))


def test_c_client_without_card(demo, tmp_path):
    """No DTPU_DEVICE: the card; with none, dtpu_load returns NULL and the
    client stops at "load failed" with the port's error, before any
    work."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = tmp_path / "small.cfg"
    cfg.write_text(SMALL_CFG)
    r = subprocess.run([demo, str(cfg)], env=_env(tmp_path, device=None),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2, (r.stdout[-800:], r.stderr[-1500:])
    assert "no CUDA card" in r.stderr and "load failed" in r.stderr
    assert "net " not in r.stdout
