"""The port's training data path against the JAX package's and against
OpenCV on the CPU: each OpenCV replacement of `data/image.py` against
cv2 (1e-5: bilinear weights and reciprocals rounded in another order),
the stdlib PNG codec against cv2 and PIL (exact), `data/synth` (the same
pixels and labels from one seed), and loader batches from one seed
(images within 1e-5, truths exact), with mosaic, mixup, blur and the
process pool; and the loader's handling of unreadable images: a file
that cannot be decoded becomes zeros in bad.list, a missing decoder
library raises."""

import os

import numpy as np
import pytest

import cv2

from darknet_tpu.data import synth as jsynth
from darknet_tpu.data.loader import DetectionLoader as JLoader
from darknet_tpu_torch.data import image as imageops
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.data.loader import DetectionLoader

TOL = 1e-5


def rgb(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("src,dst", [((37, 53), (64, 64)),
                                     ((130, 100), (32, 64)),
                                     ((96, 96), (48, 48)),
                                     ((120, 140), (896, 896)),
                                     ((64, 64), (64, 64))])
def test_resize_matches_cv2(src, dst):
    img = rgb(*src)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    got = imageops.resize_linear(img, *dst)
    assert np.abs(got - want).max() <= TOL


def test_border_and_flip_match_cv2():
    img = rgb(20, 30)
    mean = cv2.mean(img)[:3]
    want = cv2.copyMakeBorder(img, 3, 4, 5, 6, cv2.BORDER_CONSTANT, value=mean)
    got = imageops.pad_constant(img, 3, 4, 5, 6,
                                img.reshape(-1, 3).astype(np.float64).mean(0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imageops.flip_horizontal(img),
                                  cv2.flip(img, 1))


@pytest.mark.parametrize("dhue,dsat,dexp", [(0.1, 1.5, 0.7), (-0.1, 0.5, 1.4),
                                            (0.9, 2.0, 2.0), (-0.02, 1.2, 0.8)])
def test_hsv_round_trip_matches_cv2(dhue, dsat, dexp):
    """RGB -> HSV, the loader's scaling and hue shift, HSV -> RGB, on a
    network-sized image (OpenCV's vector path covers every pixel; a
    negative hue lands in sector 0, as there)."""
    img = rgb(64, 96, seed=3)
    img[0, :3] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 0, 1]]
    want_hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    hsv = imageops.rgb_to_hsv(img)
    assert np.abs(hsv - want_hsv).max() <= TOL * 360
    hsv = want_hsv.copy()
    hsv[..., 1] *= dsat
    hsv[..., 2] *= dexp
    hsv[..., 0] += 360.0 * dhue
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    assert np.abs(imageops.hsv_to_rgb(hsv) - want).max() <= TOL


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 17])
def test_gaussian_blur_matches_cv2(k):
    img = rgb(40, 64, seed=k)
    want = cv2.GaussianBlur(img, (k, k), 0)
    assert np.abs(imageops.gaussian_blur(img, k) - want).max() <= TOL


def test_png_codec(tmp_path):
    """write_png files decode with cv2; read_png decodes cv2's filtered
    PNGs at every compression level and PIL's RGB, RGBA and gray PNGs."""
    from PIL import Image

    u8 = np.random.default_rng(1).integers(0, 256, (31, 45, 3)).astype(
        np.uint8)
    p = str(tmp_path / "a.png")
    imageops.write_png(p, u8)
    np.testing.assert_array_equal(cv2.imread(p)[..., ::-1], u8)
    np.testing.assert_array_equal(imageops.read_png(p), u8)
    for level in (0, 3, 9):
        q = str(tmp_path / f"cv{level}.png")
        cv2.imwrite(q, u8[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(imageops.read_png(q), u8)
    Image.fromarray(u8).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(imageops.read_png(tmp_path / "pil.png"), u8)
    rgba = np.concatenate([u8, u8[..., :1]], axis=2)
    Image.fromarray(rgba).save(tmp_path / "rgba.png")
    np.testing.assert_array_equal(
        imageops.load_image_rgb(tmp_path / "rgba.png"), u8 / np.float32(255))
    Image.fromarray(u8[..., 0]).save(tmp_path / "g.png")
    np.testing.assert_array_equal(imageops.read_png(tmp_path / "g.png")[..., 0],
                                  u8[..., 0])


@pytest.fixture(scope="module")
def synth_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return (jsynth.generate(str(root / "jax"), n_train=12, n_val=2, seed=5),
            synth.generate(str(root / "port"), n_train=12, n_val=2, seed=5))


def test_synth_matches_jax(synth_sets):
    jf, tf = synth_sets
    assert len(jf["train_paths"]) == len(tf["train_paths"]) == 12
    for a, b in zip(jf["train_paths"] + jf["val_paths"],
                    tf["train_paths"] + tf["val_paths"]):
        np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
        with open(a[:-4] + ".txt") as fa, open(b[:-4] + ".txt") as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(imageops.load_image_rgb(b),
                                      cv2.imread(b)[..., ::-1] / np.float32(255))


@pytest.mark.parametrize("mixup,blur,processes", [(0, 0, 0), (3, 0, 0),
                                                  (1, 1, 0), (3, 5, 0),
                                                  (3, 0, 1)])
def test_loader_matches_jax(synth_sets, mixup, blur, processes):
    """Three batches from one seed with jitter, flip and HSV jitter:
    images within 1e-5, truths exact."""
    paths = synth_sets[1]["train_paths"]
    kw = dict(w=64, h=64, batch=4, boxes=20, classes=4, jitter=0.3, hue=0.1,
              saturation=1.5, exposure=1.5, flip=True, blur=blur, mixup=mixup,
              threads=2, seed=3)
    jl = JLoader(paths, **kw)
    tl = DetectionLoader(paths, processes=processes, **kw)
    try:
        for _ in range(3):
            (xj, yj), (xt, yt) = jl.next(), tl.next()
            assert xt.dtype == np.float32 and (xt != 0).mean() > 0.9
            assert np.abs(xt - xj).max() <= TOL
            np.testing.assert_array_equal(yt, yj)
            assert (yt[:, 0, 0] > 0).all()
    finally:
        jl.close()
        tl.close()


def test_loader_zeros_an_undecodable_image(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    ld = DetectionLoader([str(bad)], w=32, h=32, batch=2, boxes=4,
                         bad_dir=str(tmp_path))
    try:
        x, y = ld.next()
    finally:
        ld.close()
    assert not x.any() and not y.any()
    assert str(bad) in (tmp_path / "bad.list").read_text()


def test_loader_raises_without_a_decoder(tmp_path, monkeypatch):
    """A JPEG with neither cv2 nor PIL importable: the loader raises
    ImportError and emits no zeros."""
    from darknet_tpu_torch.data.image import load_image_rgb

    path = str(tmp_path / "img.jpg")
    cv2.imwrite(path, (rgb(16, 16) * 255).astype(np.uint8))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError):
        load_image_rgb(path)
    ld = DetectionLoader([path], w=32, h=32, batch=2, boxes=4,
                         bad_dir=str(tmp_path))
    try:
        with pytest.raises(ImportError):
            ld.next()
    finally:
        ld.close()
    assert not os.path.exists(tmp_path / "bad.list")
