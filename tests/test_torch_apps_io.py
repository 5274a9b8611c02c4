"""The streaming modes' input without OpenCV (`darknet_tpu_torch/data/
{video,image}.py`) against OpenCV and the JAX package.

* y4m clips (4:4:4 and 4:2:0, odd and even sizes) read by the port
  against cv2.VideoCapture (OpenCV 5's FFMPEG backend): fps, frame count,
  and frames within the measured tolerance.  ffmpeg converts Y'CbCr with
  its own fixed-point arithmetic and filters chroma, the port in float32
  with replicated chroma, so at a level's scale: 4:4:4 within 1 (mean
  under 0.01), 4:2:0 of even height within 4 (mean under 1.5); 4:2:0 of
  odd height is held on its luma only (within 23 where ffmpeg's clipped
  chroma moves it, mean under 1), since ffmpeg stretches the ceil(h/2)
  chroma rows over h/2 there.
* Without cv2, a `.mp4` raises naming the file and what is read,
  -save_output raises before any work, and -mode image reads and writes
  PNG and raises on another format.
* `resize_image_cv` on uint8 equals cv2.resize(INTER_LINEAR) bitwise.
* `make_letterbox_device` on the CPU against the JAX package's
  (jax.image.resize, renormalised border weights, against torch's clamped
  source coordinate): within 2e-6 at 1280x720 -> 608 and at upscale.
"""

import sys

import cv2
import numpy as np
import pytest

from darknet_tpu.data.image import make_letterbox_device as jlbx
from darknet_tpu_torch.data import video
from darknet_tpu_torch.data.image import (make_letterbox_device,
                                          resize_image_cv)


def _clip(h, w, n, seed):
    """Frames of 4x4 blocks with noise, and a moving block."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3))
        fr = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
        fr = fr + rng.integers(-20, 20, fr.shape)
        fr[h // 4:h // 2, 2 * t:2 * t + w // 4] = (40, 90, 210)
        out.append(np.clip(fr, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("chroma,h,w,tol,mean_tol", [
    ("444", 48, 64, 1, 0.01), ("444", 37, 53, 1, 0.01),
    ("420jpeg", 48, 64, 4, 1.5), ("420jpeg", 48, 53, 4, 1.5),
    ("420jpeg", 37, 53, 23, 1.0)])
def test_y4m_reads_as_cv2(tmp_path, chroma, h, w, tol, mean_tol):
    path = str(tmp_path / "c.y4m")
    video.write_y4m(path, _clip(h, w, 5, 0), 30, chroma)
    cap = cv2.VideoCapture(path)
    mine = video.open_video(path)
    assert isinstance(mine, video.Y4MReader)
    assert mine.fps == cap.get(cv2.CAP_PROP_FPS) == 30.0
    assert mine.frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    odd_420 = chroma != "444" and h % 2
    diffs = []
    while True:
        ok, a = cap.read()
        ok2, b = mine.read()
        assert ok == ok2
        if not ok:
            break
        assert b.shape == a.shape == (h, w, 3) and b.dtype == np.uint8
        if odd_420:
            a, b = video.bgr_to_yuv(a)[0], video.bgr_to_yuv(b)[0]
        diffs.append(np.abs(a.astype(np.float64) - b))
    d = np.stack(diffs)
    assert len(diffs) == 5
    assert d.max() <= tol and d.mean() <= mean_tol, (d.max(), d.mean())
    mine.release()


def test_y4m_header_fps_ratio_and_bad_chroma(tmp_path):
    path = tmp_path / "r.y4m"
    fr = np.zeros((4, 6), np.uint8).tobytes()
    path.write_bytes(b"YUV4MPEG2 W6 H4 F30000:1001 C444\n" +
                     (b"FRAME\n" + fr * 3) * 2)
    r = video.open_video(str(path))
    assert (r.width, r.height, r.frame_count) == (6, 4, 2)
    assert abs(r.fps - 29.97002997) < 1e-6
    path.write_bytes(b"YUV4MPEG2 W6 H4 F30:1 C422\nFRAME\n")
    with pytest.raises(video.VideoFormatError, match="C422"):
        video.open_video(str(path))


def test_without_cv2_other_containers_raise(tmp_path, monkeypatch):
    mp4 = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(mp4), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (32, 24))
    w.write(np.zeros((24, 32, 3), np.uint8))
    w.release()
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    with pytest.raises(video.VideoFormatError,
                       match=r"clip\.mp4: only YUV4MPEG2 \(\.y4m"):
        video.open_video(str(mp4))
    with pytest.raises(video.VideoFormatError, match="-save_output"):
        video.require_writer()
    assert video.open_video(str(tmp_path / "missing.mp4")) is None


@pytest.mark.parametrize("size", [
    (720, 1280, 608, 608), (720, 1280, 342, 608), (480, 640, 416, 416),
    (37, 53, 64, 48), (64, 64, 96, 160), (50, 50, 23, 17), (96, 96, 48, 48),
    (120, 160, 128, 128)])
def test_uint8_resize_equals_cv2(size):
    ih, iw, h, w = size
    img = np.random.default_rng(ih * w).integers(
        0, 256, (ih, iw, 3)).astype(np.uint8)
    got = resize_image_cv(img, w, h)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("geom", [(720, 1280, 608, 608), (120, 200, 128, 128),
                                  (60, 80, 160, 160), (37, 53, 96, 64)])
def test_device_letterbox_matches_jax(geom):
    ih, iw, nw, nh = geom
    fr = np.random.default_rng(iw).integers(
        0, 256, (2, ih, iw, 3)).astype(np.uint8)
    want = np.asarray(jlbx(ih, iw, nw, nh)(fr))
    got = make_letterbox_device(ih, iw, nw, nh, device="cpu")(fr)
    assert got.shape == (2, nh, nw, 3) and got.dtype.is_floating_point
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_image_formats_without_cv2(tmp_path, monkeypatch):
    """-mode image reads and writes PNG with the port's codec; another
    format needs cv2 and, without it, raises naming the file."""
    from darknet_tpu_torch.apps import cli

    img = np.random.default_rng(3).integers(0, 256, (20, 30, 3)).astype(
        np.uint8)
    jpg = tmp_path / "a.jpg"
    cv2.imwrite(str(jpg), img)
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    png = str(tmp_path / "a.png")
    cli._write_image(png, img)
    np.testing.assert_array_equal(cli._read_image(png), img)
    with pytest.raises(RuntimeError, match=r"a\.jpg: only 8-bit PNGs"):
        cli._read_image(str(jpg))
    with pytest.raises(RuntimeError, match=r"b\.jpg: only PNG"):
        cli._write_image(str(tmp_path / "b.jpg"), img)
    assert cli._read_image(str(tmp_path / "missing.jpg")) is None
