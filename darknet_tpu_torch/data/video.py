"""Video input and output for the streaming modes of the CLI, without
OpenCV where it can be done: the counterpart of the `cv2.VideoCapture`
and `cv2.VideoWriter` calls inline in `darknet_tpu/apps/cli.py`.

* `open_video(path)`: a YUV4MPEG2 file (`.y4m`; 8-bit, C420jpeg,
  C420mpeg2, C420paldv, C420 or C444) is read by `Y4MReader`: frames come
  back as BGR uint8 (BT.601 limited range, chroma upsampled by
  replication), `fps` from the F ratio, `frame_count` from the file size.
  Any other file goes through `cv2.VideoCapture` where cv2 imports, and
  raises `VideoFormatError`, naming the file and what can be read, where
  it does not.  Either reader has `fps`, `frame_count`, `read() -> (ok,
  frame)` and `release()`.
* `open_writer(path, fps, size)`: an mp4v `cv2.VideoWriter`; where cv2
  is absent, `require_writer()` raises before any work.
* `write_y4m(path, frames_bgr, fps)`: writes a clip (C444 or C420jpeg)
  that `Y4MReader` and OpenCV's FFMPEG backend read.

The decode is not bit-equal to ffmpeg's (its fixed-point conversion and
chroma filter): `tests/test_torch_apps_io.py` states the difference.
"""

from __future__ import annotations

import os

import numpy as np

Y4M_MAGIC = b"YUV4MPEG2"
Y4M_CHROMA = ("420jpeg", "420mpeg2", "420paldv", "420", "444")


class VideoFormatError(RuntimeError):
    """A video file that the port cannot read (or write) without OpenCV."""


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


# ------------------------------------------------------------ colour

def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 limited-range Y'CbCr planes -> BGR uint8.  The chroma planes
    are full size or 2x2 subsampled (ceil(h/2) x ceil(w/2)): each chroma
    term is computed at the chroma planes' size and replicated."""
    h, w = y.shape
    sub = 1 if u.shape == y.shape else 2
    uf = (u.astype(np.float32) - 128.0) * np.float32(255.0 / 224.0)
    vf = (v.astype(np.float32) - 128.0) * np.float32(255.0 / 224.0)
    yf = (y.astype(np.float32) - 16.0) * np.float32(255.0 / 219.0)
    out = np.empty((h, w, 3), np.uint8)
    for c, term in enumerate((np.float32(1.772) * uf,
                              -np.float32(0.344136) * uf
                              - np.float32(0.714136) * vf,
                              np.float32(1.402) * vf)):
        if sub > 1:
            term = np.repeat(np.repeat(term, sub, 0), sub, 1)[:h, :w]
        term += yf
        np.rint(term, out=term)
        out[..., c] = np.clip(term, 0, 255)
    return out


def bgr_to_yuv(frame: np.ndarray):
    """BGR uint8 -> BT.601 limited-range Y, Cb, Cr planes (float32)."""
    f = frame.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    u = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    v = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    return y, u, v


# ------------------------------------------------------------ reader

class Y4MReader:
    """A YUV4MPEG2 file read frame by frame (`cap.read()`'s contract)."""

    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "rb")
        header = self._f.readline()
        if not header.startswith(Y4M_MAGIC):
            self._f.close()
            raise VideoFormatError(f"{self.path}: not a YUV4MPEG2 file")
        self.width = self.height = 0
        self.fps = 30.0
        chroma = "420jpeg"
        for tok in header[len(Y4M_MAGIC):].split():
            key, val = chr(tok[0]), tok[1:].decode()
            if key == "W":
                self.width = int(val)
            elif key == "H":
                self.height = int(val)
            elif key == "F":
                num, den = val.split(":")
                self.fps = int(num) / int(den)
            elif key == "C":
                chroma = val
        if chroma not in Y4M_CHROMA:
            self._f.close()
            raise VideoFormatError(
                f"{self.path}: chroma C{chroma} is not read; the port reads "
                f"8-bit C{', C'.join(Y4M_CHROMA)}")
        self.chroma = chroma
        w, h = self.width, self.height
        if chroma == "444":
            self._cw, self._ch = w, h
        else:
            self._cw, self._ch = (w + 1) // 2, (h + 1) // 2
        self._frame_bytes = w * h + 2 * self._cw * self._ch
        self._data_start = self._f.tell()
        size = os.path.getsize(self.path)
        self.frame_count = (size - self._data_start) // (
            len(b"FRAME\n") + self._frame_bytes)

    def isOpened(self) -> bool:
        return not self._f.closed

    def read(self):
        """(True, BGR uint8 frame), or (False, None) at the end."""
        line = self._f.readline()
        if not line.startswith(b"FRAME"):
            return False, None
        buf = self._f.read(self._frame_bytes)
        if len(buf) < self._frame_bytes:
            return False, None
        w, h, cw, ch = self.width, self.height, self._cw, self._ch
        planes = np.frombuffer(buf, np.uint8)
        y = planes[:w * h].reshape(h, w)
        u = planes[w * h:w * h + cw * ch].reshape(ch, cw)
        v = planes[w * h + cw * ch:].reshape(ch, cw)
        return True, yuv_to_bgr(y, u, v)

    def release(self) -> None:
        self._f.close()


class _CvReader:
    """cv2.VideoCapture behind the reader interface."""

    def __init__(self, cap):
        self._cap = cap
        cv2 = _cv2()
        self.fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def isOpened(self) -> bool:
        return self._cap.isOpened()

    def read(self):
        return self._cap.read()

    def release(self) -> None:
        self._cap.release()


def _is_y4m(path) -> bool:
    with open(path, "rb") as f:
        return f.read(len(Y4M_MAGIC)) == Y4M_MAGIC


def open_video(path):
    """A reader for `path` (see the module docstring); for a file that
    does not exist, None where cv2 is absent and cv2's closed capture
    where it is present (the JAX CLI's 'could not open' case)."""
    if os.path.exists(path) and _is_y4m(path):
        return Y4MReader(path)
    cv2 = _cv2()
    if cv2 is None:
        if not os.path.exists(path):
            return None
        raise VideoFormatError(
            f"{path}: only YUV4MPEG2 (.y4m: 8-bit "
            f"C{', C'.join(Y4M_CHROMA)}) is read without OpenCV; install "
            f"opencv-python to read other containers")
    return _CvReader(cv2.VideoCapture(str(path)))


# ------------------------------------------------------------ writers

def require_writer() -> None:
    """Raise unless `open_writer` can write (it needs cv2)."""
    if _cv2() is None:
        raise VideoFormatError(
            "-save_output writes mp4v through cv2.VideoWriter, and OpenCV "
            "(cv2) is not installed")


def open_writer(path, fps: float, size):
    """An mp4v cv2.VideoWriter of `size` = (width, height)."""
    require_writer()
    cv2 = _cv2()
    return cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                           tuple(size))


def write_y4m(path, frames_bgr, fps: int = 30, chroma: str = "420jpeg"):
    """Write BGR uint8 frames as a YUV4MPEG2 clip (C444, or C420jpeg with
    each chroma sample the mean of its 2x2 block)."""
    frames = list(frames_bgr)
    h, w = frames[0].shape[:2]
    if chroma not in ("444", "420jpeg"):
        raise ValueError("write_y4m writes C444 or C420jpeg")
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 "
                f"C{chroma}\n".encode())
        for fr in frames:
            y, u, v = bgr_to_yuv(fr)
            if chroma != "444":
                u, v = _subsample(u), _subsample(v)
            f.write(b"FRAME\n")
            for p in (y, u, v):
                f.write(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                        .tobytes())


def _subsample(p: np.ndarray) -> np.ndarray:
    h, w = p.shape
    p = np.pad(p, ((0, h % 2), (0, w % 2)), mode="edge")
    return p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean(axis=(1, 3))
