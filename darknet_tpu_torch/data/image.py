"""Image I/O, the inference resizes and letterbox, and the image
operations of the training data path (`darknet_tpu/data/image.py`, and
the OpenCV calls of `darknet_tpu/data/augment.py`), with no OpenCV or PIL
needed.

Images are HWC float32 RGB in [0, 1].  8-bit PNGs (gray, RGB, RGBA; not
interlaced) are read and RGB PNGs written with the standard library
(`zlib`, `struct`); any other file goes through cv2 or PIL where one is
installed, and raises ImportError where neither is.  A file that cannot
be read or decoded raises `ImageDecodeError` (or OSError), which the
loader treats as a bad image.

The five OpenCV operations, each matching OpenCV's float32 semantics:

* `resize_linear`: cv::resize INTER_LINEAR (half-pixel centres, clamped
  edges, no antialiasing), as torch's bilinear interpolate with
  align_corners=False; `resize_u8` is the same resize on uint8 images in
  OpenCV's 11-bit fixed point, bitwise;
* `pad_constant`: cv::copyMakeBorder BORDER_CONSTANT;
* `flip_horizontal`: cv::flip(img, 1);
* `rgb_to_hsv` / `hsv_to_rgb`: cv::cvtColor COLOR_RGB2HSV / COLOR_HSV2RGB
  on float images (H in [0, 360), S and V in [0, 1]);
* `gaussian_blur`: cv::GaussianBlur with a square kernel and sigma 0
  (OpenCV's sigma rule and its fixed kernels up to 9 taps), reflect-101
  border, as a separable depthwise conv.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_FLT_EPS = np.float32(1.19209290e-07)


class ImageDecodeError(ValueError):
    """An image file that exists but cannot be decoded."""


# ------------------------------------------------------------------ PNG

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ft = data[pos]
        line = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += 1 + stride
        if ft == 0:
            cur = line.copy()
        elif ft == 1:
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ft == 2:
            cur = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 255
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(a, b, c)) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ImageDecodeError(f"PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray | None:
    """An 8-bit, non-interlaced PNG as an (H, W, C) uint8 array (C = 1, 3
    or 4); None for any other PNG variant; ImageDecodeError for a file
    that is not a PNG or is damaged."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_PNG_SIG):
        raise ImageDecodeError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    try:
        while pos < len(blob):
            n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
            body = blob[pos + 8:pos + 8 + n]
            if len(body) != n:
                raise ImageDecodeError(f"{path}: truncated PNG")
            pos += 12 + n
            if kind == b"IHDR":
                hdr = struct.unpack(">IIBBBBB", body)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
        if hdr is None:
            raise ImageDecodeError(f"{path}: PNG without IHDR")
        w, h, depth, ctype, _comp, _filt, interlace = hdr
        chans = {0: 1, 2: 3, 6: 4}.get(ctype)
        if depth != 8 or chans is None or interlace:
            return None
        raw = zlib.decompress(b"".join(idat))
    except (struct.error, zlib.error) as e:
        raise ImageDecodeError(f"{path}: {e}") from e
    if len(raw) < h * (1 + w * chans):
        raise ImageDecodeError(f"{path}: truncated PNG data")
    return _unfilter(raw, h, w * chans, chans).reshape(h, w, chans)


def write_png(path, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB array as an 8-bit PNG (filter None)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("write_png writes RGB images")

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def load_image_rgb(path) -> np.ndarray:
    """Load an image file -> HWC float32 RGB in [0,1]."""
    path = str(path)
    with open(path, "rb") as f:
        is_png = f.read(8) == _PNG_SIG
    m = read_png(path) if is_png else None
    if m is not None:
        if m.shape[2] == 1:
            m = np.repeat(m, 3, axis=2)
        return m[..., :3].astype(np.float32) / 255.0
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        m = cv2.imread(path, cv2.IMREAD_COLOR)
        if m is None:
            raise ImageDecodeError(f"{path}: cv2 cannot decode it")
        return cv2.cvtColor(m, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: only 8-bit PNGs are read without OpenCV or PIL") from e
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    except OSError as e:
        raise ImageDecodeError(f"{path}: {e}") from e


# ------------------------------------------------------- the OpenCV ops

def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv::resize(img, (w, h), INTER_LINEAR) on an HWC float32 image."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    y = F.interpolate(t.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


# ------------------------------------------- inference resize, letterbox

def resize_image_darknet(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Exact port of the reference's two-pass bilinear `resize_image`
    (image.cpp): first horizontal, then vertical, with edge clamping on the
    last column.  im is HWC float32."""
    ih, iw, c = im.shape
    if (iw, ih) == (w, h):
        return im.copy()
    w_scale = np.float32((iw - 1) / (w - 1)) if w > 1 else np.float32(0)
    h_scale = np.float32((ih - 1) / (h - 1)) if h > 1 else np.float32(0)

    # horizontal pass -> (ih, w, c): last output column (or 1-wide input)
    # copies the input's last column verbatim (image.cpp:594-597)
    sx = np.arange(w, dtype=np.float32) * w_scale
    ix = sx.astype(np.int64)
    dx = (sx - ix).astype(np.float32)
    ix1 = np.minimum(ix + 1, iw - 1)
    part = (1 - dx)[None, :, None] * im[:, np.minimum(ix, iw - 1), :] + \
        dx[None, :, None] * im[:, ix1, :]
    last_col = (np.arange(w) == w - 1) | (iw == 1)
    part[:, last_col, :] = im[:, iw - 1:iw, :]

    # vertical pass -> (h, w, c): second tap skipped on the last row
    # (image.cpp:619-626)
    sy = np.arange(h, dtype=np.float32) * h_scale
    iy = sy.astype(np.int64)
    dy = (sy - iy).astype(np.float32)
    iy0 = np.minimum(iy, ih - 1)
    iy1 = np.minimum(iy + 1, ih - 1)
    out = (1 - dy)[:, None, None] * part[iy0, :, :]
    skip = (np.arange(h) == h - 1) | (ih == 1)
    out += np.where(skip[:, None, None], 0.0,
                    dy[:, None, None] * part[iy1, :, :])
    return out.astype(np.float32)


def _u8_taps(dst: int, src: int, clamp: bool):
    """cv::resize INTER_LINEAR's taps for 8-bit images: source indices and
    11-bit fixed-point weights (float32 fractions rounded to nearest
    even).  Columns clamp the fraction at the borders; rows keep it and
    clip the row index (both taps then read the border row)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        edge = s >= src - 1
        f[edge] = 0
        s[edge] = src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def resize_u8(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv::resize(INTER_LINEAR) on an HWC (or HW) uint8 image, bitwise:
    the horizontal pass in exact integers, the vertical pass as OpenCV's
    vector path computes it (each row's sum >> 4 times its 11-bit weight,
    >> 16, the two added, rounded by (t + 2) >> 2).  Every intermediate
    fits int32."""
    im = np.asarray(im)
    ih, iw = im.shape[:2]
    x0, x1, a0, a1 = _u8_taps(w, iw, clamp=True)
    y0, y1, b0, b1 = _u8_taps(h, ih, clamp=False)
    src = im if im.ndim == 3 else im[..., None]
    # the horizontal pass on the source rows that the taps read only
    used, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    src = src[used]
    rows = src[:, x0].astype(np.int32) * a0[None, :, None]
    rows += src[:, x1].astype(np.int32) * a1[None, :, None]
    rows >>= 4
    t = rows[inv[:h]] * b0[:, None, None]
    t >>= 16
    t1 = rows[inv[h:]] * b1[:, None, None]
    t1 >>= 16
    t += t1
    t += 2
    t >>= 2
    out = np.clip(t, 0, 255).astype(np.uint8)
    return out if im.ndim == 3 else out[..., 0]


def resize_image_cv(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv::resize INTER_LINEAR, the reference CLI's inference resize, with
    no OpenCV needed: `resize_u8` for a uint8 image (the streaming modes'
    device path), `resize_linear` for a float one."""
    if np.asarray(im).dtype == np.uint8:
        return resize_u8(im, w, h)
    return resize_linear(im, w, h)


def correct_boxes_letterbox(boxes, img_w: int, img_h: int, net_w: int,
                            net_h: int):
    """Map relative center-format boxes from letterboxed net coords back to
    original-image relative coords (the upstream correct_yolo_boxes
    analogue, for the optional letterbox path)."""
    boxes = np.asarray(boxes, dtype=np.float32).copy()
    scale = min(net_w / img_w, net_h / img_h)
    nw, nh = img_w * scale, img_h * scale
    dx = (net_w - nw) / 2 / net_w
    dy = (net_h - nh) / 2 / net_h
    boxes[..., 0] = (boxes[..., 0] - dx) / (nw / net_w)
    boxes[..., 1] = (boxes[..., 1] - dy) / (nh / net_h)
    boxes[..., 2] = boxes[..., 2] / (nw / net_w)
    boxes[..., 3] = boxes[..., 3] / (nh / net_h)
    return boxes


def letterbox_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Aspect-preserving resize with 0.5-gray padding (upstream darknet's
    letterbox)."""
    ih, iw, c = im.shape
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = resize_image_cv(im, nw, nh)
    out = np.full((h, w, c), 0.5, dtype=np.float32)
    dy, dx = (h - nh) // 2, (w - nw) // 2
    out[dy:dy + nh, dx:dx + nw, :] = resized
    return out


def make_letterbox_device(img_h: int, img_w: int, net_w: int, net_h: int,
                          channels: int = 3, device="cuda"):
    """On-device batched letterbox: (N, img_h, img_w, C) uint8 frames (a
    numpy array or a tensor) -> (N, net_h, net_w, C) float32 in [0, 1] on
    `device`, aspect preserved, 0.5-gray padding at the offsets of
    `correct_boxes_letterbox`.  The frames upload as uint8 and normalise
    through a table of the host's quotients v / 255 (as `Network` does);
    the resize is torch's bilinear (half-pixel centres, clamped source
    coordinates, no antialiasing), where the JAX package's
    jax.image.resize renormalises its triangle weights at the borders:
    the two agree to interpolation tolerance, not bit for bit."""
    from darknet_tpu_torch.nn.params import resolve_device

    device = resolve_device(device)
    scale = min(net_w / img_w, net_h / img_h)
    nw, nh = int(img_w * scale), int(img_h * scale)
    dy, dx = (net_h - nh) // 2, (net_w - nw) // 2
    unit = torch.from_numpy(
        np.arange(256, dtype=np.float32) / np.float32(255)).to(device)

    def letterbox(frames):
        x = torch.as_tensor(frames).to(device)
        if x.shape[1:] != (img_h, img_w, channels):
            raise ValueError(f"letterbox built for ({img_h}, {img_w}, "
                             f"{channels}) frames, got {tuple(x.shape)}")
        x = unit[x.long()].permute(0, 3, 1, 2)
        r = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          align_corners=False, antialias=False)
        out = torch.full((x.shape[0], channels, net_h, net_w), 0.5,
                         dtype=torch.float32, device=device)
        out[:, :, dy:dy + nh, dx:dx + nw] = r
        return out.permute(0, 2, 3, 1).contiguous()

    return letterbox


def pad_constant(img: np.ndarray, top: int, bottom: int, left: int,
                 right: int, value) -> np.ndarray:
    """cv::copyMakeBorder(BORDER_CONSTANT, value): one fill per channel."""
    h, w, c = img.shape
    out = np.empty((h + top + bottom, w + left + right, c), img.dtype)
    out[:] = np.asarray(value, img.dtype)[:c]
    out[top:top + h, left:left + w] = img
    return out


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    """cv::flip(img, 1)."""
    return np.ascontiguousarray(img[:, ::-1])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv::cvtColor(COLOR_RGB2HSV) on float32 (RGB2HSV_f)."""
    r, g, b = (img[..., i].astype(np.float32) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPS)
    diff = np.float32(60.0) / (diff + _FLT_EPS)
    h = np.where(v == r, (g - b) * diff,
                 np.where(v == g, (b - r) * diff + np.float32(120.0),
                          (r - g) * diff + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv::cvtColor(COLOR_HSV2RGB) on float32, as OpenCV's vector path
    (HSV2RGB_simd) computes it for every pixel of an image whose pixel
    count is a multiple of the vector width: sector = trunc(h * 6/360)
    modulo 6 by truncation and f = h - trunc(h), so a negative hue (a
    hue shift below 0) lands in sector 0 with a negative f, where the
    scalar path would wrap it by 360.  S and V are not clamped."""
    h, s, v = (img[..., i].astype(np.float32) for i in range(3))
    h = h * np.float32(6.0 / 360.0)
    pre = np.trunc(h)
    f = h - pre
    sector = pre - np.trunc(pre * np.float32(1.0 / 6.0)) * np.float32(6.0)
    one = np.float32(1.0)
    t0, t1 = v, v * (one - s)
    t2, t3 = v * (one - s * f), v * (one - s * (one - f))
    b = np.where(sector < 2, t1, np.where(sector <= 2, t3, np.where(
        sector <= 4, t0, t2)))
    g = np.where(sector < 1, t3, np.where(sector <= 2, t0, np.where(
        sector <= 3, t2, t1)))
    r = np.where(sector < 1, t0, np.where(sector < 2, t2, np.where(
        sector < 4, t1, np.where(sector <= 4, t3, t0))))
    return np.stack([r, g, b], axis=-1).astype(np.float32)


# getGaussianKernel's fixed kernels for 1-9 taps when sigma <= 0
_SMALL_GAUSS = {1: [1.0], 3: [0.25, 0.5, 0.25],
                5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                    0.03125],
                9: [0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375,
                    0.19921875, 0.1171875, 0.05078125, 0.015625]}


def gaussian_kernel(n: int) -> np.ndarray:
    """cv::getGaussianKernel(n, 0, CV_32F)."""
    if n in _SMALL_GAUSS:
        return np.asarray(_SMALL_GAUSS[n], np.float32)
    sigma = ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(x * x * (-0.5 / (sigma * sigma)))
    return (t * (1.0 / t.sum())).astype(np.float32)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv::GaussianBlur(img, (k, k), 0): separable, reflect-101 border."""
    kern = torch.from_numpy(gaussian_kernel(k))
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    c = t.shape[2]
    x = t.permute(2, 0, 1)[None]
    r = k // 2
    x = F.pad(x, (r, r, r, r), mode="reflect")
    x = F.conv2d(x, kern.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    x = F.conv2d(x, kern.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return x[0].permute(1, 2, 0).contiguous().numpy()
