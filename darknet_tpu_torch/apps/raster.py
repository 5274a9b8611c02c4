"""Raster primitives for the overlays, on HxWxC uint8 numpy images, with
no OpenCV needed: the counterparts of the OpenCV drawing calls that
`darknet_tpu/apps/{visualize,geo}.py` make.

* `line`: cv::line, 8-connected (LINE_8), clipped as cv::clipLine clips;
  thickness >= 2 draws cv's thick line: the segment clipped to the image
  grown by the thickness, a filled quad of it in 16.16 fixed point and
  round caps (filled circles) at the ends the caller asks for;
* `polyline`: cv::polylines of a closed contour;
* `rectangle`: cv::rectangle, outlined (thickness >= 1) or filled (-1);
* `text_size`: cv::getTextSize for FONT_HERSHEY_COMPLEX_SMALL at
  thickness 1, from per-character advance and descent tables measured
  from OpenCV 5's built-in font at the overlays' scales (1.0, 0.7, 0.5;
  another scale raises): width = the advances' sum + 1, height a
  constant of the scale, baseline the largest descent of the string's
  characters; a character outside printable ASCII counts as '?';
* `put_text`: the port's own 5x7 bitmap font, each glyph resampled into
  its character's advance cell, every pixel inside the box that
  `text_size` gives for the origin.  Its glyphs are not OpenCV's (display
  only; the boxes, and so every pixel outside them, are).

Colours are tuples in the image's channel order.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    """Pixels x1..x2 (inclusive) of row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine on a w x h area: the clipped end points, or None when
    the segment misses the area."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line8(img, p0, p1, color) -> None:
    """cv::Line with LINE_8 (cv::LineIterator, left to right)."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p0, p1
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        c = clip_line(w, h, x1, y1, x2, y2)
        if c is None:
            return
        x1, y1, x2, y2 = c
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    if dy == 0:
        img[y1, x1:x2 + 1] = color
        return
    if dx == 0:
        lo, hi = min(y1, y2), max(y1, y2)
        img[lo:hi + 1, x1] = color
        return
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # the iterator steps the minor axis where its error (dx - 2dy at the
    # start, -2dy a step, +2dx on a minor step) is negative: in closed
    # form, (2dy k + dx - 1) // 2dx minor steps after k major ones
    k = np.arange(dx + 1)
    m = (2 * dy * k + dx - 1) // (2 * dx)
    if vert:
        img[y1 + sy * k, x1 + m] = color
    else:
        img[y1 + sy * m, x1 + k] = color


def _line2(img, p0, p1, color) -> None:
    """cv::Line2: an 8-connected line between 16.16 fixed-point points."""
    h, w = img.shape[:2]
    c = clip_line(w << XY_SHIFT, h << XY_SHIFT, *p0, *p1)
    if c is None:
        return
    x1, y1, x2, y2 = c
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    i = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = ((x1 + half) >> XY_SHIFT) + i
        ys = (y1 + half + i * step) >> XY_SHIFT
    else:
        xs = (x1 + half + i * step) >> XY_SHIFT
        ys = ((y1 + half) >> XY_SHIFT) + i
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_convex_poly(img, pts, color, shift: int = 0) -> None:
    """cv::FillConvexPoly with LINE_8: the outline, then a scanline fill
    between the two edge walkers (points in `shift`-bit fixed point)."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = (1 << shift) >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = pts[-1]
    p0 = (p0[0] << (XY_SHIFT - shift), p0[1] << (XY_SHIFT - shift))
    xmin = xmax = pts[0][0]
    ymin = ymax = pts[0][1]
    imin = 0
    for i, (px, py) in enumerate(pts):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if shift == 0:
            _line8(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # edge walkers: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs = pts[idx0][0] << (XY_SHIFT - shift)
                        xe = pts[idx][0] << (XY_SHIFT - shift)
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta1) >> XY_SHIFT
            xx2 = (edge[right][2] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, xx1, xx2, color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _fill_axis_rect(img, x1, y1, x2, y2, color, shift: int = 0) -> None:
    """fill_convex_poly of an axis-aligned rectangle with corners (x1, y1)
    and (x2, y2) in `shift`-bit fixed point: its outline and scanlines
    cover exactly the span of the rounded corners."""
    delta = (1 << shift) >> 1
    xa, xb = sorted(((x1 + delta) >> shift, (x2 + delta) >> shift))
    ya, yb = sorted(((y1 + delta) >> shift, (y2 + delta) >> shift))
    img[max(ya, 0):max(yb + 1, 0), max(xa, 0):max(xb + 1, 0)] = color


def fill_circle(img, cx: int, cy: int, r: int, color) -> None:
    """cv::Circle with fill: the midpoint circle's horizontal spans."""
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img, p0, p1, color, thickness: int, caps: int) -> None:
    """cv::ThickLine for thickness >= 2, LINE_8, integer end points:
    `caps` bit 0 and bit 1 ask for the round cap at p0 and p1.  As OpenCV
    5 does, the segment is first clipped to the image grown by the
    thickness on every side."""
    h, w = img.shape[:2]
    c = clip_line(w + 2 * thickness, h + 2 * thickness, p0[0] + thickness,
                  p0[1] + thickness, p1[0] + thickness, p1[1] + thickness)
    if c is None:
        return
    p0 = (c[0] - thickness, c[1] - thickness)
    p1 = (c[2] - thickness, c[3] - thickness)
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = _round(dy * r), _round(dx * r)
        if ddx == 0 or ddy == 0:            # along an axis
            _fill_axis_rect(img, x0 + ddx, y0 + ddy, x1 - ddx, y1 - ddy,
                            color, XY_SHIFT)
        else:
            fill_convex_poly(img, [(x0 + ddx, y0 + ddy),
                                   (x0 - ddx, y0 - ddy),
                                   (x1 - ddx, y1 - ddy),
                                   (x1 + ddx, y1 + ddy)], color, XY_SHIFT)
    for i, (px, py) in enumerate(((x0, y0), (x1, y1))):
        if caps & (i + 1):
            fill_circle(img, (px + (XY_ONE >> 1)) >> XY_SHIFT,
                        (py + (XY_ONE >> 1)) >> XY_SHIFT,
                        (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def _round(v: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(np.rint(v))


def line(img, p0, p1, color, thickness: int = 1) -> None:
    """cv::line(img, p0, p1, color, thickness), LINE_8."""
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        _line8(img, p0, p1, color)
    else:
        _thick_line(img, p0, p1, color, thickness, 3)


def polyline(img, pts, color, thickness: int = 1) -> None:
    """cv::polylines for one closed contour, LINE_8."""
    pts = [(int(x), int(y)) for x, y in pts]
    p0 = pts[-1] if pts else None
    for p in pts:
        if thickness <= 1:
            _line8(img, p0, p, color)
        else:
            _thick_line(img, p0, p, color, thickness, 2)
        p0 = p


def rectangle(img, p1, p2, color, thickness: int = 1) -> None:
    """cv::rectangle(img, p1, p2, color, thickness): an outline, or filled
    for a negative thickness."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness >= 0:
        polyline(img, pts, color, thickness)
    else:
        _fill_axis_rect(img, x1, y1, x2, y2, color)


# ------------------------------------------------------------------ text

_FIRST = 32                     # the tables cover chr(32) .. chr(126)
# OpenCV 5's FONT_HERSHEY_COMPLEX_SMALL at thickness 1: each printable
# character's advance (px) and descent below the baseline (px), and the
# text height, per scale (cv2.getTextSize of each character alone)
_ADVANCE = {
    1.0: [6, 5, 8, 16, 14, 17, 16, 5, 14, 14, 10, 14, 5, 11, 5, 11, 14, 14,
          14, 14, 14, 14, 14, 14, 14, 14, 6, 6, 11, 13, 11, 12, 19, 15, 15,
          15, 16, 14, 13, 16, 16, 6, 14, 14, 13, 18, 16, 15, 15, 15, 15, 14,
          13, 16, 15, 18, 14, 15, 14, 7, 11, 7, 10, 17, 7, 12, 14, 12, 14, 13,
          9, 14, 14, 5, 5, 12, 5, 20, 14, 13, 14, 14, 8, 12, 9, 14, 13, 18,
          12, 12, 11, 8, 5, 8, 13],
    0.7: [4, 3, 5, 11, 9, 12, 11, 3, 9, 9, 7, 9, 4, 7, 4, 7, 9, 9, 9, 9, 9,
          9, 9, 9, 9, 9, 4, 4, 7, 9, 7, 8, 13, 10, 10, 10, 11, 9, 9, 10, 11,
          4, 10, 9, 9, 12, 11, 10, 10, 10, 10, 9, 9, 11, 10, 12, 10, 10, 9, 5,
          7, 5, 6, 11, 5, 8, 9, 8, 9, 8, 6, 9, 9, 3, 4, 8, 3, 14, 9, 9, 9, 9,
          6, 8, 6, 9, 8, 12, 8, 8, 8, 5, 3, 5, 8],
    0.5: [3, 2, 4, 8, 7, 8, 8, 2, 7, 7, 5, 7, 2, 5, 2, 5, 7, 7, 7, 7, 7, 7,
          7, 7, 7, 7, 3, 3, 5, 6, 5, 6, 9, 7, 7, 7, 8, 7, 6, 8, 8, 3, 7, 7, 6,
          9, 8, 7, 7, 7, 7, 7, 6, 8, 7, 9, 7, 7, 7, 3, 5, 3, 5, 8, 3, 6, 7, 6,
          7, 6, 4, 7, 7, 2, 2, 6, 2, 10, 7, 6, 7, 7, 4, 6, 4, 7, 6, 9, 6, 6,
          5, 4, 2, 4, 6],
}
_DESCENT = {
    1.0: "00003110330020021001011010020000300100010010000102010100000424010"
         "111110600500001550101000504540",
    0.7: "00002110220020021001011010020000200100010010000102010100000323010"
         "111110400400001440101000403430",
    0.5: "00002110220010011001011010010000200100010010000101010100000212010"
         "111110300300001330101000302320",
}
_HEIGHT = {1.0: 22, 0.7: 15, 0.5: 11}

# the port's 5x7 font: five column bytes a character, bit 0 the top row
_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "14083e0814" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090901" "3e4149497a"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f020c027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "3f4038403f" "6314081463" "0708700807" "6151494543" "007f414100"
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "0c5252523e" "7f08040478" "00447d4000" "2040443d00"
    "7f10284400" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "1008081008")


def _table(scale: float) -> float:
    """The table key of `scale`: the overlays' scales only."""
    for k in _ADVANCE:
        if abs(scale - k) < 1e-9:
            return k
    raise ValueError(f"text scale {scale}: the font tables hold "
                     f"{sorted(_ADVANCE)}")


def _char_index(ch: str) -> int:
    i = ord(ch) - _FIRST
    return i if 0 <= i < len(_ADVANCE[1.0]) else ord("?") - _FIRST


def _advances(text: str, scale: float) -> list:
    adv = _ADVANCE[_table(scale)]
    return [adv[_char_index(c)] for c in text]


def text_size(text: str, scale: float):
    """cv::getTextSize(text, FONT_HERSHEY_COMPLEX_SMALL, scale, 1):
    ((width, height), baseline)."""
    if not text:
        return (0, 0), 0
    k = _table(scale)
    base = max(int(_DESCENT[k][_char_index(c)]) for c in text)
    return (sum(_advances(text, scale)) + 1, _HEIGHT[k]), base


def _glyph_mask(ch: str, w: int, h: int) -> np.ndarray:
    """The port's glyph of `ch` resampled (nearest) to h x w."""
    i = _char_index(ch)
    cols = np.frombuffer(_GLYPHS[5 * i:5 * i + 5], np.uint8)
    bits = (cols[None, :] >> np.arange(7)[:, None]) & 1    # 7 x 5
    ys = np.arange(h) * 7 // h
    xs = np.arange(w) * 5 // w
    return bits[ys][:, xs].astype(bool)


def put_text(img, text: str, org, scale: float, color,
             thickness: int = 1) -> None:
    """Draw `text` with the port's bitmap font, its baseline at org[1]
    and its left edge at org[0], inside the box of `text_size`: each
    character fills its advance cell (less one column) over the upper
    seven tenths of the text height; a thickness of 3 or more thickens
    the strokes by one pixel around, still inside the box."""
    if not text:
        return
    ih, iw = img.shape[:2]
    (tw, th), _base = text_size(text, scale)
    x0, y0 = int(org[0]), int(org[1])
    gh = max(1, int(round(th * 0.7)))
    mask = np.zeros((gh + 2, tw + 2), bool)
    x = 1
    for ch, adv in zip(text, _advances(text, scale)):
        if adv > 1:
            mask[1:gh + 1, x:x + adv - 1] = _glyph_mask(ch, adv - 1, gh)
        x += adv
    if thickness >= 3:
        grown = mask.copy()
        grown[1:] |= mask[:-1]
        grown[:-1] |= mask[1:]
        grown[:, 1:] |= mask[:, :-1]
        grown[:, :-1] |= mask[:, 1:]
        mask = grown
    # keep the ink in the box: columns x0 .. x0 + tw - 1, rows y0 - th ..
    # y0 - 1 (the mask's margin holds only the thickened strokes)
    mask = mask[1:gh + 1, 1:tw + 1]
    top = y0 - gh
    ys, xs = np.nonzero(mask)
    ys, xs = ys + top, xs + x0
    keep = (ys >= 0) & (ys < ih) & (xs >= 0) & (xs < iw)
    img[ys[keep], xs[keep]] = color
