"""The port's raster primitives and overlays (`darknet_tpu_torch/apps/
{raster,visualize}.py`, `GeoInfo.draw`) against OpenCV and the JAX
package's overlays.

* Primitives against cv2 on random shapes, bitwise: lines, rectangles
  (outlined and filled) and closed polylines, thin and thick, with end
  points inside and outside the image.
* `text_size` equals cv2.getTextSize (FONT_HERSHEY_COMPLEX_SMALL,
  thickness 1) for every printable character and every overlay string at
  scales 1.0, 0.7 and 0.5.
* Each overlay equals the JAX package's image bitwise outside the text
  boxes: a box is cv2.getTextSize's at the call's scale and thickness,
  from 2 px left of the origin (where OpenCV's glyphs reach) to the
  baseline.  Both packages put the same strings at the same origins; the
  port's glyphs leave ink inside every box and none outside.
"""

import cv2
import numpy as np
import pytest

from darknet_tpu.apps import geo as jgeo
from darknet_tpu.apps import tracker as jtracker
from darknet_tpu.apps import visualize as jviz
from darknet_tpu_torch.apps import geo as tgeo
from darknet_tpu_torch.apps import raster
from darknet_tpu_torch.apps import visualize as tviz
from darknet_tpu_torch.data.image import read_png

FONT = cv2.FONT_HERSHEY_COMPLEX_SMALL
COLOR = (255, 128, 7)
PRINTABLE = [chr(c) for c in range(32, 127)]
GLYPH_REACH = 2          # px OpenCV's glyphs reach left of the origin


def _shapes(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        p = [int(v) for v in rng.integers(-30, 90, 8)]
        yield h, w, p, int(rng.integers(1, 8))


KINDS = ["line", "thick_line", "axis_lines", "rect", "filled_rect",
         "closed_polyline"]


@pytest.mark.parametrize("kind", KINDS)
def test_primitive_equals_cv2(kind):
    """Random shapes, end points inside and outside the image, thickness
    1-7 (2-7 for the thick kinds), bitwise."""
    for h, w, p, t in _shapes(KINDS.index(kind), 400):
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        p0, p1 = tuple(p[:2]), tuple(p[2:4])
        quad = [tuple(p[i:i + 2]) for i in (0, 2, 4, 6)]
        if kind == "line":
            cv2.line(a, p0, p1, COLOR, 1)
            raster.line(b, p0, p1, COLOR, 1)
        elif kind == "thick_line":
            cv2.line(a, p0, p1, COLOR, max(t, 2))
            raster.line(b, p0, p1, COLOR, max(t, 2))
        elif kind == "axis_lines":
            for q in ((p[4], p[1]), (p[0], p[5])):
                cv2.line(a, p0, q, COLOR, t)
                raster.line(b, p0, q, COLOR, t)
        elif kind == "rect":
            cv2.rectangle(a, p0, p1, COLOR, t)
            raster.rectangle(b, p0, p1, COLOR, t)
        elif kind == "filled_rect":
            cv2.rectangle(a, p0, p1, COLOR, -1)
            raster.rectangle(b, p0, p1, COLOR, -1)
        else:
            cv2.polylines(a, [np.array(quad, np.int32)], True, COLOR, t)
            raster.polyline(b, quad, COLOR, t)
        np.testing.assert_array_equal(b, a, err_msg=f"{kind} {h}x{w} {p}")


def test_text_size_equals_cv2():
    rng = np.random.default_rng(0)
    strings = PRINTABLE + [
        "person(87%)", "car( 5%)", "c17(3,95%)", "truck(12,100%)",
        "Proc time: 37 ms", "Frame: 12/64", "00:01:05", "P1", "HANDOVER",
        "0.5", "1000", "avg loss", "mAP%", "dont_show(50%)", "",
        "".join(rng.choice(PRINTABLE, 40))]
    for scale in (1.0, 0.7, 0.5):
        for s in strings:
            assert raster.text_size(s, scale) == \
                cv2.getTextSize(s, FONT, scale, 1), (s, scale)


def _text_spies(monkeypatch):
    """Record the putText calls of both packages: (text, org, scale,
    thickness)."""
    calls = {"jax": [], "port": []}
    put_cv, put_port = cv2.putText, raster.put_text

    def spy_cv(img, text, org, font, scale, color, thickness=1, *a, **k):
        calls["jax"].append((text, tuple(org), scale, thickness))
        return put_cv(img, text, org, font, scale, color, thickness, *a, **k)

    def spy_port(img, text, org, scale, color, thickness=1):
        calls["port"].append((text, tuple(org), scale, thickness))
        return put_port(img, text, org, scale, color, thickness)

    monkeypatch.setattr(cv2, "putText", spy_cv)
    monkeypatch.setattr(raster, "put_text", spy_port)
    return calls


def _boxes(calls, shape):
    """The text boxes of the recorded calls (cv2.getTextSize at each
    call's scale and thickness) as one mask, and the boxes that lie
    wholly inside the image as slice pairs."""
    mask = np.zeros(shape[:2], bool)
    boxes = []
    for text, (x, y), scale, thickness in calls:
        (w, h), base = cv2.getTextSize(text, FONT, scale, thickness)
        if not text.strip():
            continue
        sl = (slice(max(y - h, 0), max(y + base + 1, 0)),
              slice(max(x - GLYPH_REACH, 0), max(x + w, 0)))
        mask[sl] = True
        if y - h >= 0 and x >= 0 and y + base < shape[0] and \
                x + w <= shape[1]:
            boxes.append(sl)
    return mask, boxes


def _held_to_jax(jax_img, port_img, port_plain, calls):
    """`port_plain` is the port's image drawn with put_text switched off."""
    assert [c[:3] for c in calls["port"]] == [c[:3] for c in calls["jax"]]
    mask, boxes = _boxes(calls["jax"], jax_img.shape)
    outside = ~mask
    np.testing.assert_array_equal(port_img[outside], jax_img[outside])
    ink = (port_img != port_plain).any(-1)
    assert not (ink & outside).any(), "the port's glyphs leave their box"
    assert boxes
    for sl in boxes:
        assert ink[sl].any(), "a text box without ink"
    return mask


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    return np.ascontiguousarray(np.repeat(np.repeat(img, 8, 0), 8, 1)[:h, :w])


def _dets(mod, seed, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = rng.uniform(-0.05, 1.05, 2)
        s = rng.uniform(0.05, 0.5, 2)
        out.append(mod.MostProbDet((float(c[0]), float(c[1]), float(s[0]),
                                    float(s[1])), int(rng.integers(0, 90)),
                                   float(rng.uniform(0.05, 1.0))))
    return out


NAMES = [f"class{i}" for i in range(80)]


@pytest.mark.parametrize("h,w", [(120, 160), (720, 1280)])
def test_draw_detections_equals_jax(monkeypatch, h, w):
    calls = _text_spies(monkeypatch)
    frame = _frame(h, w, 1)
    a = jviz.draw_detections(frame.copy(), _dets(jtracker, 2), NAMES)
    b = tviz.draw_detections(frame.copy(), _dets(jtracker, 2), NAMES)
    monkeypatch.setattr(raster, "put_text", lambda *a, **k: None)
    plain = tviz.draw_detections(frame.copy(), _dets(jtracker, 2), NAMES)
    _held_to_jax(a, b, plain, calls)


def _tracks(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, d in enumerate(_dets(mod, seed, 10)):
        t = mod.Track(d, mod.ConfParam(), 10.0)
        t.label = int(rng.integers(-1, 40))
        t.status = mod.STATIONARY if i % 3 == 0 else mod.MOVING
        out.append(t)
    return out


@pytest.mark.parametrize("h,w", [(120, 160), (720, 1280)])
def test_draw_trackings_equals_jax(monkeypatch, h, w):
    """Stationary tracks, and every track of a 1280 px frame, have thick
    (2 and 4 px) outlines."""
    from darknet_tpu_torch.apps import tracker as ttracker

    calls = _text_spies(monkeypatch)
    frame = _frame(h, w, 3)
    a = jviz.draw_trackings(frame.copy(), _tracks(jtracker, 4), NAMES)
    b = tviz.draw_trackings(frame.copy(), _tracks(ttracker, 4), NAMES)
    monkeypatch.setattr(raster, "put_text", lambda *a, **k: None)
    plain = tviz.draw_trackings(frame.copy(), _tracks(ttracker, 4), NAMES)
    _held_to_jax(a, b, plain, calls)


def test_proc_time_and_frame_info_equal_jax(monkeypatch):
    calls = _text_spies(monkeypatch)
    frame = _frame(240, 320, 5)
    a = jviz.draw_frame_info(jviz.draw_proc_time(frame.copy(), 37.8), 12, 64)
    b = tviz.draw_frame_info(tviz.draw_proc_time(frame.copy(), 37.8), 12, 64)
    monkeypatch.setattr(raster, "put_text", lambda *a, **k: None)
    plain = tviz.draw_frame_info(tviz.draw_proc_time(frame.copy(), 37.8),
                                 12, 64)
    mask = _held_to_jax(a, b, plain, calls)
    assert mask.sum() < mask.size // 4


GEO_XML = """<polygons>
  <polygon><name>P1</name><num>4</num>
    <x0>0.1</x0><y0>0.1</y0><x1>0.5</x1><y1>0.12</y1>
    <x2>0.45</x2><y2>0.4</y2><x3>0.1</x3><y3>0.4</y3></polygon>
  <polygon><name>HANDOVER</name><num>3</num>
    <x0>0.6</x0><y0>0.5</y0><x1>1.0</x1><y1>0.6</y1>
    <x2>0.7</x2><y2>1.0</y2></polygon>
</polygons>
"""


@pytest.mark.parametrize("bgr", [False, True])
def test_geo_draw_equals_jax(monkeypatch, tmp_path, bgr):
    """Zone outlines, names, and a parked lot's HH:MM:SS under one clock."""
    class Clock:
        now = 5000.0

        def time(self):
            return self.now

    monkeypatch.setattr(jgeo, "time", Clock())
    monkeypatch.setattr(tgeo, "time", Clock())
    xml = tmp_path / "cam.xml"
    xml.write_text(GEO_XML)
    geos = [jgeo.GeoInfo().load(str(xml)), tgeo.GeoInfo().load(str(xml)),
            tgeo.GeoInfo().load(str(xml))]
    for g in geos:
        g.parking_lots[0].curr_occ.start = 5000.0 - 3725.0
    calls = _text_spies(monkeypatch)
    frame = _frame(180, 240, 6)
    a = geos[0].draw(frame.copy(), bgr=bgr)
    b = geos[1].draw(frame.copy(), bgr=bgr)
    monkeypatch.setattr(raster, "put_text", lambda *a, **k: None)
    plain = geos[2].draw(frame.copy(), bgr=bgr)
    _held_to_jax(a, b, plain, calls)
    assert calls["port"][0][0] == "01:02:05"


def test_loss_chart_equals_jax(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    iters = list(range(0, 400, 7))
    losses = list(np.cumsum(rng.normal(0, 0.2, len(iters))) + 3.0)
    losses[5] = float("nan")
    map_iters, maps = [100, 200, 300], [0.1, 0.35, 0.3]
    calls = _text_spies(monkeypatch)
    a = jviz.draw_loss_chart(iters, losses, map_iters, maps, max_iter=400,
                             path=None)
    path = tmp_path / "chart.png"
    b = tviz.draw_loss_chart(iters, losses, map_iters, maps, max_iter=400,
                             path=str(path))
    monkeypatch.setattr(raster, "put_text", lambda *a, **k: None)
    plain = tviz.draw_loss_chart(iters, losses, map_iters, maps,
                                 max_iter=400, path=None)
    _held_to_jax(a, b, plain, calls)
    np.testing.assert_array_equal(read_png(str(path)), b)


def test_gui_off_without_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert not tviz.gui_ok()
    assert tviz.safe_imshow("w", np.zeros((4, 4, 3), np.uint8)) == -1
