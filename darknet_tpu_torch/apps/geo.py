"""Geofencing: polygon zones from XML — port of `geo_info.cpp`
(tinyxml2 -> xml.etree.ElementTree); the port's copy of
`darknet_tpu/apps/geo.py`, drawing through `apps/raster` (no OpenCV).

XML schema (geo_info.cpp:306-340)::

    <polygons>
      <polygon><name>P1</name><num>4</num>
        <x0>.1</x0><y0>.1</y0> ... </polygon>
    </polygons>

Zones named ``P*`` become ParkingLot (occupancy timer while a STATIONARY
track's center is inside, geo_info.cpp:262-291); a zone named ``HANDOVER``
becomes a cross-camera handover region (enter/exit queues by bbox overlap,
label transfer via Crosstalk, geo_info.cpp:174-221).
"""

from __future__ import annotations

import dataclasses
import time
import xml.etree.ElementTree as ET
from collections import deque

from darknet_tpu_torch.apps import raster
from darknet_tpu_torch.apps.tracker import STATIONARY


def is_in_polygon(poly, pt) -> bool:
    """Ray-cast point-in-polygon (geo_info.cpp:71-88)."""
    x, y = pt
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        if (poly[i][1] > y) != (poly[j][1] > y) and \
                x < poly[i][0] + (poly[j][0] - poly[i][0]) * \
                (y - poly[i][1]) / (poly[j][1] - poly[i][1]):
            inside = not inside
        j = i
    return inside


def polygon_area(poly) -> float:
    """Shoelace (geo_info.cpp:90-104)."""
    if len(poly) < 3:
        return 0.0
    area = 0.0
    j = len(poly) - 1
    for i in range(len(poly)):
        area += (poly[j][0] + poly[i][0]) * (poly[j][1] - poly[i][1])
        j = i
    return abs(area / 2.0)


def _box_intersect(a, b) -> float:
    w = min(a[0] + a[2] / 2, b[0] + b[2] / 2) - \
        max(a[0] - a[2] / 2, b[0] - b[2] / 2)
    h = min(a[1] + a[3] / 2, b[1] + b[3] / 2) - \
        max(a[1] - a[3] / 2, b[1] - b[3] / 2)
    return 0.0 if (w < 0 or h < 0) else w * h


class PolyInfo:
    def __init__(self, name: str, poly):
        self.name = name
        self.poly = list(poly)
        xs = [p[0] for p in poly]
        ys = [p[1] for p in poly]
        self.bbox = ((min(xs) + max(xs)) / 2, (min(ys) + max(ys)) / 2,
                     max(xs) - min(xs), max(ys) - min(ys))

    def is_in_polygon(self, pt) -> bool:
        return is_in_polygon(self.poly, pt)

    def proc(self, tracks):  # pragma: no cover - overridden
        pass

    def draw(self, img, msg: str | None = None, bgr: bool = False):
        """Scale + draw the zone polygon with a centered message
        (PolyInfo::Draw, geo_info.cpp:132-166): closed red polyline,
        message (default: the zone name) centered at the polygon
        centroid, white halo under red text.  ``img`` is RGB HxWx3
        (the visualize module's convention); pass ``bgr=True`` for
        OpenCV-native BGR frames."""
        h, w = img.shape[:2]
        scaled = [(int(x * w + 0.5), int(y * h + 0.5)) for x, y in self.poly]
        red = (0, 0, 255) if bgr else (255, 0, 0)
        white = (255, 255, 255)
        font_sz = 0.7
        raster.polyline(img, scaled, red)
        if msg is None:
            msg = self.name
        cx = sum(p[0] for p in self.poly) * w / len(self.poly)
        cy = sum(p[1] for p in self.poly) * h / len(self.poly)
        (tw, th), _ = raster.text_size(msg, font_sz)
        org = (int(cx - tw / 2), int(cy + th / 2))
        raster.put_text(img, msg, org, font_sz, white, 3)
        raster.put_text(img, msg, org, font_sz, red, 1)
        return img


@dataclasses.dataclass
class Occupation:
    label: int = -1
    start: float = 0.0
    end: float = 0.0


class ParkingLot(PolyInfo):
    """Occupancy timer for a STATIONARY track inside the polygon."""

    def __init__(self, name, poly):
        super().__init__(name, poly)
        self.curr_occ = Occupation()
        self.occupations: list[Occupation] = []

    def proc(self, tracks):
        matched = False
        for t in tracks:
            center = (t.bbox[0], t.bbox[1])
            if not self.is_in_polygon(center):
                continue
            if self.curr_occ.start == 0 and t.status == STATIONARY:
                self.curr_occ.label = t.label
                self.curr_occ.start = time.time()
                matched = True
            elif self.curr_occ.start != 0 and self.curr_occ.label == t.label:
                matched = True
        if not matched and self.curr_occ.start != 0:
            self.curr_occ.end = time.time()
            self.occupations.append(self.curr_occ)
            self.curr_occ = Occupation()

    def occupied_seconds(self) -> float:
        if self.curr_occ.start == 0:
            return 0.0
        return time.time() - self.curr_occ.start

    def draw(self, img, msg: str | None = None, bgr: bool = False):
        """ParkingLot::Draw (geo_info.cpp:244-260): the message is the
        elapsed occupancy time as HH:MM:SS while occupied, else empty."""
        if msg is None:
            msg = ""
            if self.curr_occ.start != 0:
                diff = int(time.time() - self.curr_occ.start)
                msg = f"{diff // 3600:02d}:{diff // 60 % 60:02d}:" \
                      f"{diff % 60:02d}"
        return super().draw(img, msg, bgr=bgr)


class Handover(PolyInfo):
    """Cross-camera handover: tracks overlapping the zone's bbox by >50%
    queue as entering (young tracks) or exiting; Crosstalk transfers labels
    across two cameras' zones."""

    def __init__(self, name, poly, fps: float = 30.0):
        super().__init__(name, poly)
        self.fps = fps
        self.enter: deque = deque()
        self.exit: deque = deque()

    def proc(self, tracks):
        for t in tracks:
            box = t.bbox
            area_i = _box_intersect(self.bbox, box)
            denom = box[2] * box[3]
            if denom <= 0 or area_i / denom <= 0.5:
                continue
            if not t.enter_status and t.count < self.fps * 2:
                if t not in self.enter:
                    self.enter.append(t)
            elif not t.exit_status:
                if t not in self.exit:
                    self.exit.append(t)

    @staticmethod
    def crosstalk(h1: "Handover", h2: "Handover"):
        if h1.exit and h2.enter:
            label = h1.exit[0].label
            if label != -1:
                h2.enter[0].label = label
                h2.enter[0].enter_status = True
                h1.exit[0].exit_status = True
                h1.exit.popleft()
                h2.enter.popleft()
        if h2.exit and h1.enter:
            label = h2.exit[0].label
            if label != -1:
                h1.enter[0].label = label
                h1.enter[0].enter_status = True
                h2.exit[0].exit_status = True
                h2.exit.popleft()
                h1.enter.popleft()


class GeoInfo:
    def __init__(self):
        self.parking_lots: list[ParkingLot] = []
        self.handovers: list[Handover] = []

    def load(self, xml_path, fps: float = 30.0):
        try:
            tree = ET.parse(xml_path)
        except (ET.ParseError, OSError):
            return self
        root = tree.getroot()
        for polygon in root.findall("polygon"):
            name = polygon.findtext("name", "")
            num = int(polygon.findtext("num", "0"))
            poly = []
            for i in range(num):
                x = float(polygon.findtext(f"x{i}", "0"))
                y = float(polygon.findtext(f"y{i}", "0"))
                poly.append((x, y))
            if name.startswith("P"):
                self.parking_lots.append(ParkingLot(name, poly))
            elif name == "HANDOVER":
                self.handovers.append(Handover(name, poly, fps=fps))
        return self

    def proc(self, tracks):
        for p in self.parking_lots:
            p.proc(tracks)
        for hd in self.handovers:
            hd.proc(tracks)

    def draw(self, img, bgr: bool = False):
        """GeoInfo::Draw (geo_info.cpp:342-353): render every zone's
        polygon + status text onto the frame."""
        for p in self.parking_lots:
            p.draw(img, bgr=bgr)
        for hd in self.handovers:
            hd.draw(img, bgr=bgr)
        return img
