"""The port's tracker and geofences (`darknet_tpu_torch/apps/{tracker,
geo}.py`) against the JAX package's on the same inputs.

Tracker: random detection sequences over several seeds (objects that
spawn, move, cross, stop and vanish, with dropped and spurious
detections) through both TrackManagers, compared after every frame track
by track: boxes at 1e-6, labels (both class-wide label counters reset to
0 first), confidence, count and status, and the saved tracks.  Geo: the
XML load, the polygon helpers, a ParkingLot under one patched clock, and
Handover.crosstalk.
"""

import numpy as np
import pytest

from darknet_tpu.apps import geo as jgeo
from darknet_tpu.apps import tracker as jtracker
from darknet_tpu_torch.apps import geo as tgeo
from darknet_tpu_torch.apps import tracker as ttracker

FPS = 10.0


def _scene(seed, frames=90):
    """Per frame, a list of (bbox, cid, prob): movers on straight lines
    (two of them crossing), a parked object (prob > 0.9, still), objects
    that appear late or vanish early, jittered boxes, dropped detections
    and a few spurious ones."""
    rng = np.random.default_rng(seed)
    objs = []
    for k in range(5):
        start = rng.uniform(0.15, 0.85, 2)
        vel = rng.uniform(-0.01, 0.01, 2)
        size = rng.uniform(0.06, 0.2, 2)
        t0 = int(rng.integers(0, frames // 3))
        t1 = int(rng.integers(frames // 2, frames + 1))
        objs.append((start, vel, size, t0, t1, int(rng.integers(0, 4)),
                     float(rng.uniform(0.5, 0.9))))
    # two objects crossing each other's path
    objs.append((np.array([0.2, 0.5]), np.array([0.008, 0.0]),
                 np.array([0.1, 0.12]), 0, frames, 1, 0.8))
    objs.append((np.array([0.8, 0.52]), np.array([-0.008, 0.0]),
                 np.array([0.1, 0.12]), 0, frames, 2, 0.8))
    # a parked car: still, confident
    objs.append((np.array([0.5, 0.2]), np.zeros(2), np.array([0.15, 0.1]),
                 5, frames, 0, 0.97))
    seq = []
    for t in range(frames):
        dets = []
        for start, vel, size, t0, t1, cid, prob in objs:
            if not t0 <= t < t1 or rng.uniform() < 0.08:
                continue
            c = start + vel * (t - t0) + rng.normal(0, 0.002, 2)
            s = size * (1 + rng.normal(0, 0.02, 2))
            dets.append(((float(c[0]), float(c[1]), float(s[0]),
                          float(s[1])), cid,
                         float(min(0.999, prob + rng.normal(0, 0.01)))))
        for _ in range(int(rng.poisson(0.3))):
            c = rng.uniform(0.1, 0.9, 2)
            dets.append(((float(c[0]), float(c[1]), 0.05, 0.05),
                         int(rng.integers(0, 4)), 0.4))
        rng.shuffle(dets)
        seq.append(dets)
    return seq


def _state(tm):
    return [(t.bbox, t.label, t.conf, t.count, t.status, t.det.cid,
             t.det.prob) for t in tm.tracks]


def _assert_same(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        np.testing.assert_allclose(ta[0], tb[0], rtol=0, atol=1e-6)
        assert ta[1:5] == tb[1:5]
        assert ta[5] == tb[5]
        assert abs(ta[6] - tb[6]) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_track_manager_matches_jax(seed):
    seq = _scene(seed)
    jtracker.Track._shared_label = 0
    ttracker.Track._shared_label = 0
    cp = jtracker.ConfParam.from_fps(FPS)
    jtm = jtracker.TrackManager(cp, FPS, 0.3)
    ttm = ttracker.TrackManager(ttracker.ConfParam.from_fps(FPS), FPS, 0.3)
    statuses = set()
    for dets in seq:
        jtm.track([jtracker.MostProbDet(b, c, p) for b, c, p in dets])
        ttm.track([ttracker.MostProbDet(b, c, p) for b, c, p in dets])
        _assert_same(_state(ttm), _state(jtm))
        assert [t.label for t in ttm.get_tracks()] == \
            [t.label for t in jtm.get_tracks()]
        statuses |= {t.status for t in ttm.tracks}
    saved_j = [(t.bbox, t.label, t.conf, t.count, t.status, t.det.cid,
                t.det.prob) for t in jtm.get_saved_tracks()]
    saved_t = [(t.bbox, t.label, t.conf, t.count, t.status, t.det.cid,
                t.det.prob) for t in ttm.get_saved_tracks()]
    _assert_same(saved_t, saved_j)
    # the scenes exercise what the test claims: both statuses, labels
    assert statuses == {ttracker.MOVING, ttracker.STATIONARY}
    assert ttracker.Track._shared_label > 3


def test_most_prob_dets_match_jax():
    rng = np.random.default_rng(5)

    class D:
        def __init__(self, bbox, prob):
            self.bbox, self.prob = bbox, prob

    dets = [D(tuple(rng.uniform(0, 1, 4)),
              np.where(rng.uniform(size=6) < (0.5 if i % 4 else 1.0), 0.0,
                       rng.uniform(size=6)).astype(np.float32))
            for i in range(40)]
    a = ttracker.get_most_prob_dets(dets)
    b = jtracker.get_most_prob_dets(dets)
    assert [(d.bbox, d.cid, d.prob) for d in a] == \
        [(d.bbox, d.cid, d.prob) for d in b]
    assert 0 < len(a) < len(dets)


GEO_XML = """<polygons>
  <polygon><name>P1</name><num>4</num>
    <x0>0.1</x0><y0>0.1</y0><x1>0.5</x1><y1>0.1</y1>
    <x2>0.5</x2><y2>0.4</y2><x3>0.1</x3><y3>0.4</y3></polygon>
  <polygon><name>P2</name><num>3</num>
    <x0>0.6</x0><y0>0.6</y0><x1>0.9</x1><y1>0.65</y1>
    <x2>0.7</x2><y2>0.95</y2></polygon>
  <polygon><name>HANDOVER</name><num>4</num>
    <x0>0.6</x0><y0>0.0</y0><x1>1.0</x1><y1>0.0</y1>
    <x2>1.0</x2><y2>0.5</y2><x3>0.6</x3><y3>0.5</y3></polygon>
  <polygon><name>other</name><num>3</num>
    <x0>0</x0><y0>0</y0><x1>1</x1><y1>0</y1><x2>0</x2><y2>1</y2></polygon>
</polygons>
"""


def test_geo_load_and_polygon_helpers(tmp_path):
    xml = tmp_path / "cam.xml"
    xml.write_text(GEO_XML)
    a = tgeo.GeoInfo().load(str(xml), fps=FPS)
    b = jgeo.GeoInfo().load(str(xml), fps=FPS)
    for za, zb in zip(a.parking_lots + a.handovers,
                      b.parking_lots + b.handovers):
        assert (type(za).__name__, za.name, za.poly, za.bbox) == \
            (type(zb).__name__, zb.name, zb.poly, zb.bbox)
    assert [len(a.parking_lots), len(a.handovers)] == [2, 1]
    assert len(b.parking_lots) == 2
    # a file that does not parse leaves the zones empty, as in the JAX one
    bad = tmp_path / "bad.xml"
    bad.write_text("<polygons><polygon>")
    assert not tgeo.GeoInfo().load(str(bad)).parking_lots
    rng = np.random.default_rng(0)
    for _ in range(50):
        poly = [tuple(p) for p in rng.uniform(0, 1, (int(rng.integers(3, 8)),
                                                      2))]
        pts = [tuple(p) for p in rng.uniform(-0.2, 1.2, (20, 2))]
        assert [tgeo.is_in_polygon(poly, p) for p in pts] == \
            [jgeo.is_in_polygon(poly, p) for p in pts]
        assert tgeo.polygon_area(poly) == jgeo.polygon_area(poly)


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


class _T:
    """A track as the zones read it."""

    def __init__(self, bbox, label, status, count=1):
        self.bbox, self.label, self.status, self.count = \
            bbox, label, status, count
        self.enter_status = self.exit_status = False


def test_parking_lot_under_one_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(jgeo, "time", clock)
    monkeypatch.setattr(tgeo, "time", clock)
    poly = [(0.1, 0.1), (0.5, 0.1), (0.5, 0.4), (0.1, 0.4)]
    lots = [tgeo.ParkingLot("P1", poly), jgeo.ParkingLot("P1", poly)]
    script = [
        [_T((0.3, 0.2, 0.1, 0.1), 4, "moving")],        # not parked yet
        [_T((0.3, 0.2, 0.1, 0.1), 4, "stationary")],    # occupies
        [_T((0.3, 0.2, 0.1, 0.1), 4, "stationary")],
        [_T((0.3, 0.2, 0.1, 0.1), 7, "stationary")],    # another label
        [],                                              # leaves
        [_T((0.8, 0.8, 0.1, 0.1), 9, "stationary")],    # outside
        [_T((0.2, 0.3, 0.1, 0.1), 9, "stationary")],
    ]
    seen = []
    for step, tracks in enumerate(script):
        clock.now += 2.5 + step
        for lot in lots:
            lot.proc(tracks)
        seen.append([(lot.curr_occ.label, lot.curr_occ.start,
                      lot.occupied_seconds(),
                      [(o.label, o.start, o.end) for o in lot.occupations])
                     for lot in lots])
    assert all(s[0] == s[1] for s in seen)
    assert seen[-1][0][3] and seen[-1][0][0] == 9


def test_handover_crosstalk_matches_jax():
    poly = [(0.6, 0.0), (1.0, 0.0), (1.0, 0.5), (0.6, 0.5)]
    out = []
    for mod in (tgeo, jgeo):
        h1, h2 = mod.Handover("HANDOVER", poly, fps=FPS), \
            mod.Handover("HANDOVER", poly, fps=FPS)
        leaving = _T((0.8, 0.25, 0.1, 0.1), 5, "moving", count=200)
        arriving = _T((0.75, 0.2, 0.1, 0.1), 11, "moving", count=3)
        young_no_label = _T((0.7, 0.3, 0.1, 0.1), -1, "moving", count=2)
        outside = _T((0.2, 0.8, 0.1, 0.1), 8, "moving", count=200)
        h1.proc([leaving, outside])
        h2.proc([arriving, young_no_label])
        mod.Handover.crosstalk(h1, h2)
        h2.proc([young_no_label])
        h1.proc([_T((0.9, 0.1, 0.1, 0.1), -1, "moving", count=300)])
        mod.Handover.crosstalk(h2, h1)
        out.append([(t.label, t.enter_status, t.exit_status)
                    for t in (leaving, arriving, young_no_label, outside)]
                   + [len(h1.enter), len(h1.exit), len(h2.enter),
                      len(h2.exit)])
    assert out[0] == out[1]
    assert out[0][1] == (5, True, False)           # the label handed over
