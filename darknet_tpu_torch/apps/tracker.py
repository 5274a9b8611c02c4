"""Multi-object tracker: Kalman prediction + Hungarian IoU association
(the port's copy of `darknet_tpu/apps/tracker.py`, host code on numpy;
`Track._shared_label` is this module's own counter).

Port of `track_manager.cpp` (+ the vendored `hungarian/` solver, replaced by
`scipy.optimize.linear_sum_assignment` — the 1,079-LoC Kuhn-Munkres
implementation reduces to one library call; optimal assignments agree up to
ties).

Semantics preserved:
* per-track cv::KalmanFilter: 4-state constant-velocity (x, y, vx, vy),
  2 measurements, process noise 1e-4*I, measurement noise 2e-4*I, initial
  error covariance 0 (track_manager.cpp:115-125);
* Predict decays confidence by 1 (`:60-73`); Correct KF-corrects the
  center, averages w/h/prob 50/50, confidence += 2 capped at max
  (`:75-97`);
* STATIONARY when the 10s box history's ends have IoU > 0.7 and
  prob > 0.9 (`:100-113`); stationary tracks low-pass their box 0.9/0.1
  instead of the KF;
* a track gets a label after `min_conf` frames (`:69-72`);
* association: IoU similarity, Hungarian assignment, matches gated by
  IoU > iou_thresh (`:337-431`); unmatched detections spawn tracks;
  tracks retire at confidence <= 0 (saved if seen > 30 frames)
  (`:295-319`);
* ConfParam defaults from fps: init 1, min fps/5, max 2*fps/5
  (`yolo_core.cpp:244-246`).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

MOVING = "moving"
STATIONARY = "stationary"


@dataclasses.dataclass
class ConfParam:
    init_conf: int = 1
    min_conf: int = 3
    max_conf: int = 6

    @classmethod
    def from_fps(cls, fps: float) -> "ConfParam":
        min_conf = int(fps / 5)
        return cls(1, min_conf, 2 * min_conf)


@dataclasses.dataclass
class MostProbDet:
    """Best-class detection (box.cpp GetMostProbDets): relative
    center-format bbox + single (class, prob)."""

    bbox: tuple       # (x, y, w, h)
    cid: int
    prob: float


def _iou(a, b) -> float:
    w = min(a[0] + a[2] / 2, b[0] + b[2] / 2) - \
        max(a[0] - a[2] / 2, b[0] - b[2] / 2)
    h = min(a[1] + a[3] / 2, b[1] + b[3] / 2) - \
        max(a[1] - a[3] / 2, b[1] - b[3] / 2)
    if w < 0 or h < 0:
        return 0.0
    inter = w * h
    u = a[2] * a[3] + b[2] * b[3] - inter
    eps = np.finfo(np.float32).eps
    if abs(inter) < eps or abs(u) < eps:
        return 0.0
    return inter / u


class _Kalman:
    """cv::KalmanFilter equivalent: constant-velocity, dt=1."""

    def __init__(self, x: float, y: float):
        self.F = np.array([[1, 0, 1, 0], [0, 1, 0, 1],
                           [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        self.H = np.eye(2, 4, dtype=np.float32)
        self.Q = np.eye(4, dtype=np.float32) * 1e-4
        self.R = np.eye(2, dtype=np.float32) * 2e-4
        self.x = np.array([x, y, 0.0, 0.0], np.float32)
        self.P = np.zeros((4, 4), np.float32)   # cv init: zero covariance

    def predict(self):
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.x[:2]

    def correct(self, zx: float, zy: float):
        z = np.array([zx, zy], np.float32)
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (z - self.H @ self.x)
        self.P = (np.eye(4, dtype=np.float32) - K @ self.H) @ self.P
        return self.x[:2]


class Track:
    _shared_label = 0

    def __init__(self, det: MostProbDet, conf_param: ConfParam, fps: float):
        self.status = MOVING
        self.det = MostProbDet(tuple(det.bbox), det.cid, det.prob)
        self.conf_param = conf_param
        self.fps = fps
        self.count = 1
        self.label = -1
        self.conf = conf_param.init_conf
        self.enter_status = False
        self.exit_status = False
        self.history: deque = deque()
        self.kf = _Kalman(det.bbox[0], det.bbox[1])

    # -- reference Track::Predict (track_manager.cpp:60-73)
    def predict(self):
        if self.status == MOVING:
            x, y = self.kf.predict()
            b = self.det.bbox
            self.det.bbox = (float(x), float(y), b[2], b[3])
            self.conf -= 1
        self.count += 1
        if self.count >= self.conf_param.min_conf and self.label < 0:
            self.label = Track._shared_label
            Track._shared_label += 1

    # -- reference Track::Correct (track_manager.cpp:75-113)
    def correct(self, det: MostProbDet):
        bx, by, bw, bh = det.bbox
        if self.status == MOVING:
            x, y = self.kf.correct(bx, by)
            ow, oh = self.det.bbox[2], self.det.bbox[3]
            self.det.bbox = (float(x), float(y), (ow + bw) / 2,
                             (oh + bh) / 2)
            self.det.prob = (self.det.prob + det.prob) / 2
            self.conf = min(self.conf_param.max_conf, self.conf + 2)
        else:
            ox, oy, ow, oh = self.det.bbox
            self.det.bbox = (0.9 * ox + 0.1 * bx, 0.9 * oy + 0.1 * by,
                             0.9 * ow + 0.1 * bw, 0.9 * oh + 0.1 * bh)

        self.history.append(self.det.bbox)
        if len(self.history) > self.fps * 10:
            self.history.popleft()
        if len(self.history) < self.fps:
            return
        if _iou(self.history[0], self.history[-1]) > 0.7 and \
                self.det.prob > 0.9:
            self.status = STATIONARY
        else:
            self.status = MOVING

    @property
    def bbox(self):
        return self.det.bbox


class TrackManager:
    def __init__(self, conf_param: ConfParam, fps: float,
                 iou_thresh: float = 0.3):
        self.conf_param = conf_param
        self.fps = fps
        self.iou_thresh = iou_thresh
        self.tracks: list[Track] = []
        self.saved_tracks: list[Track] = []

    def clear(self):
        self.tracks = []

    # -- reference TrackManager::Track (track_manager.cpp:242-319)
    def track(self, dets: list):
        if self.tracks:
            for t in self.tracks:
                t.predict()
            if dets:
                match = self._associate(dets)       # (n_tracks, n_dets) 0/1
                for i, t in enumerate(self.tracks):
                    for j, d in enumerate(dets):
                        if match[i, j]:
                            t.correct(d)
                unmatched = np.nonzero(match.sum(axis=0) == 0)[0]
                for j in unmatched:
                    self.tracks.append(
                        Track(dets[j], self.conf_param, self.fps))
        else:
            for d in dets:
                self.tracks.append(Track(d, self.conf_param, self.fps))

        remaining = []
        for t in self.tracks:
            if t.conf > 0:
                remaining.append(t)
            elif t.count > 30:
                self.saved_tracks.append(t)
        self.tracks = remaining

    def get_tracks(self) -> list:
        return [t for t in self.tracks
                if t.conf >= self.conf_param.min_conf]

    def get_saved_tracks(self) -> list:
        return list(self.saved_tracks)

    def _associate(self, dets: list) -> np.ndarray:
        from scipy.optimize import linear_sum_assignment

        n_t, n_d = len(self.tracks), len(dets)
        sim = np.zeros((n_t, n_d), np.float64)
        for i, t in enumerate(self.tracks):
            for j, d in enumerate(dets):
                sim[i, j] = _iou(t.bbox, d.bbox)
        rows, cols = linear_sum_assignment(sim, maximize=True)
        match = np.zeros((n_t, n_d), np.int32)
        for i, j in zip(rows, cols):
            if sim[i, j] > self.iou_thresh:
                match[i, j] = 1
        return match


def get_most_prob_dets(dets) -> list:
    """GetMostProbDets (box.cpp:421-443): argmax class per detection,
    dropping all-zero detections."""
    out = []
    for d in dets:
        cid = int(np.argmax(d.prob))
        p = float(d.prob[cid])
        if p > 0:
            out.append(MostProbDet(bbox=tuple(d.bbox), cid=cid, prob=p))
    return out
