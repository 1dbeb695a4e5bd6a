"""SORT multi-object tracker (host-side numpy): the port's copy of
``gastx.pipeline.sort``.

Behavioral parity target: reference ``lib/track/sort.py`` — per-box constant
velocity Kalman tracker over the [cx, cy, area, aspect, vx, vy, vs] state,
Hungarian assignment on an IoU matrix, track lifecycle with ``max_age=1`` /
``min_hits=3``. Rebuilt without the reference's filterpy / numba dependencies:
the Kalman filter is ~20 lines of numpy (with filterpy's default-matrix
scaling reproduced), and IoU is vectorized over the full detection x track
matrix instead of a jit-compiled scalar loop.
"""
from __future__ import annotations

from typing import List

import numpy as np
from scipy.optimize import linear_sum_assignment


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between (N, 4+) and (M, 4+) xyxy boxes -> (N, M)."""
    a = boxes_a[:, None, :4]
    b = boxes_b[None, :, :4]
    xx1 = np.maximum(a[..., 0], b[..., 0])
    yy1 = np.maximum(a[..., 1], b[..., 1])
    xx2 = np.minimum(a[..., 2], b[..., 2])
    yy2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def bbox_to_z(bbox: np.ndarray) -> np.ndarray:
    """xyxy -> [cx, cy, area, aspect] column."""
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    return np.array([bbox[0] + w / 2.0, bbox[1] + h / 2.0, w * h,
                     w / float(h)]).reshape(4, 1)


def z_to_bbox(x: np.ndarray) -> np.ndarray:
    """[cx, cy, area, aspect, ...] state -> (1, 4) xyxy."""
    w = np.sqrt(x[2] * x[3])
    h = x[2] / w
    return np.array([x[0] - w / 2.0, x[1] - h / 2.0, x[0] + w / 2.0,
                     x[1] + h / 2.0]).reshape(1, 4)


class _Kalman:
    """Minimal linear Kalman filter (predict/update) for the SORT state."""

    def __init__(self):
        self.F = np.eye(7)
        self.F[0, 4] = self.F[1, 5] = self.F[2, 6] = 1.0
        self.H = np.eye(4, 7)
        self.R = np.eye(4)
        self.R[2:, 2:] *= 10.0
        self.P = np.eye(7) * 10.0
        self.P[4:, 4:] *= 1000.0  # unobservable initial velocities
        self.Q = np.eye(7)
        self.Q[-1, -1] *= 0.01
        self.Q[4:, 4:] *= 0.01
        self.x = np.zeros((7, 1))

    def predict(self):
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q

    def update(self, z):
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(7) - k @ self.H) @ self.P


class KalmanBoxTracker:
    """State of one tracked box."""

    count = 0

    def __init__(self, bbox: np.ndarray):
        self.kf = _Kalman()
        self.kf.x[:4] = bbox_to_z(bbox)
        self.time_since_update = 0
        self.id = KalmanBoxTracker.count
        KalmanBoxTracker.count += 1
        self.history: List[np.ndarray] = []
        self.hits = 0
        self.hit_streak = 0
        self.age = 0

    def update(self, bbox: np.ndarray) -> None:
        self.time_since_update = 0
        self.history = []
        self.hits += 1
        self.hit_streak += 1
        self.kf.update(bbox_to_z(bbox))

    def predict(self) -> np.ndarray:
        # Keep the area non-negative after the velocity step.
        if (self.kf.x[6] + self.kf.x[2]) <= 0:
            self.kf.x[6] *= 0.0
        self.kf.predict()
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        self.history.append(z_to_bbox(self.kf.x))
        return self.history[-1]

    def get_state(self) -> np.ndarray:
        return z_to_bbox(self.kf.x)


def associate(detections: np.ndarray, trackers: np.ndarray,
              iou_threshold: float = 0.3):
    """Hungarian assignment of detections to predicted track boxes."""
    if len(trackers) == 0:
        return (np.empty((0, 2), dtype=int), np.arange(len(detections)),
                np.empty((0,), dtype=int))

    ious = iou_matrix(detections, trackers)
    rows, cols = linear_sum_assignment(-ious)

    unmatched_dets = [d for d in range(len(detections)) if d not in rows]
    unmatched_trks = [t for t in range(len(trackers)) if t not in cols]

    matches = []
    for d, t in zip(rows, cols):
        if ious[d, t] < iou_threshold:
            unmatched_dets.append(d)
            unmatched_trks.append(t)
        else:
            matches.append((d, t))
    matches = (np.array(matches, dtype=int) if matches
               else np.empty((0, 2), dtype=int))
    return matches, np.array(unmatched_dets), np.array(unmatched_trks)


class Sort:
    """Frame-by-frame tracker; call :meth:`update` once per frame."""

    def __init__(self, max_age: int = 1, min_hits: int = 3):
        self.max_age = max_age
        self.min_hits = min_hits
        self.trackers: List[KalmanBoxTracker] = []
        self.frame_count = 0

    def update(self, dets: np.ndarray) -> np.ndarray:
        """``dets``: (N, 5) [x1, y1, x2, y2, score]. Returns (M, 5) with the
        last column holding 1-based track ids."""
        self.frame_count += 1

        # Predict current track positions; drop NaN tracks.
        trks = np.zeros((len(self.trackers), 5))
        to_del = []
        for t in range(len(trks)):
            pos = self.trackers[t].predict()[0]
            trks[t, :4] = pos
            if np.any(np.isnan(pos)):
                to_del.append(t)
        trks = np.ma.compress_rows(np.ma.masked_invalid(trks))
        for t in reversed(to_del):
            self.trackers.pop(t)

        matched, unmatched_dets, unmatched_trks = associate(dets, trks)

        for t, trk in enumerate(self.trackers):
            if t not in unmatched_trks:
                d = matched[matched[:, 1] == t, 0]
                trk.update(dets[d, :][0])

        for i in unmatched_dets:
            self.trackers.append(KalmanBoxTracker(dets[i, :]))

        ret = []
        i = len(self.trackers)
        for trk in reversed(self.trackers):
            d = trk.get_state()[0]
            if trk.time_since_update < 1 and (
                    trk.hit_streak >= self.min_hits
                    or self.frame_count <= self.min_hits):
                # 1-based ids (MOT convention)
                ret.append(np.concatenate((d, [trk.id + 1])).reshape(1, -1))
            i -= 1
            if trk.time_since_update > self.max_age:
                self.trackers.pop(i)

        if ret:
            return np.concatenate(ret)
        return np.empty((0, 5))
