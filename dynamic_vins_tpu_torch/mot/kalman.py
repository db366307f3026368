"""Bounding-box Kalman filter for multi-object tracking.

Capability parity with `KalmanTracker` (`mot/kalman_tracker.h:27`):
8-state constant-velocity filter over (cx, cy, aspect, h) as in
DeepSORT; std parameterization follows the published DeepSORT weights
(position std ~ h).
"""

from __future__ import annotations

import numpy as np

_STD_WEIGHT_POS = 1.0 / 20
_STD_WEIGHT_VEL = 1.0 / 160


def xyah_from_tlbr(tlbr):
    x1, y1, x2, y2 = tlbr
    w = x2 - x1
    h = y2 - y1
    return np.array([x1 + w / 2, y1 + h / 2, w / max(h, 1e-6), h])


def tlbr_from_xyah(xyah):
    cx, cy, a, h = xyah
    w = a * h
    return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


class BoxKalman:
    def __init__(self, xyah):
        self.x = np.zeros(8)
        self.x[:4] = xyah
        h = xyah[3]
        std = [2 * _STD_WEIGHT_POS * h, 2 * _STD_WEIGHT_POS * h, 1e-2,
               2 * _STD_WEIGHT_POS * h,
               10 * _STD_WEIGHT_VEL * h, 10 * _STD_WEIGHT_VEL * h, 1e-5,
               10 * _STD_WEIGHT_VEL * h]
        self.P = np.diag(np.square(std))
        self.F = np.eye(8)
        self.F[:4, 4:] = np.eye(4)
        self.H = np.eye(4, 8)

    def predict(self):
        h = self.x[3]
        q = [_STD_WEIGHT_POS * h, _STD_WEIGHT_POS * h, 1e-2,
             _STD_WEIGHT_POS * h,
             _STD_WEIGHT_VEL * h, _STD_WEIGHT_VEL * h, 1e-5,
             _STD_WEIGHT_VEL * h]
        Q = np.diag(np.square(q))
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + Q
        return self.x[:4]

    def update(self, xyah):
        h = self.x[3]
        r = [_STD_WEIGHT_POS * h, _STD_WEIGHT_POS * h, 1e-1,
             _STD_WEIGHT_POS * h]
        R = np.diag(np.square(r))
        S = self.H @ self.P @ self.H.T + R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (xyah - self.H @ self.x)
        self.P = (np.eye(8) - K @ self.H) @ self.P

    @property
    def tlbr(self):
        return tlbr_from_xyah(self.x[:4])
