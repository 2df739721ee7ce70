"""Constant-velocity Kalman filter constants (copied from yolo_tpu/kalman/tracker.py).

State: [cx, cy, w, h, vx, vy, vw, vh]; observation: [cx, cy, w, h]. Only the
constants the batched tracker needs are ported; the object-per-track tracker
is not (yet).
"""

from __future__ import annotations

import numpy as np

STATE_DIM = 8
MEAS_DIM = 4


def _make_F():
    F = np.eye(STATE_DIM)
    F[0, 4] = F[1, 5] = F[2, 6] = F[3, 7] = 1.0  # x += vx·dt (dt = 1 frame)
    return F


def _make_Q():
    Q = np.eye(STATE_DIM)
    Q[:2, :2] *= 0.1  # position process noise (smooth flight)
    Q[2:4, 2:4] *= 0.01  # size barely changes
    Q[4:6, 4:6] *= 0.1  # velocity drift
    Q[6:, 6:] *= 0.001  # size-velocity drift
    return Q


def _make_P0():
    P = np.eye(STATE_DIM)
    P[:4, :4] *= 50.0  # initial position/size uncertainty
    P[4:6, 4:6] *= 100.0  # initial velocity uncertainty
    P[6:, 6:] *= 1.0
    return P


R_MEAS = np.eye(MEAS_DIM) * 10.0
