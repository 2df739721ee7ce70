"""Single-target constant-velocity Kalman tracker with long-term extrapolation.

The port's own copy of yolo_tpu/kalman/tracker.py (numpy, host side): the
filter constants, which the batched tracker (kalman/batched.py) shares, and
`AircraftKalmanTracker`, the object-per-track tracker of the clip loop
(kalman/pipeline.py).

State: [cx, cy, w, h, vx, vy, vw, vh]; observation: [cx, cy, w, h].
Designed for aircraft: near-linear motion, 150-450-frame loss tolerance with
confidence-decayed extrapolation from the learned motion pattern.
"""

from __future__ import annotations

import uuid
from collections import deque

import numpy as np


def bbox_to_cxcywh(bbox):
    x1, y1, x2, y2 = bbox[:4]
    return np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1], dtype=float)


def cxcywh_to_bbox(state):
    cx, cy, w, h = state[:4]
    return np.array([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dtype=float)


# Filter constants (the batched tracker, kalman/batched.py, shares them) -------
STATE_DIM = 8
MEAS_DIM = 4


def _make_F():
    F = np.eye(STATE_DIM)
    F[0, 4] = F[1, 5] = F[2, 6] = F[3, 7] = 1.0  # x += vx·dt (dt = 1 frame)
    return F


def _make_H():
    H = np.zeros((MEAS_DIM, STATE_DIM))
    H[0, 0] = H[1, 1] = H[2, 2] = H[3, 3] = 1.0
    return H


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


class AircraftKalmanTracker:
    """8-state CV Kalman tracker with motion-pattern analysis and lost-state coasting."""

    def __init__(self, initial_bbox, track_id: str | None = None, max_lost_frames: int = 450):
        self.track_id = track_id or str(uuid.uuid4())[:8]
        self.age = 0
        self.hits = 1
        self.hit_streak = 1
        self.time_since_update = 0

        self.state_dim = STATE_DIM
        self.measure_dim = MEAS_DIM
        self.x = np.zeros(STATE_DIM, dtype=float)
        self.P = _make_P0()
        self.F = _make_F()
        self.H = _make_H()
        self.Q = _make_Q()
        self.R = R_MEAS.copy()

        z0 = bbox_to_cxcywh(initial_bbox)
        self.x[:4] = z0

        # trajectory memory
        self.trajectory_history = deque(maxlen=150)
        self.velocity_history = deque(maxlen=50)
        self.position_history = deque(maxlen=100)

        self.motion_analysis = {
            "velocity_avg": np.array([0.0, 0.0]),
            "velocity_std": np.array([0.0, 0.0]),
            "direction": 0.0,
            "speed": 0.0,
            "stability_score": 0.0,
            "prediction_confidence": 0.0,
        }

        self.is_lost = False
        self.lost_frames = 0
        self.max_lost_frames = max_lost_frames
        self.lost_start_state = None
        self.lost_start_time = None

        self.trajectory_history.append((z0[0], z0[1]))
        self.position_history.append(z0[:2])

    # kept as methods for the callers that use the original demo's tracker API
    def bbox_to_state(self, bbox):
        return bbox_to_cxcywh(bbox)

    def state_to_bbox(self, state):
        return cxcywh_to_bbox(state)

    # --- motion analysis -----------------------------------------------------

    def analyze_motion_pattern(self):
        """Update velocity stats / direction consistency / prediction confidence."""
        if len(self.velocity_history) < 5:
            return
        velocities = np.array(self.velocity_history)
        self.motion_analysis["velocity_avg"] = velocities.mean(axis=0)
        self.motion_analysis["velocity_std"] = velocities.std(axis=0)

        avg_vx, avg_vy = self.motion_analysis["velocity_avg"]
        self.motion_analysis["speed"] = float(np.hypot(avg_vx, avg_vy))
        self.motion_analysis["direction"] = float(np.arctan2(avg_vy, avg_vx))

        speed_stability = 1.0 / (1.0 + float(self.motion_analysis["velocity_std"].mean()))
        direction_consistency = self._calculate_direction_consistency()
        self.motion_analysis["stability_score"] = (speed_stability + direction_consistency) / 2.0

        data_confidence = min(len(self.velocity_history) / 30.0, 1.0)
        self.motion_analysis["prediction_confidence"] = self.motion_analysis["stability_score"] * data_confidence

    def _calculate_direction_consistency(self) -> float:
        """1 / (1 + 10·std(wrapped heading changes))."""
        if len(self.velocity_history) < 3:
            return 0.0
        v = np.array(self.velocity_history)
        headings = np.arctan2(v[:, 1], v[:, 0])
        d = np.diff(headings)
        d = np.where(np.abs(d) < np.pi, d, d - 2 * np.pi * np.sign(d))  # unwrap jumps
        return float(1.0 / (1.0 + d.std() * 10))

    # --- filter steps ----------------------------------------------------------

    def predict(self):
        """Kalman time update; returns predicted bbox [x1,y1,x2,y2]."""
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        self.time_since_update += 1
        self.trajectory_history.append((self.x[0], self.x[1]))
        return cxcywh_to_bbox(self.x)

    def enhanced_long_term_predict(self, frames_ahead: int = 1):
        """Extrapolate `frames_ahead` frames using the learned motion pattern.

        High-confidence tracks extrapolate with the *mean* historical velocity
        (robust to late-filter noise); low-confidence tracks fall back to F^n·x.
        Confidence decays with horizon / max_lost_frames.

        Behaviour kept from the JAX package's tracker, which the tests pin:
        - frames_ahead <= 1 early-outs into predict(), a side effect in a
          "getter" that permanently advances the filter;
        - extrapolation starts from the already-propagated state (the manager
          predicts every tracker each frame), so lost boxes advance about
          twice the velocity;
        - get_track_info reports lost_frames := time_since_update and
          is_lost := (time_since_update > 0).
        """
        if frames_ahead <= 1:
            return self.predict(), 1.0

        self.analyze_motion_pattern()

        if self.motion_analysis["prediction_confidence"] > 0.3:
            pred = self.x.copy()
            avg_v = self.motion_analysis["velocity_avg"]
            pred[0] += avg_v[0] * frames_ahead
            pred[1] += avg_v[1] * frames_ahead
            pred[2:4] = self.x[2:4]  # size held constant
            time_decay = max(0.1, 1.0 - frames_ahead / self.max_lost_frames)
            confidence = self.motion_analysis["prediction_confidence"] * time_decay
        else:
            pred = self.x.copy()
            for _ in range(frames_ahead):
                pred = self.F @ pred
            confidence = max(0.1, 1.0 - frames_ahead / (self.max_lost_frames * 0.5))
        return cxcywh_to_bbox(pred), confidence

    def update(self, bbox):
        """Kalman measurement update with motion-history bookkeeping."""
        self.time_since_update = 0
        self.hits += 1
        self.hit_streak += 1

        if self.is_lost:
            lost_time = self.lost_frames
            self.is_lost = False
            self.lost_frames = 0
            self.lost_start_state = None
            self.lost_start_time = None
            print(f"Target {self.track_id} re-acquired after {lost_time} lost frames")

        z = bbox_to_cxcywh(bbox)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(STATE_DIM) - K @ self.H) @ self.P

        self.velocity_history.append(self.x[4:6].copy())
        self.position_history.append(self.x[:2].copy())
        self.trajectory_history.append((self.x[0], self.x[1]))
        self.analyze_motion_pattern()

    # --- lost-state lifecycle -----------------------------------------------------

    def mark_as_lost(self):
        """Flag the track lost; count lost frames; zero the hit streak."""
        if not self.is_lost:
            self.is_lost = True
            self.lost_frames = 0
            self.lost_start_state = self.x.copy()
            self.lost_start_time = self.age
            pos, vel = self.x[:2], self.x[4:6]
            conf = self.motion_analysis.get("prediction_confidence", 0.0)
            print(
                f"Target {self.track_id} lost - pos [{pos[0]:.1f}, {pos[1]:.1f}], "
                f"vel [{vel[0]:.2f}, {vel[1]:.2f}], motion confidence {conf:.2f}"
            )
        self.lost_frames += 1
        self.hit_streak = 0

    def get_lost_prediction(self):
        """Best-effort position while lost → (bbox, confidence)."""
        if not self.is_lost:
            return cxcywh_to_bbox(self.x), 1.0
        return self.enhanced_long_term_predict(frames_ahead=self.lost_frames)

    def get_track_info(self) -> dict:
        """Full track record; status is 'predicted' iff time_since_update > 0."""
        is_predicted = self.time_since_update > 0
        if is_predicted:
            if self.is_lost:
                bbox, confidence = self.get_lost_prediction()
            else:
                bbox = cxcywh_to_bbox(self.x)
                confidence = max(0.3, 1.0 - self.time_since_update / 60.0)
            status = "predicted"
        else:
            bbox = cxcywh_to_bbox(self.x)
            confidence = 1.0
            status = "detected"

        return {
            "track_id": self.track_id,
            "bbox": bbox,
            "confidence": confidence,
            "status": status,
            "age": self.age,
            "hits": self.hits,
            "hit_streak": self.hit_streak,
            "time_since_update": self.time_since_update,
            "lost_frames": self.time_since_update,
            "is_lost": is_predicted,
            "trajectory": list(self.trajectory_history)[-30:],
            "velocity": self.x[4:6],
            "motion_confidence": self.motion_analysis.get("prediction_confidence", 0.0),
            "is_stable_motion": self.motion_analysis.get("stability_score", 0.0) > 0.5,
            "speed": self.motion_analysis.get("speed", 0.0),
            "direction": self.motion_analysis.get("direction", 0.0),
        }

    def should_delete(self, max_lost_frames: int) -> bool:
        """Prune rule: hard timeout, plus faster pruning for unconfirmed tracks."""
        if self.time_since_update > max_lost_frames:
            return True
        if self.age < 5 and self.hit_streak == 0 and self.time_since_update > 15:
            return True
        if self.age < 10 and self.hit_streak <= 1 and self.time_since_update > 30:
            return True
        return False


EnhancedAircraftKalmanTracker = AircraftKalmanTracker  # the name the original demo uses
