"""Kalman tracker with camera-motion-aware state reset (counterpart of
yolo_tpu/motion/motion_reset_tracker.py; numpy, host side).

Subclasses the port's `kalman/tracker.py::AircraftKalmanTracker`: position
jump > 40 px, velocity change > 60 px/frame, size ratio > 0.3, confidence
fusion, the reset (velocities zeroed, P scaled x100 / x5), a 15-frame cooldown
and the post-reset prediction blend (ref:
camera_motion_compensation/motion_reset_kalman_tracker.py MotionResetKalmanTracker:16).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from yolo_tpu_torch.kalman.tracker import AircraftKalmanTracker


class MotionResetKalmanTracker(AircraftKalmanTracker):
    """Single-target tracker that resets its filter on abrupt (camera) motion."""

    def __init__(self, initial_bbox, track_id=None, max_lost_frames: int = 150):
        super().__init__(initial_bbox, track_id, max_lost_frames)

        # motion-jump detection state (note: narrower position window than base)
        self.position_history = deque(maxlen=8)
        self.velocity_smoothing = deque(maxlen=5)
        self.bbox_history = deque(maxlen=5)

        self.jump_threshold = 40.0  # px
        self.velocity_threshold = 60.0  # px/frame
        self.size_change_threshold = 0.3  # ratio
        self.reset_cooldown = 15  # frames

        self.reset_count = 0
        self.last_reset_frame = -999
        self.reset_reasons: list[dict] = []
        self.motion_scores = deque(maxlen=10)

        self.adaptive_enabled = True
        self.confidence_factor = 1.0
        self.motion_consistency = 0.0

        center = self._get_bbox_center(initial_bbox)
        self.position_history.append(center)
        self.bbox_history.append(initial_bbox)

    @staticmethod
    def _get_bbox_center(bbox):
        return np.array([(bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0])

    @staticmethod
    def _get_bbox_size(bbox):
        return np.array([bbox[2] - bbox[0], bbox[3] - bbox[1]])

    # --- jump detectors ---------------------------------------------------------

    def _detect_position_jump(self, new_center):
        if len(self.position_history) < 2:
            return False, 0.0, "insufficient_history"
        avg = np.mean(list(self.position_history)[-3:], axis=0)
        distance = float(np.linalg.norm(new_center - avg))
        is_jump = distance > self.jump_threshold
        self.motion_scores.append(min(distance / self.jump_threshold, 3.0))
        return is_jump, distance, f"position_jump_{distance:.1f}px" if is_jump else "normal_motion"

    def _detect_velocity_change(self, new_center):
        if len(self.position_history) < 3:
            return False, 0.0, "insufficient_velocity_history"
        positions = list(self.position_history)[-3:] + [new_center]
        velocities = [float(np.linalg.norm(positions[i] - positions[i - 1])) for i in range(1, len(positions))]
        if len(velocities) < 2:
            return False, 0.0, "insufficient_velocity_data"
        change = abs(velocities[-1] - float(np.mean(velocities[:-1])))
        is_change = change > self.velocity_threshold
        return is_change, change, f"velocity_change_{change:.1f}px/f" if is_change else "normal_velocity"

    def _detect_size_change(self, new_bbox):
        if len(self.bbox_history) < 2:
            return False, 0.0, "insufficient_size_history"
        cur = self._get_bbox_size(new_bbox)
        prev = np.maximum(self._get_bbox_size(self.bbox_history[-1]), 1.0)
        ratio = cur / prev
        max_change = float(max(abs(ratio[0] - 1.0), abs(ratio[1] - 1.0)))
        is_jump = max_change > self.size_change_threshold
        return is_jump, max_change, f"size_change_{max_change:.2f}" if is_jump else "normal_size"

    def _calculate_motion_consistency(self):
        if len(self.motion_scores) < 3:
            return 0.0
        scores = list(self.motion_scores)
        mean = float(np.mean(scores))
        if mean > 0:
            return max(0.0, 1.0 - float(np.var(scores)) / (mean + 0.1))
        return 1.0

    # --- reset decision + execution ------------------------------------------------

    def _should_reset_kalman(self, new_bbox):
        frames_since_reset = self.age - self.last_reset_frame
        if frames_since_reset < self.reset_cooldown:
            return False, ["in_cooldown"], 0.0

        new_center = self._get_bbox_center(new_bbox)
        reasons, factors = [], []
        is_jump, dist, r = self._detect_position_jump(new_center)
        if is_jump:
            reasons.append(r)
            factors.append(min(dist / self.jump_threshold, 2.0))
        is_vel, vel, r = self._detect_velocity_change(new_center)
        if is_vel:
            reasons.append(r)
            factors.append(min(vel / self.velocity_threshold, 2.0))
        is_size, size, r = self._detect_size_change(new_bbox)
        if is_size:
            reasons.append(r)
            factors.append(size / self.size_change_threshold)

        if factors:
            confidence = float(np.mean(factors))
            self.motion_consistency = self._calculate_motion_consistency()
            if self.motion_consistency < 0.3:  # erratic motion → easier reset
                confidence *= 1.5
            if self.adaptive_enabled and self.reset_count > 0 and frames_since_reset < 50:
                confidence *= 0.8  # damp frequent resets
            return confidence > 1.0, reasons, confidence
        return False, reasons, 0.0

    def _reset_kalman_filter(self, new_bbox, reasons, confidence):
        print(f"[{self.track_id}] Kalman reset - confidence {confidence:.2f}; reasons: {', '.join(reasons)}")
        self.reset_count += 1
        self.last_reset_frame = self.age
        self.reset_reasons.append(
            {"frame": self.age, "reasons": reasons, "confidence": confidence, "motion_consistency": self.motion_consistency}
        )
        self.x[:4] = self.bbox_to_state(new_bbox)
        self.x[4:] = 0  # zero velocities
        self.P[4:, 4:] *= 100.0  # velocity uncertainty way up
        self.P[:4, :4] *= 5.0  # position uncertainty moderately up

        center = self._get_bbox_center(new_bbox)
        self.trajectory_history.clear()
        self.trajectory_history.append((center[0], center[1]))
        self.velocity_history.clear()
        self.position_history.clear()
        self.position_history.append(center)
        self.motion_scores.clear()

        self.hits += 1
        self.hit_streak += 1
        self.time_since_update = 0
        print(f"[{self.track_id}] reset done (#{self.reset_count})")

    # --- overridden lifecycle ---------------------------------------------------------

    def update(self, bbox):
        should_reset, reasons, confidence = self._should_reset_kalman(bbox)
        if should_reset:
            self._reset_kalman_filter(bbox, reasons, confidence)
        else:
            super().update(bbox)
        self.position_history.append(self._get_bbox_center(bbox))
        self.bbox_history.append(bbox)

    def predict(self):
        predicted_bbox = super().predict()
        frames_since_reset = self.age - self.last_reset_frame
        if frames_since_reset < 10 and len(self.position_history) > 0:
            # conservative blend toward last observed center right after a reset
            last_center = self.position_history[-1]
            pred_center = self._get_bbox_center(predicted_bbox)
            blend = min(frames_since_reset / 10.0, 1.0)
            adj = (1 - blend) * last_center + blend * pred_center
            size = self._get_bbox_size(predicted_bbox)
            predicted_bbox = [adj[0] - size[0] / 2, adj[1] - size[1] / 2, adj[0] + size[0] / 2, adj[1] + size[1] / 2]
        return predicted_bbox

    def get_track_info(self):
        info = super().get_track_info()
        info["reset_count"] = self.reset_count
        frames_since_reset = self.age - self.last_reset_frame
        info["frames_since_reset"] = frames_since_reset
        info["motion_consistency"] = f"{self.motion_consistency:.2f}"
        if self.reset_count > 0:
            if frames_since_reset < 20:
                info["status_suffix"] = f" | reset ({frames_since_reset}f ago)"
            else:
                info["status_suffix"] = f" | reset x{self.reset_count}"
        else:
            info["status_suffix"] = ""
        return info

    def get_reset_statistics(self):
        if not self.reset_reasons:
            return {"total_resets": 0, "details": []}
        reason_counts: dict = {}
        for r in self.reset_reasons:
            for reason in r["reasons"]:
                key = reason.split("_")[0]
                reason_counts[key] = reason_counts.get(key, 0) + 1
        return {
            "total_resets": self.reset_count,
            "reason_distribution": reason_counts,
            "avg_confidence": float(np.mean([r["confidence"] for r in self.reset_reasons])),
            "avg_motion_consistency": float(np.mean([r["motion_consistency"] for r in self.reset_reasons])),
            "details": self.reset_reasons[-5:],
        }
