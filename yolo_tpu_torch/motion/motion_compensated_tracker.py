"""Multi-target tracker with global camera-motion compensation (counterpart of
yolo_tpu/motion/motion_compensated_tracker.py; numpy and cv2, host side).

Per-frame global motion detection, the global reset (clear and re-seed) gated
by detection stability, sustained motion or a 60 px jump, standard tracking
with individual resets, greedy IoU association (ties go to the larger indices,
as Python's reverse sort of (iou, d, t) gives them) and the stats (ref:
camera_motion_compensation/motion_compensated_multi_tracker.py MotionCompensatedMultiTracker:18).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from yolo_tpu_torch.kalman.multi_tracker import EnhancedMultiTargetTracker, iou_xyxy
from yolo_tpu_torch.motion.global_motion_detector import GlobalMotionDetector
from yolo_tpu_torch.motion.motion_reset_tracker import MotionResetKalmanTracker


class MotionCompensatedMultiTracker(EnhancedMultiTargetTracker):
    """Multi-target manager wiring global motion detection + reset trackers."""

    def __init__(self, max_lost_frames: int = 150, min_hits: int = 1, iou_threshold: float = 0.1, motion_detection_method: str = "optical_flow"):
        super().__init__(max_lost_frames, min_hits, iou_threshold)
        self.motion_detector = GlobalMotionDetector(method=motion_detection_method)

        self.global_motion_compensation = True
        self.individual_reset_enabled = True
        self.adaptive_thresholds = True

        self.global_motion_history = deque(maxlen=20)
        self.detection_stability_history = deque(maxlen=10)

        self.stats = {
            "total_frames": 0,
            "global_motion_events": 0,
            "global_resets": 0,
            "individual_resets": 0,
            "tracking_recoveries": 0,
            "processing_times": deque(maxlen=100),
            "motion_compensation_effects": [],
        }
        self.current_frame = None
        self.frame_motion_info = None
        print(f"Motion-compensated multi tracker ready (method={motion_detection_method}, max_lost={max_lost_frames}, iou={iou_threshold})")

    def update(self, detections, frame=None):
        """One tracking step with global + individual motion compensation."""
        self.frame_count += 1
        self.stats["total_frames"] += 1
        self.current_frame = frame

        global_motion_detected = False
        if frame is not None and self.global_motion_compensation:
            is_motion, magnitude, vector, should_reset = self.motion_detector.detect_motion(frame)
            self.frame_motion_info = {
                "is_motion": is_motion,
                "magnitude": magnitude,
                "vector": vector.tolist() if hasattr(vector, "tolist") else vector,
                "should_reset": should_reset,
            }
            self.global_motion_history.append(magnitude)
            if should_reset:
                global_motion_detected = True
                self.stats["global_motion_events"] += 1
                print(f"frame {self.frame_count}: global motion detected ({magnitude:.1f}px)")

        self.detection_stability_history.append(len(detections))

        if global_motion_detected and self._should_global_reset():
            return self._perform_global_reset(detections)
        return self._perform_standard_tracking_with_compensation(detections)

    def _should_global_reset(self) -> bool:
        if not self.frame_motion_info or not self.frame_motion_info["should_reset"]:
            return False
        if len(self.detection_stability_history) >= 5:
            recent = list(self.detection_stability_history)[-5:]
            stability = np.std(recent) / (np.mean(recent) + 1)
            if stability > 0.5:  # unstable detections + motion → hard reset
                return True
        if len(self.global_motion_history) >= 3:
            if np.mean(list(self.global_motion_history)[-3:]) > 30.0:  # sustained motion
                return True
        return self.frame_motion_info["magnitude"] > 60.0

    def _perform_global_reset(self, detections):
        print(f"frame {self.frame_count}: GLOBAL RESET - dropping {len(self.trackers)} trackers")
        self.stats["global_resets"] += 1
        old = len(self.trackers)
        self.trackers.clear()
        for detection in detections:
            self.trackers.append(MotionResetKalmanTracker(detection[:4], max_lost_frames=self.max_lost_frames))
        print(f"global reset done: {old} -> {len(self.trackers)} trackers")
        return self._get_enhanced_track_results()

    def _perform_standard_tracking_with_compensation(self, detections):
        predicted = [t.predict() for t in self.trackers]
        if len(detections) > 0 and len(self.trackers) > 0:
            matched, unmatched_dets, unmatched_trks = self.associate_detections_to_trackers(
                detections, predicted, self.iou_threshold
            )
        else:
            matched = []
            unmatched_dets = list(range(len(detections)))
            unmatched_trks = list(range(len(self.trackers)))

        individual_resets = 0
        for det_idx, trk_idx in matched:
            pre = getattr(self.trackers[trk_idx], "reset_count", 0)
            self.trackers[trk_idx].update(detections[det_idx][:4])
            if getattr(self.trackers[trk_idx], "reset_count", 0) > pre:
                individual_resets += 1
        if individual_resets:
            self.stats["individual_resets"] += individual_resets
            print(f"frame {self.frame_count}: {individual_resets} individual resets")

        for trk_idx in unmatched_trks:
            self.trackers[trk_idx].mark_as_lost()
        for det_idx in unmatched_dets:
            self.trackers.append(MotionResetKalmanTracker(detections[det_idx][:4], max_lost_frames=self.max_lost_frames))

        alive = []
        for tracker in self.trackers:
            if tracker.should_delete(self.max_lost_frames):
                if getattr(tracker, "reset_count", 0) > 0:
                    self.stats["tracking_recoveries"] += 1
            else:
                alive.append(tracker)
        self.trackers = alive
        return self._get_enhanced_track_results()

    def associate_detections_to_trackers(self, detections, predicted_bboxes, iou_threshold):
        """Greedy IoU matching (own impl in reference, ref :235-279)."""
        if len(detections) == 0:
            return [], [], list(range(len(predicted_bboxes)))
        if len(predicted_bboxes) == 0:
            return [], list(range(len(detections))), []
        iou_matrix = np.zeros((len(detections), len(predicted_bboxes)))
        for d, det in enumerate(detections):
            for t, pred in enumerate(predicted_bboxes):
                iou_matrix[d, t] = iou_xyxy(det[:4], pred)
        matches = sorted(
            ((iou_matrix[d, t], d, t) for d in range(len(detections)) for t in range(len(predicted_bboxes)) if iou_matrix[d, t] > iou_threshold),
            reverse=True,
        )
        matched, used_d, used_t = [], set(), set()
        for _, d, t in matches:
            if d not in used_d and t not in used_t:
                matched.append([d, t])
                used_d.add(d)
                used_t.add(t)
        unmatched_detections = [d for d in range(len(detections)) if d not in used_d]
        unmatched_trackers = [t for t in range(len(predicted_bboxes)) if t not in used_t]
        return matched, unmatched_detections, unmatched_trackers

    def get_comprehensive_stats(self):
        perf = {}
        if self.stats["processing_times"]:
            times = self.stats["processing_times"]
            perf = {
                "avg_processing_time": f"{np.mean(times):.2f}ms",
                "max_processing_time": f"{np.max(times):.2f}ms",
                "min_processing_time": f"{np.min(times):.2f}ms",
            }
        return {
            "basic": {k: self.stats[k] for k in ("total_frames", "global_motion_events", "global_resets", "individual_resets", "tracking_recoveries")},
            "motion_detection": self.motion_detector.get_stats(),
            "performance": perf,
            "trackers": {
                "active_trackers": len(self.trackers),
                "total_resets_by_tracker": sum(getattr(t, "reset_count", 0) for t in self.trackers),
            },
            "motion_history_avg": float(np.mean(self.global_motion_history)) if self.global_motion_history else 0.0,
        }

    def enable_adaptive_mode(self, enabled: bool = True):
        self.adaptive_thresholds = enabled
        for t in self.trackers:
            if hasattr(t, "adaptive_enabled"):
                t.adaptive_enabled = enabled

    def set_global_motion_sensitivity(self, sensitivity: float):
        """Scale motion thresholds by 1/sensitivity (valid 0.5-2.0)."""
        if 0.5 <= sensitivity <= 2.0:
            self.motion_detector.global_motion_threshold /= sensitivity
            self.motion_detector.reset_motion_threshold /= sensitivity
        else:
            print(f"sensitivity must be in [0.5, 2.0], got {sensitivity}")

    def reset_all_statistics(self):
        self.stats = {
            "total_frames": 0,
            "global_motion_events": 0,
            "global_resets": 0,
            "individual_resets": 0,
            "tracking_recoveries": 0,
            "processing_times": deque(maxlen=100),
            "motion_compensation_effects": [],
        }
        self.motion_detector.reset_stats()

    def _get_enhanced_track_results(self):
        tracks = []
        for tracker in self.trackers:
            info = tracker.get_track_info()
            if self.frame_motion_info:
                info["global_motion"] = self.frame_motion_info
            if hasattr(tracker, "get_reset_statistics"):
                info["reset_statistics"] = tracker.get_reset_statistics()
            tracks.append(info)
        return tracks
