"""Multi-target tracking manager: predict → greedy-IoU associate → lifecycle.

The port's own copy of yolo_tpu/kalman/multi_tracker.py (numpy, host side).
The update contract: confirmed-track dict schema, ids "T%03d" assigned in
detection index order, greedy matching by descending IoU.
"""

from __future__ import annotations

import numpy as np

from yolo_tpu_torch.kalman.tracker import AircraftKalmanTracker


def iou_xyxy(bbox1, bbox2) -> float:
    """Plain IoU of two xyxy boxes (0 when degenerate/disjoint)."""
    ax1, ay1, ax2, ay2 = bbox1[:4]
    bx1, by1, bx2, by2 = bbox2[:4]
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    if ix2 <= ix1 or iy2 <= iy1:
        return 0.0
    inter = (ix2 - ix1) * (iy2 - iy1)
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / union if union > 0 else 0.0


class EnhancedMultiTargetTracker:
    """Greedy-IoU multi-target manager over AircraftKalmanTracker instances."""

    def __init__(self, max_lost_frames: int = 450, min_hits: int = 3, iou_threshold: float = 0.3):
        self.trackers: list[AircraftKalmanTracker] = []
        self.max_lost_frames = max_lost_frames
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.frame_count = 0
        self.next_track_id = 1
        self.stats = {
            "total_tracks_created": 0,
            "total_tracks_terminated": 0,
            "current_active_tracks": 0,
            "long_term_predictions": 0,
            "successful_recoveries": 0,
        }
        print(
            f"Multi-target tracker ready - loss tolerance {max_lost_frames} frames "
            f"({max_lost_frames / 30:.1f}s @30fps)"
        )

    def update(self, detections) -> list[dict]:
        """One tracking step.

        Args:
            detections: list of [x1, y1, x2, y2, conf].

        Returns:
            Confirmed track-info dicts (see AircraftKalmanTracker.get_track_info).
        """
        self.frame_count += 1

        # 1) time-update every tracker
        predicted_boxes = [t.predict() for t in self.trackers]

        # 2) associate detections ↔ predictions
        if len(detections) > 0 and len(self.trackers) > 0:
            matched, unmatched_dets, unmatched_trks = self._associate_detections_to_trackers(
                detections, predicted_boxes, self.iou_threshold
            )
        else:
            matched = []
            unmatched_dets = list(range(len(detections)))
            unmatched_trks = list(range(len(self.trackers)))

        # 3) measurement-update matched trackers
        for det_idx, trk_idx in matched:
            tracker = self.trackers[trk_idx]
            was_lost = tracker.is_lost
            tracker.update(detections[det_idx][:4])
            if was_lost:
                self.stats["successful_recoveries"] += 1
                print(f"Tracker {tracker.track_id} re-acquired, back to detection mode")

        # 4) unmatched trackers go/stay lost
        for trk_idx in unmatched_trks:
            tracker = self.trackers[trk_idx]
            was_lost = tracker.is_lost
            tracker.mark_as_lost()
            if not was_lost:
                print(f"Tracker {tracker.track_id} lost detection, switching to prediction mode")

        # 5) new trackers for unmatched detections (ID order = detection index order)
        for det_idx in unmatched_dets:
            new_tracker = AircraftKalmanTracker(
                detections[det_idx][:4],
                track_id=f"T{self.next_track_id:03d}",
                max_lost_frames=self.max_lost_frames,
            )
            self.trackers.append(new_tracker)
            self.next_track_id += 1
            self.stats["total_tracks_created"] += 1
            print(f"New tracker created: {new_tracker.track_id}")

        # 6) prune dead trackers
        alive = []
        for tracker in self.trackers:
            if tracker.should_delete(self.max_lost_frames):
                print(f"Deleting tracker {tracker.track_id} - lost for {tracker.time_since_update} frames")
                self.stats["total_tracks_terminated"] += 1
            else:
                alive.append(tracker)
        self.trackers = alive
        self.stats["current_active_tracks"] = len(self.trackers)

        # 7) emit confirmed tracks (lost ones always emit — the whole point is coasting)
        confirmed = []
        for tracker in self.trackers:
            if tracker.hit_streak >= self.min_hits or self.frame_count <= self.min_hits or tracker.is_lost:
                info = tracker.get_track_info()
                confirmed.append(info)
                if info["status"] == "predicted" and info["lost_frames"] > 30:
                    self.stats["long_term_predictions"] += 1

        if self.frame_count % 100 == 0:
            self._print_statistics()
        return confirmed

    # --- association -----------------------------------------------------------

    def _associate_detections_to_trackers(self, detections, trackers, iou_threshold: float = 0.3):
        """Greedy IoU matching → (matched pairs, unmatched det idxs, unmatched trk idxs)."""
        if len(trackers) == 0:
            return [], list(range(len(detections))), []

        iou_matrix = self._calculate_iou_matrix(detections, trackers)
        matched_indices = self._solve_assignment_problem(iou_matrix, iou_threshold)

        matched, unmatched_detections, unmatched_trackers = [], [], []
        matched_det = {m[0] for m in matched_indices}
        matched_trk = {m[1] for m in matched_indices}
        for det_idx in range(len(detections)):
            if det_idx not in matched_det:
                unmatched_detections.append(det_idx)
        for trk_idx in range(len(trackers)):
            if trk_idx not in matched_trk:
                unmatched_trackers.append(trk_idx)
        for det_idx, trk_idx in matched_indices:
            if iou_matrix[det_idx, trk_idx] >= iou_threshold:
                matched.append((det_idx, trk_idx))
            else:
                unmatched_detections.append(det_idx)
                unmatched_trackers.append(trk_idx)
        return matched, unmatched_detections, unmatched_trackers

    def _calculate_iou_matrix(self, detections, trackers) -> np.ndarray:
        m = np.zeros((len(detections), len(trackers)))
        for d, det in enumerate(detections):
            for t, trk_bbox in enumerate(trackers):
                m[d, t] = iou_xyxy(det[:4], trk_bbox)
        return m

    def _calculate_iou(self, bbox1, bbox2) -> float:
        return iou_xyxy(bbox1, bbox2)

    def _solve_assignment_problem(self, iou_matrix: np.ndarray, threshold: float):
        """Greedy assignment by descending IoU; numpy's default argsort decides
        the order among equal IoUs, as in the JAX package's manager."""
        if iou_matrix.size == 0:
            return []
        det_indices, trk_indices = np.where(iou_matrix >= threshold)
        if len(det_indices) == 0:
            return []
        iou_values = iou_matrix[det_indices, trk_indices]
        order = np.argsort(-iou_values)  # descending

        matched, used_dets, used_trks = [], set(), set()
        for idx in order:
            d, t = int(det_indices[idx]), int(trk_indices[idx])
            if d not in used_dets and t not in used_trks:
                matched.append((d, t))
                used_dets.add(d)
                used_trks.add(t)
        return matched

    # --- stats ----------------------------------------------------------------------

    def _print_statistics(self):
        print(f"\n=== Tracking stats (frame {self.frame_count}) ===")
        print(f"active tracks: {self.stats['current_active_tracks']}")
        print(f"tracks created: {self.stats['total_tracks_created']}")
        print(f"tracks terminated: {self.stats['total_tracks_terminated']}")
        print(f"recoveries: {self.stats['successful_recoveries']}")
        print(f"long-term predictions: {self.stats['long_term_predictions']}")
        for t in self.trackers:
            status = "lost" if t.is_lost else "ok"
            conf = t.motion_analysis.get("prediction_confidence", 0.0)
            print(f"  {t.track_id}: {status}, age:{t.age}, hits:{t.hits}, lost:{t.lost_frames}, conf:{conf:.2f}")

    def get_statistics(self) -> dict:
        return {
            **self.stats,
            "frame_count": self.frame_count,
            "tracker_details": [
                {
                    "track_id": t.track_id,
                    "age": t.age,
                    "hits": t.hits,
                    "lost_frames": t.lost_frames,
                    "is_lost": t.is_lost,
                    "confidence": t.motion_analysis.get("prediction_confidence", 0.0),
                }
                for t in self.trackers
            ],
        }
