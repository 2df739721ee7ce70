"""Association costs and the linear assignment of the MOT trackers (counterpart of
yolo_tpu/trackers/matching.py), host numpy and scipy.

The IoU cost is computed in numpy at float32, as the JAX package's host path
computes it, so host rows compare exactly. Rotated boxes (OBB tracks) are not
ported.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

from yolo_tpu_torch.ops.boxes import box_iou


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    """Hungarian assignment with a cost threshold → (matches (M, 2), unmatched_a, unmatched_b)."""
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            tuple(range(cost_matrix.shape[0])),
            tuple(range(cost_matrix.shape[1])),
        )
    cost = cost_matrix.copy()
    cost[cost > thresh] = thresh + 1e-4  # above-threshold pairs may be assigned, then are dropped
    row, col = scipy.optimize.linear_sum_assignment(cost)
    matches = [(r, c) for r, c in zip(row, col) if cost_matrix[r, c] <= thresh]
    matched_a = {m[0] for m in matches}
    matched_b = {m[1] for m in matches}
    unmatched_a = tuple(i for i in range(cost_matrix.shape[0]) if i not in matched_a)
    unmatched_b = tuple(i for i in range(cost_matrix.shape[1]) if i not in matched_b)
    return np.asarray(matches, dtype=int).reshape(-1, 2), unmatched_a, unmatched_b


def iou_distance(atracks: list, btracks: list) -> np.ndarray:
    """1 - IoU between two lists of tracks (their `xyxy`) or of xyxy boxes → (len a, len b) float32."""

    def coords(tracks):
        if tracks and not isinstance(tracks[0], np.ndarray):
            return [t.xyxy for t in tracks]
        return tracks

    atlbrs, btlbrs = coords(atracks), coords(btracks)
    if len(atlbrs) == 0 or len(btlbrs) == 0:
        return np.zeros((len(atlbrs), len(btlbrs)), dtype=np.float32)
    a, b = np.stack(atlbrs).astype(np.float32), np.stack(btlbrs).astype(np.float32)
    return 1.0 - box_iou(a, b)


def embedding_distance(tracks: list, detections: list, metric: str = "cosine") -> np.ndarray:
    """Cosine distance between the tracks' smoothed features and the detections' features."""
    cost = np.zeros((len(tracks), len(detections)), dtype=np.float32)
    if cost.size == 0:
        return cost
    det_features = np.asarray([d.curr_feat for d in detections], dtype=np.float32)
    track_features = np.asarray([t.smooth_feat for t in tracks], dtype=np.float32)
    a = track_features / (np.linalg.norm(track_features, axis=1, keepdims=True) + 1e-9)
    b = det_features / (np.linalg.norm(det_features, axis=1, keepdims=True) + 1e-9)
    return np.maximum(0.0, 1.0 - a @ b.T)


def fuse_score(cost_matrix: np.ndarray, detections: list) -> np.ndarray:
    """Fuse the detections' confidences into an IoU cost: 1 - IoU * score."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1 - cost_matrix
    det_scores = np.array([d.score for d in detections])
    det_scores = np.broadcast_to(det_scores[None, :], cost_matrix.shape)
    fused = iou_sim * det_scores
    return 1 - fused
