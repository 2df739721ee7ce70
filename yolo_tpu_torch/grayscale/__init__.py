"""Grayscale-appearance fallback tracking (counterpart of yolo_tpu/grayscale/; ref: Grayscale-Tracking/).

When the detector loses a small IR target, a 40×40 ROI / 5×5 sliding-window
grayscale+gradient scorer keeps predicting the target center indefinitely.
The reference's "GPU unfold" scorer maps to a vectorized window scorer here:
numpy on the host (the tracker's), and `predict_center_torch` on any device
for batches of ROIs; both equal the reference's per-window loop.
"""

from yolo_tpu_torch.grayscale.scoring import gradient_window_scores, predict_center, predict_center_torch
from yolo_tpu_torch.grayscale.tracker import GrayscaleTracker

__all__ = ["GrayscaleTracker", "gradient_window_scores", "predict_center", "predict_center_torch"]
