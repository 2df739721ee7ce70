"""Alternative IR pipelines (counterpart of yolo_tpu/otherplan/):

  - :mod:`classical`: top-hat + LoG + local-contrast enhancement and geometry-filtered
    detection, no learned model; the enhancement also as a batched torch function on the
    device (`enhance_small_targets_torch`).
  - :mod:`single_target`: the 4-state [cx, cy, vx, vy] Kalman single-target tracker with the
    right→left direction prior, 50 px gating, a 30-frame coast limit and CSV trajectory rows.
  - :func:`detect_only`: the detector-only video loop.
"""

from yolo_tpu_torch.otherplan.classical import classical_detect, enhance_small_targets, enhance_small_targets_torch
from yolo_tpu_torch.otherplan.detect_only import detect_only
from yolo_tpu_torch.otherplan.single_target import IRSmallTargetTracker, KalmanCV2D, run_single_target_tracking

__all__ = [
    "classical_detect", "enhance_small_targets", "enhance_small_targets_torch",
    "IRSmallTargetTracker", "KalmanCV2D", "run_single_target_tracking", "detect_only",
]
