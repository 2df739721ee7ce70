"""Camera-motion compensation (counterpart of yolo_tpu/motion/; ref: camera_motion_compensation/).

Global camera-motion detection (optical flow / ORB feature matching / hybrid)
triggering Kalman-state resets, on the host as in the JAX package:

  - :class:`GlobalMotionDetector`: per-frame motion magnitude / vector and a reset flag.
  - :class:`MotionResetKalmanTracker`: single-target tracker with jump detection and filter reset.
  - :class:`MotionCompensatedMultiTracker`: the multi-target manager wiring both.
  - :func:`compare_motion_methods`: each method over one video, frames/s and resets.
"""

from yolo_tpu_torch.motion.compare import METHODS, compare_motion_methods
from yolo_tpu_torch.motion.global_motion_detector import GlobalMotionDetector
from yolo_tpu_torch.motion.motion_compensated_tracker import MotionCompensatedMultiTracker
from yolo_tpu_torch.motion.motion_reset_tracker import MotionResetKalmanTracker

__all__ = ["METHODS", "GlobalMotionDetector", "MotionCompensatedMultiTracker", "MotionResetKalmanTracker",
           "compare_motion_methods"]
