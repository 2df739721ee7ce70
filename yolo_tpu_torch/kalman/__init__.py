"""Long-horizon Kalman tracking for IR aircraft under cloud occlusion (counterpart of yolo_tpu/kalman/).

Two implementations of one contract: per-track numpy objects (`tracker`,
`multi_tracker`: the API layer) and the fixed-capacity track table stepped in
torch on the device (`batched`: the fused detect+track path)."""

from yolo_tpu_torch.kalman.multi_tracker import EnhancedMultiTargetTracker
from yolo_tpu_torch.kalman.tracker import AircraftKalmanTracker, EnhancedAircraftKalmanTracker
from yolo_tpu_torch.kalman.visualizer import TrajectoryVisualizer

__all__ = [
    "AircraftKalmanTracker",
    "EnhancedAircraftKalmanTracker",
    "EnhancedMultiTargetTracker",
    "TrajectoryVisualizer",
]
