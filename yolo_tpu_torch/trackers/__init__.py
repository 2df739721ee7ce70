"""Multi-object trackers (counterpart of yolo_tpu/trackers/): ByteTrack and BoT-SORT
with their Kalman filters, association costs and camera-motion compensation as
host numpy code, and the batched ByteTrack twin as torch tensors on one device
(trackers/batched.py). `YOLO.track` reaches them through trackers/track.py."""

from yolo_tpu_torch.trackers.bot_sort import BOTSORT, BOTrack
from yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack
from yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYAH, KalmanFilterXYWH

__all__ = ["BYTETracker", "STrack", "BOTSORT", "BOTrack", "KalmanFilterXYAH", "KalmanFilterXYWH"]
