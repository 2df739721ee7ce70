"""Fused detect+track on the device (counterpart of yolo_tpu/pipeline/)."""

from yolo_tpu_torch.pipeline.fused import FusedDetectTrack

__all__ = ["FusedDetectTrack"]
