"""Model family facades beyond the YOLO class (counterpart of yolo_tpu/models/): SAM and FastSAM."""

from yolo_tpu_torch.models.fastsam import FastSAM, FastSAMPredictor
from yolo_tpu_torch.models.sam import SAM, SAMPredictor

__all__ = ["FastSAM", "FastSAMPredictor", "SAM", "SAMPredictor"]
