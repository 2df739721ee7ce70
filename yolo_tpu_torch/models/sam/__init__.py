"""Segment Anything: SAM ViT-B/L/H, MobileSAM, SAM2-t/s/b (counterpart of yolo_tpu/models/sam/)."""

from yolo_tpu_torch.models.sam.build import SAM_BUILDERS, build_sam_vit_b, build_sam_vit_h, build_sam_vit_l, sam_params_from_jax
from yolo_tpu_torch.models.sam.model import SAM
from yolo_tpu_torch.models.sam.predict import SAMPredictor
from yolo_tpu_torch.models.sam.video import SAM2VideoPredictor

__all__ = ["SAM", "SAMPredictor", "SAM2VideoPredictor", "SAM_BUILDERS", "build_sam_vit_b", "build_sam_vit_l",
           "build_sam_vit_h", "sam_params_from_jax"]
