"""SAM facade (counterpart of yolo_tpu/models/sam/model.py).

    sam = SAM("sam_b")                      # the seeded init(0) weights (JAX's), on the card
    sam = SAM("mobile_sam", device="cpu")   # the CPU: plain torch, as everywhere in the port
    sam.load_torch("sam_b.pt")              # a released state dict: load_state_dict by name
    r = sam.predict(bgr, points=[[x, y]])   # Results: masks at the image's size, iou_scores
    vp = SAM("sam2_t").video_predictor(num_frames=len(frames))
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.models.sam.build import SAM_BUILDERS, load_state_dict_checked, param_count, sam_params_from_jax
from yolo_tpu_torch.models.sam.predict import SAMPredictor


class SAM:
    """Promptable Segment Anything: `sam_b`, `sam_l`, `sam_h`, `mobile_sam`, `sam2_t`, `sam2_s`, `sam2_b` (a name
    may end in .pt and use '-'). Built on `device` (None: the card) in f32 with the JAX package's init(0) weights;
    on the meta device nothing is drawn nor allocated (for `info`)."""

    def __init__(self, model: str = "sam_b", img_size: int = 1024, device=None):
        key = str(model).lower().replace(".pt", "").replace("-", "_")
        if key not in SAM_BUILDERS:
            raise ValueError(f"unknown SAM variant '{model}' — choose from {sorted(SAM_BUILDERS)}")
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = SAM_BUILDERS[key](img_size=img_size).eval()
        if self.device.type != "meta":
            sam_params_from_jax(self.model, self.model.init(0))
        self.predictor = None
        self.task = "segment"

    def load_torch(self, path):
        """A released SAM / MobileSAM / SAM2 checkpoint (.pt / .pth state dict, torch layout) by name."""
        from yolo_tpu_torch.nn.torch_import import load_torch_checkpoint

        sd, _ = load_torch_checkpoint(path)
        load_state_dict_checked(self.model, sd)
        self.predictor = None
        return self

    def predict(self, source, points=None, labels=None, bboxes=None, multimask_output=True, **kwargs):
        """One BGR image and its prompts → Results (`masks`, `iou_scores`)."""
        if self.predictor is None:
            self.predictor = SAMPredictor(self.model)
        self.predictor.set_image(source)
        return self.predictor(points=points, labels=labels, bboxes=bboxes, multimask_output=multimask_output)

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    def video_predictor(self, num_frames: int, reverse: bool = False):
        """SAM2's video propagation (models/sam/video.py); a SAM1 variant raises ValueError."""
        from yolo_tpu_torch.models.sam.sam2 import SAM2Model
        from yolo_tpu_torch.models.sam.video import SAM2VideoPredictor

        if not isinstance(self.model, SAM2Model):
            raise ValueError("video propagation requires a SAM2 variant (sam2_t/s/b)")
        return SAM2VideoPredictor(self.model, num_frames=num_frames, reverse=reverse)

    def info(self) -> dict:
        return {"params": param_count(self.model), "img_size": self.model.img_size}
