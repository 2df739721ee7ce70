"""Segmentation predictor (counterpart of yolo_tpu/engine/segment_predictor.py).

The detection predictor's host pipeline, with a device pass that also carries the mask
coefficients through NMS (`extra`) and assembles each slot's mask at prototype resolution
(sigmoid of the f32 product, cropped to its box); the host fetches the masks of the valid
slots only, undoes the letterbox on them with cv2 and attaches a `Masks` (the probability
> 0.5) to each Results. `retina_masks=True` strips the pad at prototype scale and resizes
once, straight to the original image (JAX's route); otherwise each mask is resized to the
letterboxed input, then through the inverse letterbox. `save`, `show` and `verbose` act as
the detection predictor's. Test-time augmentation is the detect task's: `augment=True`
warns and predicts at one scale. `int8=True` quantizes the fused tree as the detection predictor does (dynamic
activation scales) and walks the convs without the kernels 1-3.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yolo_tpu_torch.engine.predictor import BasePredictor
from yolo_tpu_torch.engine.results import Masks, Results
from yolo_tpu_torch.ops.boxes import scale_boxes
from yolo_tpu_torch.ops.masks import process_mask, scale_masks_np
from yolo_tpu_torch.ops.nms import non_max_suppression


class SegmentationPredictor(BasePredictor):
    """Predictor of a SegmentationModel: Results with boxes and masks."""

    @torch.no_grad()
    def _predict(self, imgs: torch.Tensor) -> dict:
        """RGB in [0, 1], the forward (kernels 1, 2 and 3), NMS with the coefficients as extra columns
        (kernel 5), then every output slot's mask at prototype resolution cropped to its box."""
        a = self.args
        if a.augment:
            self._takes_augment()  # warns once: one scale
        x = imgs.flip(-1).to(self.dtype) / 255.0
        preds, protos = self.model.predict(x, plain=a.plain)
        out = non_max_suppression(preds, conf_thres=a.conf, iou_thres=a.iou, classes=a.classes, agnostic=a.agnostic_nms,
                                  max_det=a.max_det, nc=self.model.nc, plain=a.plain)
        out["masks"] = process_mask(protos, out["extra"], out["boxes"], imgs.shape[1:3], upsample=False)
        return out

    def _fetch(self, out: dict) -> dict:
        """The small outputs first (one wait), then only the leading slots that hold a valid detection in
        some image of the batch (NMS puts the valid slots first)."""
        masks = out.pop("masks")
        host = super()._fetch(out)
        n = int(host["valid"].sum(1).max()) if host["valid"].size else 0
        host["masks"] = masks[:, :n].cpu().numpy()
        return host

    def _result(self, img: np.ndarray, path, out: dict, hw, lb_meta) -> Results:
        """Boxes mapped back as the JAX segment predictor maps them (the gain and pad from the two sizes),
        then the valid masks: resized to the letterboxed size and through the inverse letterbox, or with
        `retina_masks` resized once from prototype scale; kept where the probability exceeds 0.5."""
        import cv2

        h, w = hw
        valid = out["valid"]
        boxes = scale_boxes(hw, out["boxes"][valid], img.shape[:2])
        data = np.concatenate([boxes, out["scores"][valid][:, None], out["cls"][valid][:, None].astype(np.float32)], -1)
        r = Results(img, path, self.names, boxes=data)
        t0 = time.perf_counter()
        vm = out["masks"][valid[: len(out["masks"])]]  # (n, mh, mw)
        if self.args.retina_masks:
            masks = scale_masks_np(vm, img.shape[:2], vm.shape[1:] if len(vm) else (h, w))
        else:
            if len(vm):
                vm = np.stack([cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR) for m in vm])
            masks = scale_masks_np(vm.reshape(-1, h, w) if len(vm) else vm.reshape(0, h, w), img.shape[:2], (h, w))
        r.masks = Masks(masks > 0.5, img.shape[:2])
        self._host_s["masks_s"] = self._host_s.get("masks_s", 0.0) + time.perf_counter() - t0
        return r
