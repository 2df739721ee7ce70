"""Oriented-box predictor (counterpart of the obb route of yolo_tpu/engine/predictor.py).

The detection predictor's host pipeline, with a device pass whose NMS is the rotated one
(`non_max_suppression_rotated`: probiou, plain torch, with the model's nc), honouring `classes`
and `agnostic_nms` as the JAX obb route does. On the host each valid detection's centre and
size go back through the inverse letterbox (`scale_boxes(..., xywh=True)`: the centres less the
pad, all four over the gain, nothing clipped) and its angle is kept, into an `OBBoxes` on its
Results, which carries no axis-aligned boxes. `save`, `show` and `verbose` act as the detection
predictor's. Test-time augmentation is the detect task's: `augment=True` warns and predicts at
one scale. `int8=True` quantizes the fused tree as the detection predictor does (dynamic
activation scales) and walks the convs without the kernels 1-3.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.engine.predictor import BasePredictor
from yolo_tpu_torch.engine.results import OBBoxes, Results
from yolo_tpu_torch.ops.boxes import scale_boxes
from yolo_tpu_torch.ops.nms import non_max_suppression_rotated


class OBBPredictor(BasePredictor):
    """Predictor of an OBBModel: Results with oriented boxes."""

    @torch.no_grad()
    def _predict(self, imgs: torch.Tensor) -> dict:
        """RGB in [0, 1], the forward (kernels 1, 2 and 3), the rotated NMS."""
        a = self.args
        if a.augment:
            self._takes_augment()  # warns once: one scale
        x = imgs.flip(-1).to(self.dtype) / 255.0
        return non_max_suppression_rotated(self.model.predict(x, plain=a.plain), conf_thres=a.conf, iou_thres=a.iou,
                                           classes=a.classes, agnostic=a.agnostic_nms, max_det=a.max_det, nc=self.model.nc)

    def _result(self, img: np.ndarray, path, out: dict, hw, lb_meta) -> Results:
        """The valid slots as (n, 7) [cx, cy, w, h, angle, conf, cls]: centre and size through the inverse
        letterbox, the angle as predicted."""
        valid = out["valid"]
        boxes = out["boxes"][valid]
        xywh = scale_boxes(hw, boxes[:, :4], img.shape[:2], ratio_pad=lb_meta, xywh=True)
        data = np.concatenate([xywh, boxes[:, 4:5], out["scores"][valid][:, None], out["cls"][valid][:, None].astype(np.float32)], -1)
        r = Results(img, path, self.names)
        r.obb = OBBoxes(data, img.shape[:2])
        return r
