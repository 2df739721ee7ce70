"""Pose predictor (counterpart of the pose route of yolo_tpu/engine/predictor.py).

The detection predictor's host pipeline, with a device pass whose NMS gets the model's nc
explicitly and carries each anchor's decoded keypoints as extra columns (the NMS kernel),
honouring `classes` and `agnostic_nms` as the JAX pose route does. On the host each valid
detection's keypoints go back through the inverse letterbox, x and y clipped to the frame and
the visibility column kept, into a `Keypoints` on its Results. `save`, `show` and `verbose`
act as the detection predictor's. Test-time augmentation is the detect task's: `augment=True`
warns and predicts at one scale. `int8=True` quantizes the fused tree as the detection predictor does (dynamic
activation scales) and walks the convs without the kernels 1-3.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.engine.predictor import BasePredictor
from yolo_tpu_torch.engine.results import Keypoints, Results
from yolo_tpu_torch.ops.nms import non_max_suppression


class PosePredictor(BasePredictor):
    """Predictor of a PoseModel: Results with boxes and keypoints."""

    @torch.no_grad()
    def _predict(self, imgs: torch.Tensor) -> dict:
        """RGB in [0, 1], the forward (kernels 1, 2 and 3), NMS with the keypoints as extra columns (kernel 5)."""
        a = self.args
        if a.augment:
            self._takes_augment()  # warns once: one scale
        x = imgs.flip(-1).to(self.dtype) / 255.0
        return non_max_suppression(self.model.predict(x, plain=a.plain), conf_thres=a.conf, iou_thres=a.iou, classes=a.classes,
                                   agnostic=a.agnostic_nms, max_det=a.max_det, nc=self.model.nc, plain=a.plain)

    def _result(self, img: np.ndarray, path, out: dict, hw, lb_meta) -> Results:
        """The detection Results, then the valid slots' keypoints (K, ndim): x and y less the letterbox's pad,
        over its gain, clipped to [0, W] and [0, H]."""
        r = super()._result(img, path, {k: v for k, v in out.items() if k != "extra"}, hw, lb_meta)
        K, ndim = self.model.head.kpt_shape
        kd = out["extra"][out["valid"]].reshape(-1, K, ndim).copy()
        (gain, _), pad = lb_meta
        H0, W0 = img.shape[:2]
        kd[..., 0] = np.clip((kd[..., 0] - pad[0]) / gain, 0, W0)
        kd[..., 1] = np.clip((kd[..., 1] - pad[1]) / gain, 0, H0)
        r.keypoints = Keypoints(kd, img.shape[:2])
        return r
