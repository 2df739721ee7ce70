"""SAM predictor: set_image → prompts → masks, and segment-everything (counterpart of
yolo_tpu/models/sam/predict.py).

The image is encoded once per `set_image` on the model's device; each prompt batch reuses the
embedding. The masks are upscaled on the host with cv2, as in JAX. `generate` prompts a point
grid in chunks of `points_batch_size` (JAX pads the last chunk to its compiled batch; the
decoder treats prompts independently, so the port does not pad and keeps the same masks),
filters by predicted IoU and stability on the low-resolution grid and dedupes with the host
NMS (`nms_numpy`, the port's copy of JAX's).
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.engine.results import Masks, Results


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS on the host → kept indices, best score first (JAX `ops/nms.py::nms_numpy`)."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        suppressed |= inter / (areas[i] + areas - inter + 1e-7) > iou_threshold
    return np.asarray(keep, dtype=np.int64)


def _is_sam2(model) -> bool:
    from yolo_tpu_torch.models.sam.sam2 import SAM2Model

    return isinstance(model, SAM2Model)


class SAMPredictor:
    """Promptable segmentation over a SAMModel or SAM2Model whose weights are installed. `timings`, when set to
    a list, gets one dict a call: encode / decode seconds (host clock, synchronised)."""

    def __init__(self, model):
        self.model = model
        self.features = None
        self._orig_hw = None
        self._scale = None
        self.timings = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def img_size(self) -> int:
        return self.model.img_size

    @torch.no_grad()
    def set_image(self, img: np.ndarray):
        """Encode one BGR uint8 image, resized so its long side is img_size and padded with raw zeros."""
        import cv2

        s = self.img_size
        h0, w0 = img.shape[:2]
        scale = s / max(h0, w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        im = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)[..., ::-1].astype(np.float32)
        pad = np.zeros((s, s, 3), np.float32)
        pad[:nh, :nw] = im
        self.features = self.model.encode_image(torch.from_numpy(pad)[None].to(self.device))
        self._orig_hw = (h0, w0)
        self._scale = scale
        return self

    @torch.no_grad()
    def decode(self, points=None, boxes=None, multimask_output=True):
        """The low-resolution mask logits and IoU scores on the device for prompts already in img_size pixels:
        points a (coords (B, N, 2), labels (B, N)) pair, boxes (B, 4)."""
        if self.features is None:
            raise RuntimeError("call set_image() first")
        if _is_sam2(self.model):
            embed, high_res = self.features
            masks, iou, _ = self.model.predict_masks(embed, high_res, points=points, boxes=boxes,
                                                     multimask_output=multimask_output)
            return masks, iou
        return self.model.predict_masks(self.features, points=points, boxes=boxes, multimask_output=multimask_output)

    def __call__(self, points=None, labels=None, bboxes=None, multimask_output=True) -> Results:
        """Masks for point / box prompts in the ORIGINAL image's pixels: points (N, 2), labels (N,) 1 foreground
        0 background (default ones), bboxes (M, 4) xyxy. → Results with `masks` at the original size and
        `iou_scores`."""
        dev = self.device
        pts = None
        if points is not None:
            pts_arr = np.atleast_2d(np.asarray(points, np.float32)) * self._scale
            lab = np.ones(len(pts_arr), np.int64) if labels is None else np.asarray(labels, np.int64)
            pts = (torch.from_numpy(pts_arr)[None].to(dev), torch.from_numpy(lab)[None].to(dev))
        bxs = None
        if bboxes is not None:
            bxs = torch.from_numpy(np.atleast_2d(np.asarray(bboxes, np.float32)) * self._scale).to(dev)
        masks, iou = self.decode(pts, bxs, bool(multimask_output))
        return self._results(masks.float().cpu().numpy(), iou.float().cpu().numpy())

    def _results(self, masks: np.ndarray, iou: np.ndarray) -> Results:
        """Low-resolution logits (B, M, h, w) → masks at the original size (cv2 upscale, crop, resize) > threshold."""
        import cv2

        s = self.img_size
        h0, w0 = self._orig_hw
        out = []
        for b in range(masks.shape[0]):
            for m in range(masks.shape[1]):
                full = cv2.resize(masks[b, m], (s, s), interpolation=cv2.INTER_LINEAR)
                crop = full[: int(round(h0 * self._scale)), : int(round(w0 * self._scale))]
                out.append(cv2.resize(crop, (w0, h0), interpolation=cv2.INTER_LINEAR) > self.model.mask_threshold)
        r = Results(np.zeros((h0, w0, 3), np.uint8), "", {0: "object"})
        r.masks = Masks(np.stack(out) if out else np.zeros((0, h0, w0), bool), (h0, w0))
        r.iou_scores = iou.reshape(-1)
        return r

    def generate(self, img: np.ndarray, points_stride: int = 32, points_batch_size: int = 64,
                 conf_thres: float = 0.88, stability_score_thresh: float = 0.95, stability_score_offset: float = 1.0,
                 nms_thresh: float = 0.7) -> Results:
        """Segment everything through a points_stride² grid of single-point prompts (JAX :119): multimask
        decode, IoU > conf_thres, stability (the ±offset thresholdings' IoU) > stability_score_thresh, boxes from
        the low-resolution masks, NMS → Results with masks at the original size, boxes and scores. SAM2 raises
        NotImplementedError, as in JAX."""
        import cv2

        if _is_sam2(self.model):
            raise NotImplementedError(
                "generate() (segment-everything) currently supports SAM1/MobileSAM predictors; "
                "SAM2's predict_masks takes the high-res feature pyramid — use point/box prompts")
        t0 = self._clock()
        self.set_image(img)
        t_enc = self._clock()
        h0, w0 = self._orig_hw
        side = points_stride
        gy, gx = np.meshgrid((np.arange(side) + 0.5) / side, (np.arange(side) + 0.5) / side, indexing="ij")
        grid = np.stack([gx.reshape(-1) * w0, gy.reshape(-1) * h0], -1).astype(np.float32)
        thr = self.model.mask_threshold
        all_masks, all_scores, all_boxes = [], [], []
        dev_s = host_s = 0.0
        for i in range(0, len(grid), points_batch_size):
            t1 = self._clock()
            chunk = torch.from_numpy(grid[i : i + points_batch_size, None] * self._scale).to(self.device)
            labels = torch.ones(chunk.shape[:2], dtype=torch.long, device=self.device)
            masks, iou = self.decode((chunk, labels), None, True)
            masks = masks.float().cpu().numpy()
            iou = iou.float().cpu().numpy().reshape(-1)
            t2 = self._clock()
            masks = masks.reshape(-1, *masks.shape[-2:])
            keep = iou > conf_thres
            masks, iou = masks[keep], iou[keep]
            if len(masks):
                hi = (masks > thr + stability_score_offset).sum((1, 2))
                lo = (masks > thr - stability_score_offset).sum((1, 2))
                keep = hi / np.maximum(lo, 1) > stability_score_thresh
                for m, s in zip(masks[keep] > thr, iou[keep]):
                    ys, xs = np.where(m)
                    if len(ys):
                        all_boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                        all_masks.append(m)
                        all_scores.append(float(s))
            dev_s += t2 - t1
            host_s += self._clock() - t2
        t3 = self._clock()
        r = Results(np.zeros((h0, w0, 3), np.uint8), "", {0: "object"})
        if not all_masks:
            r.masks = Masks(np.zeros((0, h0, w0), bool), (h0, w0))
        else:
            boxes = np.asarray(all_boxes, np.float32)
            scores = np.asarray(all_scores, np.float32)
            keep = nms_numpy(boxes, scores, nms_thresh)
            crop_h = max(int(round(h0 * self._scale / 4)), 1)
            crop_w = max(int(round(w0 * self._scale / 4)), 1)
            gain = np.array([w0 / crop_w, h0 / crop_h, w0 / crop_w, h0 / crop_h])
            out_masks = [cv2.resize(all_masks[k][:crop_h, :crop_w].astype(np.uint8), (w0, h0),
                                    interpolation=cv2.INTER_NEAREST) > 0 for k in keep]
            r.masks = Masks(np.stack(out_masks), (h0, w0))
            data = np.concatenate([np.asarray([boxes[k] * gain for k in keep], np.float32), scores[keep][:, None],
                                   np.zeros((len(keep), 1), np.float32)], -1)
            r.update(boxes=data)
        if self.timings is not None:
            self.timings.append({"encode_s": t_enc - t0, "decode_s": dev_s, "filter_s": host_s,
                                 "nms_s": self._clock() - t3, "points": len(grid)})
        return r

    def _clock(self) -> float:
        import time

        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()
