"""Box-format conversions, the inverse letterbox and pairwise IoU (counterpart of yolo_tpu/ops/boxes.py).

`xyxy2xywh`, `xywh2xyxy`, `xywhn2xyxy`, `xyxy2xywhn`, `ltwh2xyxy`, `xyxy2ltwh`, `clip_boxes`,
`scale_boxes` and `box_iou` take numpy arrays (the host side of the predictor, the validator,
the MOT trackers and `utils.instance`) or torch tensors alike; `bbox_iou` (the training
loss's IoU variants) takes torch tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _stack(cols, like):
    return torch.stack(cols, dim=-1) if torch.is_tensor(like) else np.stack(cols, axis=-1)


def _as_array(x):
    return x if torch.is_tensor(x) else np.asarray(x)


def xyxy2xywh(x):
    """(x1, y1, x2, y2) → (cx, cy, w, h) over the last axis."""
    x = _as_array(x)
    return _stack([(x[..., 0] + x[..., 2]) / 2, (x[..., 1] + x[..., 3]) / 2, x[..., 2] - x[..., 0], x[..., 3] - x[..., 1]], x)


def xywhn2xyxy(x, w: int = 640, h: int = 640, padw: float = 0.0, padh: float = 0.0):
    """Normalized (cx, cy, w, h) → pixel (x1, y1, x2, y2), shifted by the pads."""
    x = _as_array(x)
    return _stack([
        w * (x[..., 0] - x[..., 2] / 2) + padw, h * (x[..., 1] - x[..., 3] / 2) + padh,
        w * (x[..., 0] + x[..., 2] / 2) + padw, h * (x[..., 1] + x[..., 3] / 2) + padh,
    ], x)


def xyxy2xywhn(x, w: int = 640, h: int = 640, clip: bool = False, eps: float = 0.0):
    """Pixel (x1, y1, x2, y2) → normalized (cx, cy, w, h); `clip` first clips to (h - eps, w - eps)."""
    x = _as_array(x)
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    return _stack([
        (x[..., 0] + x[..., 2]) / 2 / w, (x[..., 1] + x[..., 3]) / 2 / h, (x[..., 2] - x[..., 0]) / w, (x[..., 3] - x[..., 1]) / h,
    ], x)


def ltwh2xyxy(x):
    """(left, top, w, h) → (x1, y1, x2, y2) over the last axis."""
    x = _as_array(x)
    return _stack([x[..., 0], x[..., 1], x[..., 0] + x[..., 2], x[..., 1] + x[..., 3]], x)


def xyxy2ltwh(x):
    """(x1, y1, x2, y2) → (left, top, w, h) over the last axis."""
    x = _as_array(x)
    return _stack([x[..., 0], x[..., 1], x[..., 2] - x[..., 0], x[..., 3] - x[..., 1]], x)


def clip_boxes(boxes, shape):
    """Clip xyxy boxes to the image bounds shape = (h, w)."""
    boxes = _as_array(boxes)
    h, w = shape[0], shape[1]
    clip = (lambda v, hi: v.clamp(0, hi)) if torch.is_tensor(boxes) else (lambda v, hi: np.clip(v, 0, hi))
    return _stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h), clip(boxes[..., 2], w), clip(boxes[..., 3], h)], boxes)


def scale_boxes(img1_shape, boxes, img0_shape, ratio_pad=None, padding: bool = True, xywh: bool = False):
    """Rescale boxes from the letterboxed img1_shape back to the original img0_shape.

    The inverse letterbox: gain is min(h1 / h0, w1 / w0) and the pad is
    (round(wdiff / 2 - 0.1), round(hdiff / 2 - 0.1)), unless `ratio_pad` =
    ((gain, gain), (padw, padh)) gives them. xyxy boxes are clipped to the
    image; xywh ones (centres) are not."""
    boxes = _as_array(boxes)
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (
            round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
            round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1),
        )
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    if padding:
        shift = [pad[0], pad[1], 0 if xywh else pad[0], 0 if xywh else pad[1]]
        if torch.is_tensor(boxes):
            boxes = boxes - torch.tensor(shift, dtype=boxes.dtype, device=boxes.device)
        else:
            boxes = boxes - np.asarray(shift, dtype=boxes.dtype)
    boxes = boxes / gain
    return boxes if xywh else clip_boxes(boxes, img0_shape)


def xywh2xyxy(x):
    """(cx, cy, w, h) → (x1, y1, x2, y2) over the last axis."""
    x = _as_array(x)
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    return _stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], x)


def box_iou(box1, box2, eps: float = 1e-7):
    """Pairwise IoU between (..., N, 4) and (..., M, 4) xyxy boxes → (..., N, M); numpy
    arrays (the host trackers, in their own dtype) or torch tensors alike."""
    xp = torch if torch.is_tensor(box1) else np
    lt = xp.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = xp.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = xp.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False, DIoU: bool = False,
             CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU, GIoU, DIoU or CIoU of broadcastable (..., 4) boxes → (...).

    The loss's CIoU and the assigner's overlaps. As in the JAX package, an xyxy
    box's height carries `eps` and an xywh one's does not, and the CIoU weight
    `alpha` is held out of the gradient."""
    if xywh:
        x1, y1, w1, h1 = box1.unbind(-1)
        x2, y2, w2, h2 = box2.unbind(-1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
        b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
        w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
        w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * (
        torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)
    ).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # enclosing width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # enclosing height
    if CIoU or DIoU:
        c2 = cw**2 + ch**2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            with torch.no_grad():
                alpha = v / (v - iou + (1 + eps))
            return iou - (rho2 / c2 + v * alpha)
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area
