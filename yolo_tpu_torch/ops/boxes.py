"""Box-format conversions, the inverse letterbox and pairwise IoU (counterpart of yolo_tpu/ops/boxes.py).

`xyxy2xywh`, `xywh2xyxy`, `xywhn2xyxy`, `xyxy2xywhn`, `ltwh2xyxy`, `xyxy2ltwh`, `clip_boxes`,
`scale_boxes` and `box_iou` take numpy arrays (the host side of the predictor, the validator,
the MOT trackers and `utils.instance`) or torch tensors alike; `bbox_iou` (the training
loss's IoU variants) takes torch tensors. The rotated-box ops of the obb task: `probiou`
and `xywhr2xyxyxyxy` take either, `xyxyxyxy2xywhr` is host cv2 (`minAreaRect`).
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


def _covariance_terms(boxes):
    """The Gaussian covariance entries (a, b, c) of xywhr boxes, each (..., 1)."""
    xp = torch if torch.is_tensor(boxes) else np
    a = boxes[..., 2:3] ** 2 / 12
    b = boxes[..., 3:4] ** 2 / 12
    r = boxes[..., 4:5]
    cos, sin = xp.cos(r), xp.sin(r)
    cos2, sin2 = cos**2, sin**2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1, obb2, CIoU: bool = False, eps: float = 1e-7):
    """Probabilistic IoU of broadcastable xywhr boxes (arXiv:2106.06072) → (..., 1): one minus the
    Hellinger distance of their Gaussians, in the JAX package's order of operations. `CIoU` subtracts
    the aspect-ratio penalty only, its weight held out of the gradient. Numpy arrays or torch tensors.
    The values are JAX's; the gradient differs where a box has no area (a zero-padded target): zero
    there, where JAX's square root gives NaN and poisons the whole backward."""
    is_t = torch.is_tensor(obb1)
    xp = torch if is_t else np
    if not is_t:
        obb1, obb2 = np.asarray(obb1), np.asarray(obb2)
    clip = (lambda v, lo, hi: v.clamp(lo, hi)) if is_t else np.clip
    x1, y1 = obb1[..., 0:1], obb1[..., 1:2]
    x2, y2 = obb2[..., 0:1], obb2[..., 1:2]
    a1, b1, c1 = _covariance_terms(obb1)
    a2, b2, c2 = _covariance_terms(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = (((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom) * 0.25
    t2 = (((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom) * 0.5
    det = clip(a1 * b1 - c1**2, 0, None) * clip(a2 * b2 - c2**2, 0, None)
    if is_t:  # the same root, with a zero gradient where a box is degenerate (JAX's is inf · 0 = NaN there)
        root = torch.where(det > 0, torch.sqrt(torch.where(det > 0, det, torch.ones_like(det))), torch.zeros_like(det))
    else:
        root = np.sqrt(det)
    t3 = xp.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2) / (4 * root + eps) + eps) * 0.5
    bd = clip(t1 + t2 + t3, eps, 100.0)
    iou = 1 - xp.sqrt(1.0 - xp.exp(-bd) + eps)
    if not CIoU:
        return iou
    w1, h1 = obb1[..., 2:3], obb1[..., 3:4]
    w2, h2 = obb2[..., 2:3], obb2[..., 3:4]
    atan = torch.atan if is_t else np.arctan
    v = (4 / math.pi**2) * (atan(w2 / h2) - atan(w1 / h1)) ** 2
    alpha = v / (v - iou + (1 + eps))
    return iou - v * (alpha.detach() if is_t else alpha)


def xywhr2xyxyxyxy(x):
    """xywhr → the 4 corners (..., 4, 2): centre ± the rotated half-width vector ± the rotated
    half-height vector. Numpy arrays or torch tensors."""
    is_t = torch.is_tensor(x)
    xp = torch if is_t else np
    x = x if is_t else np.asarray(x)
    cat = (lambda v: torch.cat(v, -1)) if is_t else (lambda v: np.concatenate(v, -1))
    ctr = x[..., :2]
    w, h, angle = x[..., 2:3], x[..., 3:4], x[..., 4:5]
    cos, sin = xp.cos(angle), xp.sin(angle)
    vec1 = cat([w / 2 * cos, w / 2 * sin])
    vec2 = cat([-h / 2 * sin, h / 2 * cos])
    pts = [ctr + vec1 + vec2, ctr + vec1 - vec2, ctr - vec1 - vec2, ctr - vec1 + vec2]
    return torch.stack(pts, -2) if is_t else np.stack(pts, axis=-2)


def xyxyxyxy2xywhr(corners) -> np.ndarray:
    """Corners (n, 8) or (n, 4, 2) → xywhr (n, 5) f32 through cv2's `minAreaRect`, the angle in
    radians in (0, π/2]. cv2 4.5+ reports that angle in (0°, 90°]; other versions report the same
    rectangle as (h, w, angle − 90°) with the angle in (−90°, 0°], which is bridged back."""
    import cv2

    pts = np.asarray(corners, np.float32).reshape(-1, 4, 2)
    out = []
    for p in pts:
        (cx, cy), (w, h), ang = cv2.minAreaRect(p)
        if ang <= 0:
            w, h = h, w
            ang += 90
        out.append([cx, cy, w, h, ang * math.pi / 180])
    return np.array(out, np.float32).reshape(-1, 5)
