"""Box-format conversions and pairwise IoU (counterpart of yolo_tpu/ops/boxes.py)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (x1, y1, x2, y2) over the last axis."""
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    return torch.stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], dim=-1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) xyxy boxes → (..., N, M)."""
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)
