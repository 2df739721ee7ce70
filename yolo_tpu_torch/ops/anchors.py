"""Anchor grids and the distance→box transform (counterpart of yolo_tpu/ops/anchors.py)."""

from __future__ import annotations

import torch


def make_anchors(feat_shapes, strides, grid_cell_offset: float = 0.5, device=None):
    """Anchor centres and per-anchor strides for a list of (h, w) feature shapes.

    Returns anchor_points (A, 2) as (x, y) cell centres in grid units and
    stride_tensor (A, 1); x varies fastest within a level, levels in input order.
    """
    anchor_points, stride_tensor = [], []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = torch.arange(w, device=device, dtype=torch.float32) + grid_cell_offset
        sy = torch.arange(h, device=device, dtype=torch.float32) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack((gx, gy), -1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), float(stride), device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True, dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances from anchor points → xywh (or xyxy) boxes."""
    lt, rb = distance.chunk(2, dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim)
    return torch.cat([x1y1, x2y2], dim)
