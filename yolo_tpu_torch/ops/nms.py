"""Fixed-shape non-max suppression (counterpart of yolo_tpu/ops/nms.py).

1. score filter → the top-K candidates by a stable descending sort (the
   earliest anchor wins among equal scores, as `jax.lax.top_k` does), padded
   slots scoring -1;
2. greedy suppression over the K candidates (strict IoU >): the keep mask of
   the CUDA kernel (ops/cuda_nms.py), then the select step of the JAX
   package's Pallas route, a stable sort of the kept scores;
3. the top max_det kept → fixed (B, max_det) boxes, scores, cls, valid.

`plain=True` replaces step 2 by `nms_fixed`, the JAX package's default
select-max route, the reference the kernel route is held against.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from yolo_tpu_torch.ops.cuda_nms import nms_keep

MAX_WH = 7680.0  # class offset for class-aware NMS in one pass


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_det: int):
    """Exact greedy NMS by iterative select-max, batched: boxes (B, K, 4) xyxy,
    scores (B, K) (padded < 0) → (keep_idx (B, max_det), keep_valid (B, max_det))."""
    B, K, _ = boxes.shape
    col = torch.arange(K, device=boxes.device)
    rows = torch.arange(B, device=boxes.device)
    suppressed = torch.zeros((B, K), dtype=torch.bool, device=boxes.device)
    idx, valid = [], []
    for _ in range(max_det):
        ms = torch.where(suppressed, -1.0, scores)
        j = torch.argmax(ms, 1)  # first maximal index
        v = ms[rows, j] > 0
        row = box_iou(boxes[rows, j][:, None], boxes)[:, 0] > iou_threshold
        suppressed = suppressed | (row & v[:, None]) | (col[None] == j[:, None])
        idx.append(j)
        valid.append(v)
    return torch.stack(idx, 1), torch.stack(valid, 1)


def non_max_suppression_parts(
    boxes_xywh: torch.Tensor,
    cls_scores: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 1024,
    plain: bool = False,
) -> dict:
    """Fixed-shape NMS over anchors-major decode parts: boxes (B, A, 4) xywh, scores (B, A, nc).

    Returns boxes (B, max_det, 4) xyxy | scores (B, max_det) | cls (B, max_det) | valid (B, max_det)."""
    K = min(max_nms, boxes_xywh.shape[1])
    conf, cls_id = cls_scores.max(-1)
    conf = torch.where(conf > conf_thres, conf, -1.0)
    top_conf, top_idx = torch.sort(conf, dim=1, descending=True, stable=True)
    top_conf, top_idx = top_conf[:, :K], top_idx[:, :K]
    b = xywh2xyxy(torch.gather(boxes_xywh, 1, top_idx[..., None].expand(-1, -1, 4)))
    c = torch.gather(cls_id, 1, top_idx)
    offset = c.to(b.dtype) * MAX_WH
    return _suppress_tail(b, c, top_conf, offset, iou_thres, max_det, plain)


def _suppress_tail(b, c, top_conf, offset, iou_thres, max_det, plain):
    """IoU suppression over the per-frame top-K candidates → the fixed outputs."""
    shifted = b + offset[..., None]
    if plain:
        sel, keep_valid = nms_fixed(shifted, top_conf, iou_thres, max_det)
    else:
        keep = nms_keep(shifted, top_conf, iou_thres)
        ranked = torch.where(keep, top_conf, -1.0)
        sel = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :max_det]
        keep_valid = torch.gather(ranked, 1, sel) > 0
    if sel.shape[1] < max_det:  # fewer candidates than output slots
        pad = max_det - sel.shape[1]
        sel = torch.cat([sel, sel.new_zeros((sel.shape[0], pad))], 1)
        keep_valid = torch.cat([keep_valid, keep_valid.new_zeros((sel.shape[0], pad))], 1)
    boxes = torch.gather(b, 1, sel[..., None].expand(-1, -1, 4))
    return {
        "boxes": torch.where(keep_valid[..., None], boxes, 0.0),
        "scores": torch.where(keep_valid, torch.gather(top_conf, 1, sel), 0.0),
        "cls": torch.where(keep_valid, torch.gather(c, 1, sel), -1),
        "valid": keep_valid,
    }
