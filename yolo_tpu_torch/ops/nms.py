"""Fixed-shape non-max suppression (counterpart of yolo_tpu/ops/nms.py).

1. score filter → the top-K candidates by a stable descending sort (the
   earliest anchor wins among equal scores, as `jax.lax.top_k` does), padded
   slots scoring -1;
2. greedy suppression over the K candidates (strict IoU >): the keep mask of
   the CUDA kernel (ops/cuda_nms.py), then the select step of the JAX
   package's Pallas route, a stable sort of the kept scores;
3. the top max_det kept → fixed (B, max_det) boxes, scores, cls, valid, and
   `extra` (B, max_det, E) where extra columns ride along (the segment task's
   mask coefficients), gathered with the same indices, zero where not valid.

`plain=True` replaces step 2 by `nms_fixed`, the JAX package's default
select-max route, the reference the kernel route is held against.

The obb task's `non_max_suppression_rotated` is plain torch on every device, as
the JAX package's is plain XLA: its suppression is not greedy (a candidate goes
when its probiou with any higher-scored candidate, kept or not, reaches the
threshold), so the greedy keep-mask kernel does not serve it.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops.boxes import box_iou, probiou, xywh2xyxy
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


def non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    classes=None,
    agnostic: bool = False,
    max_det: int = 300,
    nc: int = 0,
    max_nms: int = 1024,
    plain: bool = False,
) -> dict:
    """Fixed-shape NMS over decoded predictions (B, 4 + nc + E, A): xywh boxes, per-class
    scores, then E extra rows (the layout of `DetectionModel.predict`, and with the mask
    coefficients of `SegmentationModel.predict`). The rows beyond 4 + nc are extras only when
    `nc` is given (else every row after the boxes is a class). Same outputs as
    `non_max_suppression_parts`, with out["extra"] (B, max_det, E) when E > 0."""
    nc = nc or (prediction.shape[1] - 4)
    extra = prediction[:, 4 + nc :].transpose(1, 2) if prediction.shape[1] > 4 + nc else None
    return non_max_suppression_parts(
        prediction[:, :4].transpose(1, 2), prediction[:, 4 : 4 + nc].transpose(1, 2), conf_thres=conf_thres,
        iou_thres=iou_thres, classes=classes, agnostic=agnostic, max_det=max_det, max_nms=max_nms, plain=plain, extra=extra,
    )


def non_max_suppression_parts(
    boxes_xywh: torch.Tensor,
    cls_scores: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    classes=None,
    agnostic: bool = False,
    max_det: int = 300,
    max_nms: int = 1024,
    plain: bool = False,
    extra: torch.Tensor | None = None,
) -> dict:
    """Fixed-shape NMS over anchors-major decode parts: boxes (B, A, 4) xywh, scores (B, A, nc),
    and optional `extra` columns (B, A, E) that ride with their anchors.

    `classes` keeps only those class ids (the others score 0); `agnostic`
    suppresses across classes (no per-class box offset).
    Returns boxes (B, max_det, 4) xyxy | scores (B, max_det) | cls (B, max_det) | valid (B, max_det),
    and extra (B, max_det, E) (zero where not valid) when `extra` has columns."""
    K = min(max_nms, boxes_xywh.shape[1])
    if classes is not None:
        cls_scores = _keep_classes(cls_scores, classes)
    conf, cls_id = cls_scores.max(-1)
    conf = torch.where(conf > conf_thres, conf, -1.0)
    top_conf, top_idx = torch.sort(conf, dim=1, descending=True, stable=True)
    top_conf, top_idx = top_conf[:, :K], top_idx[:, :K]
    b = xywh2xyxy(torch.gather(boxes_xywh, 1, top_idx[..., None].expand(-1, -1, 4)))
    c = torch.gather(cls_id, 1, top_idx)
    offset = torch.zeros_like(top_conf) if agnostic else c.to(b.dtype) * MAX_WH
    if extra is not None and extra.shape[-1]:
        extra = torch.gather(extra, 1, top_idx[..., None].expand(-1, -1, extra.shape[-1]))
    else:
        extra = None
    return _suppress_tail(b, c, top_conf, offset, iou_thres, max_det, plain, extra)


def _keep_classes(cls_scores: torch.Tensor, classes) -> torch.Tensor:
    """Scores (..., nc) with every class but `classes` zeroed: ids in [-nc, nc) count, negative ones from the
    end; the others select nothing (as JAX's scatter drops them)."""
    nc = cls_scores.shape[-1]
    ids = [c % nc for c in map(int, classes) if -nc <= c < nc]
    allowed = torch.zeros(nc, dtype=torch.bool, device=cls_scores.device)
    allowed[torch.as_tensor(ids, dtype=torch.long, device=cls_scores.device)] = True
    return torch.where(allowed, cls_scores, 0.0)


def _pad_slots(sel: torch.Tensor, valid: torch.Tensor, max_det: int):
    """The selected slots (B, n) and their validity padded to max_det with invalid slot 0 where n < max_det
    (fewer candidates than output slots)."""
    pad = max_det - sel.shape[1]
    if pad <= 0:
        return sel, valid
    return torch.cat([sel, sel.new_zeros((sel.shape[0], pad))], 1), torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], 1)


def _suppress_tail(b, c, top_conf, offset, iou_thres, max_det, plain, extra=None):
    """IoU suppression over the per-frame top-K candidates → the fixed outputs (the extra columns
    of the candidates, (B, K, E), gathered with the kept boxes)."""
    shifted = b + offset[..., None]
    if plain:
        sel, keep_valid = nms_fixed(shifted, top_conf, iou_thres, max_det)
    else:
        keep = nms_keep(shifted, top_conf, iou_thres)
        ranked = torch.where(keep, top_conf, -1.0)
        sel = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :max_det]
        keep_valid = torch.gather(ranked, 1, sel) > 0
    sel, keep_valid = _pad_slots(sel, keep_valid, max_det)
    boxes = torch.gather(b, 1, sel[..., None].expand(-1, -1, 4))
    out = {
        "boxes": torch.where(keep_valid[..., None], boxes, 0.0),
        "scores": torch.where(keep_valid, torch.gather(top_conf, 1, sel), 0.0),
        "cls": torch.where(keep_valid, torch.gather(c, 1, sel), -1),
        "valid": keep_valid,
    }
    if extra is not None:
        ex = torch.gather(extra, 1, sel[..., None].expand(-1, -1, extra.shape[-1]))
        out["extra"] = torch.where(keep_valid[..., None], ex, 0.0)
    return out


ROTATED_CHUNK = 1 << 25  # probiou entries built at once: (B, K, K) is taken in chunks of images under this


def nms_rotated_fixed(rboxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_det: int):
    """Rotated suppression over candidates sorted by descending score (stable), batched: rboxes (B, K, 5)
    xywhr, scores (B, K) (padded ≤ 0) → (keep_idx (B, min(K, max_det)), keep_valid). A candidate goes when
    its probiou with any earlier candidate, kept or not, is ≥ the threshold (JAX `nms_rotated_fixed`); the
    kept ones are ranked by a stable sort of their scores."""
    B, K, _ = rboxes.shape
    upper = torch.ones((K, K), dtype=torch.bool, device=rboxes.device).triu(1)
    per = max(1, ROTATED_CHUNK // max(K * K, 1))
    suppressed = []
    for i in range(0, B, per):
        b = rboxes[i : i + per]
        iou = probiou(b[:, :, None, :], b[:, None, :, :])[..., 0]
        suppressed.append(((iou >= iou_threshold) & upper).any(1))
    keep = ~torch.cat(suppressed) & (scores > 0)
    ranked = torch.where(keep, scores, -1.0)
    sel = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :max_det]
    return sel, torch.gather(ranked, 1, sel) > 0


def non_max_suppression_rotated(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    classes=None,
    agnostic: bool = False,
    max_det: int = 300,
    nc: int = 0,
    max_nms: int = 1024,
) -> dict:
    """Fixed-shape rotated NMS over decoded obb predictions (B, 4 + nc + 1, A): xywh, the per-class scores,
    the angle (the layout of `OBBModel.predict`; JAX `non_max_suppression_rotated`).

    The conf is the best class's score where it is > conf_thres, else −1; the top K = min(max_nms, A) by a
    stable sort; `classes` keeps only those ids (in [−nc, nc), negative ones from the end); unless `agnostic`,
    each candidate's centre moves by its class id · MAX_WH before the probiou. Returns boxes (B, max_det, 5)
    xywhr | scores | cls | valid, zero (cls −1) where not valid."""
    nc = nc or (prediction.shape[1] - 5)
    boxes = prediction[:, :4].transpose(1, 2)
    cls_scores = prediction[:, 4 : 4 + nc].transpose(1, 2)
    angle = prediction[:, 4 + nc : 5 + nc].transpose(1, 2)
    K = min(max_nms, prediction.shape[2])
    if classes is not None:
        cls_scores = _keep_classes(cls_scores, classes)
    conf, cls_id = cls_scores.max(-1)
    conf = torch.where(conf > conf_thres, conf, -1.0)
    top_conf, top_idx = torch.sort(conf, dim=1, descending=True, stable=True)
    top_conf, top_idx = top_conf[:, :K], top_idx[:, :K]
    rb = torch.gather(torch.cat([boxes, angle], -1), 1, top_idx[..., None].expand(-1, -1, 5))
    c = torch.gather(cls_id, 1, top_idx)
    off = torch.zeros_like(top_conf) if agnostic else c.to(rb.dtype) * MAX_WH
    shifted = torch.cat([rb[..., :2] + off[..., None], rb[..., 2:]], -1)
    sel, valid = _pad_slots(*nms_rotated_fixed(shifted, top_conf, iou_thres, max_det), max_det)
    return {
        "boxes": torch.where(valid[..., None], torch.gather(rb, 1, sel[..., None].expand(-1, -1, 5)), 0.0),
        "scores": torch.where(valid, torch.gather(top_conf, 1, sel), 0.0),
        "cls": torch.where(valid, torch.gather(c, 1, sel), -1),
        "valid": valid,
    }
