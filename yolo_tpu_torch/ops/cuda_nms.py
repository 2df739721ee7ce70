"""Greedy NMS keep mask: the wrapper of the CUDA kernel csrc/nms.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_nms.py::pallas_nms_keep (kernel
`_nms_kernel`); see the note at the top of csrc/nms.cu for its design, what
bounds it, and what it does about that.

`nms_keep` launches the kernel for a CUDA tensor and counts the launch in its
`launches` attribute; for a CPU tensor it computes the plain twin
`nms_keep_plain`, which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_tpu_torch.ops import _cuda
from yolo_tpu_torch.ops.boxes import box_iou


def nms_keep_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain twin: boxes (B, K, 4) xyxy sorted by descending score, scores (B, K)
    (padded slots < 0) → keep (B, K) bool. Greedy in score order: a candidate
    that survives suppresses every later one with IoU > threshold."""
    K = boxes.shape[1]
    iou = box_iou(boxes, boxes) > iou_threshold  # (B, K, K)
    later = torch.arange(K, device=boxes.device)
    suppressed = torch.zeros(scores.shape, dtype=torch.bool, device=boxes.device)
    for i in range(K):
        suppressed |= iou[:, i, :] & (later > i) & ~suppressed[:, i : i + 1]
    return ~suppressed & (scores > 0)


@functools.lru_cache(maxsize=None)
def _entry():
    p = ctypes.c_void_p
    return _cuda.function("yt_nms_keep", [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float, p])


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask (B, K) bool for score-sorted candidates (B, K, 4) f32, scores (B, K) f32; K <= 1024."""
    if not boxes.is_cuda:
        return nms_keep_plain(boxes, scores, iou_threshold)
    B, K, _ = boxes.shape
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or scores.shape != (B, K) or not 1 <= K <= 1024:
        raise ValueError(f"nms_keep takes f32 boxes (B, K<=1024, 4) and scores (B, K), got {boxes.shape} {scores.shape}")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    keep = torch.empty((B, K), device=boxes.device, dtype=torch.uint8)
    err = _entry()(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), B, K, float(iou_threshold), _cuda.stream_of(boxes))
    _cuda.check(err, "nms kernel")
    nms_keep.launches += 1
    return keep.bool()


nms_keep.launches = 0
