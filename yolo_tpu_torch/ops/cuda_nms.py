"""Greedy NMS keep mask: the wrapper of the CUDA kernel csrc/nms.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_nms.py::pallas_nms_keep (kernel
`_nms_kernel`); see the note at the top of csrc/nms.cu for its design, what
bounds it, and what it does about that.

`nms_keep` runs the kernel for a CUDA tensor, in one launch or two as `plan`
says, and counts the call in its `launches` attribute; for a CPU tensor it
computes the plain twin `nms_keep_plain`, which is also what the kernel is held
against on the card.
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


# Shapes (B, K) the card run holds the kernel against its twin at: one image and a chunk, at
# one slot, a word and one slot over, the main path's 64, the predict facade's 1024, the
# d_max = 300 pipeline's 1200 (one launch, 202 KB of shared memory), the last K
# of one launch and the first of two, and 4096
NMS_EDGES = [(B, K) for B in (1, 128) for K in (1, 33, 64, 1024, 1200, 4096)] + [(1, 1280), (1, 1281)]


def edge_candidates(B: int, K: int, seed: int = 0, device="cpu"):
    """Seeded score-sorted candidates (B, K, 4) xyxy and scores (B, K) f32 for the
    edge shapes: boxes of 4-60 px crowded into a 640 px frame so that many
    overlap, every 5th box a duplicate of the one before, scores rounded to
    two digits (ties), the last quarter of the slots padding (score -1) and
    one image in four padding only."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 640, (B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (B, K, 2))], -1).astype(np.float32)
    boxes[:, 1::5] = boxes[:, 0::5][:, : boxes[:, 1::5].shape[1]]
    scores = -np.sort(-np.round(rng.uniform(0.01, 1.0, (B, K)), 2), 1).astype(np.float32)
    scores[:, K - K // 4 :] = -1.0
    scores[3::4] = -1.0
    return torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device)


@functools.lru_cache(maxsize=None)
def plan(B: int, K: int) -> dict:
    """How the kernel runs B images of K candidate slots on the current card, as
    csrc/nms.cu::plan_for decides it (read through its C entry yt_nms_plan).

    One launch (`yt_nms_keep`, a block of 1024 threads per image) while an
    image's boxes, areas and mask fit a block's shared memory (K <= 1280).
    Otherwise two (`yt_nms_keep_split`): each image's mask rows spread over
    `row_blocks` blocks, about eight blocks per SM in all, into a scratch of
    `scratch_words` 32-bit words in device memory, then a scan kernel of four
    images per block."""
    out = (ctypes.c_longlong * 5)()
    _cuda.check(_entry("yt_nms_plan")(B, K, out), "nms plan")
    launches, blocks, smem, row_blocks, scratch_words = out
    return dict(form="one launch" if launches == 1 else "two launches", launches=launches, blocks=blocks, smem=smem,
                row_blocks=row_blocks, scratch_words=scratch_words)


def plan_text(B: int, K: int) -> str:
    p = plan(B, K)
    text = f"{p['form']}: blocks={p['blocks']} smem={p['smem']}B"
    if p["launches"] == 1:
        return text
    return text + f" row_blocks={p['row_blocks']} scratch={4 * p['scratch_words']}B"


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _cuda.function(name, {
        "yt_nms_plan": [i, i, ctypes.POINTER(ctypes.c_longlong)],
        "yt_nms_keep": [p, p, p, i, i, f, p],
        "yt_nms_keep_split": [p, p, p, p, i, i, f, p],
    }[name])


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask (B, K) bool for score-sorted candidates (B, K, 4) f32, scores (B, K) f32; any K >= 1."""
    if not boxes.is_cuda:
        return nms_keep_plain(boxes, scores, iou_threshold)
    if boxes.dim() != 3 or boxes.shape[2] != 4 or boxes.shape[1] < 1 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_keep takes boxes (B, K>=1, 4) and scores (B, K), got {tuple(boxes.shape)} {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or scores.device != boxes.device:
        raise ValueError(f"nms_keep takes f32 boxes and scores on one card, got {boxes.dtype} on {boxes.device}, "
                         f"{scores.dtype} on {scores.device}")
    B, K, _ = boxes.shape
    boxes, scores = boxes.contiguous(), scores.contiguous()
    keep = torch.empty((B, K), device=boxes.device, dtype=torch.bool)
    p = plan(B, K)
    thr, stream = float(iou_threshold), _cuda.stream_of(boxes)
    if p["launches"] == 1:
        err = _entry("yt_nms_keep")(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), B, K, thr, stream)
    else:
        mask = torch.empty(p["scratch_words"], device=boxes.device, dtype=torch.int32)
        err = _entry("yt_nms_keep_split")(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), mask.data_ptr(), B, K,
                                          thr, stream)
    _cuda.check(err, "nms kernel")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
