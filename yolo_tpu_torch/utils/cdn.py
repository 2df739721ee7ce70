"""Contrastive denoising (cdn) groups for RT-DETR training (counterpart of yolo_tpu/utils/cdn.py).

The denoising queries are keyed on the loader's fixed label capacity N (the collate pads to it), so every step
has the same layout: [positive copy 0 | ... | positive copy G-1 | negative copy 0 | ... | negative copy G-1], each
block N slots, slot j of a block backed by label slot j; padded slots carry zero embeddings and zero box logits.
The noise is drawn on the host with numpy from an explicit `numpy.random.Generator` (the trainer seeds it from its
seed; the JAX trainer draws from an unseeded one) and enters the step as plain arrays; the class embedding is looked
up in the forward, so the embedding table trains.
"""

from __future__ import annotations

import numpy as np


def _xywh2xyxy(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    out[..., :2] = b[..., :2] - b[..., 2:] / 2
    out[..., 2:] = b[..., :2] + b[..., 2:] / 2
    return out


def _xyxy2xywh(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    out[..., :2] = (b[..., :2] + b[..., 2:]) / 2
    out[..., 2:] = b[..., 2:] - b[..., :2]
    return out


def cdn_attn_mask(num_group: int, n: int, num_queries: int) -> np.ndarray:
    """The (tgt, tgt) bool attention mask, True blocked, with the reference's semantics (JAX `cdn_attn_mask`): the
    matching queries see no denoising query, and the denoising blocks, taken as consecutive pairs of N-slot copies,
    see no other pair (for G > 1 a pair holds two positive copies, the reference's layout, kept as it is)."""
    num_dn = 2 * num_group * n
    tgt = num_dn + num_queries
    m = np.zeros((tgt, tgt), bool)
    m[num_dn:, :num_dn] = True
    for i in range(num_group):
        rows = slice(n * 2 * i, n * 2 * (i + 1))
        if i == 0:
            m[rows, n * 2 * (i + 1) : num_dn] = True
        if i == num_group - 1:
            m[rows, : n * i * 2] = True
        else:
            m[rows, n * 2 * (i + 1) : num_dn] = True
            m[rows, : n * 2 * i] = True
    return m


def make_cdn_batch(batch: dict, num_classes: int, rng: np.random.Generator, num_dn: int = 100,
                   cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0) -> dict:
    """The denoising entries of a batch ({'cls' (B, N), 'bboxes' (B, N, 4) normalized xywh, 'mask_gt' (B, N)}), with
    JAX's `make_cdn_batch` noise drawn from `rng` in JAX's order → dn_cls (B, 2G·N) int32 (a label's class, flipped
    to a random class with probability cls_noise_ratio / 2), dn_bbox (B, 2G·N, 4) f32 (each box's corners moved by up
    to box_noise_scale · half its size: the positive copies within, the negative ones between one and two times that;
    clipped to [0, 1], then in logit space with torch.logit's eps 1e-6; 0 in padded slots), dn_valid (B, 2G·N) f32,
    and dn_num_group G = max(num_dn // N, 1)."""
    cls = np.asarray(batch["cls"])
    boxes = np.asarray(batch["bboxes"], np.float32)
    valid = np.asarray(batch["mask_gt"], np.float32)
    B, N = cls.shape[:2]
    cls = cls.reshape(B, N)
    G = max(num_dn // N, 1)
    dn_cls = np.tile(cls.astype(np.int64), (1, 2 * G))
    dn_box = np.tile(boxes, (1, 2 * G, 1))
    dn_valid = np.tile(valid, (1, 2 * G))
    if cls_noise_ratio > 0:
        flip = (rng.random(dn_cls.shape) < cls_noise_ratio * 0.5) & (dn_valid > 0)
        dn_cls = np.where(flip, rng.integers(0, num_classes, dn_cls.shape), dn_cls)
    if box_noise_scale > 0:
        known = _xywh2xyxy(dn_box)
        diff = np.tile(dn_box[..., 2:] * 0.5, (1, 1, 2)) * box_noise_scale
        sign = rng.integers(0, 2, dn_box.shape) * 2.0 - 1.0
        part = rng.random(dn_box.shape)
        part[:, G * N :] += 1.0  # the negative copies, pushed outside
        known = np.clip(known + sign * part * diff, 0.0, 1.0)
        p = np.clip(_xyxy2xywh(known), 1e-6, 1 - 1e-6)
        dn_box = np.log(p / (1 - p))
    dn_box = dn_box * dn_valid[..., None]
    return {"dn_cls": dn_cls.astype(np.int32), "dn_bbox": dn_box.astype(np.float32),
            "dn_valid": dn_valid.astype(np.float32), "dn_num_group": G}
