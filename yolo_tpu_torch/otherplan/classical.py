"""Classical (model-free) small-target detection (counterpart of yolo_tpu/otherplan/classical.py).

Top-hat (6x6 ellipse) + LoG (σ 1.2) + local contrast (σ 5 background
subtracted) → a 0.5 / 0.3 / 0.2 weighted score → a 98th-percentile threshold
→ contours → geometry filters (area in [1e-6, 2e-4]·HW, circularity ≥ 0.55,
aspect ≥ 0.6). `enhance_small_targets` and `classical_detect` run cv2 on the
host; `enhance_small_targets_torch` is the batched enhancement in plain torch
on the tensor's device (the JAX package's `enhance_small_targets_jax`), whose
result `classical_detect(enhanced=...)` takes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TOPHAT_KSIZE = 6
LOG_GAUSS_SIGMA = 1.2
BG_GAUSS_SIGMA = 5.0
BINARY_PRC = 98
MIN_AREA_RATIO = 1e-6
MAX_AREA_RATIO = 2e-4
MIN_CIRCULARITY = 0.55
ASPECT_TOL = 0.6
LAPLACIAN_3X3 = ((2.0, 0.0, 2.0), (0.0, -8.0, 0.0), (2.0, 0.0, 2.0))  # cv2.Laplacian, ksize=3


def normalize_u8(img: np.ndarray) -> np.ndarray:
    """Linear rescale to uint8 [0, 255] (all zero if constant)."""
    img = img.astype(np.float32)
    mn, mx = float(img.min()), float(img.max())
    if mx - mn < 1e-6:
        return np.zeros_like(img, dtype=np.uint8)
    return ((img - mn) / (mx - mn) * 255.0).clip(0, 255).astype(np.uint8)


def enhance_small_targets(gray: np.ndarray) -> np.ndarray:
    """One uint8 frame → its uint8 score map, with cv2 on the host."""
    import cv2

    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (TOPHAT_KSIZE, TOPHAT_KSIZE))
    toph = cv2.morphologyEx(gray, cv2.MORPH_TOPHAT, k)
    blur = cv2.GaussianBlur(gray, (0, 0), LOG_GAUSS_SIGMA)
    log_ = cv2.Laplacian(blur, cv2.CV_32F, ksize=3)
    log_pos = np.maximum(log_, 0.0)
    bg = cv2.GaussianBlur(gray, (0, 0), BG_GAUSS_SIGMA)
    local_contrast = cv2.subtract(gray, bg)
    score = 0.5 * normalize_u8(toph) + 0.3 * normalize_u8(log_pos) + 0.2 * normalize_u8(local_contrast)
    return normalize_u8(score)


def _gauss_kernel_1d(sigma: float) -> np.ndarray:
    """Normalised f32 Gaussian taps, 2·ceil(3σ) + 1 of them (9 at σ 1.2, 31 at σ 5)."""
    radius = int(math.ceil(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _ellipse() -> np.ndarray:
    import cv2

    return cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (TOPHAT_KSIZE, TOPHAT_KSIZE)).astype(bool)


def enhance_small_targets_torch(gray_batch) -> torch.Tensor:
    """Batched enhancement: (B, H, W) frames (a tensor on any device, or numpy) → (B, H, W)
    f32 scores in [0, 255] on that device. The top-hat is x minus the opening (a masked
    min, then max, over the elliptical element, pads +inf / -inf, offsets kh//2, (kh-1)//2);
    the Gaussians are separable with edge padding; each part is normalised per image."""
    x = torch.as_tensor(gray_batch).to(torch.float32)
    B, H, W = x.shape

    def norm(v):
        mn = v.amin(dim=(-2, -1), keepdim=True)
        mx = v.amax(dim=(-2, -1), keepdim=True)
        return torch.where(mx - mn < 1e-6, torch.zeros_like(v), (v - mn) / (mx - mn + 1e-12) * 255.0)

    se = _ellipse()
    kh, kw = se.shape

    def morpho(v, op):
        fill = -math.inf if op == "max" else math.inf
        vp = F.pad(v, ((kw // 2), (kw - 1) // 2, kh // 2, (kh - 1) // 2), value=fill)
        out = None
        for i in range(kh):
            for j in range(kw):
                if se[i, j]:
                    s = vp[:, i : i + H, j : j + W]
                    out = s if out is None else (torch.maximum(out, s) if op == "max" else torch.minimum(out, s))
        return out

    toph = x - morpho(morpho(x, "min"), "max")

    def edge_pad(v, rh, rw):
        return F.pad(v[:, None], (rw, rw, rh, rh), mode="replicate")[:, 0]

    def sep_gauss(v, sigma):
        k = [float(t) for t in _gauss_kernel_1d(sigma)]
        r = (len(k) - 1) // 2
        vp = edge_pad(v, r, 0)
        v1 = sum(k[i] * vp[:, i : i + H, :] for i in range(len(k)))
        vp = edge_pad(v1, 0, r)
        return sum(k[i] * vp[:, :, i : i + W] for i in range(len(k)))

    blur = sep_gauss(x, LOG_GAUSS_SIGMA)
    bp = edge_pad(blur, 1, 1)
    log_ = sum(LAPLACIAN_3X3[i][j] * bp[:, i : i + H, j : j + W] for i in range(3) for j in range(3))
    log_pos = torch.clamp(log_, min=0.0)
    local_contrast = torch.clamp(x - sep_gauss(x, BG_GAUSS_SIGMA), min=0.0)  # cv2.subtract saturates at 0
    score = 0.5 * norm(toph) + 0.3 * norm(log_pos) + 0.2 * norm(local_contrast)
    return norm(score)


def classical_detect(gray: np.ndarray, frame_shape=None, enhanced: np.ndarray | None = None) -> list:
    """Geometry-filtered candidate boxes [(x1, y1, x2, y2, score), ...], by score, highest first."""
    import cv2

    H, W = (frame_shape or gray.shape)[:2]
    enh = enhanced if enhanced is not None else enhance_small_targets(gray)
    thr_val = np.percentile(enh, BINARY_PRC)
    _, bin_ = cv2.threshold(enh, thr_val, 255, cv2.THRESH_BINARY)
    cnts, _ = cv2.findContours(bin_.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)

    boxes = []
    min_area = int(MIN_AREA_RATIO * W * H)
    max_area = int(MAX_AREA_RATIO * W * H)
    for c in cnts:
        # cv2.contourArea is 0 for 1-px and thin contours, so sub-2 px blobs are
        # rejected although MIN_AREA_RATIO admits them (the JAX package does the same)
        area = cv2.contourArea(c)
        if area < max(1, min_area) or area > max_area:
            continue
        x, y, w, h = cv2.boundingRect(c)
        perim = cv2.arcLength(c, True)
        circularity = 0.0 if perim <= 1e-3 else 4.0 * math.pi * area / (perim * perim)
        if circularity < MIN_CIRCULARITY:
            continue
        aspect = min(w, h) / max(w, h)
        if aspect < ASPECT_TOL:
            continue
        score = float(enh[y : y + h, x : x + w].mean())
        boxes.append((x, y, x + w, y + h, score))
    boxes.sort(key=lambda b: b[4], reverse=True)
    return boxes
