"""Sliding-window grayscale+gradient scoring (counterpart of yolo_tpu/grayscale/scoring.py).

Numerically identical to the reference's per-window loop (ref:
Grayscale-Tracking/grayscale_tracking_system.py gradient_magnitude_prediction:437
— 5×5 windows over a 40×40 ROI, score = mean(gray) + 0.3·mean(|Sobel∇|), Sobel
computed per-window with REFLECT_101 borders, first-in-scan-order argmax) but
fully vectorized: all windows scored at once. Two backends:

  - numpy (host): sliding_window_view + tensordot, as in the JAX package; the
    grayscale tracker calls this one.
  - torch (`predict_center_torch`, any device, leading batch dimensions): the
    counterpart of the JAX package's jittable `predict_center_jax`, for many
    ROIs at once on the card. It is plain PyTorch, as the JAX one is plain XLA:
    the JAX package has no kernel for it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = SOBEL_X.T


def gradient_window_scores(roi: np.ndarray, win: int = 5, grad_weight: float = 0.3) -> np.ndarray:
    """Score every valid win×win window of `roi` → (H-win+1, W-win+1) map."""
    roi = roi.astype(np.float32)
    H, W = roi.shape
    if H < win or W < win:
        return np.zeros((max(H - win + 1, 0), max(W - win + 1, 0)), np.float32)
    windows = np.lib.stride_tricks.sliding_window_view(roi, (win, win))  # (h, w, win, win)
    mean_gray = windows.mean(axis=(-2, -1))

    # per-window Sobel with REFLECT_101 border (cv2 default): pad each window by 1
    flat = windows.reshape(-1, win, win)
    padded = np.pad(flat, ((0, 0), (1, 1), (1, 1)), mode="reflect")
    neigh = np.lib.stride_tricks.sliding_window_view(padded, (3, 3), axis=(1, 2))  # (n, win, win, 3, 3)
    gx = np.tensordot(neigh, SOBEL_X, axes=([3, 4], [0, 1]))
    gy = np.tensordot(neigh, SOBEL_Y, axes=([3, 4], [0, 1]))
    grad_mean = np.sqrt(gx**2 + gy**2).mean(axis=(-2, -1)).reshape(mean_gray.shape)
    return mean_gray + grad_weight * grad_mean


def predict_center(gray_frame: np.ndarray, last_center, roi_size: int = 40, win: int = 5):
    """Reference-parity center prediction → ((x, y), normalized_score)."""
    last_x, last_y = int(last_center[0]), int(last_center[1])
    h, w = gray_frame.shape[:2]
    half = roi_size // 2
    x1, y1 = max(0, last_x - half), max(0, last_y - half)
    x2, y2 = min(w, last_x + half), min(h, last_y + half)
    roi = gray_frame[y1:y2, x1:x2]
    if roi.size == 0:
        return (last_x, last_y), 0.0
    scores = gradient_window_scores(roi, win)
    if scores.size == 0:
        return (last_x, last_y), 0.0
    iy, ix = np.unravel_index(int(np.argmax(scores)), scores.shape)
    # window top-left (iy, ix) → center offset half-window (reference indexes centers)
    hw = win // 2
    gx, gy = x1 + ix + hw, y1 + iy + hw
    return (int(gx), int(gy)), float(min(1.0, scores[iy, ix] / 255.0))


def predict_center_torch(gray_roi, win: int = 5, grad_weight: float = 0.3):
    """Window scorer over fixed-size ROIs (..., H, W) → (best_idx_yx (..., 2), best_score (...)).

    Same math as the numpy path: the windows by `unfold`, each padded by one
    pixel with REFLECT_101 (`F.pad(mode="reflect")`, as `np.pad(mode="reflect")`),
    Sobel x and y as sums of the nine shifted neighbourhoods (exact f32 products,
    no convolution algorithm or TF32 involved), the first maximum in scan order.
    Runs on the device of its input; a numpy array stays on the CPU.
    """
    roi = torch.as_tensor(gray_roi).to(torch.float32)
    *lead, H, W = roi.shape
    h_out, w_out = H - win + 1, W - win + 1
    windows = roi.unfold(-2, win, 1).unfold(-2, win, 1)  # (..., h_out, w_out, win, win)
    mean_gray = windows.mean(dim=(-2, -1))

    pad = F.pad(windows.reshape(-1, win, win), (1, 1, 1, 1), mode="reflect")  # (n, win + 2, win + 2)
    gx = torch.zeros((pad.shape[0], win, win), dtype=torch.float32, device=roi.device)
    gy = torch.zeros_like(gx)
    for dy in range(3):
        for dx in range(3):
            neigh = pad[:, dy : dy + win, dx : dx + win]
            if SOBEL_X[dy, dx]:
                gx = gx + float(SOBEL_X[dy, dx]) * neigh
            if SOBEL_Y[dy, dx]:
                gy = gy + float(SOBEL_Y[dy, dx]) * neigh
    grad_mean = torch.sqrt(gx**2 + gy**2).mean(dim=(-2, -1)).reshape(mean_gray.shape)

    scores = (mean_gray + grad_weight * grad_mean).reshape(*lead, h_out * w_out)
    flat_idx = torch.argmax(scores, dim=-1)  # the first maximum
    best = torch.stack([flat_idx // w_out, flat_idx % w_out], dim=-1)
    return best, torch.gather(scores, -1, flat_idx[..., None])[..., 0]


def grayscale_similarity_search(gray_frame: np.ndarray, template: np.ndarray | None, last_center,
                                search_radius: int = 50, stride: int = 2):
    """Stride-2 NCC grid search around last_center (ref :644-714), vectorized.

    Replicates the reference's manual loop exactly, including its quirks:

    - candidates on a stride-2 grid ``dy, dx ∈ range(-r, r+1, 2)`` (ref :677-678);
    - a candidate is only scored if fully in-bounds by the ``±size//2``
      predicate (ref :683-685);
    - the candidate ROI comes from ``extract_roi`` (ref :354-379) whose span is
      ``[c-size//2, c+size//2)`` = ``2*(size//2)`` pixels, so an ODD template
      (e.g. the 25×25 default capture size) never shape-matches and the search
      degenerates to ``(last_center, -1.0)`` — only even template sides are
      live in the reference, and we keep that contract;
    - normalized cross-correlation, candidates with zero denominator skipped,
      strictly-greater comparison → first-in-scan-order wins ties (ref :687-711).

    Returns ``((x, y), score)`` with score −1.0 when nothing scored (the
    reference's initial best), 0.0 when no template is set (ref :656-657).
    """
    lx, ly = int(last_center[0]), int(last_center[1])
    if template is None:
        return (lx, ly), 0.0
    ts = int(template.shape[0])
    half = ts // 2
    roi_side = 2 * half
    if roi_side != ts:  # odd template: every ROI is (2*half)² ≠ ts² → all skipped
        return (lx, ly), -1.0
    h, w = gray_frame.shape[:2]

    offs = np.arange(-search_radius, search_radius + 1, stride)
    cys = ly + offs
    cxs = lx + offs
    ok_y = (cys - half >= 0) & (cys + half < h)
    ok_x = (cxs - half >= 0) & (cxs + half < w)
    if not (ok_y.any() and ok_x.any()):
        return (lx, ly), -1.0
    cys, cxs = cys[ok_y], cxs[ok_x]

    windows = np.lib.stride_tricks.sliding_window_view(
        gray_frame.astype(np.float32, copy=False), (roi_side, roi_side)
    )
    cand = windows[np.ix_(cys - half, cxs - half)]  # (ny, nx, s, s)
    cand = cand - cand.mean(axis=(-2, -1), keepdims=True)
    tmpl = template.astype(np.float32) - template.astype(np.float32).mean()
    num = np.einsum("yxab,ab->yx", cand, tmpl)
    den = np.sqrt(np.einsum("yxab,yxab->yx", cand, cand) * (tmpl * tmpl).sum())
    scores = np.where(den > 0, num / np.where(den > 0, den, 1.0), -np.inf)
    if not np.isfinite(scores).any():
        return (lx, ly), -1.0
    iy, ix = np.unravel_index(int(np.argmax(scores)), scores.shape)  # first max = scan order
    return (int(cxs[ix]), int(cys[iy])), float(scores[iy, ix])


def template_match(gray_frame: np.ndarray, template: np.ndarray, last_center, search_radius: int = 50):
    """TM_CCOEFF_NORMED template matching near last_center (ref :381-435)."""
    import cv2

    h, w = gray_frame.shape[:2]
    th, tw = template.shape[:2]
    x1 = max(0, int(last_center[0]) - search_radius)
    y1 = max(0, int(last_center[1]) - search_radius)
    x2 = min(w, int(last_center[0]) + search_radius)
    y2 = min(h, int(last_center[1]) + search_radius)
    region = gray_frame[y1:y2, x1:x2]
    if region.shape[0] < th or region.shape[1] < tw:
        return (int(last_center[0]), int(last_center[1])), 0.0
    res = cv2.matchTemplate(region.astype(np.float32), template.astype(np.float32), cv2.TM_CCOEFF_NORMED)
    _, max_val, _, max_loc = cv2.minMaxLoc(res)
    cx = x1 + max_loc[0] + tw // 2
    cy = y1 + max_loc[1] + th // 2
    return (int(cx), int(cy)), float(max_val)
