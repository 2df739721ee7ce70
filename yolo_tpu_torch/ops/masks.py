"""Instance masks from prototypes and coefficients (counterpart of yolo_tpu/ops/masks.py).

masks = sigmoid(coefs @ protos), the product in f32, cropped to the detection boxes;
the predictor keeps them at prototype resolution on the device and upsamples only the
valid ones on the host (`scale_masks_np` undoes the letterbox with cv2).
"""

from __future__ import annotations

import numpy as np
import torch


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each box (JAX `crop_mask_np`, on tensors of any leading shape): masks
    (..., H, W), boxes (..., 4) xyxy in mask pixels; a pixel (x, y) stays when x1 <= x < x2 and y1 <= y < y2."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :]
    b = boxes[..., None, None, :]
    keep = (xs >= b[..., 0]) & (xs < b[..., 2]) & (ys >= b[..., 1]) & (ys < b[..., 3])
    return masks * keep


def process_mask(protos: torch.Tensor, coefs: torch.Tensor, boxes: torch.Tensor, img_hw, upsample: bool = True) -> torch.Tensor:
    """Per-detection masks: protos (..., h, w, nm), coefs (..., N, nm), boxes (..., N, 4) xyxy in input
    pixels, the leading axes (one image, or a batch) alike → (..., N, h, w) probabilities in [0, 1]
    cropped to the boxes at prototype scale h / H; `upsample=True` first resizes them to `img_hw` (the
    weights of JAX's bilinear `jax.image.resize`, `nn.tasks._resize_weights`) and crops at input scale."""
    from yolo_tpu_torch.nn.tasks import _resize_weights

    h, w, nm = protos.shape[-3:]
    H, W = img_hw
    flat = protos.reshape(*protos.shape[:-3], h * w, nm).transpose(-1, -2).float()
    m = torch.sigmoid(coefs.float() @ flat).reshape(*coefs.shape[:-1], h, w)
    scale = 1.0
    if upsample:
        wh, ww = _resize_weights(h, H).to(m.device), _resize_weights(w, W).to(m.device)
        m = torch.einsum("...hw,hH,wW->...HW", m, wh, ww)
    else:
        scale = h / H
    return crop_mask(m, boxes.float() * scale)


def scale_masks_np(masks: np.ndarray, orig_hw, letterbox_hw, ratio_pad=None) -> np.ndarray:
    """Undo the letterbox on (N, H, W) masks → (N, h0, w0): the pad stripped (rounded as JAX rounds
    it), each mask resized with cv2 INTER_LINEAR. `ratio_pad` ((gain, _), (pad_w, pad_h)) overrides
    the gain and pad computed from the two sizes."""
    import cv2

    if masks.size == 0:
        return masks.reshape(0, *orig_hw)
    H, W = letterbox_hw
    h0, w0 = orig_hw
    if ratio_pad is None:
        gain = min(H / h0, W / w0)
        pad_w, pad_h = (W - w0 * gain) / 2, (H - h0 * gain) / 2
    else:
        pad_w, pad_h = ratio_pad[1]
    top, left = int(round(pad_h - 0.1)), int(round(pad_w - 0.1))
    bottom, right = int(round(H - pad_h + 0.1)), int(round(W - pad_w + 0.1))
    out = np.empty((masks.shape[0], h0, w0), masks.dtype)
    for i, m in enumerate(masks):
        out[i] = cv2.resize(m[top:bottom, left:right], (w0, h0), interpolation=cv2.INTER_LINEAR)
    return out
