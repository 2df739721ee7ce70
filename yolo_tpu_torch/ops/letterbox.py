"""Letterbox preprocessing: ratio-preserving resize + gray padding (counterpart of yolo_tpu/ops/letterbox.py).

The host path pads with numpy and resizes with cv2, which is imported only
when a resize is needed: a frame that already fits the target (the 640x512 IR
frame into imgsz 640) is pure padding. The device path (`letterbox_device`)
is the same geometry on a torch batch.
"""

from __future__ import annotations

import numpy as np


def letterbox_params(shape, new_shape=(640, 640), auto: bool = False, stride: int = 32, scale_fill=False, scaleup: bool = True, center: bool = True):
    """(ratio, (dw, dh), (new_unpad_w, new_unpad_h)) of a letterbox.

    shape: source (h, w). new_shape: target (h, w) or int."""
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))  # (w, h)
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # pad only to a stride multiple
        dw, dh = dw % stride, dh % stride
    if center:
        dw /= 2
        dh /= 2
    return (r, r), (dw, dh), new_unpad


def _edge_pads(dw: float, dh: float, center: bool = True):
    """(top, bottom, left, right) whole-pixel pads of the half-pads (dw, dh)."""
    top, bottom = int(round(dh - 0.1)) if center else 0, int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)) if center else 0, int(round(dw + 0.1))
    return top, bottom, left, right


class LetterBox:
    """Callable host letterbox: bilinear resize to the fitting size, then a centred 114 pad."""

    def __init__(self, new_shape=(640, 640), auto: bool = False, scale_fill: bool = False, scaleup: bool = True, center: bool = True, stride: int = 32, padding_value: int = 114):
        self.new_shape = (new_shape, new_shape) if isinstance(new_shape, int) else tuple(new_shape)
        self.auto = auto
        self.scale_fill = scale_fill
        self.scaleup = scaleup
        self.center = center
        self.stride = stride
        self.padding_value = padding_value

    def __call__(self, image: np.ndarray, return_meta: bool = False):
        shape = image.shape[:2]
        new_shape = self.new_shape
        if self.scale_fill:
            import cv2

            ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
            img = cv2.resize(image, (new_shape[1], new_shape[0]), interpolation=cv2.INTER_LINEAR)
            return (img, (ratio, (0.0, 0.0))) if return_meta else img

        (r, _), (dw, dh), new_unpad = letterbox_params(
            shape, new_shape, auto=self.auto, stride=self.stride, scaleup=self.scaleup, center=self.center
        )
        img = image
        if shape[::-1] != new_unpad:
            import cv2

            img = cv2.resize(image, new_unpad, interpolation=cv2.INTER_LINEAR)
        if img.ndim == 2:
            img = img[..., None]
        top, bottom, left, right = _edge_pads(dw, dh, self.center)
        img = np.pad(img, ((top, bottom), (left, right), (0, 0)), constant_values=self.padding_value)
        return (img, ((r, r), (dw, dh))) if return_meta else img


def letterbox_device(images, src_shape, dst_shape, padding_value: float = 114.0):
    """Letterbox of an NHWC torch batch from a fixed (h, w) source to an (H, W)
    target: bilinear resize (half-pixel centres; antialiased when it shrinks,
    as `jax.image.resize` does in the JAX package) and a centred pad.
    → (f32 batch, ((r, r), (dw, dh)))."""
    import torch.nn.functional as F

    h, w = src_shape
    H, W = dst_shape
    r = min(H / h, W / w)
    new_w, new_h = round(w * r), round(h * r)
    dw, dh = (W - new_w) / 2, (H - new_h) / 2
    top, bottom, left, right = _edge_pads(dw, dh)
    x = images.float().permute(0, 3, 1, 2)
    if (new_h, new_w) != (h, w):
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False, antialias=True)
    x = F.pad(x, (left, right, top, bottom), value=padding_value)
    return x.permute(0, 2, 3, 1).contiguous(), ((r, r), (dw, dh))
