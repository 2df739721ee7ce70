"""Plain PyTorch conv helpers shared by the modules and the kernels' plain twins."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the logistic taken in f32 and rounded to x's dtype
    (the TPU kernels' SiLU, yolo_tpu/ops/pallas_c2f.py:_silu)."""
    return x * torch.sigmoid(x.float()).to(x.dtype)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """Conv of an NHWC map with an OIHW weight through an NCHW view (channels_last
    memory, so no transpose is materialised); returns a contiguous NHWC map."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride, padding, 1, groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_hwio(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, act: bool = True) -> torch.Tensor:
    """Stride-1 'same' conv with a flat HWIO weight (k*k*cin, cout) as the
    kernels take it: f32 sum rounded to x's dtype, bias added in that dtype,
    then SiLU."""
    cout = w.shape[-1]
    wo = w.reshape(k, k, -1, cout).permute(3, 2, 0, 1)
    y = conv_nhwc(x, wo, 1, k // 2) + b.to(x.dtype)
    return silu(y) if act else y
