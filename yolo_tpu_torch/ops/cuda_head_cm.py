"""Channel-major fused Detect level: the wrapper of the CUDA kernel csrc/head_cm.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_head2.py::head_level_cm. One kernel
computes a whole level and, unlike ops/cuda_head.py's, also the sigmoid of
the cls logits: the merged reg|cls first 3x3, both second 3x3s, the 1x1 heads,
the DFL projection and the logistic. The kernel runs the body
of ops/cuda_head.py's (csrc/head.cuh) with its own cls epilogue, and the
same plan; the note at the top of csrc/head.cuh has its design, what bounds
it, and what it does about that.

`head_level_cm` launches the kernel for a CUDA tensor and counts the launch
in its `launches` attribute; for a CPU tensor it computes the plain twin
`head_level_cm_plain`, which is also what the kernel is held against on the
card.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops import cuda_head
from yolo_tpu_torch.ops.conv import conv_hwio
from yolo_tpu_torch.ops.cuda_head import HeadWeights


def head_level_cm_plain(x: torch.Tensor, kw: HeadWeights):
    """Plain twin of the kernel: x (B, H, W, C) → (dist (B, H*W, 4) f32, cls
    scores (B, H*W, nc) f32).

    Numerics of pallas_head2.py's body: each conv sums in f32 and rounds to
    x's dtype before the bias is added in that dtype (the 1x1 heads too), SiLU
    takes its logistic in f32, the second convs read zeros outside the map,
    the DFL takes exp(b - max) in x's dtype and both sums and the divide in
    f32, and the cls logits go through the logistic in f32."""
    B, H, W, _ = x.shape
    u = conv_hwio(x, kw.w0, kw.b0, 3)
    zr = conv_hwio(u[..., : kw.c2], kw.w1r, kw.b1r, 3)
    zc = conv_hwio(u[..., kw.c2 :], kw.w1c, kw.b1c, 3)
    bins = conv_hwio(zr, kw.w2r, kw.b2r, 1, act=False).reshape(B, H * W, 4, kw.reg_max)
    logits = conv_hwio(zc, kw.w2c, kw.b2c, 1, act=False).reshape(B, H * W, kw.nc)
    e = torch.exp(bins - bins.amax(-1, keepdim=True)).float()
    dist = (e * kw.proj.float()).sum(-1) / e.sum(-1)
    return dist, torch.sigmoid(logits.float())


def plan(B: int, H: int, W: int, C: int, c2: int, c3: int, nc: int, dtype) -> dict:
    """What the kernel picks for a level: ops/cuda_head.py's plan, which the two head kernels share."""
    return cuda_head.plan(B, H, W, C, c2, c3, nc, dtype)


def head_level_cm(x: torch.Tensor, kw: HeadWeights):
    """One Detect level: x (B, H, W, C) → (dist (B, H*W, 4) f32, cls scores (B, H*W, nc) f32, sigmoid applied)."""
    if not x.is_cuda:
        return head_level_cm_plain(x, kw)
    out = cuda_head._launch(x, kw, cm=True)
    head_level_cm.launches += 1
    return out


head_level_cm.launches = 0
