"""Channel-major fused Detect level: the wrapper of the CUDA kernel csrc/head_cm.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_head2.py::head_level_cm. One kernel
computes a whole level and, unlike ops/cuda_head.py's, also the sigmoid of
the cls logits: the merged reg|cls first 3x3, both second 3x3s, the 1x1 heads
with the weights as the products' row operand (out channels are the GEMM's M,
pixels its N), the DFL projection and the logistic. See the note at the top
of csrc/head_cm.cu for its design, what bounds it, and what it does about
that.

`head_level_cm` launches the kernel for a CUDA tensor and counts the launch
in its `launches` attribute; for a CPU tensor it computes the plain twin
`head_level_cm_plain`, which is also what the kernel is held against on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_tpu_torch.ops import _cuda
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


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _cuda.function("yt_head_level_cm", [p] * 14 + [i] * 9 + [p])


def plan(H: int, W: int, C: int, c2: int, c3: int, dtype) -> tuple[int, int, int]:
    """(tile rows, tile columns, shared bytes) the kernel picks for a level."""
    th, tw, nb = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    fn = _cuda.function(
        "yt_head_cm_plan", [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.POINTER(ctypes.c_longlong)]
    )
    _cuda.check(fn(H, W, C, c2, c3, int(dtype == torch.bfloat16), th, tw, nb), "head_cm plan")
    return th.value, tw.value, nb.value


def head_level_cm(x: torch.Tensor, kw: HeadWeights):
    """One Detect level: x (B, H, W, C) → (dist (B, H*W, 4) f32, cls scores (B, H*W, nc) f32, sigmoid applied)."""
    if not x.is_cuda:
        return head_level_cm_plain(x, kw)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the channel-major head takes f32 or bf16 activations, got {x.dtype}")
    B, H, W, C = x.shape
    if kw.w0.shape[0] != 9 * C or kw.w0.device != x.device:
        raise ValueError(f"head weights take {kw.w0.shape[0] // 9} channels on {kw.w0.device}, got {C} on {x.device}")
    x = x.contiguous()
    bf16 = x.dtype == torch.bfloat16
    ws = kw.mma_cm() if bf16 else (kw.w0, kw.w1r, kw.w1c, kw.w2r, kw.w2c)
    dist = torch.empty((B, H * W, 4), device=x.device, dtype=torch.float32)
    cls = torch.empty((B, H * W, kw.nc), device=x.device, dtype=torch.float32)
    err = _entry()(
        x.data_ptr(), dist.data_ptr(), cls.data_ptr(),
        *(w.data_ptr() for w in ws),
        kw.b0.data_ptr(), kw.b1r.data_ptr(), kw.b1c.data_ptr(), kw.b2r.data_ptr(), kw.b2c.data_ptr(),
        kw.proj.data_ptr(),
        B, H, W, C, kw.c2, kw.c3, kw.nc, kw.reg_max, int(bf16),
        _cuda.stream_of(x),
    )
    _cuda.check(err, "head_cm kernel")
    head_level_cm.launches += 1
    return dist, cls


head_level_cm.launches = 0
