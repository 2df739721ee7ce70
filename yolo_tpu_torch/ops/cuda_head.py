"""Fused Detect level: the wrapper of the CUDA kernel csrc/head.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_head.py::fused_head_level (kernel
`_head_level_kernel`). One kernel computes a whole level: the merged reg|cls
first 3x3, both second 3x3s, the 1x1s and the DFL projection; see the note at
the top of csrc/head.cu for its design, what bounds it, and what it does about
that.

`fused_head_level` launches the kernel for a CUDA tensor and counts the launch
in its `launches` attribute; for a CPU tensor it computes the plain twin
`head_level_plain`, which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from yolo_tpu_torch.ops import _cuda
from yolo_tpu_torch.ops.conv import conv_hwio


def _flat(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight → flat HWIO (k*k*cin, cout) f32."""
    return w.float().permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


@dataclass
class HeadWeights:
    """One Detect level's fused weights in the kernel's layout (f32 HWIO,
    values already rounded to the model's compute dtype)."""

    w0: torch.Tensor  # merged first convs (9C, c2 + c3), reg channels first
    b0: torch.Tensor
    w1r: torch.Tensor  # (9 c2, c2)
    b1r: torch.Tensor
    w1c: torch.Tensor  # (9 c3, c3)
    b1c: torch.Tensor
    w2r: torch.Tensor  # (c2, 4 reg_max)
    b2r: torch.Tensor
    w2c: torch.Tensor  # (c3, nc)
    b2c: torch.Tensor
    proj: torch.Tensor  # (reg_max,) f32
    _mma: tuple | None = field(default=None, repr=False)

    def mma(self) -> tuple:
        """(w0, w1r, w1c) in the bf16 tensor-core layout [9][pad16(cout)][pad16(cin)]."""
        if self._mma is None:
            self._mma = tuple(_cuda.mma_weight(w, 3) for w in (self.w0, self.w1r, self.w1c))
        return self._mma

    @property
    def c2(self) -> int:
        return self.w1r.shape[1]

    @property
    def c3(self) -> int:
        return self.w1c.shape[1]

    @property
    def nc(self) -> int:
        return self.w2c.shape[1]

    @property
    def reg_max(self) -> int:
        return self.proj.shape[0]

    @classmethod
    def from_convs(cls, reg, cls_branch, proj) -> "HeadWeights":
        """From one level's branches ([ConvBNAct, ConvBNAct, Conv2d] each)."""
        return cls(
            w0=torch.cat([_flat(reg[0].weight), _flat(cls_branch[0].weight)], 1).contiguous(),
            b0=torch.cat([reg[0].bias.float(), cls_branch[0].bias.float()]).contiguous(),
            w1r=_flat(reg[1].weight),
            b1r=reg[1].bias.float().contiguous(),
            w1c=_flat(cls_branch[1].weight),
            b1c=cls_branch[1].bias.float().contiguous(),
            w2r=_flat(reg[2].weight),
            b2r=reg[2].bias.float().contiguous(),
            w2c=_flat(cls_branch[2].weight),
            b2c=cls_branch[2].bias.float().contiguous(),
            proj=proj.float().contiguous(),
        )


def head_level_plain(x: torch.Tensor, kw: HeadWeights):
    """Plain twin of the kernel: x (B, H, W, C) → (dist (B, H*W, 4) f32, cls
    logits (B, H*W, nc) in x's dtype)."""
    from yolo_tpu_torch.nn.modules import dfl_project

    B, H, W, _ = x.shape
    u = conv_hwio(x, kw.w0, kw.b0, 3)
    b = conv_hwio(u[..., : kw.c2], kw.w1r, kw.b1r, 3)
    c = conv_hwio(u[..., kw.c2 :], kw.w1c, kw.b1c, 3)
    bins = conv_hwio(b, kw.w2r, kw.b2r, 1, act=False)
    logits = conv_hwio(c, kw.w2c, kw.b2c, 1, act=False)
    dist = dfl_project(bins.reshape(B, H * W, 4, kw.reg_max), kw.proj)
    return dist, logits.reshape(B, H * W, kw.nc)


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _cuda.function("yt_head_level", [p, p, p] + [p] * 11 + [i] * 9 + [p])


def plan(H: int, W: int, C: int, c2: int, c3: int, dtype) -> tuple[int, int, int]:
    """(tile rows, tile columns, shared bytes) the kernel picks for a level."""
    th, tw, nb = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    fn = _cuda.function(
        "yt_head_plan", [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.POINTER(ctypes.c_longlong)]
    )
    _cuda.check(fn(H, W, C, c2, c3, int(dtype == torch.bfloat16), th, tw, nb), "head plan")
    return th.value, tw.value, nb.value


def fused_head_level(x: torch.Tensor, kw: HeadWeights):
    """One Detect level: x (B, H, W, C) → (dist (B, H*W, 4) f32, cls logits (B, H*W, nc) in x's dtype)."""
    if not x.is_cuda:
        return head_level_plain(x, kw)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused head takes f32 or bf16 activations, got {x.dtype}")
    B, H, W, C = x.shape
    if kw.w0.shape[0] != 9 * C or kw.w0.device != x.device:
        raise ValueError(f"head weights take {kw.w0.shape[0] // 9} channels on {kw.w0.device}, got {C} on {x.device}")
    x = x.contiguous()
    w0, w1r, w1c = kw.mma() if x.dtype == torch.bfloat16 else (kw.w0, kw.w1r, kw.w1c)
    dist = torch.empty((B, H * W, 4), device=x.device, dtype=torch.float32)
    cls = torch.empty((B, H * W, kw.nc), device=x.device, dtype=x.dtype)
    err = _entry()(
        x.data_ptr(), dist.data_ptr(), cls.data_ptr(),
        w0.data_ptr(), kw.b0.data_ptr(), w1r.data_ptr(), kw.b1r.data_ptr(), w1c.data_ptr(),
        kw.b1c.data_ptr(), kw.w2r.data_ptr(), kw.b2r.data_ptr(), kw.w2c.data_ptr(), kw.b2c.data_ptr(),
        kw.proj.data_ptr(),
        B, H, W, C, kw.c2, kw.c3, kw.nc, kw.reg_max, int(x.dtype == torch.bfloat16),
        _cuda.stream_of(x),
    )
    _cuda.check(err, "head kernel")
    fused_head_level.launches += 1
    return dist, cls


fused_head_level.launches = 0
