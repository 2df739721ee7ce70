"""Fused C2f: the wrapper of the CUDA kernel csrc/c2f.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_c2f.py (`fused_c2f`, `fused_c2f_upconcat`,
both served by `_c2f_kernel`). The kernel computes one whole C2f block with
every intermediate map in shared memory; see the note at the top of
csrc/c2f.cu for its design, what bounds it, and what it does about that.

`fused_c2f` / `fused_c2f_upconcat` launch the kernel for a CUDA tensor and
count the launch in their `launches` attribute; for a CPU tensor they compute
the plain twin (`c2f_plain` / `c2f_upconcat_plain`), which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from yolo_tpu_torch.ops import _cuda
from yolo_tpu_torch.ops.conv import conv_hwio, conv_nhwc, silu


def _flat(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight → flat HWIO (k*k*cin, cout) f32."""
    return w.float().permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


@dataclass
class C2fWeights:
    """One C2f's fused weights in the kernel's layout: f32 HWIO, values already
    rounded to the model's compute dtype."""

    w1: torch.Tensor  # cv1 (c1, 2c)
    b1: torch.Tensor  # (2c,)
    wm: torch.Tensor  # (2n, 9c, c): bottleneck i conv j at 2i + j
    bm: torch.Tensor  # (2n, c)
    w2: torch.Tensor  # cv2 ((2 + n) c, c2o)
    b2: torch.Tensor  # (c2o,)
    _mma: tuple | None = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.wm.shape[0] // 2

    @property
    def c(self) -> int:
        return self.wm.shape[-1]

    def mma(self) -> tuple:
        """(wm, w2) in the bf16 tensor-core layout: each bottleneck conv as
        [9][pad16(c)][pad16(c)], cv2 as one [pad16(c2o)][pad16(c)] per concat segment."""
        if self._mma is None:
            c, c2o = self.c, self.w2.shape[1]
            wm = torch.stack([_cuda.mma_weight(w, 3) for w in self.wm])
            w2 = torch.cat([_cuda.mma_weight(s, 1) for s in self.w2.reshape(-1, c, c2o)])
            self._mma = (wm.contiguous(), w2.contiguous())
        return self._mma

    @classmethod
    def from_convs(cls, cv1, bottlenecks, cv2) -> "C2fWeights":
        """From the C2f's ConvBNAct modules (OIHW weight + bias each)."""
        convs = [cv for pair in bottlenecks for cv in pair]
        return cls(
            w1=_flat(cv1.weight),
            b1=cv1.bias.float().contiguous(),
            wm=torch.stack([_flat(cv.weight) for cv in convs]),
            bm=torch.stack([cv.bias.float() for cv in convs]),
            w2=_flat(cv2.weight),
            b2=cv2.bias.float().contiguous(),
        )


def _tail(y: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """Everything after cv1: split, the bottleneck chain, concat, cv2."""
    c = kw.c
    parts = [y[..., :c], y[..., c:]]
    for i in range(kw.n):
        t = conv_hwio(parts[-1], kw.wm[2 * i], kw.bm[2 * i], 3)
        t = conv_hwio(t, kw.wm[2 * i + 1], kw.bm[2 * i + 1], 3)
        parts.append(parts[-1] + t if shortcut else t)
    return conv_hwio(torch.cat(parts, -1), kw.w2, kw.b2, 1)


def c2f_plain(x: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """Plain twin of the kernel: x (B, H, W, c1) → (B, H, W, c2o) in x's dtype."""
    return _tail(conv_hwio(x, kw.w1, kw.b1, 1), kw, shortcut)


def c2f_upconcat_plain(small: torch.Tensor, skip: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """Plain twin of the upconcat mode, the JAX package's C2f.call_upconcat
    algebra: cv1 splits along its input channels, the `small` half runs at low
    resolution and only its 2c-channel result is upsampled."""
    cs = small.shape[-1]
    w1 = kw.w1.t()[:, :, None, None]  # (2c, c1, 1, 1)
    ya = conv_nhwc(small, w1[:, :cs])
    yb = conv_nhwc(skip, w1[:, cs:])
    up = ya.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return _tail(silu(up + yb + kw.b1.to(yb.dtype)), kw, shortcut)


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _cuda.function("yt_c2f_forward", [p, p, p] + [p] * 6 + [i] * 10 + [p])


def plan(H: int, W: int, c: int, c2o: int, n: int, dtype) -> tuple[int, int, int]:
    """(tile rows, tile columns, shared bytes) the kernel picks for an instance."""
    th, tw, nb = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    fn = _cuda.function(
        "yt_c2f_plan", [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.POINTER(ctypes.c_longlong)]
    )
    _cuda.check(fn(H, W, c, c2o, n, int(dtype == torch.bfloat16), th, tw, nb), "c2f plan")
    return th.value, tw.value, nb.value


def _launch(x: torch.Tensor, small: torch.Tensor | None, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused C2f takes f32 or bf16 activations, got {x.dtype}")
    B, H, W, ck = x.shape
    cs = 0 if small is None else small.shape[-1]
    if small is not None and (small.dtype != x.dtype or small.shape != (B, H // 2, W // 2, cs) or H % 2 or W % 2):
        raise ValueError(f"small {tuple(small.shape)} is not a 2x-downsampled partner of skip {tuple(x.shape)}")
    if kw.w1.shape[0] != cs + ck or kw.w1.device != x.device:
        raise ValueError(f"C2f weights take {kw.w1.shape[0]} input channels on {kw.w1.device}, got {cs + ck} on {x.device}")
    x = x.contiguous()
    small = None if small is None else small.contiguous()
    c2o = kw.w2.shape[1]
    wm, w2 = kw.mma() if x.dtype == torch.bfloat16 else (kw.wm, kw.w2)
    out = torch.empty((B, H, W, c2o), device=x.device, dtype=x.dtype)
    err = _entry()(
        x.data_ptr(), 0 if small is None else small.data_ptr(), out.data_ptr(),
        kw.w1.data_ptr(), kw.b1.data_ptr(), wm.data_ptr(), kw.bm.data_ptr(), w2.data_ptr(), kw.b2.data_ptr(),
        B, H, W, cs + ck, cs, kw.c, c2o, kw.n, int(shortcut), int(x.dtype == torch.bfloat16),
        _cuda.stream_of(x),
    )
    _cuda.check(err, "c2f kernel")
    return out


def fused_c2f(x: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """One C2f block: x (B, H, W, c1) → (B, H, W, c2o), in x's dtype (f32 or bf16)."""
    if not x.is_cuda:
        return c2f_plain(x, kw, shortcut)
    out = _launch(x, None, kw, shortcut)
    fused_c2f.launches += 1
    return out


def fused_c2f_upconcat(small: torch.Tensor, skip: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """C2f(concat(up2x_nearest(small), skip)): small (B, H/2, W/2, cs), skip (B, H, W, ck)."""
    if not skip.is_cuda:
        return c2f_upconcat_plain(small, skip, kw, shortcut)
    out = _launch(skip, small, kw, shortcut)
    fused_c2f_upconcat.launches += 1
    return out


fused_c2f.launches = 0
fused_c2f_upconcat.launches = 0
