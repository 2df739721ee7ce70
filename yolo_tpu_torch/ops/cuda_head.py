"""Fused Detect level: the wrapper of the CUDA kernel csrc/head.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_head.py::fused_head_level (kernel
`_head_level_kernel`). One kernel computes a whole level: the merged reg|cls
first 3x3, both second 3x3s, the 1x1s and the DFL projection. Its body is
shared with the channel-major entry (ops/cuda_head_cm.py): in bf16 every
product runs on the tensor cores with the weights streamed into shared memory
in the layout `pack_core` writes; `plan` says what the kernel picks for a
level and `candidates` what it weighed. The note at the top of
csrc/head.cuh has the design, what bounds it, and what it does about that.

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
    _core: torch.Tensor | None = field(default=None, repr=False)

    def core(self) -> torch.Tensor:
        """The weights as the bf16 kernel streams them (`pack_core`), made once."""
        if self._core is None:
            self._core = pack_core(self)
        return self._core

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

    @classmethod
    def random(cls, C: int, c2: int, c3: int, nc: int, seed: int = 0, device="cpu", dtype=torch.float32) -> "HeadWeights":
        """A level with seeded random weights (uniform over +-1/sqrt(fan-in)) and
        biases (normal, 0.1), values rounded to `dtype`, reg_max 16, projection
        0..15: the `[head edges]` shapes have no trained level."""
        import numpy as np

        rng = np.random.default_rng(seed)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).float().to(device).contiguous()

        def conv(k, cin, cout):
            return t(rng.uniform(-1, 1, (k * k * cin, cout)) / np.sqrt(k * k * cin)), t(rng.normal(0, 0.1, cout))

        (w0, b0), (w1r, b1r), (w1c, b1c) = conv(3, C, c2 + c3), conv(3, c2, c2), conv(3, c3, c3)
        (w2r, b2r), (w2c, b2c) = conv(1, c2, 64), conv(1, c3, nc)
        return cls(w0, b0, w1r, b1r, w1c, b1c, w2r, b2r, w2c, b2c, torch.arange(16, dtype=torch.float32, device=device))


def _pad(c: int, m: int) -> int:
    return -(-c // m) * m


def _passes(w: torch.Tensor, k: int, kp: int, npad: int, width: int) -> torch.Tensor:
    """A flat HWIO conv weight (k*k*cin, cout) → bf16, zero-padded to kp inputs and npad
    outputs, flat in the order [pass of `width` outputs][tap][16-wide K chunk][n / 8][k / 8]
    [n % 8][k % 8]: every 8x8 block of one K chunk is 128 contiguous bytes."""
    cin, cout = w.shape[0] // (k * k), w.shape[1]
    t = torch.zeros((k * k, kp, npad), dtype=torch.float32, device=w.device)
    t[:, :cin, :cout] = w.reshape(k * k, cin, cout)
    t = t.reshape(k * k, kp // 16, 2, 8, npad // width, width // 8, 8)  # tap, chunk, k/8, k%8, pass, n/8, n%8
    return t.permute(4, 0, 1, 5, 2, 6, 3).to(torch.bfloat16).reshape(-1)


def pack_core(kw: HeadWeights) -> torch.Tensor:
    """Every conv of the level as the bf16 kernel streams them (csrc/head.cuh `Pack`), one flat
    tensor in the core-matrix layout of `_passes`; pads are zero:
    - the merged first conv, C padded to 16 inputs, outputs padded so that its map holds the
      cls slice [c2, c2 + pad32(c3)), in passes of 48;
    - the reg second conv, pad16(c2) inputs, in passes of 64 outputs (pad64(c2) of them); the
      cls one in passes of 32 (c3 padded to 32);
    - the reg 1x1 (pad64(c2) inputs, 64 outputs, one pass), which the kernel keeps in shared
      memory for a block's life, and the cls 1x1 in passes of 16 outputs (nc padded to 16), one
      of which it keeps there at a time."""
    C, c2, c3, nc = kw.w0.shape[0] // 9, kw.c2, kw.c3, kw.nc
    kx, k3, kr, nr = _pad(C, 16), _pad(c3, 32), _pad(c2, 16), _pad(c2, 64)
    n1 = _pad(c2 + k3, 48)
    return torch.cat([
        _passes(kw.w0, 3, kx, n1, 48),
        _passes(kw.w1r, 3, kr, nr, 64),
        _passes(kw.w1c, 3, k3, k3, 32),
        _passes(kw.w2r, 1, nr, 64, 64),
        _passes(kw.w2c, 1, k3, _pad(nc, 16), 16),
    ]).contiguous()


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


# Levels a tiling can get wrong and the main path lacks; the card run holds both head kernels
# against their twins at them and the CPU tests the twins against the JAX package:
# (B, H, W, C, c2, c3, nc)
HEAD_EDGES = [
    (1, 128, 160, 24, 64, 24, 1),  # the main path's P2 level with one frame (the predict path)
    (3, 21, 30, 24, 64, 24, 1),  # three frames of an odd map no tile divides
    (1, 16, 20, 192, 64, 24, 1),  # the main path's P5 level (C = 192) with one frame
    (2, 5, 7, 192, 64, 192, 1),  # a map narrower than the tile; c3 = 192, six passes of the cls conv
    (2, 16, 20, 48, 64, 48, 3),  # nc = 3
    (3, 33, 41, 96, 64, 96, 17),  # nc = 17: two n-tile pairs of the cls 1x1
    (2, 20, 20, 64, 64, 80, 80),  # the stock yolov8.yaml level: C = 64, c3 = 80, nc = 80
    (2, 20, 20, 320, 80, 320, 80),  # yolov8x.yaml's P3 channels: c2 = 80 (two passes of the reg conv), c3 = 320
    (1, 20, 20, 512, 80, 320, 80),  # yolov8x.yaml's P5 level at 640x640: C = 512, five runs of the cls conv
]


# The legacy heads of yolov3, yolov3-tiny and yolov9 at 640x640 (c2 = 64, c3 = max(C of P3, 80)), one frame: the
# card also times the head kernel at these against its bound and the cuDNN conv walk. Part of HEAD_EDGES.
HEAD_WIDTHS = [
    (1, 80, 80, 256, 64, 256, 80),  # yolov3 / -spp and yolov9c / -e (and their seg heads) P3
    (1, 40, 40, 512, 64, 256, 80),  # their P4
    (1, 20, 20, 1024, 64, 256, 80),  # yolov3's P5: C = 1024, where no f32 tile of 2x4 or more fits 227 KB
    (1, 40, 40, 256, 64, 256, 80),  # yolov3-tiny's stride-16 level
    (1, 20, 20, 512, 64, 256, 80),  # yolov3-tiny's stride-32 level, yolov9c / -e P5
    (1, 80, 80, 64, 64, 80, 80),  # yolov9t
    (1, 40, 40, 96, 64, 80, 80),
    (1, 20, 20, 128, 64, 80, 80),
    (1, 80, 80, 128, 64, 128, 80),  # yolov9s
    (1, 40, 40, 192, 64, 128, 80),
    (1, 20, 20, 256, 64, 128, 80),
    (1, 80, 80, 240, 64, 240, 80),  # yolov9m
    (1, 40, 40, 360, 64, 240, 80),
    (1, 20, 20, 480, 64, 240, 80),
]
HEAD_EDGES += HEAD_WIDTHS


@functools.lru_cache(maxsize=None)
def _entry(cm: bool = False, lib=None):
    """`yt_head_level` (`yt_head_level_cm` with cm) of the kernel library, or of another build of it (`lib`)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    name, argtypes = "yt_head_level_cm" if cm else "yt_head_level", [p] * 15 + [i] * 11 + [p]
    if lib is None:
        return _cuda.function(name, argtypes)
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _refusal(B, H, W, C, c2, c3, nc, dtype) -> str:
    return (f"the head kernels do not take B={B}, a {H}x{W} map, C={C}, c2={c2}, c3={c3}, nc={nc} in {dtype}: they need "
            "c2 and c3 multiples of 8, at most 65535 frames, in bf16 C % 8 == 0, and a tile that fits "
            "227 KB of shared memory")


def plan(B: int, H: int, W: int, C: int, c2: int, c3: int, nc: int, dtype) -> dict:
    """What the kernel picks for a level (both head kernels share it; it depends on
    the batch: few frames take small tiles to spread over the SMs): the output tile,
    the blocks of the launch (in bf16 persistent, each walking tiles) and how many
    an SM holds, the shared bytes per block and the matrix instructions; in bf16
    also the steps of the weight ring (two) and the bytes of a step."""
    bf16 = dtype == torch.bfloat16
    out = (ctypes.c_longlong * 8)()
    fn = _cuda.function("yt_head_plan", [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)])
    err = fn(B, H, W, C, c2, c3, nc, int(bf16), out)
    if err < 0:
        raise ValueError(_refusal(B, H, W, C, c2, c3, nc, dtype))
    _cuda.check(err, "head plan")
    th, tw, blocks, tiles, per_sm, smem, slot, ins = (int(v) for v in out)
    instruction = ("fmaf (CUDA cores)", "wgmma.m64n64k16 (reg 3x3) + mma.sync.m16n8k16 + ldmatrix")[ins]
    return dict(tile=(th, tw), blocks=blocks, tiles=tiles, blocks_per_sm=per_sm, smem=smem,
                ring_steps=2 if bf16 else 0, slot_bytes=slot, instruction=instruction)


def candidates(B: int, H: int, W: int, C: int, c2: int, c3: int, nc: int, dtype, model=None) -> list[dict]:
    """Every tile the plan weighs for a level, in its order, as dicts with the
    modelled `cost`; the plan is the first of least cost. `model` = {"barrier": v}
    gives the cost model's one constant (csrc/head.cuh::Model) another value (a
    measurement's way to ask what it decides)."""
    room = 256
    plans, costs, count = (ctypes.c_longlong * (5 * room))(), (ctypes.c_double * room)(), ctypes.c_int(0)
    barrier = float("nan") if model is None else model.get("barrier", float("nan"))
    i = ctypes.c_int
    fn = _cuda.function("yt_head_candidates", [i] * 8 + [ctypes.c_double, i, ctypes.POINTER(ctypes.c_longlong),
                                                        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(i)])
    err = fn(B, H, W, C, c2, c3, nc, int(dtype == torch.bfloat16), barrier, room, plans, costs, ctypes.byref(count))
    if err < 0:
        raise ValueError(_refusal(B, H, W, C, c2, c3, nc, dtype))
    _cuda.check(err, "head candidates")
    keys = ("th", "tw", "slot_bytes", "blocks", "smem")
    return [dict(zip(keys, (int(v) for v in plans[5 * k : 5 * k + 5])), cost=costs[k]) for k in range(min(count.value, room))]


def _launch(x: torch.Tensor, kw: HeadWeights, cm: bool, force=(0, 0), lib=None):
    """Launch one of the two entries of the kernel (cm: the channel-major one, sigmoid
    inside) with the level's plan, or (measurements only) with the tile `force` =
    (th, tw), from `lib` where that is another build of the kernel library."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the head kernels take f32 or bf16 activations, got {x.dtype}")
    B, H, W, C = x.shape
    if kw.w0.shape[0] != 9 * C or kw.w0.device != x.device:
        raise ValueError(f"head weights take {kw.w0.shape[0] // 9} channels on {kw.w0.device}, got {C} on {x.device}")
    x = x.contiguous()
    bf16 = x.dtype == torch.bfloat16
    dist = torch.empty((B, H * W, 4), device=x.device, dtype=torch.float32)
    cls = torch.empty((B, H * W, kw.nc), device=x.device, dtype=torch.float32 if cm else x.dtype)
    err = _entry(cm, lib)(
        x.data_ptr(), dist.data_ptr(), cls.data_ptr(), kw.core().data_ptr() if bf16 else 0,
        *(t.data_ptr() for t in (kw.w0, kw.w1r, kw.w1c, kw.w2r, kw.w2c, kw.b0, kw.b1r, kw.b1c, kw.b2r, kw.b2c, kw.proj)),
        B, H, W, C, kw.c2, kw.c3, kw.nc, kw.reg_max, int(bf16), *force,
        _cuda.stream_of(x),
    )
    if err < 0:  # the kernel's own refusals; CUDA's error codes are positive
        raise ValueError(_refusal(B, H, W, C, kw.c2, kw.c3, kw.nc, x.dtype))
    _cuda.check(err, "head_cm kernel" if cm else "head kernel")
    return dist, cls


def fused_head_level(x: torch.Tensor, kw: HeadWeights):
    """One Detect level: x (B, H, W, C) → (dist (B, H*W, 4) f32, cls logits (B, H*W, nc) in x's dtype)."""
    if not x.is_cuda:
        return head_level_plain(x, kw)
    out = _launch(x, kw, cm=False)
    fused_head_level.launches += 1
    return out


fused_head_level.launches = 0
