"""The YOLO modules of the detect+track main path, as PyTorch modules.

Counterpart of yolo_tpu/nn/modules.py for the blocks that yolov8-small (P2)
and yolov8n use: ConvBNAct, Conv2d, Bottleneck, C2f (with the neck's
Upsample→Concat→C2f fold, `call_upconcat`), SPPF, Concat, Upsample and the
Detect head with its DFL decode.

- Inference only, with fused weights: each conv holds an OIHW `weight` and a
  `bias` (BN already folded, see nn/tasks.fuse) in the model's compute dtype.
  `load_jax(p)` takes the module's subtree of a fused JAX parameter tree
  (HWIO) and converts it.
- Activations cross module boundaries as NHWC tensors, as in the JAX package.
- Numerics of the fused ConvBNAct path: the conv sums in f32, rounds to the
  compute dtype, adds the bias in that dtype, and SiLU is x * sigmoid(x)
  with the logistic taken in f32 and rounded (ops/pallas_c2f.py:_silu).
- C2f blocks and Detect levels run the hand-written CUDA kernels
  (ops/cuda_c2f.py, ops/cuda_head.py); `plain=True` runs their plain PyTorch
  twins instead, the reference the kernels are held against on the card.
  Every other conv (stem, stride-2 convs, SPPF) is torch.nn.functional.conv2d,
  as the JAX package leaves those to XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.ops import cuda_c2f, cuda_head
from yolo_tpu_torch.ops.conv import conv_nhwc, silu


def _hwio_to_oihw(w, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1)))
    return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _vec(v, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device=device, dtype=dtype)


class ConvBNAct(nn.Module):
    """Conv ('same' padding) + (folded) BN + SiLU (JAX ConvBNAct), fused form only."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.c1, self.c2, self.k, self.s = c1, c2, k, s
        self.register_buffer("weight", torch.zeros(c2, c1, k, k))
        self.register_buffer("bias", torch.zeros(c2))

    def load_jax(self, p: dict, device, dtype) -> None:
        if "bn" in p:
            raise ValueError("load_jax takes fused parameters (fold BN with nn.tasks.fuse first)")
        self.weight = _hwio_to_oihw(p["conv"]["weight"], device, dtype)
        self.bias = _vec(p["conv"]["bias"], device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(conv_nhwc(x, self.weight, self.s, self.k // 2) + self.bias)


class Conv2d(nn.Module):
    """Plain conv with bias (the final 1x1s of the Detect branches)."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.c1, self.c2, self.k = c1, c2, k
        self.register_buffer("weight", torch.zeros(c2, c1, k, k))
        self.register_buffer("bias", torch.zeros(c2))

    def load_jax(self, p: dict, device, dtype) -> None:
        self.weight = _hwio_to_oihw(p["weight"], device, dtype)
        self.bias = _vec(p["bias"], device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.weight, 1, self.k // 2) + self.bias


class Bottleneck(nn.Module):
    """Two 3x3 ConvBNAct with an optional residual (JAX Bottleneck, k=(3, 3), e=1.0 inside C2f)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 3, 1)
        self.cv2 = ConvBNAct(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def load_jax(self, p: dict, device, dtype) -> None:
        self.cv1.load_jax(p["cv1"], device, dtype)
        self.cv2.load_jax(p["cv2"], device, dtype)


class C2f(nn.Module):
    """CSP bottleneck with 2 convs (JAX C2f), one fused CUDA kernel per block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, e=1.0) for _ in range(n))
        self.shortcut = self.m[0].add
        self._kw = None

    def load_jax(self, p: dict, device, dtype) -> None:
        self.cv1.load_jax(p["cv1"], device, dtype)
        self.cv2.load_jax(p["cv2"], device, dtype)
        for i, m in enumerate(self.m):
            m.load_jax(p["m"][str(i)], device, dtype)
        self._kw = None

    def kernel_weights(self) -> cuda_c2f.C2fWeights:
        if self._kw is None:
            self._kw = cuda_c2f.C2fWeights.from_convs(self.cv1, [(m.cv1, m.cv2) for m in self.m], self.cv2)
        return self._kw

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        fn = cuda_c2f.c2f_plain if plain else cuda_c2f.fused_c2f
        return fn(x, self.kernel_weights(), shortcut=self.shortcut)

    def call_upconcat(self, small: torch.Tensor, skip: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """C2f(concat(up2x_nearest(small), skip)) without the upsampled map or the concat."""
        fn = cuda_c2f.c2f_upconcat_plain if plain else cuda_c2f.fused_c2f_upconcat
        return fn(small, skip, self.kernel_weights(), shortcut=self.shortcut)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast (JAX SPPF): 1x1, three 5x5 max-pools, concat, 1x1."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_ * 4, c2, 1, 1)

    def load_jax(self, p: dict, device, dtype) -> None:
        self.cv1.load_jax(p["cv1"], device, dtype)
        self.cv2.load_jax(p["cv2"], device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            pooled = F.max_pool2d(y[-1].permute(0, 3, 1, 2), self.k, 1, self.k // 2)
            y.append(pooled.permute(0, 2, 3, 1).contiguous())
        return self.cv2(torch.cat(y, -1))


class Concat(nn.Module):
    """Channel concat (axis 1 in NCHW is the last axis in NHWC)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        if dim != 1:
            raise ValueError("only channel concat is supported")

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(xs, -1)


class Upsample(nn.Module):
    """Nearest 2x upsample of an NHWC map."""

    def __init__(self, size=None, scale_factor=2, mode="nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError("only nearest upsampling is supported")
        self.scale = int(scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(self.scale, 1).repeat_interleave(self.scale, 2)


def dfl_project(box: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """DFL expectation over the last (reg_max) axis: softmax(box) · proj.

    box: (..., 4, reg_max) raw bin logits in the compute dtype; returns (..., 4)
    f32. As in the JAX package, the max-subtraction and exp stay in the
    compute dtype and the two sums and the divide run in f32."""
    e = torch.exp(box - box.amax(-1, keepdim=True)).float()
    return (e * proj.float()).sum(-1) / e.sum(-1)


class Detect(nn.Module):
    """Anchor-free detect head with DFL box regression (JAX Detect, legacy v8 branches)."""

    def __init__(self, nc: int = 80, ch: tuple = ()):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = 16
        self.stride = [8, 16, 32][: self.nl] if self.nl <= 3 else [4, 8, 16, 32]  # set from the graph at build
        c2 = max(16, ch[0] // 4, self.reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.ModuleList([ConvBNAct(x, c2, 3), ConvBNAct(c2, c2, 3), Conv2d(c2, 4 * self.reg_max, 1)]) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.ModuleList([ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3), Conv2d(c3, nc, 1)]) for x in ch
        )
        self.register_buffer("proj", torch.arange(self.reg_max, dtype=torch.float32))
        self._kw = None

    def load_jax(self, p: dict, device, dtype) -> None:
        for l in range(self.nl):
            for j in range(3):
                self.cv2[l][j].load_jax(p["cv2"][str(l)][str(j)], device, dtype)
                self.cv3[l][j].load_jax(p["cv3"][str(l)][str(j)], device, dtype)
        self.proj = _vec(np.asarray(p["dfl"]["conv"]["weight"]).reshape(self.reg_max), device, torch.float32)
        self._kw = None

    def kernel_weights(self, l: int) -> cuda_head.HeadWeights:
        if self._kw is None:
            self._kw = [
                cuda_head.HeadWeights.from_convs(self.cv2[i], self.cv3[i], self.proj) for i in range(self.nl)
            ]
        return self._kw[l]

    def decode_from_inputs(self, xs, plain: bool = False):
        """Both branches + DFL per level from the head inputs (NHWC), then the
        anchor decode: (boxes (B, A, 4) px xywh f32, scores (B, A, nc) f32)."""
        from yolo_tpu_torch.ops.anchors import dist2bbox, make_anchors

        fn = cuda_head.head_level_plain if plain else cuda_head.fused_head_level
        dists, clss = [], []
        for l, x in enumerate(xs):
            d, c = fn(x, self.kernel_weights(l))
            dists.append(d)
            clss.append(torch.sigmoid(c.float()))
        feat_shapes = [(x.shape[1], x.shape[2]) for x in xs]
        anchors, strides = make_anchors(feat_shapes, self.stride, 0.5, device=xs[0].device)
        dist = torch.cat(dists, 1)
        dbox = dist2bbox(dist, anchors[None], xywh=True, dim=-1) * strides[None]
        return dbox, torch.cat(clss, 1)
