"""The YOLO modules of the detect+track main path, as PyTorch modules.

Counterpart of yolo_tpu/nn/modules.py for the blocks that yolov8-small (P2),
yolov8n, yolov8n-cls, yolov8n-seg, yolov8n-pose and yolov8n-obb use: ConvBNAct, Conv2d, Bottleneck,
C2f (with the neck's Upsample→Concat→C2f fold, `call_upconcat`), SPPF, Concat, Upsample,
the Detect head with its DFL decode, the Classify head, the Segment head with its
Proto and ConvTranspose, the Pose head and the OBB head.

- Two forms of the weights live side by side in each conv module.
  - The inference form, with fused weights: an OIHW `weight` and a `bias`
    buffer (BN already folded, see nn/tasks.fuse) in the model's compute
    dtype. `load_jax(p)` takes the module's subtree of a fused JAX parameter
    tree (HWIO) and converts it. The kernels read this form.
  - The train form, the JAX package's unfused tree: `conv_weight` (OIHW f32
    master) and, in a ConvBNAct, `bn` with γ (`weight`) and β (`bias`) as
    parameters and the running moments as buffers; the head's Conv2d holds
    `conv_weight` and `conv_bias`. `train_leaves()` names each tensor by its
    path in the JAX tree, `init(rng)` draws the JAX package's initial tree
    with the same numpy calls in the same order, and `forward_train` is the
    JAX walk with `Ctx(train=True)` (no kernel, no neck fold): the conv in
    the input's dtype with the weight cast from its f32 master, BN on the
    batch's f32 moments (training mode) or on the running ones (eval mode).
- Activations cross module boundaries as NHWC tensors, as in the JAX package.
- Numerics of the fused ConvBNAct path: the conv sums in f32, rounds to the
  compute dtype, adds the bias in that dtype, and SiLU is x * sigmoid(x)
  with the logistic taken in f32 and rounded (ops/pallas_c2f.py:_silu).
- C2f blocks and Detect levels run the hand-written CUDA kernels
  (ops/cuda_c2f.py, ops/cuda_head.py, ops/cuda_head_cm.py); `plain=True` runs
  their plain PyTorch twins instead, the reference the kernels are held
  against on the card.
  Every other conv (stem, stride-2 convs, SPPF, the Segment head's coefficient
  branch and prototypes, the Pose head's keypoint branch, the OBB head's angle branch) is torch.nn.functional.conv2d (conv_transpose2d for
  Proto's upsample), as the JAX package leaves those to XLA.
- A ConvBNAct that `load_jax` gives an int8 subtree (nn/quantize.py) runs the int8 conv
  instead, and may emit a `QTensor`; the blocks then walk their convs module by module
  (the JAX package's QTensor flow: split, concat, upsample and max-pool stay int8, a
  residual add or a float conv dequantizes). While `quantize.capture` runs on a model, each
  of its float ConvBNActs records the amax of its input and output for `calibrate_act_scales`.
- The int8 head is the Detect head's `forward` (the branches conv by conv) and
  `decode_parts` (the DFL decode).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.nn import quantize as Q
from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_head_cm
from yolo_tpu_torch.ops.conv import conv_nhwc, silu


def _hwio_to_oihw(w, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1)))
    return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _vec(v, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device=device, dtype=dtype)


BN_EPS = 1e-3  # the BatchNorm eps of the JAX package


def _dtype_of(m) -> torch.dtype:
    """The compute dtype `params_from_jax` loaded a module in (f32 before any load)."""
    return getattr(m, "compute_dtype", torch.float32)


def _uniform_hwio(rng, c1: int, c2: int, k: int) -> np.ndarray:
    """The JAX package's conv init: kaiming-uniform over the fan-in, drawn as HWIO."""
    bound = (1.0 / (c1 * k * k)) ** 0.5 * 3.0**0.5
    return rng.uniform(-bound, bound, (k, k, c1, c2)).astype(np.float32)


class BatchNorm(nn.Module):
    """The `bn` group of a ConvBNAct: γ and β to train, the running moments beside them."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class ConvBNAct(nn.Module):
    """Conv ('same' padding) + BN + SiLU (JAX ConvBNAct): the fused inference form and the train form."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.c1, self.c2, self.k, self.s = c1, c2, k, s
        self.register_buffer("weight", torch.zeros(c2, c1, k, k))
        self.register_buffer("bias", torch.zeros(c2))
        self.conv_weight = nn.Parameter(torch.zeros(c2, c1, k, k))
        self.bn = BatchNorm(c2)
        self.batch_stats = None  # (mean, biased var, count) of the last training forward, held out of the gradient
        self.q = None  # the int8 form (nn/quantize.py) when load_jax took a quantized subtree
        self.path = ""  # the JAX tree path ('model/3/cv1'), the key of its calibrated scales
        self.calib = None  # while `quantize.capture` runs on this model: the {path: amax} store
        self.record_bn = True  # cleared while a rematerialised layer is recomputed (`recording_bn`)

    def init(self, rng) -> dict:
        return {
            "conv": {"weight": _uniform_hwio(rng, self.c1, self.c2, self.k)},
            "bn": {
                "weight": np.ones(self.c2, np.float32),
                "bias": np.zeros(self.c2, np.float32),
                "running_mean": np.zeros(self.c2, np.float32),
                "running_var": np.ones(self.c2, np.float32),
            },
        }

    def train_leaves(self) -> dict:
        bn = self.bn
        return {"conv/weight": self.conv_weight, "bn/weight": bn.weight, "bn/bias": bn.bias,
                "bn/running_mean": bn.running_mean, "bn/running_var": bn.running_var}

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The train-form conv + BN + SiLU in x's dtype. Training mode: the BN moments of
        the batch, taken in f32 over N, H and W (the scale rounded to x's dtype), kept
        in `batch_stats` for `utils.optim.apply_bn_stats`; eval mode: the running ones,
        exact in f32."""
        y = conv_nhwc(x, self.conv_weight, self.s, self.k // 2)
        bn = self.bn
        if self.training:
            var, mean = torch.var_mean(y.float(), (0, 1, 2), correction=0)
            if self.record_bn:
                self.batch_stats = (mean.detach(), var.detach(), y.shape[0] * y.shape[1] * y.shape[2])
        else:
            mean, var, y = bn.running_mean, bn.running_var, y.float()
        scale = (bn.weight * torch.rsqrt(var + BN_EPS)).to(y.dtype)
        y = (y - mean.to(y.dtype)) * scale + bn.bias.to(y.dtype)
        return silu(y).to(x.dtype)

    def load_jax(self, p: dict, device, dtype) -> None:
        if "bn" in p:
            raise ValueError("load_jax takes fused parameters (fold BN with nn.tasks.fuse first)")
        c = p["conv"]
        if "w_int8" in c:
            def scale(k):
                return None if c.get(k) is None else torch.tensor(float(np.float32(c[k])), dtype=torch.float32, device=device)

            self.q = {"w": Q.weight_matrix(c["w_int8"], device), "w_scale": _vec(c["w_scale"], device, torch.float32),
                      "bias": _vec(c["bias"], device, torch.float32), "x_scale": scale("x_scale"),
                      "y_scale": scale("y_scale")}
            return
        self.q = None
        self.weight = _hwio_to_oihw(c["weight"], device, dtype)
        self.bias = _vec(c["bias"], device, dtype)

    def forward(self, x):
        if self.q is not None:
            return self._forward_int8(x)
        x = Q.deq(x, self.weight.dtype)  # a quantized producer may feed a float conv
        if self.calib is not None:
            Q.record(self.calib, self.path, x)
        y = silu(conv_nhwc(x, self.weight, self.s, self.k // 2) + self.bias)
        if self.calib is not None:
            Q.record(self.calib, f"OUT::{self.path}", y)
        return y

    def _forward_int8(self, x):
        """The int8 conv (JAX `ConvBNAct._call_int8`): a QTensor input rides in as it is, a dense one
        is quantized (static x_scale, else dynamic); int32 sums scaled by s_x · w_scale, bias and SiLU
        in f32; requantized to a QTensor where a y_scale was calibrated, else the compute dtype."""
        q = self.q
        xq, sx = (x.q, x.s) if isinstance(x, Q.QTensor) else Q.quantize_input(x, q["x_scale"])
        y = Q.int8_conv(xq, q["w"], self.k, self.s, self.c2).float()
        y = y * (sx * q["w_scale"]) + q["bias"]
        y = y * torch.sigmoid(y)
        if q["y_scale"] is not None:
            return Q.QTensor(torch.clamp(torch.round(y / q["y_scale"]), -127, 127).to(torch.int8), q["y_scale"])
        return y.to(_dtype_of(self))


@contextlib.contextmanager
def recording_bn(module: nn.Module, on: bool):
    """Whether the ConvBNActs inside `module` keep their BN batch moments (`batch_stats`) in
    training forwards while the block runs; a flag on each, so no other module changes."""
    convs = [c for c in module.modules() if isinstance(c, ConvBNAct)]
    for c in convs:
        c.record_bn = on
    try:
        yield
    finally:
        for c in convs:
            c.record_bn = True


class Conv2d(nn.Module):
    """Plain conv with bias (the final 1x1s of the Detect branches)."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.c1, self.c2, self.k = c1, c2, k
        self.register_buffer("weight", torch.zeros(c2, c1, k, k))
        self.register_buffer("bias", torch.zeros(c2))
        self.conv_weight = nn.Parameter(torch.zeros(c2, c1, k, k))
        self.conv_bias = nn.Parameter(torch.zeros(c2))

    def init(self, rng) -> dict:
        w = _uniform_hwio(rng, self.c1, self.c2, self.k)
        bb = (1.0 / (self.c1 * self.k * self.k)) ** 0.5
        return {"weight": w, "bias": rng.uniform(-bb, bb, (self.c2,)).astype(np.float32)}

    def train_leaves(self) -> dict:
        return {"weight": self.conv_weight, "bias": self.conv_bias}

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.conv_weight, 1, self.k // 2) + self.conv_bias.to(x.dtype)

    def load_jax(self, p: dict, device, dtype) -> None:
        self.weight = _hwio_to_oihw(p["weight"], device, dtype)
        self.bias = _vec(p["bias"], device, dtype)

    def forward(self, x) -> torch.Tensor:
        return conv_nhwc(Q.deq(x, self.weight.dtype), self.weight, 1, self.k // 2) + self.bias


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

    def init(self, rng) -> dict:
        return {"cv1": self.cv1.init(rng), "cv2": self.cv2.init(rng)}

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2.forward_train(self.cv1.forward_train(x))
        return x + y if self.add else y

    def forward(self, x):
        """Conv by conv (the C2f module walk); a residual across int8 maps adds them dense."""
        y = self.cv2(self.cv1(x))
        if not self.add:
            return y
        if isinstance(x, Q.QTensor) or isinstance(y, Q.QTensor):
            return Q.deq(x, _dtype_of(self)) + Q.deq(y, _dtype_of(self))
        return x + y


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

    def init(self, rng) -> dict:
        return {"cv1": self.cv1.init(rng), "cv2": self.cv2.init(rng), "m": {str(i): m.init(rng) for i, m in enumerate(self.m)}}

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """cv1, split, the bottleneck chain, concat, cv2, through the train form (no kernel)."""
        y = self.cv1.forward_train(x)
        parts = [y[..., : self.c], y[..., self.c :]]
        for m in self.m:
            parts.append(m.forward_train(parts[-1]))
        return self.cv2.forward_train(torch.cat(parts, -1))

    def kernel_weights(self) -> cuda_c2f.C2fWeights:
        if self._kw is None:
            self._kw = cuda_c2f.C2fWeights.from_convs(self.cv1, [(m.cv1, m.cv2) for m in self.m], self.cv2)
        return self._kw

    def forward(self, x, plain: bool = False):
        """One C2f block through the kernel (`plain`: its twin); int8 weights, an int8 input or a
        calibration capture walk the convs module by module instead (`forward_modules`)."""
        if self.cv1.q is not None or isinstance(x, Q.QTensor) or self.cv1.calib is not None:
            return self.forward_modules(x)
        fn = cuda_c2f.c2f_plain if plain else cuda_c2f.fused_c2f
        return fn(x, self.kernel_weights(), shortcut=self.shortcut)

    def forward_modules(self, x):
        """cv1, split, the bottleneck chain, concat, cv2 conv by conv (JAX `C2f.__call__` without a
        kernel): an int8 cv1 output splits as int8, the concat stays int8 when every part is."""
        y = self.cv1(x)
        if isinstance(y, Q.QTensor):
            parts = [Q.QTensor(y.q[..., : self.c], y.s), Q.QTensor(y.q[..., self.c :], y.s)]
        else:
            parts = [y[..., : self.c], y[..., self.c :]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(Q.qconcat(parts, _dtype_of(self)))

    def call_upconcat(self, small: torch.Tensor, skip: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """C2f(concat(up2x_nearest(small), skip)) without the upsampled map or the concat."""
        if self.cv1.q is not None:
            raise ValueError("the neck fold needs fused float weights, not int8 (neck_opt=False)")
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

    def init(self, rng) -> dict:
        return {"cv1": self.cv1.init(rng), "cv2": self.cv2.init(rng)}

    def _pool(self, y: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(y.permute(0, 3, 1, 2), self.k, 1, self.k // 2).permute(0, 2, 3, 1).contiguous()

    def _pooled(self, y0: torch.Tensor) -> torch.Tensor:
        y = [y0]
        for _ in range(3):
            y.append(self._pool(y[-1]))
        return torch.cat(y, -1)

    def forward(self, x):
        y0 = self.cv1(x)
        if not isinstance(y0, Q.QTensor):
            return self.cv2(self._pooled(y0))
        y = [y0]  # max is monotone in q: pool the codes (exact in f32), the scale rides along
        for _ in range(3):
            y.append(Q.QTensor(self._pool(y[-1].q.float()).to(torch.int8), y0.s))
        return self.cv2(Q.qconcat(y, _dtype_of(self)))

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2.forward_train(self._pooled(self.cv1.forward_train(x)))


class Concat(nn.Module):
    """Channel concat (axis 1 in NCHW is the last axis in NHWC)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        if dim != 1:
            raise ValueError("only channel concat is supported")

    def init(self, rng) -> dict:
        return {}

    def forward(self, xs):
        return Q.qconcat(list(xs), _dtype_of(self))


class Upsample(nn.Module):
    """Nearest 2x upsample of an NHWC map."""

    def __init__(self, size=None, scale_factor=2, mode="nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError("only nearest upsampling is supported")
        self.scale = int(scale_factor)

    def init(self, rng) -> dict:
        return {}

    def forward(self, x):
        if isinstance(x, Q.QTensor):  # nearest replication commutes with the scale
            return Q.QTensor(self.forward(x.q), x.s)
        return x.repeat_interleave(self.scale, 1).repeat_interleave(self.scale, 2)


def dfl_project(box: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """DFL expectation over the last (reg_max) axis: softmax(box) · proj.

    box: (..., 4, reg_max) raw bin logits in the compute dtype; returns (..., 4)
    f32. As in the JAX package, the max-subtraction and exp stay in the
    compute dtype and the two sums and the divide run in f32."""
    e = torch.exp(box - box.amax(-1, keepdim=True)).float()
    return (e * proj.float()).sum(-1) / e.sum(-1)


def _branch_init(branch, rng) -> dict:
    """The JAX draws of a head's extra per-level branch (`cv4`: 3x3, 3x3, 1x1 a level), level by level."""
    return {str(l): {str(j): m.init(rng) for j, m in enumerate(level)} for l, level in enumerate(branch)}


def _branch_load(branch, p: dict, device, dtype) -> None:
    for l, level in enumerate(branch):
        for j, m in enumerate(level):
            m.load_jax(p[str(l)][str(j)], device, dtype)


def _branch_walk(branch, xs, train: bool) -> list:
    """Each level's input through its branch, in the train form or the inference form → per-level NHWC maps."""
    outs = []
    for level, x in zip(branch, xs):
        for m in level:
            x = m.forward_train(x) if train else m(x)
        outs.append(x)
    return outs


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

    def init(self, rng) -> dict:
        """The JAX Detect's draws, level by level, each conv of the box branch before its
        class-branch twin; the DFL's fixed arange; then the bias priors (`bias_init`)."""
        p = {"cv2": {}, "cv3": {}}
        for l in range(self.nl):
            p["cv2"][str(l)], p["cv3"][str(l)] = {}, {}
            for j in range(3):
                p["cv2"][str(l)][str(j)] = self.cv2[l][j].init(rng)
                p["cv3"][str(l)][str(j)] = self.cv3[l][j].init(rng)
        p["dfl"] = {"conv": {"weight": np.arange(self.reg_max, dtype=np.float32).reshape(1, 1, self.reg_max, 1)}}
        return self.bias_init(p)

    def bias_init(self, p: dict) -> dict:
        """Detection bias priors: box bins 1.0, class logits log(5 / nc / (640 / stride)^2)."""
        for l, s in enumerate(self.stride):
            p["cv2"][str(l)]["2"]["bias"] = np.ones_like(np.asarray(p["cv2"][str(l)]["2"]["bias"]))
            p["cv3"][str(l)]["2"]["bias"] = np.full_like(np.asarray(p["cv3"][str(l)]["2"]["bias"]), math.log(5 / self.nc / (640 / s) ** 2))
        return p

    def train_leaves(self) -> dict:
        return {"dfl/conv/weight": self.proj}  # fixed, never trained

    def forward_train(self, xs):
        """Per-level raw outputs (B, H, W, 4*reg_max + nc) through the train form."""
        outs = []
        for l, x in enumerate(xs):
            b, c = x, x
            for j in range(3):
                b, c = self.cv2[l][j].forward_train(b), self.cv3[l][j].forward_train(c)
            outs.append(torch.cat([b, c], -1))
        return outs

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

    def forward(self, xs):
        """Per-level raw outputs (B, H, W, 4*reg_max + nc), box bins then cls
        logits, through plain convs (JAX Detect.__call__): what `decode_parts`
        and `decode` take."""
        outs = []
        for l, x in enumerate(xs):
            b, c = x, x
            for j in range(3):
                b, c = self.cv2[l][j](b), self.cv3[l][j](c)
            outs.append(torch.cat([b, c], -1))
        return outs

    def _anchor_decode(self, dists, clss, feat_shapes):
        """Per-level dist (B, A_l, 4) and scores (B, A_l, nc) → (boxes (B, A, 4) px xywh, scores (B, A, nc))."""
        from yolo_tpu_torch.ops.anchors import dist2bbox, make_anchors

        anchors, strides = make_anchors(feat_shapes, self.stride, 0.5, device=dists[0].device)
        dbox = dist2bbox(torch.cat(dists, 1), anchors[None], xywh=True, dim=-1) * strides[None]
        return dbox, torch.cat(clss, 1)

    def decode_parts(self, outs):
        """DFL decode of the raw per-level outputs → (boxes (B, A, 4) px xywh f32,
        scores (B, A, nc) f32 sigmoid), the anchors-major layout NMS consumes."""
        dists, clss = [], []
        for o in outs:
            B, H, W, _ = o.shape
            box = o[..., : self.reg_max * 4].reshape(B, H * W, 4, self.reg_max)
            dists.append(dfl_project(box, self.proj))
            clss.append(torch.sigmoid(o[..., self.reg_max * 4 :].reshape(B, H * W, self.nc).float()))
        return self._anchor_decode(dists, clss, [(o.shape[1], o.shape[2]) for o in outs])

    @staticmethod
    def pack(dbox: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        """Decode parts → (B, 4 + nc, A), the layout of `decode` and of `non_max_suppression`."""
        return torch.cat([dbox, cls], -1).transpose(1, 2)

    def decode(self, outs) -> torch.Tensor:
        """DFL decode of the raw per-level outputs → (B, 4 + nc, A): px xywh, then sigmoid scores."""
        return self.pack(*self.decode_parts(outs))

    def head_levels(self, xs, plain: bool = False):
        """Both branches + DFL per level from the head inputs (NHWC) through the head kernel (`plain`:
        its twin) → (dists [(B, HW, 4) f32], scores [(B, HW, nc) f32 sigmoid]), level by level."""
        fn = cuda_head.head_level_plain if plain else cuda_head.fused_head_level
        dists, clss = [], []
        for l, x in enumerate(xs):
            d, c = fn(x, self.kernel_weights(l))
            dists.append(d)
            clss.append(torch.sigmoid(c.float()))
        return dists, clss

    def decode_from_inputs(self, xs, plain: bool = False):
        """`head_levels`, then the anchor decode: (boxes (B, A, 4) px xywh f32, scores (B, A, nc) f32)."""
        dists, clss = self.head_levels(xs, plain)
        return self._anchor_decode(dists, clss, [(x.shape[1], x.shape[2]) for x in xs])

    def decode_from_inputs_cm(self, xs, plain: bool = False):
        """`decode_from_inputs` with every level through the channel-major
        kernel (ops/cuda_head_cm.py, sigmoid inside). Every level shape is
        served: there is no tile width to fall back from."""
        fn = cuda_head_cm.head_level_cm_plain if plain else cuda_head_cm.head_level_cm
        dists, clss = zip(*(fn(x, self.kernel_weights(l)) for l, x in enumerate(xs)))
        return self._anchor_decode(dists, clss, [(x.shape[1], x.shape[2]) for x in xs])


class ConvTranspose(nn.Module):
    """Transposed conv + optional BN + optional SiLU (JAX ConvTranspose): Proto's 2x upsample.

    The JAX tree keeps the kernel as (kh, kw, c2, c1); both forms here hold torch's
    conv_transpose2d layout (c1, c2, kh, kw). The transposed conv runs in the input's dtype,
    the bias (or BN) and SiLU in f32, and the result is cast back, in the JAX order. With BN
    the inference form takes the tree `nn.tasks.fuse` folds: {conv_transpose: {weight}, bias}."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0, bn: bool = True, act: bool = True):
        super().__init__()
        self.c1, self.c2, self.k, self.s, self.p, self.act = c1, c2, k, s, p, act
        self.register_buffer("weight", torch.zeros(c1, c2, k, k))
        self.register_buffer("bias", torch.zeros(c2))
        self.conv_weight = nn.Parameter(torch.zeros(c1, c2, k, k))
        self.bn = BatchNorm(c2) if bn else None
        self.conv_bias = None if bn else nn.Parameter(torch.zeros(c2))
        self.batch_stats = None  # as ConvBNAct's: (mean, biased var, count) of the last training forward
        self.record_bn = True

    def init(self, rng) -> dict:
        fan_in = self.c1 * self.k * self.k
        bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
        w = rng.uniform(-bound, bound, (self.k, self.k, self.c2, self.c1)).astype(np.float32)
        if self.bn is not None:
            return {"conv_transpose": {"weight": w}, "bn": {
                "weight": np.ones(self.c2, np.float32), "bias": np.zeros(self.c2, np.float32),
                "running_mean": np.zeros(self.c2, np.float32), "running_var": np.ones(self.c2, np.float32)}}
        bb = math.sqrt(1.0 / fan_in)
        return {"weight": w, "bias": rng.uniform(-bb, bb, (self.c2,)).astype(np.float32)}

    def train_leaves(self) -> dict:
        if self.bn is None:
            return {"weight": self.conv_weight, "bias": self.conv_bias}
        bn = self.bn
        return {"conv_transpose/weight": self.conv_weight, "bn/weight": bn.weight, "bn/bias": bn.bias,
                "bn/running_mean": bn.running_mean, "bn/running_var": bn.running_var}

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The transposed conv of an NHWC map in x's dtype → an f32 NHWC map."""
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, self.s, self.p)
        return y.permute(0, 2, 3, 1).float()

    def _out(self, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (silu(y) if self.act else y).to(dtype)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The train form: BN on the f32 batch moments in training mode (kept in `batch_stats`), on the
        running ones in eval mode; without BN the bias."""
        y = self._conv(x, self.conv_weight)
        if self.bn is None:
            return self._out(y + self.conv_bias, x.dtype)
        bn = self.bn
        if self.training:
            var, mean = torch.var_mean(y, (0, 1, 2), correction=0)
            if self.record_bn:
                self.batch_stats = (mean.detach(), var.detach(), y.shape[0] * y.shape[1] * y.shape[2])
        else:
            mean, var = bn.running_mean, bn.running_var
        return self._out((y - mean) * (bn.weight * torch.rsqrt(var + BN_EPS)) + bn.bias, x.dtype)

    def load_jax(self, p: dict, device, dtype) -> None:
        if "bn" in p:
            raise ValueError("load_jax takes fused parameters (fold BN with nn.tasks.fuse first)")
        w = p["conv_transpose"]["weight"] if "conv_transpose" in p else p["weight"]
        self.weight = torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(device, dtype)
        self.bias = _vec(p["bias"], device, torch.float32) if "bias" in p else torch.zeros(self.c2, device=device)

    def forward(self, x) -> torch.Tensor:
        x = Q.deq(x, self.weight.dtype)
        return self._out(self._conv(x, self.weight) + self.bias, x.dtype)


class Proto(nn.Module):
    """Mask prototypes (JAX Proto): ConvBNAct 3x3, ConvTranspose 2x2 / 2 with a bias, ConvBNAct 3x3,
    ConvBNAct 1x1 → (B, 2H, 2W, c2) in the compute dtype. Plain torch convs (no kernel), as the
    JAX package leaves them to XLA."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c_, 3)
        self.upsample = ConvTranspose(c_, c_, 2, 2, 0, bn=False, act=False)
        self.cv2 = ConvBNAct(c_, c_, 3)
        self.cv3 = ConvBNAct(c_, c2)

    def init(self, rng) -> dict:
        return {"cv1": self.cv1.init(rng), "upsample": self.upsample.init(rng), "cv2": self.cv2.init(rng),
                "cv3": self.cv3.init(rng)}

    def load_jax(self, p: dict, device, dtype) -> None:
        for name in ("cv1", "upsample", "cv2", "cv3"):
            getattr(self, name).load_jax(p[name], device, dtype)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3.forward_train(self.cv2.forward_train(self.upsample.forward_train(self.cv1.forward_train(x))))

    def forward(self, x) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Segment(Detect):
    """Detect + mask coefficients + prototypes (JAX Segment). The box and class branches are the
    Detect head's (the head kernel at inference); the coefficient branch `cv4` (3x3, 3x3, 1x1 a
    level) and `proto` are plain torch convs, as the JAX package computes them outside any kernel."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: tuple = ()):
        super().__init__(nc, ch)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, nm, 1)]) for x in ch)

    def init(self, rng) -> dict:
        """Detect's draws and bias priors, then the proto's (cv1, upsample, cv2, cv3), then cv4 level by level."""
        p = super().init(rng)
        p["proto"] = self.proto.init(rng)
        p["cv4"] = _branch_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        self.proto.load_jax(p["proto"], device, dtype)
        _branch_load(self.cv4, p["cv4"], device, dtype)

    def forward_train(self, xs):
        """(per-level raw box + class outputs, per-level coefficients (B, H, W, nm), protos (B, h, w, nm))
        through the train form: what `v8SegmentationLoss` takes."""
        return super().forward_train(xs), _branch_walk(self.cv4, xs, True), self.proto.forward_train(xs[0])

    def coefficients(self, xs) -> torch.Tensor:
        """The mask coefficients of every anchor (B, A, nm), levels in order, in the compute dtype."""
        return torch.cat([m.reshape(m.shape[0], -1, self.nm) for m in _branch_walk(self.cv4, xs, False)], 1)


class Pose(Detect):
    """Detect + keypoint regression (JAX Pose). The box and class branches are the Detect head's (the head
    kernel at inference); the keypoint branch `cv4` (3x3, 3x3, 1x1 to nk = K · ndim a level) is plain torch
    convs, as the JAX package computes it outside any kernel."""

    def __init__(self, nc: int = 80, kpt_shape: tuple = (17, 3), ch: tuple = ()):
        super().__init__(nc, ch)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, self.nk)
        self.cv4 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, self.nk, 1)]) for x in ch)

    def init(self, rng) -> dict:
        """Detect's draws and bias priors, then cv4 level by level."""
        p = super().init(rng)
        p["cv4"] = _branch_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        _branch_load(self.cv4, p["cv4"], device, dtype)

    def forward_train(self, xs):
        """(per-level raw box + class outputs, per-level raw keypoints (B, H, W, nk)) through the train form:
        what `v8PoseLoss` takes."""
        return super().forward_train(xs), _branch_walk(self.cv4, xs, True)

    def keypoints(self, xs) -> torch.Tensor:
        """The decoded keypoints of every anchor (B, A, nk) in f32 (JAX `decode_with_kpts`): x, y =
        (raw · 2 + anchor − 0.5) · stride in pixels, the visibility's sigmoid where ndim is 3."""
        from yolo_tpu_torch.ops.anchors import make_anchors

        raw = _branch_walk(self.cv4, xs, False)
        B = raw[0].shape[0]
        K, ndim = self.kpt_shape
        anchors, strides = make_anchors([(x.shape[1], x.shape[2]) for x in xs], self.stride, 0.5, device=raw[0].device)
        y = torch.cat([k.reshape(B, -1, self.nk) for k in raw], 1).float().reshape(B, -1, K, ndim)
        xk = (y[..., 0] * 2.0 + (anchors[None, :, None, 0] - 0.5)) * strides[None, :, None, 0]
        yk = (y[..., 1] * 2.0 + (anchors[None, :, None, 1] - 0.5)) * strides[None, :, None, 0]
        parts = [xk[..., None], yk[..., None]] + ([torch.sigmoid(y[..., 2:3])] if ndim == 3 else [])
        return torch.cat(parts, -1).reshape(B, -1, self.nk)


class OBB(Detect):
    """Detect with oriented boxes (JAX OBB). The box and class branches are the Detect head's (the head
    kernel at inference); the angle branch `cv4` (3x3, 3x3, 1x1 to ne a level) is plain torch convs, as
    the JAX package computes it outside any kernel."""

    def __init__(self, nc: int = 80, ne: int = 1, ch: tuple = ()):
        super().__init__(nc, ch)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, ne, 1)]) for x in ch)

    def init(self, rng) -> dict:
        """Detect's draws and bias priors, then cv4 level by level."""
        p = super().init(rng)
        p["cv4"] = _branch_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        _branch_load(self.cv4, p["cv4"], device, dtype)

    def forward_train(self, xs):
        """(per-level raw box + class outputs, per-level raw angles (B, H, W, ne)) through the train form:
        what `v8OBBLoss` takes."""
        return super().forward_train(xs), _branch_walk(self.cv4, xs, True)

    def angles(self, xs) -> torch.Tensor:
        """The angle of every anchor (B, A, ne) in f32 radians: (sigmoid(raw) − 0.25) · π, in [−π/4, 3π/4)."""
        raw = _branch_walk(self.cv4, xs, False)
        B = raw[0].shape[0]
        return (torch.sigmoid(torch.cat([a.reshape(B, -1, self.ne) for a in raw], 1).float()) - 0.25) * math.pi

    def decode_rotated(self, dists, clss, angle: torch.Tensor, feat_shapes) -> torch.Tensor:
        """Per-level dist (B, A_l, 4) and scores (B, A_l, nc), the angles (B, A, 1) → (B, 4 + nc + 1, A)
        (JAX `decode_with_angle`): the rotated (cx, cy, w, h) of `dist2rbox` around the anchors times the
        stride, the scores, the angle."""
        from yolo_tpu_torch.ops.anchors import dist2rbox, make_anchors

        anchors, strides = make_anchors(feat_shapes, self.stride, 0.5, device=angle.device)
        rbox = dist2rbox(torch.cat(dists, 1), angle, anchors[None]) * strides[None]
        return torch.cat([rbox, torch.cat(clss, 1), angle], -1).transpose(1, 2)


class Classify(nn.Module):
    """Classification head (JAX Classify): a ConvBNAct to 1280 channels, the global mean, dropout
    on the pooled features (training only), then an f32 linear layer → logits (B, c2) in f32.

    The inference form's linear is `self.linear` (torch's (c2, 1280) weight); the train form's
    `linear_weight` keeps the JAX tree's (1280, c2) layout. `drop` is (rate, torch.Generator)
    while a trainer wants dropout: inverted dropout, each feature kept with probability
    1 - rate by a draw from that generator (JAX keys it with jax.random, whose bits torch
    cannot reproduce)."""

    c_ = 1280  # efficientnet_b0's width, as in the JAX package

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None, g: int = 1):
        super().__init__()
        if p not in (None, k // 2) or g != 1:
            raise NotImplementedError(f"Classify with padding {p} and groups {g} is not ported (the port's ConvBNAct pads k // 2)")
        self.c2 = c2
        self.conv = ConvBNAct(c1, self.c_, k, s)
        self.linear = nn.Linear(self.c_, c2).requires_grad_(False)
        self.linear_weight = nn.Parameter(torch.zeros(self.c_, c2))
        self.linear_bias = nn.Parameter(torch.zeros(c2))
        self.drop = None

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.c_)
        return {
            "conv": self.conv.init(rng),
            "linear": {
                "weight": rng.uniform(-bound, bound, (self.c_, self.c2)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, (self.c2,)).astype(np.float32),
            },
        }

    def train_leaves(self) -> dict:
        return {"linear/weight": self.linear_weight, "linear/bias": self.linear_bias}

    def load_jax(self, p: dict, device, dtype) -> None:
        self.conv.load_jax(p["conv"], device, dtype)
        w = torch.from_numpy(np.ascontiguousarray(np.asarray(p["linear"]["weight"], np.float32).T))
        self.linear.weight.data = w.to(device)
        self.linear.bias.data = _vec(p["linear"]["bias"], device, torch.float32)

    def forward(self, x) -> torch.Tensor:
        pooled = Q.deq(self.conv(x), _dtype_of(self)).mean(dim=(1, 2))
        return F.linear(pooled.float(), self.linear.weight, self.linear.bias)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.conv.forward_train(x).mean(dim=(1, 2))
        if self.training and self.drop is not None and self.drop[0] > 0:
            rate, gen = self.drop
            keep = 1.0 - float(rate)
            mask = torch.rand(pooled.shape, generator=gen, device=gen.device) < keep
            pooled = torch.where(mask.to(pooled.device), pooled / keep, torch.zeros((), dtype=pooled.dtype, device=pooled.device))
        return pooled.float() @ self.linear_weight + self.linear_bias
