"""The YOLO modules of the detect+track main path, as PyTorch modules.

Counterpart of yolo_tpu/nn/modules.py for the blocks that yolov8-small (P2),
yolov8n, yolov8n-cls, yolov8n-seg, yolov8n-pose and yolov8n-obb use: ConvBNAct (with JAX's
padding, groups and activation on or off), Conv2d, Bottleneck, C2f (with the neck's
Upsample→Concat→C2f fold, `call_upconcat`), SPPF, Concat, Upsample, the Detect head with its
DFL decode, the Classify head, the Segment head with its Proto and ConvTranspose, the Pose head
and the OBB head; and for the v8 variants (yolov8-p6, -ghost*, -seg-p6, -pose-p6, -cls-resnet*)
and yolov5: MaxPool2d, DWConv, C3, C2, GhostConv, GhostBottleneck, C3Ghost, ResNetBlock and
ResNetLayer; for yolo11 and yolo12: C3k, C3k2, Attention, PSABlock, C2PSA, AAttn, ABlock, A2C2f
and the non-legacy Detect class branch (`Seq`: a depth-wise 3x3, then a 1x1); for yolov3, yolov6, YOLO-NAS and
yolov9: ConvBNAct's ReLU and GELU, repeated yaml rows (`Seq`), SPP, ZeroPad2d, Identity, NASBottleneck, NASCSP,
RepConv, RepBottleneck, RepCSP, RepNCSPELAN4, ELAN1, AConv, ADown, SPPELAN, CBLinear and CBFuse; for yolov10:
SCDown, RepVGGDW, CIB, C2fCIB, PSA and the end-to-end (NMS-free) v10Detect head.

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
  branch and prototypes, the Pose head's keypoint branch, the OBB head's angle branch,
  every conv of the variants' C3, C2, GhostConv, GhostBottleneck and ResNetLayer blocks,
  all of yolo11's and yolo12's blocks and non-legacy heads, attention products included, all of
  yolov3's, yolov6's, YOLO-NAS's and yolov9's blocks, a ReLU Detect head, conv by conv, and yolov10's
  SCDown, C2fCIB, PSA and v10Detect branches) is
  plain torch (conv2d, conv_transpose2d for Proto's upsample, matmul), as the JAX package
  leaves those to XLA.
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
import copy
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


def autopad(k: int, p: int | None = None) -> int:
    """'Same' padding of an odd kernel unless a padding is given (JAX `autopad`, dilation 1)."""
    return k // 2 if p is None else p


def _uniform_hwio(rng, c1: int, c2: int, k: int, g: int = 1) -> np.ndarray:
    """The JAX package's conv init: kaiming-uniform over the fan-in (c1 / g · k²), drawn as HWIO."""
    bound = (1.0 / (c1 // g * k * k)) ** 0.5 * 3.0**0.5
    return rng.uniform(-bound, bound, (k, k, c1 // g, c2)).astype(np.float32)


class BatchNorm(nn.Module):
    """The `bn` group of a ConvBNAct: γ and β to train, the running moments beside them."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def activate(y: torch.Tensor, act) -> torch.Tensor:
    """The named activation of a ConvBNAct (JAX's three): SiLU (the logistic in f32, rounded), ReLU (torch.maximum,
    whose gradient splits at a tie as JAX's does), GELU (tanh approximation, jax.nn.gelu's default); None leaves y
    as it is."""
    if act == "silu":
        return silu(y)
    if act == "relu":  # JAX's jnp.maximum(y, 0): at y == 0 exactly (a constant map after BN) half the gradient passes
        return torch.maximum(y, torch.zeros((), dtype=y.dtype, device=y.device))
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    return y


def act_name(name) -> str:
    """A yaml's `activation:` as JAX maps it: any name holding 'relu' is relu, 'gelu' gelu, anything else silu."""
    name = str(name).lower()
    return "relu" if "relu" in name else "gelu" if "gelu" in name else "silu"


class ConvBNAct(nn.Module):
    """Conv + BN + activation (JAX ConvBNAct): the fused inference form and the train form.

    `p` is the padding (None: k // 2), `g` the groups; `act` True takes `DEFAULT_ACT` (SiLU, or the activation
    a model yaml names while that model is built: nn/tasks.parse_model), a string pins 'silu', 'relu' or
    'gelu', False means none; `self.act` holds the name or None. A dilation raises NotImplementedError
    naming the 'Conv' module."""

    DEFAULT_ACT = "silu"

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None, g: int = 1, d: int = 1, act=True):
        super().__init__()
        if d != 1:
            raise NotImplementedError(f"module 'Conv' with dilation {d!r} is not ported yet")
        if act not in (True, False, None, "silu", "relu", "gelu"):
            raise NotImplementedError(f"module 'Conv' with activation {act!r} is not ported yet (the port's ConvBNAct "
                                      "ends in SiLU, ReLU, GELU or nothing)")
        act = ConvBNAct.DEFAULT_ACT if act is True else act or None
        self.c1, self.c2, self.k, self.s, self.p, self.g, self.act = c1, c2, k, s, autopad(k, p), g, act
        self.register_buffer("weight", torch.zeros(c2, c1 // g, k, k))
        self.register_buffer("bias", torch.zeros(c2))
        self.conv_weight = nn.Parameter(torch.zeros(c2, c1 // g, k, k))
        self.bn = BatchNorm(c2)
        self.batch_stats = None  # (mean, biased var, count) of the last training forward, held out of the gradient
        self.q = None  # the int8 form (nn/quantize.py) when load_jax took a quantized subtree
        self.eval_bn = None  # (running mean, scale, beta) in f32 when load_jax took an unfused subtree
        self.path = ""  # the JAX tree path ('model/3/cv1'), the key of its calibrated scales
        self.calib = None  # while `quantize.capture` runs on this model: the {path: amax} store
        self.record_bn = True  # cleared while a rematerialised layer is recomputed (`recording_bn`)

    def init(self, rng) -> dict:
        return {
            "conv": {"weight": _uniform_hwio(rng, self.c1, self.c2, self.k, self.g)},
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
        """The train-form conv + BN + activation in x's dtype. Training mode: the BN moments of
        the batch, taken in f32 over N, H and W (the scale rounded to x's dtype), kept
        in `batch_stats` for `utils.optim.apply_bn_stats`; eval mode: the running ones,
        exact in f32."""
        y = conv_nhwc(x, self.conv_weight, self.s, self.p, self.g)
        bn = self.bn
        if self.training:
            var, mean = torch.var_mean(y.float(), (0, 1, 2), correction=0)
            if self.record_bn:
                self.batch_stats = (mean.detach(), var.detach(), y.shape[0] * y.shape[1] * y.shape[2])
        else:
            mean, var, y = bn.running_mean, bn.running_var, y.float()
        scale = (bn.weight * torch.rsqrt(var + BN_EPS)).to(y.dtype)
        y = (y - mean.to(y.dtype)) * scale + bn.bias.to(y.dtype)
        return activate(y, self.act).to(x.dtype)

    def load_jax(self, p: dict, device, dtype) -> None:
        """The fused subtree ({conv: {weight, bias}}), its int8 form, or an unfused one ({conv, bn}: the groups
        that the JAX package's fuse leaves, PSABlock's `ffn`), which runs BN on the running moments in f32."""
        c = p["conv"]
        self.eval_bn = None
        if "bn" in p:
            bn = {k: _vec(v, device, torch.float32) for k, v in p["bn"].items()}
            self.eval_bn = (bn["running_mean"], bn["weight"] * torch.rsqrt(bn["running_var"] + BN_EPS), bn["bias"])
            c = {"weight": c["weight"], "bias": np.zeros(self.c2, np.float32)}
        if "w_int8" in c:
            self.q = load_int8(c, device, self.g)
            return
        self.q = None
        self.weight = _hwio_to_oihw(c["weight"], device, dtype)
        self.bias = _vec(c["bias"], device, dtype)

    def forward(self, x):
        if self.q is not None:
            return self._forward_int8(x)
        x = Q.deq(x, self.weight.dtype).to(self.weight.dtype)  # a quantized (or an f32) producer may feed the conv
        if self.calib is not None:
            Q.record(self.calib, self.path, x)
        if self.eval_bn is not None:  # an unfused group: JAX's exact f32 eval BN, the activation in f32, then rounded
            mean, scale, beta = self.eval_bn
            y = conv_nhwc(x, self.weight, self.s, self.p, self.g)
            y = (y.double() if y.dtype == torch.float64 else y.float()) - mean  # f64 stays (a reference forward)
            y = y * scale + beta
            return activate(y, self.act).to(x.dtype)
        y = activate(conv_nhwc(x, self.weight, self.s, self.p, self.g) + self.bias, self.act)
        if self.calib is not None:
            Q.record(self.calib, f"OUT::{self.path}", y)
        return y

    def _forward_int8(self, x):
        return int8_forward(self.q, x, self.k, self.s, self.p, self.g, self.c2, self.act, _dtype_of(self))


def load_int8(c: dict, device, groups: int) -> dict:
    """An int8 conv group of `quantize_params` ({w_int8, w_scale, bias, x_scale?, y_scale?}) on the device."""
    def scale(k):
        return None if c.get(k) is None else torch.tensor(float(np.float32(c[k])), dtype=torch.float32, device=device)

    return {"w": Q.weight_matrix(c["w_int8"], device, groups), "w_scale": _vec(c["w_scale"], device, torch.float32),
            "bias": _vec(c["bias"], device, torch.float32), "x_scale": scale("x_scale"), "y_scale": scale("y_scale")}


def int8_forward(q: dict, x, k: int, s: int, p: int, g: int, c2: int, act, dtype):
    """The int8 conv (JAX `ConvBNAct._call_int8`): a QTensor input rides in as it is, a dense one is quantized
    (static x_scale, else dynamic); int32 sums scaled by s_x · w_scale, bias and the activation in f32;
    requantized to a QTensor where a y_scale was calibrated, else rounded to the compute dtype `dtype`."""
    xq, sx = (x.q, x.s) if isinstance(x, Q.QTensor) else Q.quantize_input(x, q["x_scale"])
    y = Q.int8_conv(xq, q["w"], k, s, c2, p, g).float()
    y = y * (sx * q["w_scale"]) + q["bias"]
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act:
        y = activate(y, act)
    if q["y_scale"] is not None:
        return Q.QTensor(torch.clamp(torch.round(y / q["y_scale"]), -127, 127).to(torch.int8), q["y_scale"])
    return y.to(dtype)


@contextlib.contextmanager
def recording_bn(module: nn.Module, on: bool):
    """Whether the ConvBNActs inside `module` keep their BN batch moments (`batch_stats`) in
    training forwards while the block runs; a flag on each, so no other module changes."""
    convs = [c for c in module.modules() if hasattr(c, "record_bn")]  # ConvBNAct, RepConv, ConvTranspose
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
    """Two ConvBNAct (kernels `k`, the second with `g` groups) with an optional residual (JAX Bottleneck):
    3x3 and 3x3 with e=1.0 inside C2f and C2, 1x1 and 3x3 inside C3."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        k0, k1 = (kk[0] if isinstance(kk, (tuple, list)) else kk for kk in k)  # (kh, kw) pairs are square
        self.cv1 = ConvBNAct(c1, c_, k0, 1)
        self.cv2 = ConvBNAct(c_, c2, k1, 1, g=g)
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


class MaxPool2d(nn.Module):
    """Max-pool of an NHWC map (JAX MaxPool2d): padding `p` with -inf, the output size floored as torch's."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def init(self, rng) -> dict:
        return {}

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), self.k, self.s, self.p).permute(0, 2, 3, 1).contiguous()

    forward_train = forward


def _parts(container):
    """(tree key, module) of a ModuleList (keys 0, 1, ...) or a ModuleDict (its own keys), in order."""
    return container.items() if isinstance(container, nn.ModuleDict) else ((str(i), m) for i, m in enumerate(container))


def _subtree_init(m, rng) -> dict:
    """A module's JAX draws; a ModuleList or ModuleDict is a group keyed '0', '1', ... (or its own keys),
    drawn member by member in order (a head's `cv4`: level by level, each level's convs in turn)."""
    return {k: _subtree_init(c, rng) for k, c in _parts(m)} if isinstance(m, (nn.ModuleList, nn.ModuleDict)) else m.init(rng)


def _subtree_load(m, p: dict, device, dtype) -> None:
    """Load a JAX subtree as `_subtree_init` draws it."""
    if isinstance(m, (nn.ModuleList, nn.ModuleDict)):
        for k, c in _parts(m):
            _subtree_load(c, p[k], device, dtype)
    else:
        m.load_jax(p, device, dtype)


class _Tree(nn.Module):
    """A block whose JAX subtree is its children's, under the names in `tree_keys` and in that order: the
    order of the JAX `init` draws. A ModuleList or ModuleDict child is a group keyed '0', '1', ...; a child
    that is None has no group."""

    tree_keys: tuple = ()

    def _children(self):
        for name in self.tree_keys:
            m = getattr(self, name)
            if m is not None:
                yield name, m

    def init(self, rng) -> dict:
        return {name: _subtree_init(m, rng) for name, m in self._children()}

    def load_jax(self, p: dict, device, dtype) -> None:
        for name, m in self._children():
            _subtree_load(m, p[name], device, dtype)

    def forward_train(self, x):
        return self._run(x, True)

    def forward(self, x):
        return self._run(x, False)


def _call(m, x, train: bool):
    return m.forward_train(x) if train else m(x)


class C3(_Tree):
    """CSP bottleneck with 3 convs (JAX C3): cv1 then n bottlenecks (`bottleneck_k`, e=1.0), beside cv2,
    concatenated into cv3. Plain torch convs, as the JAX package computes it outside any kernel."""

    tree_keys = ("cv1", "cv2", "cv3", "m")

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 bottleneck_k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c1, c_, 1, 1)
        self.cv3 = ConvBNAct(2 * c_, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, g, k=bottleneck_k, e=1.0) for _ in range(n))

    def _run(self, x, train: bool):
        a = _call(self.cv1, x, train)
        for m in self.m:
            a = _call(m, a, train)
        return _call(self.cv3, torch.cat([a, _call(self.cv2, x, train)], -1), train)


class C2(_Tree):
    """CSP bottleneck with 2 convs (JAX C2): cv1 split in two halves, n 3x3 bottlenecks on the first,
    concatenated with the second into cv2. Plain torch convs, as the JAX package computes it outside any kernel."""

    tree_keys = ("cv1", "cv2", "m")

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct(2 * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n))

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        a, b = y[..., : self.c], y[..., self.c :]
        for m in self.m:
            a = _call(m, a, train)
        return _call(self.cv2, torch.cat([a, b], -1), train)


class DWConv(ConvBNAct):
    """Depth-wise ConvBNAct (JAX DWConv): gcd(c1, c2) groups."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class GhostConv(_Tree):
    """Ghost convolution (JAX GhostConv): a conv to c2 / 2 channels, then a cheap 5x5 depth-wise conv of
    it, both concatenated."""

    tree_keys = ("cv1", "cv2")

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.cv1 = ConvBNAct(c1, c_, k, s, None, g, act=act)
        self.cv2 = ConvBNAct(c_, c_, 5, 1, None, c_, act=act)

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        return torch.cat([y, _call(self.cv2, y, train)], -1)


class GhostBottleneck(_Tree):
    """GhostNet bottleneck (JAX GhostBottleneck): GhostConv, a depth-wise stride-2 conv where s = 2, GhostConv
    without activation, plus the input (s = 1) or its depth-wise and 1x1 shortcut (s = 2)."""

    tree_keys = ("conv", "shortcut")

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        conv = {"0": GhostConv(c1, c_, 1, 1)}
        if s == 2:
            conv["1"] = DWConv(c_, c_, k, s, act=False)
        conv["2"] = GhostConv(c_, c2, 1, 1, act=False)
        self.conv = nn.ModuleDict(conv)
        self.shortcut = nn.ModuleList([DWConv(c1, c1, k, s, act=False), ConvBNAct(c1, c2, 1, 1, act=False)]) if s == 2 else None

    def _run(self, x, train: bool):
        y = x
        for m in self.conv.values():
            y = _call(m, y, train)
        sc = x
        for m in self.shortcut or ():
            sc = _call(m, sc, train)
        return y + sc


class C3Ghost(C3):
    """C3 with GhostBottleneck inner blocks (JAX C3Ghost)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.ModuleList(GhostBottleneck(c_, c_) for _ in range(n))


class ResNetBlock(_Tree):
    """ResNet bottleneck block (JAX ResNetBlock): 1x1, 3x3 (stride s), 1x1 to e · c2 without activation, plus
    the input or its 1x1 (stride s) projection, joined by ReLU."""

    tree_keys = ("cv1", "cv2", "cv3", "shortcut")

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4, act=True):
        super().__init__()
        c3 = e * c2
        self.cv1 = ConvBNAct(c1, c2, 1, 1, act=act)
        self.cv2 = ConvBNAct(c2, c2, 3, s, 1, act=act)
        self.cv3 = ConvBNAct(c2, c3, 1, act=False)
        self.shortcut = nn.ModuleList([ConvBNAct(c1, c3, 1, s, act=False)]) if s != 1 or c1 != c3 else None

    def _run(self, x, train: bool):
        y = _call(self.cv3, _call(self.cv2, _call(self.cv1, x, train), train), train)
        sc = _call(self.shortcut[0], x, train) if self.shortcut is not None else x
        return torch.relu(y + sc)


class ResNetLayer(_Tree):
    """A stage of ResNet blocks, or the stem (a 7x7 stride-2 conv and a 3x3 stride-2 max-pool) where
    `is_first` (JAX ResNetLayer); the yaml's args are explicit [c1, c2, s, is_first, n]."""

    tree_keys = ("layer",)

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1, e: int = 4):
        super().__init__()
        self.is_first = is_first
        self.s_total = 4 if is_first else s
        if is_first:
            self.layer = nn.ModuleList([ConvBNAct(c1, c2, 7, 2, 3)])
            self.pool = MaxPool2d(3, 2, 1)
        else:
            self.layer = nn.ModuleList([ResNetBlock(c1, c2, s, e=e)] + [ResNetBlock(e * c2, c2, 1, e=e) for _ in range(n - 1)])

    def _run(self, x, train: bool):
        for m in self.layer:
            x = _call(m, x, train)
        return self.pool(x) if self.is_first else x


def _relu(x: torch.Tensor) -> torch.Tensor:
    """JAX's jnp.maximum(x, 0) (its gradient split at a tie, as torch.maximum's)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


class TVBasicBlock(_Tree):
    """torchvision's ResNet BasicBlock (JAX _TVBasicBlock): a 3x3 (stride s) conv with ReLU, a 3x3 conv, plus the
    input or its 1x1 (stride s) projection, joined by ReLU."""

    tree_keys = ("cv1", "cv2", "down")

    def __init__(self, c1: int, c2: int, s: int = 1):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c2, 3, s, 1, act="relu")
        self.cv2 = ConvBNAct(c2, c2, 3, 1, 1, act=False)
        self.down = ConvBNAct(c1, c2, 1, s, act=False) if s != 1 or c1 != c2 else None

    def _run(self, x, train: bool):
        y = _call(self.cv2, _call(self.cv1, x, train), train)
        return _relu(y + (_call(self.down, x, train) if self.down is not None else x))


class TorchVision(_Tree):
    """A torchvision ResNet backbone built in place (JAX TorchVision; yaml args [c2, model, weights, unwrap, truncate,
    split]): a 7x7 stride-2 ReLU stem, a 3x3 stride-2 max-pool, then the four stages of BasicBlocks (resnet18, 34) or
    bottleneck ResNetBlocks with ReLU (resnet50, 101). `weights` changes nothing (the weights come from `init` or a
    checkpoint, as in JAX); unwrap with truncate >= 2 returns the stride-32 map, otherwise its global mean as a 1x1
    map. Another model or `split=True` raises NotImplementedError, as in JAX."""

    tree_keys = ("stem", "stages")
    STAGES = {"resnet18": ([2, 2, 2, 2], False), "resnet34": ([3, 4, 6, 3], False),
              "resnet50": ([3, 4, 6, 3], True), "resnet101": ([3, 4, 23, 3], True)}

    def __init__(self, c2, model: str = "resnet18", weights="DEFAULT", unwrap: bool = True, truncate: int = 2,
                 split: bool = False):
        super().__init__()
        if model not in self.STAGES:
            raise NotImplementedError(
                f"TorchVision: only native ResNet backbones {sorted(self.STAGES)} are supported, got '{model}'")
        if split:
            raise NotImplementedError("TorchVision: split=True (multi-output) is not supported")
        depths, bottleneck = self.STAGES[model]
        self.pool_out = not (unwrap and truncate >= 2)
        self.s_total = 32
        self.stem = ConvBNAct(3, 64, 7, 2, 3, act="relu")
        self.pool = MaxPool2d(3, 2, 1)
        stages, c_in = [], 64
        for si, (n, width) in enumerate(zip(depths, (64, 128, 256, 512))):
            s = 1 if si == 0 else 2
            if bottleneck:
                blocks = [ResNetBlock(c_in, width, s, act="relu")] + [ResNetBlock(4 * width, width, 1, act="relu") for _ in range(n - 1)]
                c_in = 4 * width
            else:
                blocks = [TVBasicBlock(c_in, width, s)] + [TVBasicBlock(width, width, 1) for _ in range(n - 1)]
                c_in = width
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.c_out = c_in

    def _run(self, x, train: bool):
        x = self.pool(_call(self.stem, x, train))
        for blocks in self.stages:
            for b in blocks:
                x = _call(b, x, train)
        return x.mean(dim=(1, 2), keepdim=True) if self.pool_out else x


class LightConv(_Tree):
    """A 1x1 conv without activation, then a k x k depth-wise conv with ReLU (JAX LightConv)."""

    tree_keys = ("conv1", "conv2")

    def __init__(self, c1: int, c2: int, k: int = 1, act="relu"):
        super().__init__()
        self.conv1 = ConvBNAct(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=act)

    def _run(self, x, train: bool):
        return _call(self.conv2, _call(self.conv1, x, train), train)


class HGStem(_Tree):
    """PPHGNetV2's stem (JAX HGStem): a 3x3 stride-2 ReLU conv; padded by one row and column at the bottom and right,
    two 2x2 ReLU convs (padded again between them) beside a 2x2 stride-1 max-pool of the padded map; both
    concatenated into a 3x3 stride-2 conv, then a 1x1 (all ReLU). Its output is at stride 4."""

    tree_keys = ("stem1", "stem2a", "stem2b", "stem3", "stem4")

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBNAct(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBNAct(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = ConvBNAct(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = ConvBNAct(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = ConvBNAct(cm, c2, 1, 1, act="relu")

    def _run(self, x, train: bool):
        x = F.pad(_call(self.stem1, x, train), (0, 0, 0, 1, 0, 1))
        x2 = F.pad(_call(self.stem2a, x, train), (0, 0, 0, 1, 0, 1))
        x2 = _call(self.stem2b, x2, train)
        x1 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 1).permute(0, 2, 3, 1)
        x = _call(self.stem3, torch.cat([x1, x2], -1), train)
        return _call(self.stem4, x, train)


class HGBlock(_Tree):
    """PPHGNetV2's block (JAX HGBlock): n chained convs (k x k ReLU, or LightConv), the input and every output
    concatenated, squeezed by a 1x1 to c2 / 2 and excited by a 1x1 to c2 (both ReLU), plus the input where
    `shortcut` and c1 == c2."""

    tree_keys = ("m", "sc", "ec")

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, lightconv: bool = False, shortcut: bool = False):
        super().__init__()
        self.m = nn.ModuleList((LightConv(c1 if i == 0 else cm, cm, k=k) if lightconv else
                                ConvBNAct(c1 if i == 0 else cm, cm, k, act="relu")) for i in range(n))
        self.sc = ConvBNAct(c1 + n * cm, c2 // 2, 1, 1, act="relu")
        self.ec = ConvBNAct(c2 // 2, c2, 1, 1, act="relu")
        self.add = shortcut and c1 == c2
        self.c1, self.c2, self.k, self.n = c1, c2, k, n

    def _run(self, x, train: bool):
        ys = [x]
        for m in self.m:
            ys.append(_call(m, ys[-1], train))
        y = _call(self.ec, _call(self.sc, torch.cat(ys, -1), train), train)
        return y + x if self.add else y


class RepC3(_Tree):
    """CSP block of n RepConvs (JAX RepC3): cv1 through the RepConvs plus cv2, both 1x1 of the input, then cv3 (a
    1x1) where the hidden width differs from c2."""

    tree_keys = ("cv1", "cv2", "m", "cv3")

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c1, c_, 1, 1)
        self.m = nn.ModuleList(RepConv(c_, c_) for _ in range(n))
        self.cv3 = ConvBNAct(c_, c2, 1, 1) if c_ != c2 else None
        self.c1, self.c2, self.n = c1, c2, n

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        for m in self.m:
            y = _call(m, y, train)
        y = y + _call(self.cv2, x, train)
        return _call(self.cv3, y, train) if self.cv3 is not None else y


class C3k(C3):
    """C3 with k x k bottleneck kernels (JAX C3k)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, bottleneck_k=((k, k), (k, k)))


class C3k2(C2f):
    """A C2f whose blocks are C3k(c, c, 2) where `c3k`, else half-width 3x3 Bottlenecks (JAX C3k2). Always walked
    module by module: the C2f kernel takes full-width bottlenecks only, and the JAX package gates its C2f kernel
    on the exact type, so neither the kernel nor the neck fold ever sees a C3k2."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1, shortcut: bool = True):
        nn.Module.__init__(self)
        self.c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k else Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=0.5)
            for _ in range(n)
        )

    def forward(self, x, plain: bool = False):
        return self.forward_modules(x)


class C2fCIB(C2f):
    """A C2f whose blocks are CIBs (JAX C2fCIB; `lk` puts a RepVGGDW in each). Always walked module by module, as
    C3k2: the C2f kernel takes Bottleneck chains only, and the JAX package's neck fold matches the exact type C2f."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, g: int = 1, e: float = 0.5):
        nn.Module.__init__(self)
        self.c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))

    def forward(self, x, plain: bool = False):
        return self.forward_modules(x)


class Attention(_Tree):
    """Multi-head self-attention over the pixels of an NHWC map (JAX Attention): a 1x1 qkv conv whose channels are
    (heads, q | k | v), q·k in the input's dtype, the softmax in f32 rounded back, the values' weighted sum, a
    depth-wise 3x3 positional conv of v added, a 1x1 projection. The products are torch.matmul; JAX computes them
    outside any kernel."""

    tree_keys = ("qkv", "proj", "pe")

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        self.qkv = ConvBNAct(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 3, 1, g=dim, act=False)

    def _run(self, x, train: bool):
        B, H, W, C = x.shape
        kd = self.key_dim
        qkv = _call(self.qkv, x, train).reshape(B, H * W, self.num_heads, 2 * kd + self.head_dim)
        q, k, v = qkv[..., :kd].transpose(1, 2), qkv[..., kd : 2 * kd].transpose(1, 2), qkv[..., 2 * kd :]
        attn = torch.matmul(q, k.transpose(-1, -2)) * self.scale  # (B, heads, N, N)
        attn = torch.softmax(attn.float(), -1).to(q.dtype)
        out = torch.matmul(attn, v.transpose(1, 2)).transpose(1, 2).reshape(B, H, W, C)
        return _call(self.proj, out + _call(self.pe, v.reshape(B, H, W, C), train), train)


class PSABlock(_Tree):
    """Attention and a 1x1 conv feed-forward (2c wide), each with a residual (JAX PSABlock)."""

    tree_keys = ("attn", "ffn")

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.ModuleList([ConvBNAct(c, c * 2, 1), ConvBNAct(c * 2, c, 1, act=False)])
        self.add = shortcut

    def _run(self, x, train: bool):
        a = _call(self.attn, x, train)
        x = x + a if self.add else a
        f = _call(self.ffn[1], _call(self.ffn[0], x, train), train)
        return x + f if self.add else f


class C2PSA(_Tree):
    """CSP block around n PSABlocks (JAX C2PSA): cv1 split in halves, the blocks on the second, concat, cv2."""

    tree_keys = ("cv1", "cv2", "m")

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"C2PSA keeps its width: c1 {c1} != c2 {c2}")
        self.c = int(c1 * e)
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct(2 * self.c, c1, 1)
        self.m = nn.ModuleList(PSABlock(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1)) for _ in range(n))

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        a, b = y[..., : self.c], y[..., self.c :]
        for m in self.m:
            b = _call(m, b, train)
        return _call(self.cv2, torch.cat([a, b], -1), train)


class AAttn(_Tree):
    """Area attention (JAX AAttn): the pixels cut into `area` row strips, each attended on its own; a 1x1 qkv conv
    whose channels are (heads, q | k | v), every product and the softmax in f32, then a depth-wise 7x7 positional
    conv of v added in the input's dtype and a 1x1 projection. H · W must divide into the strips (ValueError)."""

    tree_keys = ("qkv", "proj", "pe")

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.dim, self.num_heads, self.area = dim, num_heads, area
        self.head_dim = dim // num_heads
        self.qkv = ConvBNAct(dim, dim * 3, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 7, 1, 3, g=dim, act=False)

    def _run(self, x, train: bool):
        B, H, W, C = x.shape
        N, h, hd = H * W, self.num_heads, self.head_dim
        Bn, Nn = B, N
        if self.area > 1:
            if N % self.area:
                raise ValueError(f"area attention cuts {H}x{W} = {N} pixels into {self.area} strips: {N} is not a multiple of {self.area}")
            Bn, Nn = B * self.area, N // self.area
        t = _call(self.qkv, x, train).reshape(Bn, Nn, h, 3 * hd).permute(0, 2, 1, 3).float()  # (Bn, h, Nn, 3hd)
        q, k, v = t[..., :hd], t[..., hd : 2 * hd], t[..., 2 * hd :]
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5, -1)  # (Bn, h, Nn, Nn)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(B, H, W, C).to(x.dtype)
        vv = v.transpose(1, 2).reshape(B, H, W, C).to(x.dtype)
        return _call(self.proj, y + _call(self.pe, vv, train), train)


class ABlock(_Tree):
    """Area attention and a 1x1 conv MLP (mlp_ratio wide), each with a residual (JAX ABlock)."""

    tree_keys = ("attn", "mlp")

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleList([ConvBNAct(dim, hidden, 1), ConvBNAct(hidden, dim, 1, act=False)])

    def _run(self, x, train: bool):
        x = x + _call(self.attn, x, train)
        return x + _call(self.mlp[1], _call(self.mlp[0], x, train), train)


class A2C2f(_Tree):
    """Area-attention C2f (JAX A2C2f): cv1, n stages of two ABlocks (`a2`) or one C3k each, every stage's output
    concatenated into cv2; with `residual` (a2 only) the input plus a trained per-channel `gamma` times the output,
    taken in f32 and rounded to the input's dtype (every consumer casts it so in JAX)."""

    tree_keys = ("cv1", "cv2", "m")

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0, e: float = 0.5, g: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError(f"A2C2f's hidden width {c_} is not a multiple of 32")
        self.c1, self.c2, self.n, self.a2, self.residual = c1, c2, n, a2, a2 and residual
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct((1 + n) * c_, c2, 1)
        if a2:
            self.m = nn.ModuleList(nn.ModuleList(ABlock(c_, c_ // 32, mlp_ratio, area) for _ in range(2)) for _ in range(n))
        else:
            self.m = nn.ModuleList(C3k(c_, c_, 2, shortcut, g) for _ in range(n))
        self.register_buffer("gamma", torch.zeros(c2) if self.residual else None)  # the inference form's
        self.gamma_train = nn.Parameter(torch.zeros(c2)) if self.residual else None

    def init(self, rng) -> dict:
        p = super().init(rng)
        if self.residual:
            p["gamma"] = np.full((self.c2,), 0.01, np.float32)
        return p

    def train_leaves(self) -> dict:
        return {"gamma": self.gamma_train} if self.residual else {}

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        if self.residual:
            self.gamma = _vec(p["gamma"], device, torch.float32)

    def _run(self, x, train: bool):
        ys = [_call(self.cv1, x, train)]
        for stage in self.m:
            z = ys[-1]
            for blk in stage if self.a2 else (stage,):
                z = _call(blk, z, train)
            ys.append(z)
        y = _call(self.cv2, torch.cat(ys, -1), train)
        if not self.residual:
            return y
        gamma = self.gamma_train if train else self.gamma
        return (x.float() + gamma.float() * y.float()).to(x.dtype)


class SCDown(_Tree):
    """Separable-conv downsample (JAX SCDown): a 1x1 ConvBNAct to c2, then a depth-wise k x k one of stride s
    without activation."""

    tree_keys = ("cv1", "cv2")

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        self.s = s
        self.cv1 = ConvBNAct(c1, c2, 1, 1)
        self.cv2 = ConvBNAct(c2, c2, k, s, g=c2, act=False)

    def _run(self, x, train: bool):
        return _call(self.cv2, _call(self.cv1, x, train), train)


class RepVGGDW(_Tree):
    """A depth-wise 7x7 and a depth-wise 3x3 (each with BN, no activation) summed in f32, then SiLU, rounded to the
    compute dtype (JAX RepVGGDW; the train form rounds to its input's dtype)."""

    tree_keys = ("conv", "conv1")

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBNAct(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = ConvBNAct(ed, ed, 3, 1, 1, g=ed, act=False)

    def _run(self, x, train: bool):
        dtype = x.dtype if train else _dtype_of(self)
        x = x if train else Q.deq(x, dtype)
        y = _call(self.conv, x, train).float() + _call(self.conv1, x, train).float()
        return (y * torch.sigmoid(y)).to(dtype)


class CIB(_Tree):
    """Compact inverted block (JAX CIB): five convs in a row under the tree key `cv1` (a depth-wise 3x3, a 1x1 to
    2c_, a depth-wise 3x3 or, with `lk`, a RepVGGDW, a 1x1 to c2, a depth-wise 3x3), with a residual when
    `shortcut` and c1 == c2 (dense where either side is int8, as Bottleneck's). The JAX package's fuse finds no
    module under `cv1` and leaves all five with their BN (nn/tasks.py::unfused_keys)."""

    tree_keys = ("cv1",)

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Seq(
            ConvBNAct(c1, c1, 3, g=c1),
            ConvBNAct(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBNAct(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBNAct(2 * c_, c2, 1),
            ConvBNAct(c2, c2, 3, g=c2),
        )
        self.add = shortcut and c1 == c2

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        if not self.add:
            return y
        if isinstance(x, Q.QTensor) or isinstance(y, Q.QTensor):
            return Q.deq(x, _dtype_of(self)) + Q.deq(y, _dtype_of(self))
        return x + y


class PSA(_Tree):
    """Position-sensitive attention (JAX PSA): cv1 split in halves, one Attention (max(c // 64, 1) heads) and the
    1x1 feed-forward `ffn` (2c wide, the second conv without activation) on the second half, each with a residual,
    concat, cv2. The JAX package's fuse leaves `ffn` with its BN, as PSABlock's."""

    tree_keys = ("cv1", "cv2", "attn", "ffn")

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"PSA keeps its width: c1 {c1} != c2 {c2}")
        self.c = int(c1 * e)
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct(2 * self.c, c1, 1)
        self.attn = Attention(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1))
        self.ffn = nn.ModuleList([ConvBNAct(self.c, self.c * 2, 1), ConvBNAct(self.c * 2, self.c, 1, act=False)])

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        a, b = y[..., : self.c], y[..., self.c :]
        b = b + _call(self.attn, b, train)
        b = b + _call(self.ffn[1], _call(self.ffn[0], b, train), train)
        return _call(self.cv2, torch.cat([a, b], -1), train)


class Seq(nn.Sequential):
    """Modules in a row whose JAX subtree is keyed '0', '1', ... (JAX _Seq, _SeqN): the depth-wise then 1x1 pairs of
    the non-legacy Detect class branch, RepNCSPELAN4's cv2 and cv3, and a yaml row repeated n times whose module
    takes no repeats of its own (yolov3's Bottleneck x8, yolov6's Conv x9)."""

    def init(self, rng) -> dict:
        return {k: m.init(rng) for k, m in self.named_children()}

    def load_jax(self, p: dict, device, dtype) -> None:
        for k, m in self.named_children():
            if hasattr(m, "load_jax"):  # a pool or a pad has no weights
                m.load_jax(p[k], device, dtype)

    def forward_train(self, x):
        for m in self:
            x = m.forward_train(x)
        return x


class Identity(nn.Module):
    """The input as it is (yaml nn.Identity: yolov9e's layer 0 aliases the image for a second stem)."""

    def init(self, rng) -> dict:
        return {}

    def forward(self, x):
        return x

    forward_train = forward


class ZeroPad2d(nn.Module):
    """Zero padding of an NHWC map (yaml nn.ZeroPad2d), in torch's (left, right, top, bottom) order; an int pads
    all four sides."""

    def __init__(self, padding):
        super().__init__()
        self.pad = list(padding) if isinstance(padding, (list, tuple)) else [padding] * 4

    def init(self, rng) -> dict:
        return {}

    def forward(self, x):
        l, r, t, b = self.pad
        return F.pad(x, (0, 0, l, r, t, b))

    forward_train = forward


def _max_pool(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """Max-pool of an NHWC map, padded with -inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s, p).permute(0, 2, 3, 1).contiguous()


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """The 2x2 stride-1 average of an NHWC map in f32, no padding (a map of 80 becomes 79), rounded back to x's
    dtype (JAX AConv._avgpool2)."""
    return F.avg_pool2d(x.float().permute(0, 3, 1, 2), 2, 1).permute(0, 2, 3, 1).to(x.dtype).contiguous()


class SPP(_Tree):
    """Spatial pyramid pooling with parallel kernels (JAX SPP): 1x1, max-pools of each k (stride 1, -inf
    padding) of its output, concat, 1x1."""

    tree_keys = ("cv1", "cv2")

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_ * (len(self.k) + 1), c2, 1, 1)

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        return _call(self.cv2, torch.cat([y] + [_max_pool(y, k, 1, k // 2) for k in self.k], -1), train)


class SPPELAN(_Tree):
    """SPP-ELAN (JAX SPPELAN): 1x1 to c3, three chained k x k max-pools (stride 1, -inf padding), concat, 1x1."""

    tree_keys = ("cv1", "cv5")

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.c, self.k = c3, k
        self.cv1 = ConvBNAct(c1, c3, 1, 1)
        self.cv5 = ConvBNAct(4 * c3, c2, 1, 1)

    def _run(self, x, train: bool):
        y = [_call(self.cv1, x, train)]
        for _ in range(3):
            y.append(_max_pool(y[-1], self.k, 1, self.k // 2))
        return _call(self.cv5, torch.cat(y, -1), train)


class NASBottleneck(_Tree):
    """Two ReLU 3x3 ConvBNActs with a residual scaled by a trained 0-d `alpha` (JAX NASBottleneck).

    The residual sum is f32: in JAX the f32 `alpha` promotes the bf16 maps, so a NASCSP's chain of bottlenecks
    stays f32 until the next conv rounds its input. Torch does not promote by a 0-d tensor, so the sum is cast
    here; `dtype` is the compute dtype the convs round their input to (default: the input's)."""

    tree_keys = ("cv1", "cv2")

    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c2, 3, 1, act="relu")
        self.cv2 = ConvBNAct(c2, c2, 3, 1, act="relu")
        self.add = shortcut and c1 == c2
        self.register_buffer("alpha", torch.ones(()) if self.add else None)  # the inference form's
        self.alpha_train = nn.Parameter(torch.ones(())) if self.add else None

    def init(self, rng) -> dict:
        p = super().init(rng)
        if self.add:
            p["alpha"] = np.ones((), np.float32)
        return p

    def train_leaves(self) -> dict:
        return {"alpha": self.alpha_train} if self.add else {}

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        if self.add:
            self.alpha = _vec(p["alpha"], device, torch.float32)

    def forward_train(self, x, dtype=None):
        return self._run(x, True, dtype)

    def forward(self, x, dtype=None):
        return self._run(x, False, dtype)

    def _run(self, x, train: bool, dtype=None):
        y = _call(self.cv2, _call(self.cv1, x.to(dtype or x.dtype), train), train)
        if not self.add:
            return y
        alpha = self.alpha_train if train else self.alpha
        return alpha.float() * x.float() + y.float()


class NASCSP(_Tree):
    """CSP layer over NASBottlenecks (JAX NASCSP): the C3 topology with ReLU convs; the bottlenecks' f32
    residual chain is rounded to the compute dtype (the input's) at cv3's input, as JAX's concat-then-conv does."""

    tree_keys = ("cv1", "cv2", "cv3", "m")

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1, act="relu")
        self.cv2 = ConvBNAct(c1, c_, 1, 1, act="relu")
        self.cv3 = ConvBNAct(2 * c_, c2, 1, act="relu")
        self.m = nn.ModuleList(NASBottleneck(c_, c_, shortcut) for _ in range(n))

    def _run(self, x, train: bool):
        a = _call(self.cv1, x, train)
        for m in self.m:
            a = m._run(a, train, x.dtype)
        return _call(self.cv3, torch.cat([a.to(x.dtype), _call(self.cv2, x, train)], -1), train)


class RepConv(nn.Module):
    """Re-parameterisable 3x3 conv (JAX RepConv): the train form sums a 3x3 + BN branch (`conv1`), a 1x1 + BN
    branch (`conv2`) and, with `bn` where c1 == c2 and s == 1, an identity BN of the input, in f32, then SiLU
    (`act`), rounded to the compute dtype. The inference form is one 3x3 conv (`nn.tasks.fuse` pads the 1x1 into
    it and folds the identity BN into its centre tap): the sum in the compute dtype, the bias added in f32, SiLU
    in f32, then rounded; an int8 tree runs the int8 conv without activation, then the same."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int = 1, g: int = 1, d: int = 1, act=True, bn: bool = False):
        super().__init__()
        if k != 3 or p != 1 or d != 1:
            raise ValueError(f"RepConv is a 3x3 conv padded 1 (k={k}, p={p}, d={d})")
        self.c1, self.c2, self.k, self.s, self.g, self.act = c1, c2, k, s, g, bool(act)
        self.has_id_bn = bn and c1 == c2 and s == 1
        self.conv1 = ConvBNAct(c1, c2, k, s, p=p, g=g, act=False)
        self.conv2 = ConvBNAct(c1, c2, 1, s, p=p - k // 2, g=g, act=False)
        self.bn = BatchNorm(c1) if self.has_id_bn else None
        self.register_buffer("weight", torch.zeros(c2, c1 // g, k, k))
        self.register_buffer("bias", torch.zeros(c2))  # f32
        self.q = None
        self.batch_stats = None  # the identity BN's, as a ConvBNAct's
        self.record_bn = True

    def init(self, rng) -> dict:
        p = {"conv1": self.conv1.init(rng), "conv2": self.conv2.init(rng)}
        if self.has_id_bn:
            p["bn"] = {"weight": np.ones(self.c1, np.float32), "bias": np.zeros(self.c1, np.float32),
                       "running_mean": np.zeros(self.c1, np.float32), "running_var": np.ones(self.c1, np.float32)}
        return p

    def train_leaves(self) -> dict:
        if self.bn is None:
            return {}
        bn = self.bn
        return {"bn/weight": bn.weight, "bn/bias": bn.bias, "bn/running_mean": bn.running_mean, "bn/running_var": bn.running_var}

    def load_jax(self, p: dict, device, dtype) -> None:
        if "conv" not in p:
            raise ValueError("RepConv.load_jax takes the fused tree ({conv: {weight, bias}}: nn.tasks.fuse)")
        c = p["conv"]
        if "w_int8" in c:
            self.q = load_int8(c, device, self.g)
            return
        self.q = None
        self.weight = _hwio_to_oihw(c["weight"], device, dtype)
        self.bias = _vec(c["bias"], device, torch.float32)

    def forward(self, x) -> torch.Tensor:
        dtype = _dtype_of(self)
        x = Q.deq(x, dtype)
        if self.q is not None:
            y = int8_forward(self.q, x, self.k, self.s, 1, self.g, self.c2, None, dtype).float()
        else:
            y = conv_nhwc(x.to(self.weight.dtype), self.weight, self.s, 1, self.g).float() + self.bias
        return (silu(y) if self.act else y).to(dtype)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1.forward_train(x).float() + self.conv2.forward_train(x).float()
        if self.bn is not None:
            bn, xf = self.bn, x.float()
            if self.training:
                var, mean = torch.var_mean(xf, (0, 1, 2), correction=0)
                if self.record_bn:
                    self.batch_stats = (mean.detach(), var.detach(), x.shape[0] * x.shape[1] * x.shape[2])
            else:
                mean, var = bn.running_mean, bn.running_var
            y = y + (xf - mean) * (bn.weight * torch.rsqrt(var + BN_EPS)) + bn.bias
        return (silu(y) if self.act else y).to(x.dtype)


class RepBottleneck(Bottleneck):
    """A Bottleneck whose first conv is a RepConv (JAX RepBottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__(c1, c2, shortcut, g, k, e)
        self.cv1 = RepConv(c1, int(c2 * e), 3, 1)


class RepCSP(C3):
    """C3 with RepBottleneck inner blocks (JAX RepCSP)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.ModuleList(RepBottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n))


class RepNCSPELAN4(_Tree):
    """GELAN block (JAX RepNCSPELAN4): cv1 to c3 split in halves, cv2 (a RepCSP then a 3x3) on the second half,
    cv3 (the same) on cv2's output, all four concatenated into cv4. Plain torch convs, as the JAX package
    computes it outside any kernel."""

    tree_keys = ("cv1", "cv2", "cv3", "cv4")

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = ConvBNAct(c1, c3, 1, 1)
        self.cv2 = Seq(RepCSP(c3 // 2, c4, n), ConvBNAct(c4, c4, 3, 1))
        self.cv3 = Seq(RepCSP(c4, c4, n), ConvBNAct(c4, c4, 3, 1))
        self.cv4 = ConvBNAct(c3 + 2 * c4, c2, 1, 1)

    def _run(self, x, train: bool):
        y = _call(self.cv1, x, train)
        parts = [y[..., : self.c], y[..., self.c :]]
        parts.append(_call(self.cv2, parts[-1], train))
        parts.append(_call(self.cv3, parts[-1], train))
        return _call(self.cv4, torch.cat(parts, -1), train)


class ELAN1(RepNCSPELAN4):
    """Light ELAN (JAX ELAN1): RepNCSPELAN4 with a single 3x3 ConvBNAct for each of cv2 and cv3."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        _Tree.__init__(self)
        self.c = c3 // 2
        self.cv1 = ConvBNAct(c1, c3, 1, 1)
        self.cv2 = ConvBNAct(c3 // 2, c4, 3, 1)
        self.cv3 = ConvBNAct(c4, c4, 3, 1)
        self.cv4 = ConvBNAct(c3 + 2 * c4, c2, 1, 1)


class AConv(_Tree):
    """Downsample (JAX AConv): the 2x2 stride-1 average in f32, rounded, then a 3x3 stride-2 conv padded 1."""

    tree_keys = ("cv1",)
    s = 2

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c2, 3, 2, 1)

    def _run(self, x, train: bool):
        return _call(self.cv1, _avg_pool2(x), train)


class ADown(_Tree):
    """Split downsample (JAX ADown): the 2x2 stride-1 average in f32, rounded; its first half through a 3x3
    stride-2 conv, its second through a 3x3 stride-2 max-pool (-inf padding 1) and a 1x1; concatenated."""

    tree_keys = ("cv1", "cv2")
    s = 2

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBNAct(c1 // 2, self.c, 3, 2, 1)
        self.cv2 = ConvBNAct(c1 // 2, self.c, 1, 1, 0)

    def _run(self, x, train: bool):
        x = _avg_pool2(x)
        half = x.shape[-1] // 2
        x1 = _call(self.cv1, x[..., :half], train)
        x2 = _call(self.cv2, _max_pool(x[..., half:], 3, 2, 1), train)
        return torch.cat([x1, x2], -1)


class CBLinear(nn.Module):
    """A biased conv without BN whose output is a list of channel groups `c2s` (JAX CBLinear): the sum in the
    compute dtype, the bias added in f32, rounded back; an int8 tree runs the int8 conv without activation."""

    def __init__(self, c1: int, c2s, k: int = 1, s: int = 1, p: int | None = None, g: int = 1):
        super().__init__()
        self.c1, self.c2s, self.k, self.s, self.p, self.g = c1, list(c2s), k, s, autopad(k, p), g
        c2 = sum(self.c2s)
        self.register_buffer("weight", torch.zeros(c2, c1 // g, k, k))
        self.register_buffer("bias", torch.zeros(c2))  # f32
        self.conv_weight = nn.Parameter(torch.zeros(c2, c1 // g, k, k))
        self.conv_bias = nn.Parameter(torch.zeros(c2))
        self.q = None

    def init(self, rng) -> dict:
        c2 = sum(self.c2s)
        fan_in = self.c1 // self.g * self.k * self.k
        w = _uniform_hwio(rng, self.c1, c2, self.k, self.g)
        b = (1.0 / fan_in) ** 0.5
        return {"conv": {"weight": w, "bias": rng.uniform(-b, b, (c2,)).astype(np.float32)}}

    def train_leaves(self) -> dict:
        return {"conv/weight": self.conv_weight, "conv/bias": self.conv_bias}

    def load_jax(self, p: dict, device, dtype) -> None:
        c = p["conv"]
        if "w_int8" in c:
            self.q = load_int8(c, device, self.g)
            return
        self.q = None
        self.weight = _hwio_to_oihw(c["weight"], device, dtype)
        self.bias = _vec(c["bias"], device, torch.float32)

    def _split(self, y: torch.Tensor) -> list:
        return list(torch.split(y, self.c2s, -1))

    def forward(self, x) -> list:
        dtype = _dtype_of(self)
        x = Q.deq(x, dtype)
        if self.q is not None:
            return self._split(int8_forward(self.q, x, self.k, self.s, self.p, self.g, sum(self.c2s), None, dtype))
        y = conv_nhwc(x.to(self.weight.dtype), self.weight, self.s, self.p, self.g).float() + self.bias
        return self._split(y.to(dtype))

    def forward_train(self, x: torch.Tensor) -> list:
        return self._split((conv_nhwc(x, self.conv_weight, self.s, self.p, self.g).float() + self.conv_bias).to(x.dtype))


class CBFuse(nn.Module):
    """The sum of one CBLinear split per source (`idx`), each repeated up to the last input's size (nearest, by
    integer factors), and that input, in f32, rounded to the last input's dtype (JAX CBFuse)."""

    def __init__(self, idx):
        super().__init__()
        self.idx = list(idx)

    def init(self, rng) -> dict:
        return {}

    def forward(self, xs):
        target = xs[-1]
        th, tw = target.shape[1], target.shape[2]
        total = target.float()
        for i, x in enumerate(xs[:-1]):
            t = x[self.idx[i]]
            h, w = t.shape[1], t.shape[2]
            if (h, w) != (th, tw):
                t = t.repeat_interleave(th // h, 1).repeat_interleave(tw // w, 2)
            total = total + t.float()
        return total.to(target.dtype)

    forward_train = forward


def dfl_project(box: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """DFL expectation over the last (reg_max) axis: softmax(box) · proj.

    box: (..., 4, reg_max) raw bin logits in the compute dtype; returns (..., 4)
    f32. As in the JAX package, the max-subtraction and exp stay in the
    compute dtype and the two sums and the divide run in f32."""
    e = torch.exp(box - box.amax(-1, keepdim=True)).float()
    return (e * proj.float()).sum(-1) / e.sum(-1)


def _branch_walk(branch, xs, train: bool) -> list:
    """Each level's input through its branch, in the train form or the inference form → per-level NHWC maps."""
    outs = []
    for level, x in zip(branch, xs):
        for m in level:
            x = m.forward_train(x) if train else m(x)
        outs.append(x)
    return outs


class Detect(nn.Module):
    """Anchor-free detect head with DFL box regression (JAX Detect). `legacy` (the v3/v5/v8 branches, where no row
    of the yaml names C3k2, A2C2f or C2fCIB) gives the class branch two 3x3 ConvBNActs, which the head kernels take;
    otherwise (yolo11, yolo12) each of its two convs is a depth-wise 3x3 then a 1x1 (`Seq`), and the head runs as
    plain convs and the DFL decode, as the JAX package's kernels take the legacy branches only."""

    def __init__(self, nc: int = 80, ch: tuple = (), legacy: bool = True):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = 16
        self.legacy = legacy
        self.stride = [8, 16, 32][: self.nl] if self.nl <= 3 else [4, 8, 16, 32]  # set from the graph at build
        c2 = max(16, ch[0] // 4, self.reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.ModuleList([ConvBNAct(x, c2, 3), ConvBNAct(c2, c2, 3), Conv2d(c2, 4 * self.reg_max, 1)]) for x in ch
        )
        if legacy:
            self.cv3 = nn.ModuleList(
                nn.ModuleList([ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3), Conv2d(c3, nc, 1)]) for x in ch
            )
        else:
            self.cv3 = nn.ModuleList(
                nn.ModuleList([Seq(DWConv(x, x, 3), ConvBNAct(x, c3, 1)), Seq(DWConv(c3, c3, 3), ConvBNAct(c3, c3, 1)),
                               Conv2d(c3, nc, 1)]) for x in ch
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

    @property
    def kernel_branches(self) -> bool:
        """Whether the head kernels take these branches: the legacy ones with SiLU convs. A ReLU head (yolov6,
        YOLO-NAS) walks conv by conv, as JAX's `predict` does (its merged first conv applies SiLU whatever the
        head's activation, ROADMAP §3)."""
        return self.legacy and all(m.act == "silu" for br in (self.cv2, self.cv3) for level in br for m in level[:2])

    def check_cm(self) -> None:
        """Whether the channel-major head kernel takes this head: ValueError for a non-legacy one (JAX asserts),
        NotImplementedError for a ReLU one (the kernel, as JAX's, is SiLU only)."""
        if not self.legacy:
            raise ValueError("the channel-major head kernel takes the legacy Detect branches only (pallas_head2=False)")
        if not self.kernel_branches:
            raise NotImplementedError(f"the channel-major head kernel (kernel 4) is SiLU only; this head's convs end in "
                                      f"{self.cv2[0][0].act} (pallas_head2=False walks them)")

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

    def _anchor_decode(self, dists, clss, feat_shapes, xywh: bool = True):
        """Per-level dist (B, A_l, 4) and scores (B, A_l, nc) → (boxes (B, A, 4) px xywh (xyxy unless `xywh`),
        scores (B, A, nc))."""
        from yolo_tpu_torch.ops.anchors import dist2bbox, make_anchors

        anchors, strides = make_anchors(feat_shapes, self.stride, 0.5, device=dists[0].device)
        dbox = dist2bbox(torch.cat(dists, 1), anchors[None], xywh=xywh, dim=-1) * strides[None]
        return dbox, torch.cat(clss, 1)

    def levels_from_outputs(self, outs):
        """The DFL expectation and the sigmoid scores of the raw per-level outputs → (dists [(B, HW, 4) f32],
        scores [(B, HW, nc) f32]), level by level: what `head_levels` computes through the kernel."""
        dists, clss = [], []
        for o in outs:
            B, H, W, _ = o.shape
            box = o[..., : self.reg_max * 4].reshape(B, H * W, 4, self.reg_max)
            dists.append(dfl_project(box, self.proj))
            clss.append(torch.sigmoid(o[..., self.reg_max * 4 :].reshape(B, H * W, self.nc).float()))
        return dists, clss

    def decode_parts(self, outs):
        """DFL decode of the raw per-level outputs → (boxes (B, A, 4) px xywh f32,
        scores (B, A, nc) f32 sigmoid), the anchors-major layout NMS consumes."""
        return self._anchor_decode(*self.levels_from_outputs(outs), [(o.shape[1], o.shape[2]) for o in outs])

    @staticmethod
    def pack(dbox: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        """Decode parts → (B, 4 + nc, A), the layout of `decode` and of `non_max_suppression`."""
        return torch.cat([dbox, cls], -1).transpose(1, 2)

    def decode(self, outs) -> torch.Tensor:
        """DFL decode of the raw per-level outputs → (B, 4 + nc, A): px xywh, then sigmoid scores."""
        return self.pack(*self.decode_parts(outs))

    def head_levels(self, xs, plain: bool = False):
        """Both branches + DFL per level from the head inputs (NHWC) through the head kernel (`plain`:
        its twin; a non-legacy or a ReLU head's branches conv by conv) → (dists [(B, HW, 4) f32], scores
        [(B, HW, nc) f32 sigmoid]), level by level."""
        if not self.kernel_branches:  # no kernel takes these branches: conv by conv, as JAX's `predict` walks them
            dists, clss = [], []
            for l, x in enumerate(xs):
                b, c = x, x
                for j in range(3):
                    b, c = self.cv2[l][j](b), self.cv3[l][j](c)
                B, H, W, _ = b.shape
                dists.append(dfl_project(b.reshape(B, H * W, 4, self.reg_max), self.proj))
                clss.append(torch.sigmoid(c.reshape(B, H * W, self.nc).float()))
            return dists, clss
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
        served: there is no tile width to fall back from. The legacy branches only (ValueError), as JAX asserts."""
        self.check_cm()
        fn = cuda_head_cm.head_level_cm_plain if plain else cuda_head_cm.head_level_cm
        dists, clss = zip(*(fn(x, self.kernel_weights(l)) for l, x in enumerate(xs)))
        return self._anchor_decode(dists, clss, [(x.shape[1], x.shape[2]) for x in xs])


class v10Detect(Detect):
    """The end-to-end (NMS-free) head of yolov10 (JAX v10Detect): Detect's box branch and depth-wise class branch
    (c3 = max(ch[0], min(nc, 100))), the one-to-many pair, beside deep copies of both, `one2one_cv2` /
    `one2one_cv3`, with the same bias priors. Training returns (one-to-many outputs, one-to-one outputs), the
    one-to-one branch on detached inputs (only the one-to-many loss shapes the body); inference decodes the
    one-to-one branch into the (B, max_det, 6) rows of `decode_end2end`. Its branches are walked conv by conv."""

    end2end = True

    def __init__(self, nc: int = 80, ch: tuple = (), legacy: bool = False, max_det: int = 300):
        super().__init__(nc, ch, legacy=False)
        self.max_det = max_det
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    @property
    def kernel_branches(self) -> bool:
        return False

    def check_cm(self) -> None:
        raise ValueError("the channel-major head kernel takes the legacy Detect branches only (pallas_head2=False)")

    def init(self, rng) -> dict:
        """Detect's draws and priors, then each level's one-to-one box convs and class convs in turn, and their
        priors."""
        p = super().init(rng)
        p["one2one_cv2"], p["one2one_cv3"] = {}, {}
        for l in range(self.nl):
            p["one2one_cv2"][str(l)] = {str(j): self.one2one_cv2[l][j].init(rng) for j in range(3)}
            p["one2one_cv3"][str(l)] = {str(j): self.one2one_cv3[l][j].init(rng) for j in range(3)}
        for l, s in enumerate(self.stride):
            p["one2one_cv2"][str(l)]["2"]["bias"] = np.ones_like(np.asarray(p["one2one_cv2"][str(l)]["2"]["bias"]))
            p["one2one_cv3"][str(l)]["2"]["bias"] = np.full_like(np.asarray(p["one2one_cv3"][str(l)]["2"]["bias"]),
                                                                 math.log(5 / self.nc / (640 / s) ** 2))
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        for l in range(self.nl):
            for j in range(3):
                self.one2one_cv2[l][j].load_jax(p["one2one_cv2"][str(l)][str(j)], device, dtype)
                self.one2one_cv3[l][j].load_jax(p["one2one_cv3"][str(l)][str(j)], device, dtype)

    def one2one(self, xs, train: bool = False) -> list:
        """Per-level raw outputs (B, H, W, 4*reg_max + nc) of the one-to-one branches."""
        outs = []
        for l, x in enumerate(xs):
            b, c = x, x
            for j in range(3):
                b, c = _call(self.one2one_cv2[l][j], b, train), _call(self.one2one_cv3[l][j], c, train)
            outs.append(torch.cat([b, c], -1))
        return outs

    def forward_train(self, xs):
        return super().forward_train(xs), self.one2one([x.detach() for x in xs], train=True)

    def decode_end2end(self, xs) -> torch.Tensor:
        """The one-to-one branch's (B, k, 6) rows, k = min(max_det, anchors): xyxy px boxes, score, class (f32),
        by JAX's two-stage top-k: the k anchors of the best class scores, then the k best of their k x nc
        (anchor, class) pairs. Ties keep the earlier index, as `jax.lax.top_k` does (a stable sort)."""
        outs = self.one2one(xs)
        dists, clss = self.levels_from_outputs(outs)
        boxes, scores = self._anchor_decode(dists, clss, [(o.shape[1], o.shape[2]) for o in outs], xywh=False)
        B, A, nc = scores.shape
        k = min(self.max_det, A)
        top = torch.sort(scores.max(-1).values, dim=1, descending=True, stable=True).indices[:, :k]
        b_sel = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 4))
        s_sel = torch.gather(scores, 1, top[..., None].expand(-1, -1, nc)).reshape(B, k * nc)
        flat_scores, flat_idx = torch.sort(s_sel, dim=1, descending=True, stable=True)
        flat_scores, flat_idx = flat_scores[:, :k], flat_idx[:, :k]
        b_final = torch.gather(b_sel, 1, torch.div(flat_idx, nc, rounding_mode="floor")[..., None].expand(-1, -1, 4))
        return torch.cat([b_final, flat_scores[..., None], (flat_idx % nc).to(torch.float32)[..., None]], -1)


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

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: tuple = (), legacy: bool = True):
        super().__init__(nc, ch, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, nm, 1)]) for x in ch)

    def init(self, rng) -> dict:
        """Detect's draws and bias priors, then the proto's (cv1, upsample, cv2, cv3), then cv4 level by level."""
        p = super().init(rng)
        p["proto"] = self.proto.init(rng)
        p["cv4"] = _subtree_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        self.proto.load_jax(p["proto"], device, dtype)
        _subtree_load(self.cv4, p["cv4"], device, dtype)

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

    def __init__(self, nc: int = 80, kpt_shape: tuple = (17, 3), ch: tuple = (), legacy: bool = True):
        super().__init__(nc, ch, legacy)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, self.nk)
        self.cv4 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, self.nk, 1)]) for x in ch)

    def init(self, rng) -> dict:
        """Detect's draws and bias priors, then cv4 level by level."""
        p = super().init(rng)
        p["cv4"] = _subtree_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        _subtree_load(self.cv4, p["cv4"], device, dtype)

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

    def __init__(self, nc: int = 80, ne: int = 1, ch: tuple = (), legacy: bool = True):
        super().__init__(nc, ch, legacy)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, ne, 1)]) for x in ch)

    def init(self, rng) -> dict:
        """Detect's draws and bias priors, then cv4 level by level."""
        p = super().init(rng)
        p["cv4"] = _subtree_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        _subtree_load(self.cv4, p["cv4"], device, dtype)

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
        self.c2 = c2
        self.conv = ConvBNAct(c1, self.c_, k, s, p, g)
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
