"""Post-training int8 quantization for inference (counterpart of yolo_tpu/nn/quantize.py).

- Weights: symmetric per-output-channel int8 (`w_int8` HWIO + `w_scale` (K,)), BN folded
  first; convs with fewer than `min_channels` outputs, and convs without a bias (the DFL),
  stay float. `quantize_params` is the JAX package's numpy transform, so both packages
  build the same tree from the same weights and scales.
- Activations: a dynamic symmetric per-tensor scale at each conv input, or, with
  `act_scales` from `calibrate_act_scales`, a static `x_scale` per conv and a `y_scale`
  where the conv may emit int8 (`QTensor`): the int8-resident flow through split, concat,
  upsample and max-pool. Static activations quantize in bf16, as the JAX package does.
- The int8 conv (`int8_conv`) is an im2col of the int8 map into `torch._int_mm`,
  int8 x int8 → int32, exact. An f32 conv of integer-valued tensors is not: a 3x3 conv
  over 192 channels sums up to 1728 · 127² ≈ 2.8e7 > 2^24.

`predict(int8=True)` (dynamic scales) and `FusedDetectTrack(int8=True, int8_calib=frames)`
(static scales and the int8 flow) run it; neither runs the C2f or head kernels, as no
Pallas kernel of the JAX package takes int8. The NMS kernel runs on both.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class QTensor(NamedTuple):
    """An int8-resident activation: int8 NHWC payload `q` and its 0-d f32 scale `s` (x ≈ q · s)."""

    q: torch.Tensor
    s: torch.Tensor


def deq(x, dtype):
    """QTensor → a dense map in `dtype` (q and s each cast first, as in the JAX package); other maps pass through."""
    if isinstance(x, QTensor):
        return x.q.to(dtype) * x.s.to(dtype)
    return x


def qconcat(xs, dtype):
    """Channel concat of QTensors and maps. All QTensors: each is rescaled to the largest
    scale in bf16 (round(q · (s / s_max)), clipped to ±127) and the result stays int8;
    a mix is dequantized to `dtype` first."""
    if xs and all(isinstance(x, QTensor) for x in xs):
        s = xs[0].s
        for x in xs[1:]:
            s = torch.maximum(s, x.s)
        parts = []
        for x in xs:
            r = (x.s / s).to(torch.bfloat16)
            parts.append(torch.clamp(torch.round(x.q.to(torch.bfloat16) * r), -127, 127).to(torch.int8))
        return QTensor(torch.cat(parts, -1), s)
    return torch.cat([deq(x, dtype) for x in xs], -1)


def quantize_input(x, x_scale):
    """A dense map → (int8 codes, 0-d f32 scale): with a static `x_scale`, round(x · 1/s) in bf16;
    without, the dynamic symmetric per-tensor scale max|x| / 127 (at least 1e-8 / 127) in f32."""
    if x_scale is not None:
        inv = (1.0 / x_scale).to(torch.bfloat16)
        return torch.clamp(torch.round(x.to(torch.bfloat16) * inv), -127, 127).to(torch.int8), x_scale
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def weight_matrix(w_int8: np.ndarray, device, groups: int = 1) -> torch.Tensor:
    """HWIO int8 weight → the (K, N) int8 matrix `int8_conv` multiplies by, rows in (u, v, c) order,
    K and N zero-padded to multiples of 16 (the card's int8 GEMM wants 16-byte leading dimensions; exact).
    A grouped conv's weight stays OIHW (`int8_conv` convolves it grouped)."""
    if groups > 1:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(w_int8, np.int8).transpose(3, 2, 0, 1))).to(device)
    kh, kw, cin, cout = w_int8.shape
    m = np.zeros((_ceil(kh * kw * cin, 16), _ceil(cout, 16)), np.int8)
    m[: kh * kw * cin, :cout] = np.asarray(w_int8, np.int8).reshape(kh * kw * cin, cout)
    return torch.from_numpy(m).to(device)


def int8_conv(xq: torch.Tensor, w: torch.Tensor, k: int, s: int, cout: int, p: int | None = None, g: int = 1) -> torch.Tensor:
    """Conv (padding `p`, default k // 2) of an int8 NHWC map with a `weight_matrix` → int32 NHWC (B, Ho, Wo,
    cout): the im2col of zero-padded strided views, then `torch._int_mm`, int8 x int8 → int32, exact (zero
    rows and columns pad M, K and N to what the card's int8 GEMM takes). A grouped conv (`g` > 1, an OIHW
    weight) is an f64 conv of the codes, exact as well (its sums stay far below 2^53), rounded to int32."""
    p = k // 2 if p is None else p
    if g > 1:
        y = F.conv2d(xq.permute(0, 3, 1, 2).double(), w.double(), None, s, p, 1, g)
        return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)
    B = xq.shape[0]
    if p:
        xq = F.pad(xq, (0, 0, p, p, p, p))
    cols = xq.unfold(1, k, s).unfold(2, k, s)  # (B, Ho, Wo, C, ku, kv)
    Ho, Wo, C = cols.shape[1], cols.shape[2], cols.shape[3]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(B * Ho * Wo, k * k * C)
    M, K = cols.shape
    Kp = w.shape[0]
    Mp = _ceil(M, 32)  # the H100's int8 GEMM refused M = 17-48 and 1040 at N >= 32; multiples of 32 it takes
    if Kp != K or Mp != M:
        cols = F.pad(cols, (0, Kp - K, 0, Mp - M))
    y = torch._int_mm(cols.contiguous(), w)
    return y[:M, :cout].reshape(B, Ho, Wo, cout)


def _quantize_conv(conv: dict) -> dict:
    """{'weight' (H, W, I, K) f32, 'bias' (K,)} → int8 + per-channel scales."""
    w = np.asarray(conv["weight"], np.float32)
    k = w.shape[-1]
    scale = np.abs(w).reshape(-1, k).max(0) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    w_int8 = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {
        "w_int8": w_int8,
        "w_scale": scale,
        "bias": np.asarray(conv.get("bias", np.zeros((k,), np.float32)), np.float32),
    }


def quantize_params(params, min_channels: int = 16, act_scales: dict | None = None, int8_flow: bool = True,
                    flow_paths: set | None = None):
    """Every fused ConvBNAct leaf ({'conv': {weight, bias}} without 'bn') with at least
    `min_channels` outputs becomes an int8 conv; with `act_scales` it also gets a static
    `x_scale`, and a `y_scale` (the int8-resident flow) where `int8_flow` is on and its path
    is in `flow_paths` (`DetectionModel.int8_flow_paths()`). Run `fuse` first: an unfused
    tree is left float. The JAX package's transform, line for line."""

    def walk(node, path=""):
        if not isinstance(node, dict):
            return node
        if "conv" in node and isinstance(node["conv"], dict) and "weight" in node["conv"] and "bn" not in node:
            w = np.asarray(node["conv"]["weight"])
            if w.ndim == 4 and "bias" in node["conv"] and w.shape[-1] >= min_channels:
                out = dict(node)
                out["conv"] = _quantize_conv(node["conv"])
                if act_scales and path in act_scales:
                    out["conv"]["x_scale"] = np.float32(max(act_scales[path], 1e-12))
                if int8_flow and act_scales and f"OUT::{path}" in act_scales and (flow_paths is None or path in flow_paths):
                    out["conv"]["y_scale"] = np.float32(max(act_scales[f"OUT::{path}"], 1e-12))
                return out
        return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}

    return walk(params)


def params_are_fused_float(params) -> bool:
    """True when no conv of the tree still carries a BN group or an int8 weight: the
    precondition of the neck fold and of the kernels."""
    if not isinstance(params, dict):
        return True
    if "bn" in params or ("conv" in params and isinstance(params["conv"], dict) and "w_int8" in params["conv"]):
        return False
    return all(params_are_fused_float(v) for v in params.values())


@contextlib.contextmanager
def capture(model, store: dict):
    """While the block runs, every ConvBNAct of `model` records max |input| under its path and
    max |output| under 'OUT::<path>' (f32 0-d tensors) in `store`; other models are untouched."""
    from yolo_tpu_torch.nn.modules import ConvBNAct

    convs = [m for m in model.modules() if isinstance(m, ConvBNAct)]
    for m in convs:
        m.calib = store
    try:
        yield store
    finally:
        for m in convs:
            m.calib = None


def record(store: dict, path: str, t: torch.Tensor) -> None:
    amax = t.float().abs().amax()
    store[path] = torch.maximum(store[path], amax) if path in store else amax


@torch.no_grad()
def calibrate_act_scales(model, params, imgs, dtype=None) -> dict:
    """One representative batch (B, H, W, C) float in [0, 1] through the float model in
    `dtype` (bf16 by default, as in the JAX package), every layer materialised and every
    conv module by module → {path: amax / 127} of each ConvBNAct input, and {'OUT::path':
    amax / 127} of each output. `model` is not changed (a copy carries the tree)."""
    import copy

    from yolo_tpu_torch.nn.tasks import params_from_jax

    dtype = dtype or torch.bfloat16
    m = copy.deepcopy(model)
    params_from_jax(m, params, dtype)
    x = torch.as_tensor(np.asarray(imgs, np.float32)).to(m.device, dtype)
    store = {}
    guide = m._prompts(x) if hasattr(m, "_prompts") else None  # a World or YOLOE model's class prompts
    with capture(m, store):
        xs, _ = m._walk(x, plain=True, neck_opt=False, guide=guide)
        m.head(xs) if guide is None else m.head(xs, guide)
    return {k: float(v) / 127.0 for k, v in store.items()}
