"""The RT-DETR transformer stack as PyTorch modules (counterpart of yolo_tpu/nn/transformer.py).

Linear, LayerNorm, MultiheadAttention (bool and additive masks), MLP, AIFI (one post-norm encoder layer over
the stride-32 map with 2-D sincos positions), the bilinear grid sample, MSDeformAttn, the deformable decoder
layer and the RTDETRDecoder head: input projections, anchors, the encoder heads, query selection by a stable
top-k, the decoder loop (eval stops at `eval_idx`; train returns every layer's boxes and scores, the
contrastive-denoising queries prepended where the model sets `dn`).

As in the JAX package, every product and norm of these modules runs in f32 whatever the compute dtype (in f64 where the
model is loaded in f64, the reference forward); AIFI rounds back to the input's dtype at its end, the decoder returns
f32 (f64). None of them has a hand-written kernel:
the JAX package leaves them to XLA (no Pallas call), the port to plain torch (matmul, softmax,
`F.grid_sample`).

Each module keeps two forms of its weights, as the conv modules do (nn/modules.py): the inference form
(f32 buffers that `load_jax` fills from a JAX subtree) and the train form (f32 parameters named by
`train_leaves()` after their JAX tree path), so that a validation of the EMA tree never overwrites the
weights being trained. `init(rng)` draws the JAX package's initial subtree with the same numpy calls in the
same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.nn.modules import ConvBNAct, _relu, _vec

LN_EPS = 1e-5


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 where it is f64 already (a model loaded in f64: the reference forward)."""
    return x if x.dtype == torch.float64 else x.float()


def _store(v, device, dtype) -> torch.Tensor:
    """A weight of the inference form: f32, or f64 where the model loads in f64."""
    return _vec(v, device, torch.float64 if dtype == torch.float64 else torch.float32)


def _pair(shape) -> tuple:
    """(an inference buffer, a train parameter) of `shape`, both f32 zeros."""
    return torch.zeros(shape), nn.Parameter(torch.zeros(shape))


class Linear(nn.Module):
    """nn.Linear with the weight in torch's (out, in) layout, as the JAX tree holds it; f32 products."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True):
        super().__init__()
        self.c_in, self.c_out, self.has_bias = c_in, c_out, bias
        w, self.train_weight = _pair((c_out, c_in))
        self.register_buffer("weight", w)
        b, tb = _pair((c_out,))
        self.register_buffer("bias", b if bias else None)
        self.train_bias = tb if bias else None

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.c_in)
        p = {"weight": rng.uniform(-bound, bound, (self.c_out, self.c_in)).astype(np.float32)}
        if self.has_bias:
            p["bias"] = rng.uniform(-bound, bound, (self.c_out,)).astype(np.float32)
        return p

    def train_leaves(self) -> dict:
        return {"weight": self.train_weight, **({"bias": self.train_bias} if self.has_bias else {})}

    def load_jax(self, p: dict, device, dtype=None) -> None:
        self.weight = _store(p["weight"], device, dtype)
        if self.has_bias:
            self.bias = _store(p["bias"], device, dtype)

    def run(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        w, b = (self.train_weight, self.train_bias) if train else (self.weight, self.bias)
        y = _wide(x) @ w.t()
        return y + b if b is not None else y


class LayerNorm(nn.Module):
    """nn.LayerNorm over the last axis (eps 1e-5), in f32: the biased variance, as JAX's."""

    def __init__(self, c: int):
        super().__init__()
        self.c = c
        w, self.train_weight = _pair((c,))
        b, self.train_bias = _pair((c,))
        self.register_buffer("weight", w)
        self.register_buffer("bias", b)

    def init(self, rng) -> dict:
        return {"weight": np.ones((self.c,), np.float32), "bias": np.zeros((self.c,), np.float32)}

    def train_leaves(self) -> dict:
        return {"weight": self.train_weight, "bias": self.train_bias}

    def load_jax(self, p: dict, device, dtype=None) -> None:
        self.weight = _store(p["weight"], device, dtype)
        self.bias = _store(p["bias"], device, dtype)

    def run(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        w, b = (self.train_weight, self.train_bias) if train else (self.weight, self.bias)
        x = _wide(x)
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + LN_EPS) * w + b


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention (batch first) under torch's parameter names (in_proj_weight, in_proj_bias, out_proj),
    in f32. A bool mask blocks where True (-inf before the softmax); another dtype is added to the logits."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.c, self.h, self.hd = c, num_heads, c // num_heads
        w, self.train_in_w = _pair((3 * c, c))
        b, self.train_in_b = _pair((3 * c,))
        self.register_buffer("in_proj_weight", w)
        self.register_buffer("in_proj_bias", b)
        self.out_proj = Linear(c, c)

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.c)
        return {
            "in_proj_weight": rng.uniform(-bound, bound, (3 * self.c, self.c)).astype(np.float32),
            "in_proj_bias": np.zeros((3 * self.c,), np.float32),
            "out_proj": {
                "weight": rng.uniform(-bound, bound, (self.c, self.c)).astype(np.float32),
                "bias": np.zeros((self.c,), np.float32),
            },
        }

    def train_leaves(self) -> dict:
        return {"in_proj_weight": self.train_in_w, "in_proj_bias": self.train_in_b}

    def load_jax(self, p: dict, device, dtype=None) -> None:
        self.in_proj_weight = _store(p["in_proj_weight"], device, dtype)
        self.in_proj_bias = _store(p["in_proj_bias"], device, dtype)
        self.out_proj.load_jax(p["out_proj"], device, dtype)

    def run(self, q, k, v, attn_mask=None, train: bool = False) -> torch.Tensor:
        C, h, hd = self.c, self.h, self.hd
        w, b = (self.train_in_w, self.train_in_b) if train else (self.in_proj_weight, self.in_proj_bias)
        qp = _wide(q) @ w[:C].t() + b[:C]
        kp = _wide(k) @ w[C : 2 * C].t() + b[C : 2 * C]
        vp = _wide(v) @ w[2 * C :].t() + b[2 * C :]
        B, Nq, _ = qp.shape
        Nk = kp.shape[1]
        qp = qp.reshape(B, Nq, h, hd).transpose(1, 2)
        kp = kp.reshape(B, Nk, h, hd).transpose(1, 2)
        vp = vp.reshape(B, Nk, h, hd).transpose(1, 2)
        attn = (qp @ kp.transpose(-1, -2)) / math.sqrt(hd)
        if attn_mask is not None:
            attn = attn.masked_fill(attn_mask, float("-inf")) if attn_mask.dtype == torch.bool else attn + attn_mask
        y = (torch.softmax(attn, -1) @ vp).transpose(1, 2).reshape(B, Nq, C)
        return self.out_proj.run(y, train)


class MLP(nn.Module):
    """Linear layers with ReLU between them, a sigmoid at the end if asked."""

    def __init__(self, c_in: int, hidden: int, c_out: int, num_layers: int, sigmoid: bool = False):
        super().__init__()
        h = [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip([c_in] + h, h + [c_out]))
        self.sigmoid = sigmoid

    def init(self, rng) -> dict:
        return {"layers": {str(i): m.init(rng) for i, m in enumerate(self.layers)}}

    def load_jax(self, p: dict, device, dtype=None) -> None:
        for i, m in enumerate(self.layers):
            m.load_jax(p["layers"][str(i)], device, dtype)

    def run(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        n = len(self.layers)
        for i, m in enumerate(self.layers):
            x = m.run(x, train)
            if i < n - 1:
                x = _relu(x)
        return torch.sigmoid(x) if self.sigmoid else x


class AIFI(nn.Module):
    """One post-norm transformer encoder layer over an NHWC map with 2-D sincos positions (JAX AIFI): attention,
    add and norm, an exact-GELU FFN, add and norm, in f32; the output rounded to the input's dtype."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.c1, self.cm = c1, cm
        self.ma = MultiheadAttention(c1, num_heads)
        self.fc1 = Linear(c1, cm)
        self.fc2 = Linear(cm, c1)
        self.norm1 = LayerNorm(c1)
        self.norm2 = LayerNorm(c1)
        self._pos = {}

    def init(self, rng) -> dict:
        return {k: getattr(self, k).init(rng) for k in ("ma", "fc1", "fc2", "norm1", "norm2")}

    def load_jax(self, p: dict, device, dtype=None) -> None:
        for k in ("ma", "fc1", "fc2", "norm1", "norm2"):
            getattr(self, k).load_jax(p[k], device, dtype)

    @staticmethod
    def pos_embed_2d(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
        """The (1, w·h, dim) sincos embedding, flattened w-major as the reference does (JAX `pos_embed_2d`)."""
        grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
        pos_dim = dim // 4
        omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
        out_w = grid_w.flatten()[:, None] @ omega[None]
        out_h = grid_h.flatten()[:, None] @ omega[None]
        return np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], 1)[None]

    def _run(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        B, H, W, C = x.shape
        src = _wide(x.reshape(B, H * W, C))
        key = (W, H, C, x.device, src.dtype)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(self.pos_embed_2d(W, H, C)).to(x.device, src.dtype)
        q = src + self._pos[key]
        src = self.norm1.run(src + self.ma.run(q, q, src, train=train), train)
        src2 = self.fc2.run(F.gelu(self.fc1.run(src, train)), train)
        src = self.norm2.run(src + src2, train)
        return src.reshape(B, H, W, C).to(x.dtype)

    def forward(self, x):
        return self._run(x, False)

    def forward_train(self, x):
        return self._run(x, True)


def grid_sample_bilinear(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """F.grid_sample (bilinear, zero padding, align_corners=False) on NHWC maps, as JAX's four-corner gather:
    value (B, H, W, D), grid (B, Nq, P, 2) (x, y) in [-1, 1] → (B, Nq, P, D)."""
    out = F.grid_sample(value.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (JAX MSDeformAttn): per head, level and point a learned offset around each
    query's reference point (2 values: scaled by the level's size; 4, an xywh box: by half its size over the
    points), bilinear samples of the projected values there, weighted by a softmax over levels and points."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d, self.nl, self.nh, self.np_ = d_model, n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    _KEYS = ("sampling_offsets", "attention_weights", "value_proj", "output_proj")

    def init(self, rng) -> dict:
        p = {k: getattr(self, k).init(rng) for k in self._KEYS}
        p["sampling_offsets"]["weight"][:] = 0.0  # the reference's _reset_parameters: a ring of offsets in the bias
        thetas = np.arange(self.nh, dtype=np.float32) * (2.0 * math.pi / self.nh)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid.reshape(self.nh, 1, 1, 2), (1, self.nl, self.np_, 1))
        for i in range(self.np_):
            grid[:, :, i, :] *= i + 1
        p["sampling_offsets"]["bias"] = grid.reshape(-1).astype(np.float32)
        p["attention_weights"]["weight"][:] = 0.0
        p["attention_weights"]["bias"][:] = 0.0
        for name in ("value_proj", "output_proj"):  # xavier-uniform
            w = p[name]["weight"]
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[-1]))
            p[name]["weight"] = rng.uniform(-bound, bound, w.shape).astype(np.float32)
            p[name]["bias"][:] = 0.0
        return p

    def load_jax(self, p: dict, device, dtype=None) -> None:
        for k in self._KEYS:
            getattr(self, k).load_jax(p[k], device, dtype)

    def run(self, query, refer_bbox, value, value_shapes, train: bool = False) -> torch.Tensor:
        """query (B, Nq, C); refer_bbox (B, Nq, nl or 1, 2 or 4) in [0, 1]; value (B, ΣHW, C)."""
        B, Nq = query.shape[:2]
        Nv = value.shape[1]
        nh, nl, npts = self.nh, self.nl, self.np_
        hd = self.d // nh
        v = self.value_proj.run(value, train).reshape(B, Nv, nh, hd)
        off = self.sampling_offsets.run(query, train).reshape(B, Nq, nh, nl, npts, 2)
        aw = self.attention_weights.run(query, train).reshape(B, Nq, nh, nl * npts)
        aw = torch.softmax(aw, -1).reshape(B, Nq, nh, nl, npts)
        if refer_bbox.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in value_shapes], dtype=off.dtype, device=query.device)
            loc = refer_bbox[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]
        else:
            loc = refer_bbox[:, :, None, :, None, :2] + off / npts * refer_bbox[:, :, None, :, None, 2:] * 0.5
        grids = 2 * loc - 1  # (B, Nq, nh, nl, npts, 2)
        start, sampled = 0, []
        for lvl, (H, W) in enumerate(value_shapes):
            vl = v[:, start : start + H * W].permute(0, 2, 1, 3).reshape(B * nh, H, W, hd)
            start += H * W
            g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * nh, Nq, npts, 2)
            sampled.append(grid_sample_bilinear(vl, g))  # (B·nh, Nq, npts, hd)
        s = torch.stack(sampled, 2)  # (B·nh, Nq, nl, npts, hd)
        w = aw.permute(0, 2, 1, 3, 4).reshape(B * nh, Nq, nl, npts, 1)
        out = (s * w).sum((2, 3)).reshape(B, nh, Nq, hd).permute(0, 2, 1, 3).reshape(B, Nq, self.d)
        return self.output_proj.run(out, train)


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each added and normed (JAX's)."""

    _KEYS = ("self_attn", "cross_attn", "norm1", "norm2", "norm3", "linear1", "linear2")

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024, n_levels: int = 4, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)

    def init(self, rng) -> dict:
        return {k: getattr(self, k).init(rng) for k in self._KEYS}

    def load_jax(self, p: dict, device, dtype=None) -> None:
        for k in self._KEYS:
            getattr(self, k).load_jax(p[k], device, dtype)

    def run(self, embed, refer_bbox, feats, shapes, attn_mask=None, query_pos=None, train: bool = False):
        q = embed + query_pos if query_pos is not None else embed
        embed = self.norm1.run(embed + self.self_attn.run(q, q, embed, attn_mask=attn_mask, train=train), train)
        q = embed + query_pos if query_pos is not None else embed
        embed = self.norm2.run(embed + self.cross_attn.run(q, refer_bbox[:, :, None], feats, shapes, train), train)
        tgt2 = self.linear2.run(_relu(self.linear1.run(embed, train)), train)
        return self.norm3.run(embed + tgt2, train)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class ProjConv(ConvBNAct):
    """An input projection of the decoder: a 1x1 conv without bias, BN, no activation, under the JAX tree's
    torch names (`0` the conv, `1` the BN). The JAX package's fuse leaves it unfolded (no module of the decoder
    is named `input_proj`), so the inference form runs its BN on the running moments in f32, as ConvBNAct does
    for an unfused group."""

    def __init__(self, c1: int, c2: int):
        super().__init__(c1, c2, 1, act=False)

    def init(self, rng) -> dict:
        p = super().init(rng)
        return {"0": p["conv"], "1": p["bn"]}

    def train_leaves(self) -> dict:
        bn = self.bn
        return {"0/weight": self.conv_weight, "1/weight": bn.weight, "1/bias": bn.bias,
                "1/running_mean": bn.running_mean, "1/running_var": bn.running_var}

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax({"conv": p["0"], "bn": p["1"]}, device, dtype)


class Embedding(nn.Module):
    """The denoising class embedding table (nc, hd): only the train form reads it."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.train_weight = nn.Parameter(torch.zeros(n, d))

    def train_leaves(self) -> dict:
        return {"weight": self.train_weight}


class RTDETRDecoder(nn.Module):
    """The RT-DETR head (JAX RTDETRDecoder): each level projected to `hd` (a 1x1 conv and BN) and flattened;
    anchors per level (log-odds of their xywh, `inf` where a coordinate lies within 0.01 of the border); the
    encoder's output head over the features of valid anchors; the `nq` anchors of the highest class score
    selected (a stable top-k: among equal scores the earlier index, as jax.lax.top_k); `ndl` deformable decoder
    layers refining the selected boxes. Eval: (B, nq, 4 + nc) f32, normalized xywh boxes and sigmoid scores
    of layer `eval_idx`. Train (`forward_train`): (boxes (ndl, B, Q, 4), logits (ndl, B, Q, nc), the encoder's
    selected boxes (B, nq, 4) and logits (B, nq, nc)), Q = nq plus the denoising queries that `dn` (a dict of
    dn_cls, dn_bbox, dn_valid and attn_mask, set by the model) prepends."""

    def __init__(self, nc: int = 80, ch=(512, 1024, 2048), hd: int = 256, nq: int = 300, ndp: int = 4, nh: int = 8,
                 ndl: int = 6, d_ffn: int = 1024, eval_idx: int = -1):
        super().__init__()
        self.nc, self.ch, self.hd, self.nq, self.ndl = nc, tuple(ch), hd, nq, ndl
        self.nl = len(ch)
        self.eval_idx = eval_idx if eval_idx >= 0 else ndl + eval_idx
        self.input_proj = nn.ModuleList(ProjConv(c, hd) for c in ch)
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            DeformableTransformerDecoderLayer(hd, nh, d_ffn, self.nl, ndp) for _ in range(ndl))})
        self.denoising_class_embed = Embedding(nc, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.ModuleList([Linear(hd, hd), LayerNorm(hd)])
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))
        self.stride = [8, 16, 32][: self.nl] if self.nl <= 3 else [8, 16, 32, 64][: self.nl]
        self.dn = None
        self._anchors = {}

    @property
    def layers(self):
        return self.decoder["layers"]

    def init(self, rng) -> dict:
        """The JAX package's draws, in its order: the decoder layers, the denoising embedding, the query position
        head, the encoder heads, the decoder heads, then the input projections; the class biases at the prior
        -log((1 - 0.01) / 0.01) / 80 · nc, the last box layers zero."""
        p = {
            "input_proj": {},
            "decoder": {"layers": {str(i): m.init(rng) for i, m in enumerate(self.layers)}},
            "denoising_class_embed": {"weight": rng.normal(0, 1, (self.nc, self.hd)).astype(np.float32)},
            "query_pos_head": self.query_pos_head.init(rng),
            "enc_output": {"0": self.enc_output[0].init(rng), "1": self.enc_output[1].init(rng)},
            "enc_score_head": self.enc_score_head.init(rng),
            "enc_bbox_head": self.enc_bbox_head.init(rng),
            "dec_score_head": {str(i): m.init(rng) for i, m in enumerate(self.dec_score_head)},
            "dec_bbox_head": {str(i): m.init(rng) for i, m in enumerate(self.dec_bbox_head)},
        }
        for i, m in enumerate(self.input_proj):
            p["input_proj"][str(i)] = m.init(rng)
        bias_cls = float(-np.log((1 - 0.01) / 0.01)) / 80 * self.nc
        p["enc_score_head"]["bias"][:] = bias_cls
        p["enc_bbox_head"]["layers"]["2"]["weight"][:] = 0.0
        p["enc_bbox_head"]["layers"]["2"]["bias"][:] = 0.0
        for i in range(self.ndl):
            p["dec_score_head"][str(i)]["bias"][:] = bias_cls
            p["dec_bbox_head"][str(i)]["layers"]["2"]["weight"][:] = 0.0
            p["dec_bbox_head"][str(i)]["layers"]["2"]["bias"][:] = 0.0
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        for i, m in enumerate(self.input_proj):
            m.load_jax(p["input_proj"][str(i)], device, dtype)
        for i, m in enumerate(self.layers):
            m.load_jax(p["decoder"]["layers"][str(i)], device, dtype)
        self.query_pos_head.load_jax(p["query_pos_head"], device, dtype)
        self.enc_output[0].load_jax(p["enc_output"]["0"], device, dtype)
        self.enc_output[1].load_jax(p["enc_output"]["1"], device, dtype)
        self.enc_score_head.load_jax(p["enc_score_head"], device, dtype)
        self.enc_bbox_head.load_jax(p["enc_bbox_head"], device, dtype)
        for i in range(self.ndl):
            self.dec_score_head[i].load_jax(p["dec_score_head"][str(i)], device, dtype)
            self.dec_bbox_head[i].load_jax(p["dec_bbox_head"][str(i)], device, dtype)

    def anchors(self, shapes, device, grid_size: float = 0.05, eps: float = 1e-2):
        """(log-odds anchors (1, ΣHW, 4) with `inf` at invalid ones, valid (1, ΣHW, 1) f32) of the levels' shapes,
        made with numpy as JAX's `_generate_anchors` makes them, cached per shapes and device."""
        key = (tuple(shapes), device)
        if key not in self._anchors:
            out = []
            for i, (h, w) in enumerate(shapes):
                gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
                xy = (np.stack([gx, gy], -1) + 0.5) / np.array([w, h], np.float32)
                wh = np.ones_like(xy) * grid_size * (2.0**i)
                out.append(np.concatenate([xy, wh], -1).reshape(1, h * w, 4))
            a = np.concatenate(out, 1)
            valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                a = np.where(valid, np.log(a / (1 - a)), np.inf).astype(np.float32)
            self._anchors[key] = (torch.from_numpy(a).to(device), torch.from_numpy(valid.astype(np.float32)).to(device))
        return self._anchors[key]

    def encode(self, xs, train: bool):
        """The levels projected and flattened → (feats (B, ΣHW, hd) f32, shapes [(H, W)])."""
        feats, shapes = [], []
        for m, x in zip(self.input_proj, xs):
            f = m.forward_train(x) if train else m(x)
            B, H, W, C = f.shape
            feats.append(f.reshape(B, H * W, C))
            shapes.append((H, W))
        return _wide(torch.cat(feats, 1)), shapes

    def select(self, feats, shapes, train: bool, ind=None):
        """Query selection → (top features (B, nq, hd), reference logits (B, nq, 4), encoder scores (B, ΣHW, nc),
        the selected indices (B, nq)). `ind` (B, nq) takes those anchors in place of the top-k: a reference forward
        held against another forward's rows decodes the same queries."""
        if feats.shape[1] < self.nq:  # jax.lax.top_k fails there too
            raise ValueError(f"RT-DETR selects {self.nq} queries from {feats.shape[1]} anchors: the input is too small")
        anchors, valid = (a.to(feats.dtype) for a in self.anchors(shapes, feats.device))
        features = self.enc_output[1].run(self.enc_output[0].run(valid * feats, train), train)
        enc_scores = self.enc_score_head.run(features, train)
        # a stable descending sort: among equal scores the earlier anchor first (jax.lax.top_k's order; the
        # invalid anchors' features are zeroed, so all of them share one score)
        if ind is None:
            ind = torch.sort(enc_scores.max(-1).values, dim=-1, descending=True, stable=True).indices[:, : self.nq]
        top_feats = torch.gather(features, 1, ind[..., None].expand(-1, -1, features.shape[-1]))
        refer_bbox = self.enc_bbox_head.run(top_feats, train) + anchors[0][ind]
        return top_feats, refer_bbox, enc_scores, ind

    @torch.no_grad()
    def forward(self, xs, ind=None) -> torch.Tensor:
        feats, shapes = self.encode(xs, False)
        embed, refer_bbox, _, _ = self.select(feats, shapes, False, ind)
        refer = torch.sigmoid(refer_bbox)
        for i, layer in enumerate(self.layers):
            qp = self.query_pos_head.run(refer, False)
            embed = layer.run(embed, refer, feats, shapes, query_pos=qp)
            refined = torch.sigmoid(self.dec_bbox_head[i].run(embed, False) + inverse_sigmoid(refer))
            if i == self.eval_idx:
                scores = self.dec_score_head[i].run(embed, False)
                return torch.cat([refined, torch.sigmoid(scores)], -1)
            refer = refined
        raise AssertionError("eval_idx out of range")

    def forward_train(self, xs):
        feats, shapes = self.encode(xs, True)
        top_feats, refer_bbox, enc_scores, topk_ind = self.select(feats, shapes, True)
        enc_bboxes = torch.sigmoid(refer_bbox)
        enc_sel = torch.gather(enc_scores, 1, topk_ind[..., None].expand(-1, -1, enc_scores.shape[-1]))
        refer_bbox, embed = refer_bbox.detach(), top_feats.detach()
        attn_mask = None
        if self.dn is not None:
            dn = self.dn
            dn_embed = self.denoising_class_embed.train_weight[dn["dn_cls"].long()] * dn["dn_valid"][..., None].to(embed.dtype)
            embed = torch.cat([dn_embed.to(embed.dtype), embed], 1)
            refer_bbox = torch.cat([dn["dn_bbox"].to(refer_bbox.dtype), refer_bbox], 1)
            attn_mask = dn["attn_mask"]
        refer = torch.sigmoid(refer_bbox)
        out, dec_bboxes, dec_scores, last = embed, [], [], None
        for i, layer in enumerate(self.layers):
            qp = self.query_pos_head.run(refer, True)
            out = layer.run(out, refer, feats, shapes, attn_mask=attn_mask, query_pos=qp, train=True)
            bbox = self.dec_bbox_head[i].run(out, True)
            refined = torch.sigmoid(bbox + inverse_sigmoid(refer))
            dec_scores.append(self.dec_score_head[i].run(out, True))
            dec_bboxes.append(refined if i == 0 else torch.sigmoid(bbox + inverse_sigmoid(last)))
            last = refined
            refer = refined.detach()
        return torch.stack(dec_bboxes), torch.stack(dec_scores), enc_bboxes, enc_sel
