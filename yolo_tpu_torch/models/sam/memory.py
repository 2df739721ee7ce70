"""SAM2's video memory stack (counterpart of yolo_tpu/models/sam/memory.py).

- Positional encodings: `get_1d_sine_pe`, `sine_pos_embed_2d`, the axial RoPE angles and
  `apply_rotary` on real pairs (JAX's choice: no complex dtype).
- `RoPEAttention` with `num_k_exclude_rope` (object-pointer keys never rotated) and a key
  mask: the bank's empty slots are masked out (-1e9 before the softmax), which equals the
  reference's variable-length concatenation.
- `MemoryAttention`, `MaskDownSampler`, `CXBlock`, `MemoryEncoder`: NHWC, in the weights' dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.models.sam.modules import LayerNorm, Linear, _Conv, _ones, _zeros, conv_nhwc, gelu

NEG_INF = -1e9


def get_1d_sine_pe(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """(...,) positions → (..., dim) sine / cosine embedding (JAX :39)."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=pos.dtype, device=pos.device)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pe = pos[..., None] / dim_t
    return torch.cat([torch.sin(pe), torch.cos(pe)], -1)


def sine_pos_embed_2d(h: int, w: int, channels: int, temperature: float = 10000.0, scale: float = 2 * math.pi):
    """(h, w, channels) normalised 2-D sine embedding, concat(pos_y, pos_x), numpy f32 (JAX :48)."""
    npf = channels // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(npf, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / npf)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


def axial_rope_angles(head_dim: int, end_x: int, end_y: int, theta: float = 10000.0) -> np.ndarray:
    """(end_x·end_y, head_dim/2) rotation angles of the axial 2-D RoPE (JAX :68)."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4)[: head_dim // 4].astype(np.float32) / head_dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x, t_y = t % end_x, np.floor(t / end_x)
    return np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)], axis=-1)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Consecutive pairs of the last dim rotated by `angles`; x (B, nH, L, hd), angles (L, hd/2) (JAX :80)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    re, im = x2[..., 0], x2[..., 1]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.stack([re * cos - im * sin, re * sin + im * cos], -1).reshape(x.shape)


class RoPEAttention(nn.Module):
    """Attention with axial RoPE on the query grid `feat_hw` (JAX :99); with `rope_k_repeat` the keys' angles are
    the grid's, tiled along the memory; the last `num_k_exclude_rope` keys are not rotated."""

    def __init__(self, embedding_dim, num_heads, downsample_rate=1, kv_in_dim=None, rope_theta=10000.0,
                 rope_k_repeat=False, feat_hw=(64, 64)):
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.nh = num_heads
        kv_in = kv_in_dim if kv_in_dim is not None else embedding_dim
        self.q_proj = Linear(embedding_dim, self.internal_dim)
        self.k_proj = Linear(kv_in, self.internal_dim)
        self.v_proj = Linear(kv_in, self.internal_dim)
        self.out_proj = Linear(self.internal_dim, embedding_dim)
        self.rope_k_repeat = rope_k_repeat
        hd = self.internal_dim // num_heads
        self.angles_np = axial_rope_angles(hd, feat_hw[1], feat_hw[0], rope_theta)

    def init(self, rng) -> dict:
        return {k: getattr(self, k).init(rng) for k in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def forward(self, q, k, v, num_k_exclude_rope: int = 0, key_mask=None):
        """q (B, Lq, Dq); k / v (B, Lk, Dkv); key_mask (B, Lk) bool, True = attend."""
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        hd = self.internal_dim // self.nh
        q = self.q_proj(q).reshape(B, Lq, self.nh, hd).transpose(1, 2)
        k = self.k_proj(k).reshape(B, Lk, self.nh, hd).transpose(1, 2)
        v = self.v_proj(v).reshape(B, Lk, self.nh, hd).transpose(1, 2)
        angles = torch.from_numpy(self.angles_np).to(q.device, q.dtype)
        if angles.shape[0] != Lq:
            raise ValueError(f"RoPE grid {angles.shape[0]} != query length {Lq}")
        q = apply_rotary(q, angles)
        num_k_rope = Lk - num_k_exclude_rope
        if num_k_rope == Lq and not self.rope_k_repeat:
            k_ang = angles
        else:
            if not (self.rope_k_repeat and num_k_rope % Lq == 0):
                raise ValueError(f"{num_k_rope} rotated keys do not tile the {Lq}-token query grid")
            k_ang = angles.repeat(num_k_rope // Lq, 1)
        k_rot = apply_rotary(k[:, :, :num_k_rope], k_ang)
        k = torch.cat([k_rot, k[:, :, num_k_rope:]], 2) if num_k_exclude_rope else k_rot
        attn = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, None, :], attn, torch.full_like(attn, NEG_INF))
        attn = torch.softmax(attn, -1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, Lq, self.internal_dim))


class MemoryAttentionLayer(nn.Module):
    """Self-attention, cross-attention to the memory (its positions on the keys), the ReLU FFN (JAX :155)."""

    def __init__(self, d_model=256, dim_feedforward=2048, mem_dim=64, feat_hw=(64, 64)):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, 1, feat_hw=feat_hw)
        self.cross_attn_image = RoPEAttention(d_model, 1, kv_in_dim=mem_dim, rope_k_repeat=True, feat_hw=feat_hw)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1, self.norm2, self.norm3 = LayerNorm(d_model), LayerNorm(d_model), LayerNorm(d_model)

    def init(self, rng) -> dict:
        d = self.linear1.c_in

        def ln():
            return {"weight": _ones(d), "bias": _zeros(d)}

        return {"self_attn": self.self_attn.init(rng), "cross_attn_image": self.cross_attn_image.init(rng),
                "linear1": self.linear1.init(rng), "linear2": self.linear2.init(rng),
                "norm1": ln(), "norm2": ln(), "norm3": ln()}

    def forward(self, tgt, memory, pos, query_pos, num_k_exclude_rope=0, key_mask=None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(t2, memory + pos, memory, num_k_exclude_rope=num_k_exclude_rope,
                                          key_mask=key_mask)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(torch.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    """The layers on curr + 0.1 · curr_pos, then a final norm (JAX :201)."""

    def __init__(self, d_model=256, num_layers=4, dim_feedforward=2048, mem_dim=64, feat_hw=(64, 64)):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(d_model, dim_feedforward, mem_dim, feat_hw)
                                    for _ in range(num_layers))
        self.d_model = d_model
        self.norm = LayerNorm(d_model)

    def init(self, rng) -> dict:
        return {"layers": {str(i): layer.init(rng) for i, layer in enumerate(self.layers)},
                "norm": {"weight": _ones(self.d_model), "bias": _zeros(self.d_model)}}

    def forward(self, curr, memory, curr_pos, memory_pos, num_obj_ptr_tokens=0, key_mask=None):
        """curr (B, L, C); memory (B, S, mem_dim); key_mask (B, S) True = attend."""
        out = curr + 0.1 * curr_pos
        for layer in self.layers:
            out = layer(out, memory, memory_pos, curr_pos, num_k_exclude_rope=num_obj_ptr_tokens, key_mask=key_mask)
        return self.norm(out)


class MaskDownSampler(nn.Module):
    """Stride-16 mask embedder: (conv s2, LayerNorm2d, GELU) x4, then a 1x1 (JAX :243)."""

    def __init__(self, embed_dim=256, kernel_size=3, stride=2, padding=1, total_stride=16):
        super().__init__()
        self.ks, self.stride, self.pad = kernel_size, stride, padding
        self.num_layers = int(math.log2(total_stride) // math.log2(stride))
        self.chans = [1]
        for _ in range(self.num_layers):
            self.chans.append(self.chans[-1] * stride**2)
        self.embed_dim = embed_dim
        enc = {}
        for i in range(self.num_layers):
            enc[str(3 * i)] = _Conv(self.chans[i], self.chans[i + 1], kernel_size)
            enc[str(3 * i + 1)] = LayerNorm(self.chans[i + 1], 1e-6)
        enc[str(3 * self.num_layers)] = _Conv(self.chans[-1], embed_dim, 1)
        self.encoder = nn.ModuleDict(enc)

    def init(self, rng) -> dict:
        p = {"encoder": {}}
        for i in range(self.num_layers):
            cin, cout = self.chans[i], self.chans[i + 1]
            bound = math.sqrt(1.0 / (cin * self.ks * self.ks))
            p["encoder"][str(3 * i)] = {
                "weight": rng.uniform(-bound, bound, (self.ks, self.ks, cin, cout)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}
            p["encoder"][str(3 * i + 1)] = {"weight": _ones(cout), "bias": _zeros(cout)}
        bound = math.sqrt(1.0 / self.chans[-1])
        p["encoder"][str(3 * self.num_layers)] = {
            "weight": rng.uniform(-bound, bound, (1, 1, self.chans[-1], self.embed_dim)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (self.embed_dim,)).astype(np.float32)}
        return p

    def forward(self, x):
        enc = self.encoder
        for i in range(self.num_layers):
            c = enc[str(3 * i)]
            x = gelu(enc[str(3 * i + 1)](conv_nhwc(x, c.weight, c.bias, self.stride, self.pad)))
        c = enc[str(3 * self.num_layers)]
        return conv_nhwc(x, c.weight, c.bias)


class CXBlock(nn.Module):
    """ConvNeXt block on NHWC (JAX :286)."""

    def __init__(self, dim=256, kernel_size=7, padding=3):
        super().__init__()
        self.dim, self.ks, self.pad = dim, kernel_size, padding
        self.dwconv = _Conv(dim, dim, kernel_size, groups=dim)
        self.norm = LayerNorm(dim, 1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim), requires_grad=False)

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / (self.ks * self.ks))  # depthwise: fan_in 1·k·k
        return {
            "dwconv": {"weight": rng.uniform(-bound, bound, (self.ks, self.ks, 1, self.dim)).astype(np.float32),
                       "bias": rng.uniform(-bound, bound, (self.dim,)).astype(np.float32)},
            "norm": {"weight": _ones(self.dim), "bias": _zeros(self.dim)},
            "pwconv1": self.pwconv1.init(rng),
            "pwconv2": self.pwconv2.init(rng),
            "gamma": 1e-6 * np.ones((self.dim,), np.float32),
        }

    def forward(self, x):
        y = self.norm(conv_nhwc(x, self.dwconv.weight, self.dwconv.bias, padding=self.pad, groups=self.dim))
        return x + self.gamma * self.pwconv2(gelu(self.pwconv1(y)))


class _Fuser(nn.Module):
    def __init__(self, dim, n):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim=dim) for _ in range(n))


class MemoryEncoder(nn.Module):
    """Pixel features + a predicted mask → (memory features, their sine positions) (JAX :310)."""

    def __init__(self, out_dim=64, in_dim=256):
        super().__init__()
        self.out_dim, self.in_dim = out_dim, in_dim
        self.mask_downsampler = MaskDownSampler(embed_dim=in_dim, kernel_size=3, stride=2, padding=1)
        self.pix_feat_proj = _Conv(in_dim, in_dim, 1)
        self.fuser = _Fuser(in_dim, 2)
        if out_dim != in_dim:
            self.out_proj = _Conv(in_dim, out_dim, 1)

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.in_dim)
        p = {
            "mask_downsampler": self.mask_downsampler.init(rng),
            "pix_feat_proj": {"weight": rng.uniform(-bound, bound, (1, 1, self.in_dim, self.in_dim)).astype(np.float32),
                              "bias": rng.uniform(-bound, bound, (self.in_dim,)).astype(np.float32)},
            "fuser": {"layers": {str(i): layer.init(rng) for i, layer in enumerate(self.fuser.layers)}},
        }
        if self.out_dim != self.in_dim:
            p["out_proj"] = {"weight": rng.uniform(-bound, bound, (1, 1, self.in_dim, self.out_dim)).astype(np.float32),
                             "bias": rng.uniform(-bound, bound, (self.out_dim,)).astype(np.float32)}
        return p

    def forward(self, pix_feat, masks, skip_mask_sigmoid=False):
        """pix_feat (B, H, W, in_dim); masks (B, 16H, 16W, 1) logits or probabilities → (feats NHWC, pos (h, w, C))."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        m = self.mask_downsampler(masks)
        x = conv_nhwc(pix_feat, self.pix_feat_proj.weight, self.pix_feat_proj.bias) + m
        for layer in self.fuser.layers:
            x = layer(x)
        if self.out_dim != self.in_dim:
            x = conv_nhwc(x, self.out_proj.weight, self.out_proj.bias)
        pos = torch.from_numpy(sine_pos_embed_2d(x.shape[1], x.shape[2], self.out_dim)).to(x.device, x.dtype)
        return x, pos
