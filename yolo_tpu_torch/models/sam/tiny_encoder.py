"""TinyViT, MobileSAM's image encoder (counterpart of yolo_tpu/models/sam/tiny_encoder.py).

The inference form: each Conv2d_BN's BatchNorm uses its running statistics (kept as
`running_mean` / `running_var` leaves, as JAX keeps them). Names mirror torch's, so the
released mobile_sam.pt loads with `load_state_dict`.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.models.sam.modules import LN_EPS, LayerNorm, Linear, _empty, _ones, _zeros, conv_nhwc, gelu

BN_EPS = 1e-5


def _conv2d_bn_init(rng, a, b, ks=1, groups=1) -> dict:
    bound = math.sqrt(1.0 / (a // groups * ks * ks)) * math.sqrt(3.0)
    return {
        "c": {"weight": rng.uniform(-bound, bound, (ks, ks, a // groups, b)).astype(np.float32)},
        "bn": {"weight": _ones(b), "bias": _zeros(b), "running_mean": _zeros(b), "running_var": _ones(b)},
    }


class _BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = _empty(c), _empty(c)
        self.running_mean, self.running_var = _empty(c), _empty(c)


class Conv2dBN(nn.Module):
    """`c` (no bias) then `bn` in eval form (JAX `_conv2d_bn`)."""

    def __init__(self, a, b, ks=1, stride=1, pad=0, groups=1):
        super().__init__()
        self.c = nn.Module()
        self.c.weight = _empty(b, a // groups, ks, ks)
        self.bn = _BN(b)
        self.stride, self.pad, self.groups = stride, pad, groups

    def forward(self, x):
        y = conv_nhwc(x, self.c.weight, None, self.stride, self.pad, self.groups)
        bn = self.bn
        return (y - bn.running_mean) * (bn.weight * torch.rsqrt(bn.running_var + BN_EPS)) + bn.bias


class TinyAttention(nn.Module):
    """Windowed attention with a trainable bias per offset, `attention_biases[:, bias_idxs]` (JAX :66)."""

    def __init__(self, dim, key_dim, num_heads=8, attn_ratio=1.0, resolution=(7, 7)):
        super().__init__()
        self.nh, self.key_dim = num_heads, key_dim
        self.scale = key_dim**-0.5
        self.d = int(attn_ratio * key_dim)
        self.dh = self.d * num_heads
        h = self.dh + key_dim * num_heads * 2
        self.dim, self.h = dim, h
        pts = list(itertools.product(range(resolution[0]), range(resolution[1])))
        offsets, idxs = {}, []
        for p1 in pts:
            for p2 in pts:
                off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
                offsets.setdefault(off, len(offsets))
                idxs.append(offsets[off])
        self.n_offsets = len(offsets)
        self.register_buffer("bias_idxs", torch.tensor(idxs, dtype=torch.long).reshape(len(pts), len(pts)), persistent=False)
        self.norm = LayerNorm(dim)
        self.qkv = Linear(dim, h)
        self.proj = Linear(self.dh, dim)
        self.attention_biases = _empty(num_heads, self.n_offsets)

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.dim)
        return {
            "norm": {"weight": _ones(self.dim), "bias": _zeros(self.dim)},
            "qkv": {"weight": rng.uniform(-bound, bound, (self.h, self.dim)).astype(np.float32), "bias": _zeros(self.h)},
            "proj": {"weight": rng.uniform(-bound, bound, (self.dim, self.dh)).astype(np.float32), "bias": _zeros(self.dim)},
            "attention_biases": np.zeros((self.nh, self.n_offsets), np.float32),
        }

    def forward(self, x):
        B, N, _ = x.shape
        qkv = self.qkv(self.norm(x)).reshape(B, N, self.nh, -1)
        q, k, v = torch.split(qkv, [self.key_dim, self.key_dim, self.d], dim=3)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        bias = self.attention_biases[:, self.bias_idxs]  # (nh, N, N)
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.scale + bias[None], -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, self.dh))


class _TinyMLP(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Window attention, a local depthwise conv, the MLP (JAX :101)."""

    def __init__(self, dim, input_resolution, num_heads, window_size=7, mlp_ratio=4.0, local_conv_size=3):
        super().__init__()
        self.dim = dim
        self.input_resolution = input_resolution
        self.window_size = window_size
        self.local_conv_size = local_conv_size
        self.attn = TinyAttention(dim, dim // num_heads, num_heads, 1.0, (window_size, window_size))
        self.mlp_hidden = int(dim * mlp_ratio)
        self.local_conv = Conv2dBN(dim, dim, local_conv_size, 1, local_conv_size // 2, groups=dim)
        self.mlp = _TinyMLP(dim, self.mlp_hidden)

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.dim)
        bound_h = math.sqrt(1.0 / self.mlp_hidden)
        return {
            "attn": self.attn.init(rng),
            "local_conv": _conv2d_bn_init(rng, self.dim, self.dim, self.local_conv_size, groups=self.dim),
            "mlp": {
                "norm": {"weight": _ones(self.dim), "bias": _zeros(self.dim)},
                "fc1": {"weight": rng.uniform(-bound, bound, (self.mlp_hidden, self.dim)).astype(np.float32),
                        "bias": _zeros(self.mlp_hidden)},
                "fc2": {"weight": rng.uniform(-bound_h, bound_h, (self.dim, self.mlp_hidden)).astype(np.float32),
                        "bias": _zeros(self.dim)},
            },
        }

    def forward(self, x):
        h, w = self.input_resolution
        b, hw, c = x.shape
        res_x = x
        ws = self.window_size
        if h == ws and w == ws:
            x = self.attn(x)
        else:
            x = x.reshape(b, h, w, c)
            pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
            if pad_b or pad_r:
                x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            pH, pW = h + pad_b, w + pad_r
            nH, nW = pH // ws, pW // ws
            x = x.reshape(b, nH, ws, nW, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nH * nW, ws * ws, c)
            x = self.attn(x)
            x = x.reshape(b, nH, nW, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, pH, pW, c)
            x = x[:, :h, :w].reshape(b, hw, c)
        x = res_x + x
        x = self.local_conv(x.reshape(b, h, w, c)).reshape(b, hw, c)
        return x + self.mlp(x)


class _PatchMerging(nn.Module):
    """conv1 1x1 → GELU → depthwise conv2 (stride 1 or 2) → GELU → conv3 1x1, flattened (JAX :173)."""

    def __init__(self, input_resolution, dim, out_dim):
        super().__init__()
        self.input_resolution = input_resolution
        self.dim, self.out_dim = dim, out_dim
        self.stride = 1 if out_dim in {320, 448, 576} else 2
        self.conv1 = Conv2dBN(dim, out_dim, 1)
        self.conv2 = Conv2dBN(out_dim, out_dim, 3, self.stride, 1, groups=out_dim)
        self.conv3 = Conv2dBN(out_dim, out_dim, 1)

    def init(self, rng) -> dict:
        return {"conv1": _conv2d_bn_init(rng, self.dim, self.out_dim, 1),
                "conv2": _conv2d_bn_init(rng, self.out_dim, self.out_dim, 3, groups=self.out_dim),
                "conv3": _conv2d_bn_init(rng, self.out_dim, self.out_dim, 1)}

    def forward(self, x):
        if x.ndim == 3:
            h, w = self.input_resolution
            x = x.reshape(x.shape[0], h, w, -1)
        x = self.conv3(gelu(self.conv2(gelu(self.conv1(x)))))
        return x.reshape(x.shape[0], -1, x.shape[-1])


class _MBConv(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.hidden = hidden
        self.conv1 = Conv2dBN(d, hidden, 1)
        self.conv2 = Conv2dBN(hidden, hidden, 3, 1, 1, groups=hidden)
        self.conv3 = Conv2dBN(hidden, d, 1)

    def forward(self, x):
        y = gelu(self.conv2(gelu(self.conv1(x))))
        return gelu(self.conv3(y) + x)


class _Stage(nn.Module):
    def __init__(self, blocks, down):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if down is not None:
            self.downsample = down
        self.down = down is not None


class TinyViT(nn.Module):
    """MobileSAM's encoder → (B, H/16, W/16, 256) NHWC (JAX :198)."""

    def __init__(self, img_size=1024, in_chans=3, embed_dims=(64, 128, 160, 320), depths=(2, 2, 6, 2),
                 num_heads=(2, 4, 5, 10), window_sizes=(7, 7, 14, 7), mlp_ratio=4.0, mbconv_expand_ratio=4.0,
                 local_conv_size=3):
        super().__init__()
        self.img_size = img_size
        self.in_chans = in_chans
        self.embed_dims = list(embed_dims)
        self.depths = list(depths)
        pr = img_size // 4
        self.patches_resolution = (pr, pr)
        self.num_layers = len(depths)
        self.mbconv_expand = mbconv_expand_ratio
        ed = self.embed_dims
        self.patch_embed = nn.Module()
        self.patch_embed.seq = nn.ModuleDict({"0": Conv2dBN(in_chans, ed[0] // 2, 3, 2, 1),
                                              "2": Conv2dBN(ed[0] // 2, ed[0], 3, 2, 1)})
        stages = []
        for i in range(self.num_layers):
            r = pr // (2 ** (i - 1 if i == 3 else i))
            res = (r, r)
            if i == 0:
                blocks = [_MBConv(ed[0], int(ed[0] * mbconv_expand_ratio)) for _ in range(depths[0])]
            else:
                blocks = [TinyViTBlock(ed[i], res, num_heads[i], window_sizes[i], mlp_ratio, local_conv_size)
                          for _ in range(depths[i])]
            down = _PatchMerging(res, ed[i], ed[min(i + 1, self.num_layers - 1)]) if i < self.num_layers - 1 else None
            stages.append(_Stage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.out_chans = 256
        self.neck = nn.ModuleList([nn.Module(), LayerNorm(256, LN_EPS), nn.Module(), LayerNorm(256, LN_EPS)])
        self.neck[0].weight = _empty(256, ed[-1], 1, 1)
        self.neck[2].weight = _empty(256, 256, 3, 3)

    def init(self, rng) -> dict:
        ed = self.embed_dims
        p = {
            "patch_embed": {"seq": {"0": _conv2d_bn_init(rng, self.in_chans, ed[0] // 2, 3),
                                    "2": _conv2d_bn_init(rng, ed[0] // 2, ed[0], 3)}},
            "layers": {},
            "neck": {  # drawn before the stages, as JAX draws it
                "0": {"weight": rng.uniform(-0.05, 0.05, (1, 1, ed[-1], 256)).astype(np.float32)},
                "1": {"weight": _ones(256), "bias": _zeros(256)},
                "2": {"weight": rng.uniform(-0.05, 0.05, (3, 3, 256, 256)).astype(np.float32)},
                "3": {"weight": _ones(256), "bias": _zeros(256)},
            },
        }
        for i, stage in enumerate(self.layers):
            lp = {"blocks": {}}
            for j, blk in enumerate(stage.blocks):
                if i == 0:
                    d, hidden = ed[0], int(ed[0] * self.mbconv_expand)
                    lp["blocks"][str(j)] = {"conv1": _conv2d_bn_init(rng, d, hidden, 1),
                                            "conv2": _conv2d_bn_init(rng, hidden, hidden, 3, groups=hidden),
                                            "conv3": _conv2d_bn_init(rng, hidden, d, 1)}
                else:
                    lp["blocks"][str(j)] = blk.init(rng)
            if stage.down:
                lp["downsample"] = stage.downsample.init(rng)
            p["layers"][str(i)] = lp
        return p

    def forward(self, x):
        """x: (B, H, W, 3) normalised → (B, H/16, W/16, 256)."""
        seq = self.patch_embed.seq
        x = seq["2"](gelu(seq["0"](x)))  # (B, H/4, W/4, ed0)
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            if stage.down:
                x = stage.downsample(x)
        B, N, C = x.shape
        side = int(math.isqrt(N))
        x = self.neck[1](conv_nhwc(x.reshape(B, side, side, C), self.neck[0].weight))
        return self.neck[3](conv_nhwc(x, self.neck[2].weight, padding=1))
