"""SAM building blocks as `nn.Module`s (counterpart of yolo_tpu/models/sam/modules.py).

Every module's parameters are named as the JAX package's tree paths (torch's own names), so a
`state_dict` key is a tree path joined by "." and a released checkpoint loads with
`load_state_dict`. Each module also has `init(rng)`: the JAX package's initial subtree, drawn
with the same numpy calls in the same order (convolution kernels HWIO there, as JAX keeps
them); `sam_params_from_jax` installs such a tree. The forwards mirror JAX's line by line on
NHWC maps, in the dtype of the weights (f32, or f64 for a reference run), with no TF32
switch of their own. SAM runs no kernel of the port: its attention and products are plain
torch, as JAX leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # SAM's ViT LayerNorm


def _empty(*shape) -> nn.Parameter:
    """A weight slot, filled by `sam_params_from_jax` or `load_state_dict`; inference only."""
    return nn.Parameter(torch.empty(shape), requires_grad=False)


def _ones(n):
    return np.ones((n,), np.float32)


def _zeros(n):
    return np.zeros((n,), np.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf), as jax.nn.gelu(approximate=False)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """A convolution of an NHWC map with an OIHW weight, NHWC out."""
    y = F.conv2d(x.to(w.dtype).permute(0, 3, 1, 2), w, b, stride, padding, 1, groups)
    return y.permute(0, 2, 3, 1)


def deconv_nhwc(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """torch ConvTranspose2d(k=2, s=2, p=0) on an NHWC map (JAX: conv_transpose with transpose_kernel)."""
    return F.conv_transpose2d(x.to(w.dtype).permute(0, 3, 1, 2), w, b, stride=2).permute(0, 2, 3, 1)


class Linear(nn.Module):
    """nn.Linear with JAX `nn/transformer.py::Linear`'s draws (uniform ±1/sqrt(in))."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.weight = _empty(c_out, c_in)
        self.bias = _empty(c_out) if bias else None

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / self.c_in)
        p = {"weight": rng.uniform(-bound, bound, (self.c_out, self.c_in)).astype(np.float32)}
        if self.bias is not None:
            p["bias"] = rng.uniform(-bound, bound, (self.c_out,)).astype(np.float32)
        return p

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim (also SAM's LayerNorm2d, applied to NHWC)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.c, self.eps = c, eps
        self.weight = _empty(c)
        self.bias = _empty(c)

    def init(self, rng) -> dict:
        return {"weight": _ones(self.c), "bias": _zeros(self.c)}

    def forward(self, x):
        return F.layer_norm(x.to(self.weight.dtype), (self.c,), self.weight, self.bias, self.eps)


class MLP(nn.Module):
    """`layers.{i}` Linears with ReLU between (JAX `nn/transformer.py::MLP`), sigmoid out if asked."""

    def __init__(self, c_in: int, hidden: int, c_out: int, num_layers: int, sigmoid: bool = False):
        super().__init__()
        h = [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip([c_in] + h, h + [c_out]))
        self.sigmoid = sigmoid

    def init(self, rng) -> dict:
        return {"layers": {str(i): layer.init(rng) for i, layer in enumerate(self.layers)}}

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = torch.relu(x)
        return torch.sigmoid(x) if self.sigmoid else x


def window_partition(x: torch.Tensor, window_size: int):
    """(B, H, W, C) → (B·nW, ws, ws, C) with a zero pad, and the padded size (JAX :44)."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw, hw) -> torch.Tensor:
    """The inverse of `window_partition`, the pad cut off (JAX :56)."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize(method="linear") along one axis: half-pixel centres, the triangle
    kernel widened by n_in / n_out when it shrinks (antialias), each row renormalised over the samples inside."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centres = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(np.arange(n_in, dtype=np.float64)[None, :] - centres[:, None]) / width
    w = np.maximum(0.0, 1.0 - dist)
    total = w.sum(1, keepdims=True)
    return (w / np.where(total > 0, total, 1.0)).astype(np.float32)


def resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """`x` resized along `axis` to `n_out` as jax.image.resize's linear method does."""
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    m = torch.from_numpy(linear_resize_matrix(n_in, n_out)).to(x.device, x.dtype)
    return torch.movedim(torch.tensordot(m, torch.movedim(x, axis, 0), dims=1), 0, axis)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative-position table sliced (resized where its length differs) to (q, k, C) (JAX :64)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    rel_pos = resize_axis(rel_pos, 0, max_rel_dist)
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """MViTv2's decomposed relative positions added to the logits (JAX :75)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.reshape(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.reshape(B, q_h * q_w, k_h * k_w)


class MLPBlock(nn.Module):
    """lin1 → act → lin2: exact GELU in the ViT blocks, ReLU in SAM's two-way blocks (JAX :92)."""

    def __init__(self, dim: int, mlp_dim: int, act: str = "gelu"):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, dim)
        self.act = act

    def init(self, rng) -> dict:
        return {"lin1": self.lin1.init(rng), "lin2": self.lin2.init(rng)}

    def forward(self, x):
        h = self.lin1(x)
        return self.lin2(torch.relu(h) if self.act == "relu" else gelu(h))


class REAttention(nn.Module):
    """Multi-head self-attention with decomposed relative positions (JAX :109)."""

    def __init__(self, dim, num_heads=8, qkv_bias=True, use_rel_pos=False, input_size=None):
        super().__init__()
        self.dim, self.nh = dim, num_heads
        self.hd = dim // num_heads
        self.scale = self.hd**-0.5
        self.use_rel_pos = use_rel_pos
        self.input_size = input_size
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = _empty(2 * input_size[0] - 1, self.hd)
            self.rel_pos_w = _empty(2 * input_size[1] - 1, self.hd)

    def init(self, rng) -> dict:
        p = {"qkv": self.qkv.init(rng), "proj": self.proj.init(rng)}
        if self.use_rel_pos:
            p["rel_pos_h"] = np.zeros((2 * self.input_size[0] - 1, self.hd), np.float32)
            p["rel_pos_w"] = np.zeros((2 * self.input_size[1] - 1, self.hd), np.float32)
        return p

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.nh, self.hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.nh, H * W, self.hd).unbind(0)
        attn = (q * self.scale) @ k.transpose(1, 2)
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        attn = torch.softmax(attn, -1)
        y = (attn @ v).reshape(B, self.nh, H, W, self.hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(y)


class ViTBlock(nn.Module):
    """Pre-norm transformer block, windowed (zero-padded windows) or global (JAX :140)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True, use_rel_pos=False, window_size=0, input_size=None):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = REAttention(dim, num_heads, qkv_bias, use_rel_pos,
                                input_size=input_size if window_size == 0 else (window_size, window_size))
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def init(self, rng) -> dict:
        return {"norm1": self.norm1.init(rng), "attn": self.attn.init(rng), "norm2": self.norm2.init(rng),
                "mlp": self.mlp.init(rng)}

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """`patch_embed.proj`: a k x k stride-k convolution with bias."""

    def __init__(self, k: int, c_in: int, c_out: int, stride: int | None = None, padding: int = 0):
        super().__init__()
        self.proj = nn.Module()
        self.proj.weight = _empty(c_out, c_in, k, k)
        self.proj.bias = _empty(c_out)
        self.stride, self.padding = stride or k, padding

    def forward(self, x):
        return conv_nhwc(x, self.proj.weight, self.proj.bias, self.stride, self.padding)


class ImageEncoderViT(nn.Module):
    """SAM's ViT image encoder → (B, grid, grid, out_chans) NHWC (JAX :174)."""

    def __init__(self, img_size=1024, patch_size=16, in_chans=3, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, out_chans=256, qkv_bias=True, use_rel_pos=True, window_size=14,
                 global_attn_indexes=()):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        self.in_chans, self.embed_dim, self.out_chans = in_chans, embed_dim, out_chans
        self.grid = grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.pos_embed = _empty(1, grid, grid, embed_dim)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, use_rel_pos,
                     window_size=window_size if i not in global_attn_indexes else 0, input_size=(grid, grid))
            for i in range(depth))
        self.neck = nn.ModuleList([nn.Module(), LayerNorm(out_chans, LN_EPS), nn.Module(), LayerNorm(out_chans, LN_EPS)])
        self.neck[0].weight = _empty(out_chans, embed_dim, 1, 1)
        self.neck[2].weight = _empty(out_chans, out_chans, 3, 3)

    def init(self, rng) -> dict:
        k = self.patch_size
        bound = math.sqrt(1.0 / (self.in_chans * k * k)) * math.sqrt(3.0)
        return {
            "patch_embed": {"proj": {
                "weight": rng.uniform(-bound, bound, (k, k, self.in_chans, self.embed_dim)).astype(np.float32),
                "bias": _zeros(self.embed_dim)}},
            "pos_embed": np.zeros((1, self.grid, self.grid, self.embed_dim), np.float32),
            "blocks": {str(i): b.init(rng) for i, b in enumerate(self.blocks)},
            "neck": {
                "0": {"weight": rng.uniform(-0.05, 0.05, (1, 1, self.embed_dim, self.out_chans)).astype(np.float32)},
                "1": {"weight": _ones(self.out_chans), "bias": _zeros(self.out_chans)},
                "2": {"weight": rng.uniform(-0.05, 0.05, (3, 3, self.out_chans, self.out_chans)).astype(np.float32)},
                "3": {"weight": _ones(self.out_chans), "bias": _zeros(self.out_chans)},
            },
        }

    def forward(self, x):
        """x: (B, H, W, 3) normalised → (B, grid, grid, out_chans)."""
        x = self.patch_embed(x)
        pe = self.pos_embed
        if x.shape[1] != pe.shape[1] or x.shape[2] != pe.shape[2]:  # JAX's bilinear resize of the table
            pe = resize_axis(resize_axis(pe, 1, x.shape[1]), 2, x.shape[2])
        x = x + pe
        for blk in self.blocks:
            x = blk(x)
        x = self.neck[1](conv_nhwc(x, self.neck[0].weight))
        return self.neck[3](conv_nhwc(x, self.neck[2].weight, padding=1))


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (JAX :236)."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.npf = num_pos_feats
        self.positional_encoding_gaussian_matrix = _empty(2, num_pos_feats)

    def init(self, rng) -> dict:
        return {"positional_encoding_gaussian_matrix": rng.normal(0, 1, (2, self.npf)).astype(np.float32)}

    def encode(self, coords):
        """coords in [0, 1] (..., 2) → (..., 2·npf)."""
        g = self.positional_encoding_gaussian_matrix
        c = (2 * coords.to(g.dtype) - 1) @ g * (2 * np.pi)
        return torch.cat([torch.sin(c), torch.cos(c)], -1)

    def grid(self, size):
        h, w = size
        g = self.positional_encoding_gaussian_matrix
        ys = (torch.arange(h, dtype=g.dtype, device=g.device) + 0.5) / h
        xs = (torch.arange(w, dtype=g.dtype, device=g.device) + 0.5) / w
        coords = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)  # (h, w, 2), x first
        return self.encode(coords)


class _Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = _empty(n, dim)


class _Conv(nn.Module):
    """A convolution's weight (OIHW) and optional bias slot."""

    def __init__(self, c_in, c_out, k, bias=True, groups=1, transpose=False):
        super().__init__()
        self.weight = _empty(c_in, c_out, k, k) if transpose else _empty(c_out, c_in // groups, k, k)
        self.bias = _empty(c_out) if bias else None


class PromptEncoder(nn.Module):
    """Sparse (points, boxes) and dense (mask) prompt embeddings (JAX :259)."""

    def __init__(self, embed_dim=256, image_embedding_size=(64, 64), input_image_size=(1024, 1024), mask_in_chans=16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.mask_in_chans = mask_in_chans
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(_Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = _Embedding(1, embed_dim)
        self.no_mask_embed = _Embedding(1, embed_dim)
        c4 = mask_in_chans // 4
        self.mask_downscaling = nn.ModuleDict({
            "0": _Conv(1, c4, 2), "1": LayerNorm(c4, LN_EPS), "3": _Conv(c4, mask_in_chans, 2),
            "4": LayerNorm(mask_in_chans, LN_EPS), "6": _Conv(mask_in_chans, embed_dim, 1)})

    def init(self, rng) -> dict:
        def emb():
            return {"weight": rng.normal(0, 1, (1, self.embed_dim)).astype(np.float32)}

        c4 = self.mask_in_chans // 4

        def conv(k, ci, co):
            bound = math.sqrt(1.0 / (ci * k * k))
            return {"weight": rng.uniform(-bound, bound, (k, k, ci, co)).astype(np.float32),
                    "bias": rng.uniform(-bound, bound, (co,)).astype(np.float32)}

        return {
            "pe_layer": self.pe_layer.init(rng),
            "point_embeddings": {str(i): emb() for i in range(4)},
            "not_a_point_embed": emb(),
            "no_mask_embed": emb(),
            "mask_downscaling": {
                "0": conv(2, 1, c4),
                "1": {"weight": _ones(c4), "bias": _zeros(c4)},
                "3": conv(2, c4, self.mask_in_chans),
                "4": {"weight": _ones(self.mask_in_chans), "bias": _zeros(self.mask_in_chans)},
                "6": conv(1, self.mask_in_chans, self.embed_dim),
            },
        }

    def get_dense_pe(self):
        return self.pe_layer.grid(self.image_embedding_size)[None]  # (1, h, w, C)

    def _coords(self, pts):
        g = self.pe_layer.positional_encoding_gaussian_matrix
        size = torch.tensor([self.input_image_size[1], self.input_image_size[0]], dtype=g.dtype, device=g.device)
        return pts.to(g.dtype) / size

    def embed_points(self, points, labels, pad: bool):
        """points (B, N, 2) px; labels (B, N) in {-1, 0, 1, 2, 3}."""
        g = self.pe_layer.positional_encoding_gaussian_matrix
        points = points.to(g.dtype) + 0.5
        if pad:
            B = points.shape[0]
            points = torch.cat([points, points.new_zeros(B, 1, 2)], 1)
            labels = torch.cat([labels, -labels.new_ones(B, 1)], 1)
        pe = self.pe_layer.encode(self._coords(points))
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for i in range(4):
            pe = torch.where(lab == i, pe + self.point_embeddings[i].weight[0], pe)
        return pe

    def embed_boxes(self, boxes):
        """boxes (B, 4) px xyxy → (B, 2, C) corner embeddings."""
        g = self.pe_layer.positional_encoding_gaussian_matrix
        b = boxes.to(g.dtype).reshape(-1, 2, 2) + 0.5
        pe = self.pe_layer.encode(self._coords(b))
        return torch.stack([pe[:, 0] + self.point_embeddings[2].weight[0], pe[:, 1] + self.point_embeddings[3].weight[0]], 1)

    def embed_masks(self, masks):
        """masks (B, H, W, 1) → dense (B, h, w, C)."""
        md = self.mask_downscaling
        x = conv_nhwc(masks, md["0"].weight, md["0"].bias, 2)
        x = gelu(md["1"](x))
        x = conv_nhwc(x, md["3"].weight, md["3"].bias, 2)
        x = gelu(md["4"](x))
        return conv_nhwc(x, md["6"].weight, md["6"].bias)

    def forward(self, points=None, boxes=None, masks=None):
        """→ (sparse (B, n, C), dense (B, h, w, C))."""
        if points is not None:
            B = points[0].shape[0]
        elif boxes is not None:
            B = boxes.shape[0]
        elif masks is not None:
            B = masks.shape[0]
        else:
            B = 1
        w = self.no_mask_embed.weight
        sparse = w.new_zeros(B, 0, self.embed_dim)
        if points is not None:
            sparse = torch.cat([sparse, self.embed_points(points[0], points[1], pad=boxes is None)], 1)
        if boxes is not None:
            sparse = torch.cat([sparse, self.embed_boxes(boxes)], 1)
        h, wd = self.image_embedding_size
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            dense = w[0].reshape(1, 1, 1, -1).expand(B, h, wd, self.embed_dim)
        return sparse, dense


class SAMAttention(nn.Module):
    """Attention with a downsampled inner width (JAX :362)."""

    def __init__(self, embedding_dim, num_heads, downsample_rate=1, kv_in_dim=None):
        super().__init__()
        self.nh = num_heads
        kv_in = kv_in_dim if kv_in_dim is not None else embedding_dim
        self.internal = embedding_dim // downsample_rate
        self.q_proj = Linear(embedding_dim, self.internal)
        self.k_proj = Linear(kv_in, self.internal)
        self.v_proj = Linear(kv_in, self.internal)
        self.out_proj = Linear(self.internal, embedding_dim)

    def init(self, rng) -> dict:
        return {k: getattr(self, k).init(rng) for k in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, Nq, C = q.shape
        hd = C // self.nh
        q = q.reshape(B, Nq, self.nh, hd).transpose(1, 2)
        k = k.reshape(B, -1, self.nh, hd).transpose(1, 2)
        v = v.reshape(B, -1, self.nh, hd).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, Nq, C))


class TwoWayAttentionBlock(nn.Module):
    """Sparse ↔ dense two-way attention (JAX :391); SAM2's names its MLP `mlp.layers.{i}`."""

    def __init__(self, embedding_dim, num_heads, mlp_dim=2048, attention_downsample_rate=2, skip_first_layer_pe=False,
                 sam2: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SAMAttention(embedding_dim, num_heads)
        self.norm1 = LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = SAMAttention(embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(embedding_dim)
        self.mlp = MLP(embedding_dim, mlp_dim, embedding_dim, 2) if sam2 else MLPBlock(embedding_dim, mlp_dim, act="relu")
        self.norm3 = LayerNorm(embedding_dim)
        self.norm4 = LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = SAMAttention(embedding_dim, num_heads, attention_downsample_rate)

    def init(self, rng) -> dict:
        return {k: getattr(self, k).init(rng) for k in (
            "self_attn", "norm1", "cross_attn_token_to_image", "norm2", "mlp", "norm3", "norm4",
            "cross_attn_image_to_token")}

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Two-way blocks, then a final token → image attention (JAX :436)."""

    def __init__(self, depth, embedding_dim, num_heads, mlp_dim, attention_downsample_rate=2, sam2: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate,
                                 skip_first_layer_pe=i == 0, sam2=sam2) for i in range(depth))
        self.final_attn_token_to_image = SAMAttention(embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def init(self, rng) -> dict:
        return {"layers": {str(i): layer.init(rng) for i, layer in enumerate(self.layers)},
                "final_attn_token_to_image": self.final_attn_token_to_image.init(rng),
                "norm_final_attn": self.norm_final_attn.init(rng)}

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, h, w, C); point_embedding (B, N, C)."""
        B, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(B, h * w, C)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, C) if image_pe.ndim == 4 else image_pe
        key_pe = key_pe.expand(keys.shape)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """Masks and IoU predictions from image and prompt embeddings (JAX :471)."""

    def __init__(self, transformer_dim=256, num_multimask_outputs=3, iou_head_depth=3, iou_head_hidden_dim=256,
                 transformer=None):
        super().__init__()
        td = self.td = transformer_dim
        self.num_multimask_outputs = num_multimask_outputs
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = transformer or TwoWayTransformer(2, transformer_dim, 8, 2048)
        self.iou_token = _Embedding(1, td)
        self.mask_tokens = _Embedding(self.num_mask_tokens, td)
        self.output_upscaling = nn.ModuleDict({
            "0": _Conv(td, td // 4, 2, transpose=True), "1": LayerNorm(td // 4, LN_EPS),
            "3": _Conv(td // 4, td // 8, 2, transpose=True)})
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(td, td, td // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(td, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth)

    def init(self, rng) -> dict:
        td = self.td

        def deconv(ci, co):
            bound = math.sqrt(1.0 / (ci * 4))
            return {"weight": rng.uniform(-bound, bound, (2, 2, co, ci)).astype(np.float32),  # HWOI
                    "bias": rng.uniform(-bound, bound, (co,)).astype(np.float32)}

        return {
            "iou_token": {"weight": rng.normal(0, 1, (1, td)).astype(np.float32)},
            "mask_tokens": {"weight": rng.normal(0, 1, (self.num_mask_tokens, td)).astype(np.float32)},
            "transformer": self.transformer.init(rng),
            "output_upscaling": {"0": deconv(td, td // 4), "1": {"weight": _ones(td // 4), "bias": _zeros(td // 4)},
                                 "3": deconv(td // 4, td // 8)},
            "output_hypernetworks_mlps": {str(i): m.init(rng) for i, m in enumerate(self.output_hypernetworks_mlps)},
            "iou_prediction_head": self.iou_prediction_head.init(rng),
        }

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output: bool):
        masks, iou_pred = self.predict_masks(image_embeddings, image_pe, sparse, dense)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou_pred[:, sl]

    def _tokens(self, sparse, extra=()):
        out_tokens = torch.cat([*extra, self.iou_token.weight, self.mask_tokens.weight], 0)
        B = sparse.shape[0]
        return torch.cat([out_tokens[None].expand(B, *out_tokens.shape), sparse.to(out_tokens.dtype)], 1)

    def _upscale(self, src2, B, h, w, high_res=None):
        up = self.output_upscaling
        x = src2.reshape(B, h, w, self.td)
        if high_res is None:
            x = gelu(up["1"](deconv_nhwc(x, up["0"].weight, up["0"].bias)))
            return gelu(deconv_nhwc(x, up["3"].weight, up["3"].bias))
        f_s0, f_s1 = high_res
        x = gelu(up["1"](deconv_nhwc(x, up["0"].weight, up["0"].bias) + f_s1))
        return gelu(deconv_nhwc(x, up["3"].weight, up["3"].bias) + f_s0)

    def _masks(self, mask_tokens_out, x):
        hyper = torch.stack([m(mask_tokens_out[:, i]) for i, m in enumerate(self.output_hypernetworks_mlps)], 1)
        return torch.einsum("bnc,bhwc->bnhw", hyper, x)

    def predict_masks(self, image_embeddings, image_pe, sparse, dense):
        """image_embeddings (1|B, h, w, C); sparse (B, n, C); dense (B, h, w, C)."""
        tokens = self._tokens(sparse)
        B = sparse.shape[0]
        src = image_embeddings.expand(B, *image_embeddings.shape[1:]) + dense
        hs, src2 = self.transformer(src, image_pe, tokens)
        x = self._upscale(src2, B, src.shape[1], src.shape[2])
        masks = self._masks(hs[:, 1 : 1 + self.num_mask_tokens], x)
        return masks, self.iou_prediction_head(hs[:, 0])


class SAMModel(nn.Module):
    """Image encoder, prompt encoder and mask decoder (JAX :548)."""

    mask_threshold = 0.0

    def __init__(self, image_encoder, prompt_encoder, mask_decoder,
                 pixel_mean=(123.675, 116.28, 103.53), pixel_std=(58.395, 57.12, 57.375)):
        super().__init__()
        self.image_encoder = image_encoder
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_std = np.asarray(pixel_std, np.float32)

    @property
    def img_size(self) -> int:
        return self.image_encoder.img_size

    def init(self, seed: int = 0) -> dict:
        """The JAX package's `init(seed)` tree, drawn in its order."""
        rng = np.random.default_rng(seed)
        return {"image_encoder": self.image_encoder.init(rng), "prompt_encoder": self.prompt_encoder.init(rng),
                "mask_decoder": self.mask_decoder.init(rng)}

    def normalize(self, x):
        w = self.prompt_encoder.no_mask_embed.weight
        mean = torch.from_numpy(self.pixel_mean).to(w.device, w.dtype)
        std = torch.from_numpy(self.pixel_std).to(w.device, w.dtype)
        return (x.to(w.dtype) - mean) / std

    def preprocess(self, x):
        """(B, H, W, 3) RGB → normalised, zero-padded to img_size (a frame `set_image` padded with raw zeros
        arrives at img_size: its pad normalises to -mean/std, as in JAX)."""
        x = self.normalize(x)
        s = self.img_size
        pad_h, pad_w = s - x.shape[1], s - x.shape[2]
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        return x

    def encode_image(self, x):
        return self.image_encoder(self.preprocess(x))

    def predict_masks(self, image_embeddings, points=None, boxes=None, masks=None, multimask_output=True):
        sparse, dense = self.prompt_encoder(points=points, boxes=boxes, masks=masks)
        image_pe = self.prompt_encoder.get_dense_pe()
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense, multimask_output)
