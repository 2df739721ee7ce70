"""The open-vocabulary blocks of YOLO-World and YOLOE as PyTorch modules (counterpart of yolo_tpu/nn/modules.py:2403-2925).

YOLO-World: MaxSigmoidAttnBlock, C2fAttn, ImagePoolingAttn, ContrastiveHead, BNContrastiveHead and the WorldDetect
head. YOLOE: SwiGLUFFN (the head's text-prompt residual, `reprta`), SAVPE (visual prompt embeddings), the YOLOEDetect
head (both class-branch forms, the prompt-free LRPC path) and YOLOESegment.

The class prompts are an explicit argument. A C2fAttn takes the running text embeddings (`guide`), an ImagePoolingAttn
returns them refreshed, and a head takes the original ones (`guide0`); the graph walk (nn/tasks.py) threads them, and
no module keeps them. As in the JAX package, every product, norm and sigmoid of these blocks runs in f32 whatever the
compute dtype (f64 in a model loaded in f64, the reference forward): the attention of MaxSigmoidAttnBlock and
ImagePoolingAttn, the LayerNorms and linears, the contrastive products, SAVPE's raw convs and its masked softmax. Their
ConvBNActs and the heads' convs run in the compute dtype as everywhere else. None of them has a kernel: JAX leaves them
to XLA, the port to plain torch. A C2fAttn is its own module, not a C2f: the C2f kernel (kernel 1) and the neck fold
(kernel 2) never take it, and a World or YOLOE head never reaches the head kernels (kernels 3-4).

Each module keeps the two forms of its weights that the other modules keep (nn/modules.py): the inference form that
`load_jax` fills and the train form named by `train_leaves()`; `init(rng)` draws the JAX package's initial subtree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.nn.modules import (
    BN_EPS,
    BatchNorm,
    Bottleneck,
    Conv2d,
    ConvBNAct,
    Detect,
    DWConv,
    Proto,
    Seq,
    _branch_walk,
    _call,
    _hwio_to_oihw,
    _subtree_init,
    _subtree_load,
)
from yolo_tpu_torch.nn.transformer import LayerNorm, Linear, _pair, _store, _wide
from yolo_tpu_torch.ops.conv import conv_nhwc

F32_MIN = float(np.finfo(np.float32).min)  # SAVPE's score outside a prompt's mask (JAX: finfo(float32).min)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x over its L2 norm on the last axis, the norm clamped at 1e-12 (JAX's `x / maximum(norm, 1e-12)`)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _leaf(module: nn.Module, name: str, shape) -> None:
    """A weight that no conv holds (a bias, a logit scale): a buffer `name` (the inference form) and a parameter
    `train_<name>` (the train form), both f32 zeros."""
    buf, param = _pair(shape)
    module.register_buffer(name, buf)
    setattr(module, f"train_{name}", param)


def _pick(module: nn.Module, name: str, train: bool) -> torch.Tensor:
    return getattr(module, f"train_{name}" if train else name)


class RawConv(nn.Module):
    """A conv with a bias and no BN that runs in f32 whatever the compute dtype (SAVPE's cv3-cv6 and ImagePoolingAttn's
    projections: JAX's `lax.conv` on f32 operands). Its draws are JAX's: uniform within sqrt(1 / (c1 k²)) for the
    weight (HWIO) and the bias."""

    def __init__(self, c1: int, c2: int, k: int = 1, p: int = 0):
        super().__init__()
        self.c1, self.c2, self.k, self.p = c1, c2, k, p
        _leaf(self, "weight", (c2, c1, k, k))
        _leaf(self, "bias", (c2,))

    def init(self, rng) -> dict:
        bound = math.sqrt(1.0 / (self.c1 * self.k * self.k))
        return {"weight": rng.uniform(-bound, bound, (self.k, self.k, self.c1, self.c2)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, (self.c2,)).astype(np.float32)}

    def train_leaves(self) -> dict:
        return {"weight": self.train_weight, "bias": self.train_bias}

    def load_jax(self, p: dict, device, dtype) -> None:
        wide = torch.float64 if dtype == torch.float64 else torch.float32
        self.weight = _hwio_to_oihw(p["weight"], device, wide)
        self.bias = _store(p["bias"], device, dtype)

    def run(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return conv_nhwc(_wide(x), _pick(self, "weight", train), 1, self.p) + _pick(self, "bias", train)


class MaxSigmoidAttnBlock(nn.Module):
    """Text-guided max-sigmoid attention over the pixels (JAX MaxSigmoidAttnBlock): the guide (B, nt, gc) through the
    `gl` linear to ec channels in nh heads, each pixel's embedding (the 1x1 `ec` conv where c1 != ec) against every
    text's, the max over texts over √hc, plus the head's bias, a sigmoid; the 3x3 `proj_conv` of the input weighted by
    it. Products and sigmoid in f32; the output rounded to the input's dtype."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512, scale: bool = False):
        super().__init__()
        self.nh, self.hc, self.ec_dim, self.gc, self.has_scale = nh, c2 // nh, ec, gc, scale
        self.ec = ConvBNAct(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = Linear(gc, ec)
        self.proj_conv = ConvBNAct(c1, c2, 3, 1, act=False)
        _leaf(self, "bias", (nh,))
        if scale:
            _leaf(self, "scale", (1, nh, 1, 1))

    def init(self, rng) -> dict:
        p = {"gl": self.gl.init(rng), "bias": np.zeros((self.nh,), np.float32), "proj_conv": self.proj_conv.init(rng)}
        if self.ec is not None:
            p["ec"] = self.ec.init(rng)
        if self.has_scale:
            p["scale"] = np.ones((1, self.nh, 1, 1), np.float32)
        return p

    def train_leaves(self) -> dict:
        return {"bias": self.train_bias, **({"scale": self.train_scale} if self.has_scale else {})}

    def load_jax(self, p: dict, device, dtype) -> None:
        self.gl.load_jax(p["gl"], device, dtype)
        self.proj_conv.load_jax(p["proj_conv"], device, dtype)
        if self.ec is not None:
            self.ec.load_jax(p["ec"], device, dtype)
        self.bias = _store(p["bias"], device, dtype)
        if self.has_scale:
            self.scale = _store(p["scale"], device, dtype)

    def run(self, x: torch.Tensor, guide: torch.Tensor, train: bool) -> torch.Tensor:
        B, H, W, _ = x.shape
        g = self.gl.run(guide, train).reshape(B, -1, self.nh, self.hc)
        embed = _call(self.ec, x, train) if self.ec is not None else x
        embed = _wide(embed.reshape(B, H, W, self.nh, self.hc))
        aw = torch.einsum("bhwmc,bnmc->bmhwn", embed, g).amax(-1) / self.hc**0.5
        aw = torch.sigmoid(aw + _pick(self, "bias", train)[None, :, None, None])
        if self.has_scale:
            aw = aw * _pick(self, "scale", train)
        y = _wide(_call(self.proj_conv, x, train).reshape(B, H, W, self.nh, self.hc))
        return (y * aw.permute(0, 2, 3, 1)[..., None]).reshape(B, H, W, -1).to(x.dtype)


class C2fAttn(nn.Module):
    """C2f with the text-guided attention branch (JAX C2fAttn): cv1, split, n 3x3 bottlenecks, MaxSigmoidAttnBlock on
    the last part, all concatenated into cv2. Its own module, walked conv by conv: no kernel takes it, as in JAX."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512, shortcut: bool = False,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c, self.n = int(c2 * e), n
        self.cv1 = ConvBNAct(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBNAct((3 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(self.c, self.c, gc=gc, ec=ec, nh=nh)

    def init(self, rng) -> dict:
        return {"cv1": self.cv1.init(rng), "cv2": self.cv2.init(rng), "m": _subtree_init(self.m, rng),
                "attn": self.attn.init(rng)}

    def load_jax(self, p: dict, device, dtype) -> None:
        self.cv1.load_jax(p["cv1"], device, dtype)
        self.cv2.load_jax(p["cv2"], device, dtype)
        _subtree_load(self.m, p["m"], device, dtype)
        self.attn.load_jax(p["attn"], device, dtype)

    def run(self, x: torch.Tensor, guide: torch.Tensor, train: bool) -> torch.Tensor:
        y = _call(self.cv1, x, train)
        ys = [y[..., : self.c], y[..., self.c :]]
        for m in self.m:
            ys.append(_call(m, ys[-1], train))
        ys.append(self.attn.run(ys[-1], guide, train))
        return _call(self.cv2, torch.cat(ys, -1), train)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        return self.run(x, guide, False)

    def forward_train(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        return self.run(x, guide, True)


class ImagePoolingAttn(nn.Module):
    """The image-aware refresh of the text embeddings (JAX ImagePoolingAttn): each input map through its 1x1
    projection to ec channels and max-pooled to k x k bins (torch's adaptive bins: floor starts, ceil ends, as JAX
    slices them), the texts attending over all the bins in nh heads (LayerNorm then linear for query, key and value),
    the projection back to ct, added to the texts. In f32; the refreshed guide comes back rounded to the inputs'
    dtype, as JAX writes it back into its context."""

    def __init__(self, ec: int = 256, ch=(), ct: int = 512, nh: int = 8, k: int = 3, scale: bool = False):
        super().__init__()
        self.ec, self.ct, self.nh, self.k, self.hc, self.has_scale = ec, ct, nh, k, ec // nh, scale
        self.nf = len(ch)
        self.query = nn.ModuleList([LayerNorm(ct), Linear(ct, ec)])
        self.key = nn.ModuleList([LayerNorm(ec), Linear(ec, ec)])
        self.value = nn.ModuleList([LayerNorm(ec), Linear(ec, ec)])
        self.proj = Linear(ec, ct)
        self.projections = nn.ModuleList(RawConv(c, ec, 1) for c in ch)
        if scale:
            _leaf(self, "scale", (1,))

    def init(self, rng) -> dict:
        p = {name: _subtree_init(getattr(self, name), rng) for name in ("query", "key", "value")}
        p["proj"] = self.proj.init(rng)
        p["projections"] = _subtree_init(self.projections, rng)
        if self.has_scale:
            p["scale"] = np.zeros((1,), np.float32)
        return p

    def train_leaves(self) -> dict:
        return {"scale": self.train_scale} if self.has_scale else {}

    def load_jax(self, p: dict, device, dtype) -> None:
        for name in ("query", "key", "value", "proj", "projections"):
            _subtree_load(getattr(self, name), p[name], device, dtype)
        if self.has_scale:
            self.scale = _store(p["scale"], device, dtype)

    @staticmethod
    def _lin(pair, x, train):
        return pair[1].run(pair[0].run(x, train), train)

    def run(self, xs: list, guide: torch.Tensor, train: bool) -> torch.Tensor:
        text = _wide(guide)
        B, k = xs[0].shape[0], self.k
        feats = [F.adaptive_max_pool2d(p.run(x, train).permute(0, 3, 1, 2), k).permute(0, 2, 3, 1).reshape(B, k * k, self.ec)
                 for p, x in zip(self.projections, xs)]
        xflat = torch.cat(feats, 1)
        q = self._lin(self.query, text, train).reshape(B, -1, self.nh, self.hc)
        kk = self._lin(self.key, xflat, train).reshape(B, -1, self.nh, self.hc)
        v = self._lin(self.value, xflat, train).reshape(B, -1, self.nh, self.hc)
        aw = torch.softmax(torch.einsum("bnmc,bkmc->bmnk", q, kk) / self.hc**0.5, -1)
        y = self.proj.run(torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(B, -1, self.ec), train)
        if self.has_scale:
            y = y * _pick(self, "scale", train)
        return (y + text).to(xs[0].dtype)

    def forward(self, xs: list, guide: torch.Tensor) -> torch.Tensor:
        return self.run(xs, guide, False)

    def forward_train(self, xs: list, guide: torch.Tensor) -> torch.Tensor:
        return self.run(xs, guide, True)


class ContrastiveHead(nn.Module):
    """Region-text similarity (JAX ContrastiveHead): pixels and texts each L2-normalised, their products times
    exp(logit_scale), plus the bias; (B, H, W, nt) in f32."""

    def __init__(self):
        super().__init__()
        _leaf(self, "bias", (1,))
        _leaf(self, "logit_scale", ())

    def init(self, rng) -> dict:
        return {"bias": np.array([-10.0], np.float32), "logit_scale": np.array(math.log(1 / 0.07), np.float32)}

    def train_leaves(self) -> dict:
        return {"bias": self.train_bias, "logit_scale": self.train_logit_scale}

    def load_jax(self, p: dict, device, dtype) -> None:
        self.bias = _store(p["bias"], device, dtype)
        self.logit_scale = _store(p["logit_scale"], device, dtype)

    def _image(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return l2_normalize(_wide(x))

    def run(self, x: torch.Tensor, w: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.einsum("bhwc,bkc->bhwk", self._image(x, train), l2_normalize(_wide(w)))
        return y * torch.exp(_pick(self, "logit_scale", train)) + _pick(self, "bias", train)


class BNContrastiveHead(ContrastiveHead):
    """The contrastive head with a BatchNorm on the pixels in place of their L2 norm (JAX BNContrastiveHead). In
    training mode its train form takes the batch's f32 moments and keeps them in `batch_stats`, which
    `utils.optim.apply_bn_stats` folds into `norm`'s running ones as it does a ConvBNAct's; its `norm` group is never
    folded into a conv."""

    def __init__(self, embed: int):
        super().__init__()
        self.embed = embed
        self.norm = BatchNorm(embed)
        self.batch_stats = None
        self.record_bn = True
        self.eval_norm = None  # (running mean, running var, weight, bias) of the inference form

    @property
    def bn(self) -> BatchNorm:
        """`norm` under the name `apply_bn_stats` reads."""
        return self.norm

    def init(self, rng) -> dict:
        return {"norm": {"weight": np.ones((self.embed,), np.float32), "bias": np.zeros((self.embed,), np.float32),
                         "running_mean": np.zeros((self.embed,), np.float32),
                         "running_var": np.ones((self.embed,), np.float32)},
                "bias": np.array([-10.0], np.float32), "logit_scale": np.array(-1.0, np.float32)}

    def train_leaves(self) -> dict:
        n = self.norm
        return {"norm/weight": n.weight, "norm/bias": n.bias, "norm/running_mean": n.running_mean,
                "norm/running_var": n.running_var, **super().train_leaves()}

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        self.eval_norm = tuple(_store(p["norm"][k], device, dtype) for k in ("running_mean", "running_var", "weight", "bias"))

    def _image(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = _wide(x)
        if not train:
            mean, var, w, b = self.eval_norm
        elif self.training:
            var, mean = torch.var_mean(x, (0, 1, 2), correction=0)
            if self.record_bn:
                self.batch_stats = (mean.detach(), var.detach(), x.shape[0] * x.shape[1] * x.shape[2])
            w, b = self.norm.weight, self.norm.bias
        else:
            mean, var, w, b = self.norm.running_mean, self.norm.running_var, self.norm.weight, self.norm.bias
        return (x - mean) * (w * torch.rsqrt(var + BN_EPS)) + b


class _PromptedHead(Detect):
    """What the World and YOLOE heads share: Detect's box branch, a class branch that ends in an `embed`-wide 1x1 conv
    (`cv3`), the contrastive product against the class prompts (`cv4`), level by level. No head kernel takes them."""

    @property
    def kernel_branches(self) -> bool:
        return False

    def check_cm(self) -> None:
        raise ValueError(f"the channel-major head kernel takes the plain Detect head only, not a {type(self).__name__} "
                         "(pallas_head2=False)")

    def _levels(self, xs: list, text: torch.Tensor, train: bool) -> list:
        """Per-level raw outputs (B, H, W, 4*reg_max + nt): box bins, then the class logits in the boxes' dtype."""
        outs = []
        for l, x in enumerate(xs):
            box, emb = x, x
            for j in range(3):
                box, emb = _call(self.cv2[l][j], box, train), _call(self.cv3[l][j], emb, train)
            cls = self.cv4[l].run(emb, text, train)
            outs.append(torch.cat([box, cls.to(box.dtype)], -1))
        return outs

    def forward(self, xs: list, text: torch.Tensor) -> list:
        return self._levels(xs, text, False)

    def forward_train(self, xs: list, text: torch.Tensor) -> list:
        return self._levels(xs, text, True)


class WorldDetect(_PromptedHead):
    """The YOLO-World head (JAX WorldDetect): Detect's box branch; a class branch of two 3x3 ConvBNActs and a 1x1
    conv to `embed` channels, scored against the texts by a ContrastiveHead (a BNContrastiveHead `with_bn`)."""

    def __init__(self, nc: int = 80, embed: int = 512, with_bn: bool = False, ch: tuple = (), legacy: bool = True):
        super().__init__(nc, ch, legacy=True)
        c3 = max(ch[0], min(nc, 100))
        self.embed = embed
        self.cv3 = nn.ModuleList(
            nn.ModuleList([ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3), Conv2d(c3, embed, 1)]) for x in ch
        )
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead() for _ in ch)

    def init(self, rng) -> dict:
        """Detect's draws (its box branch and this class branch in turn, as JAX's Detect.init walks them), then the
        class branch drawn again level by level (JAX keeps these), then the contrastive heads."""
        p = super().init(rng)
        p["cv3"] = _subtree_init(self.cv3, rng)
        p["cv4"] = _subtree_init(self.cv4, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        _subtree_load(self.cv4, p["cv4"], device, dtype)


class SwiGLUFFN(nn.Module):
    """SwiGLU feed-forward (JAX SwiGLUFFN): w12 (gc → e·ec), its halves as silu(a) · b, w3 back to ec; in f32."""

    def __init__(self, gc: int, ec: int, e: int = 4):
        super().__init__()
        self.gc, self.ec, self.e = gc, ec, e
        self.w12 = Linear(gc, e * ec)
        self.w3 = Linear(e * ec // 2, ec)

    def init(self, rng) -> dict:
        b2 = math.sqrt(1.0 / (self.e * self.ec // 2))
        return {"w12": self.w12.init(rng),
                "w3": {"weight": rng.uniform(-b2, b2, (self.ec, self.e * self.ec // 2)).astype(np.float32),
                       "bias": np.zeros((self.ec,), np.float32)}}  # JAX's Residual zeroes w3's bias

    def load_jax(self, p: dict, device, dtype) -> None:
        self.w12.load_jax(p["w12"], device, dtype)
        self.w3.load_jax(p["w3"], device, dtype)

    def run(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x1, x2 = self.w12.run(x, train).chunk(2, -1)
        return self.w3.run(x1 * torch.sigmoid(x1) * x2, train)


def _up(x: torch.Tensor, f: int) -> torch.Tensor:
    return x.repeat_interleave(f, 1).repeat_interleave(f, 2) if f > 1 else x


class SAVPE(nn.Module):
    """Spatial-aware visual prompt embeddings (JAX SAVPE): (B, Q, H, W) binary prompt masks on the P3 grid → (B, Q,
    embed) L2-normalised embeddings. The levels' features (`cv1`, two 3x3 ConvBNActs, and `cv2`, a 1x1, each level
    upsampled to P3 by nearest repeats) go through the raw `cv3` (1x1 to embed) and `cv4` (3x3 to 16 channels); each
    mask (`cv5`, 3x3) joins the 16 channels through `cv6` (a ConvBNAct, then a raw 3x3) into scores over the positions,
    a softmax where positions outside the mask score finfo(f32).min, which pool the embed channels in 16 groups."""

    def __init__(self, ch, c3: int, embed: int):
        super().__init__()
        self.ch, self.c3, self.embed, self.c = tuple(ch), c3, embed, 16
        self.cv1 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3)]) for x in ch)
        self.cv2 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c3, 1)]) for x in ch)
        self.cv3 = RawConv(3 * c3, embed, 1)
        self.cv4 = RawConv(3 * c3, self.c, 3, 1)
        self.cv5 = RawConv(1, self.c, 3, 1)
        self.cv6 = nn.ModuleList([ConvBNAct(2 * self.c, self.c, 3), RawConv(self.c, self.c, 3, 1)])

    def init(self, rng) -> dict:
        return {name: _subtree_init(getattr(self, name), rng) for name in ("cv1", "cv2", "cv3", "cv4", "cv5", "cv6")}

    def load_jax(self, p: dict, device, dtype) -> None:
        for name in ("cv1", "cv2", "cv3", "cv4", "cv5", "cv6"):
            _subtree_load(getattr(self, name), p[name], device, dtype)

    def run(self, xs: list, vp: torch.Tensor, train: bool = False) -> torch.Tensor:
        ups = [2 * i if i in (1, 2) else 1 for i in range(len(xs))]
        y = self.cv4.run(torch.cat([_up(_call(self.cv2[i][0], x, train), u) for i, (x, u) in enumerate(zip(xs, ups))], -1),
                         train)
        feats = []
        for i, (x, u) in enumerate(zip(xs, ups)):
            feats.append(_up(_call(self.cv1[i][1], _call(self.cv1[i][0], x, train), train), u))
        feat = self.cv3.run(torch.cat(feats, -1), train)
        B, H, W, C = feat.shape
        Q = vp.shape[1]
        yq = y[:, None].expand(B, Q, H, W, self.c).reshape(B * Q, H, W, self.c)
        vpf = vp.reshape(B * Q, H, W, 1).to(feat.dtype)
        z = _call(self.cv6[0], torch.cat([yq, self.cv5.run(vpf, train)], -1), train)
        z = self.cv6[1].run(z, train).reshape(B, Q, H * W, self.c)
        vflat = vpf.reshape(B, Q, H * W, 1)
        score = torch.softmax(z * vflat + (1 - vflat) * F32_MIN, 2)
        agg = torch.einsum("bqnc,bncd->bqcd", score, feat.reshape(B, H * W, self.c, C // self.c)).reshape(B, Q, C)
        return l2_normalize(agg)


class YOLOEDetect(_PromptedHead):
    """The YOLOE head (JAX YOLOEDetect): Detect's box branch; the class branch (`cv3`; JAX's `cv3e`) of two 3x3
    ConvBNActs where `legacy`, else two depth-wise 3x3 + 1x1 pairs (`Seq`), then a 1x1 conv to `embed`, scored by a
    BNContrastiveHead against the class prompts; `reprta`, the SwiGLU residual that turns text embeddings into prompts
    (`get_tpe`); `savpe`, the visual prompt encoder (`get_vpe`). After `load_jax` of a tree with an `lrpc` group
    (`YOLOEModel.set_vocab`), `forward_lrpc` runs the prompt-free path."""

    def __init__(self, nc: int = 80, embed: int = 512, with_bn: bool = True, ch: tuple = (), legacy: bool = False):
        super().__init__(nc, ch, legacy=legacy)
        if not with_bn:
            raise ValueError("YOLOE uses the BN contrastive head (with_bn=True), as the JAX package asserts")
        self.ch, self.embed, self.nc0 = tuple(ch), embed, nc  # nc0: the class count Detect's branch was built for
        self.c3 = c3 = max(ch[0], min(nc, 100))
        if legacy:
            levels = ([ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3)] for x in ch)
        else:
            levels = ([Seq(DWConv(x, x, 3), ConvBNAct(x, c3, 1)), Seq(DWConv(c3, c3, 3), ConvBNAct(c3, c3, 1))] for x in ch)
        self.cv3 = nn.ModuleList(nn.ModuleList([*lv, Conv2d(c3, embed, 1)]) for lv in levels)
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) for _ in ch)
        self.reprta = nn.ModuleDict({"m": SwiGLUFFN(embed, embed)})
        self.savpe = SAVPE(ch, c3, embed)
        self.lrpc = None  # {"vocab" | "pf": [(weight (nc, c3), bias (nc,)) a level]} once a tree with `lrpc` is loaded

    def init(self, rng) -> dict:
        """Detect's draws with Detect's own class branch (JAX draws it, then replaces it), then this class branch, the
        contrastive heads, `reprta` and `savpe`."""
        own = self.cv3
        self.cv3 = Detect(self.nc0, self.ch, self.legacy).cv3
        try:
            p = super().init(rng)
        finally:
            self.cv3 = own
        p["cv3"] = _subtree_init(self.cv3, rng)
        p["cv4"] = _subtree_init(self.cv4, rng)
        p["reprta"] = _subtree_init(self.reprta, rng)
        p["savpe"] = self.savpe.init(rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        _subtree_load(self.cv4, p["cv4"], device, dtype)
        _subtree_load(self.reprta, p["reprta"], device, dtype)
        self.savpe.load_jax(p["savpe"], device, dtype)
        self.lrpc = None
        if "lrpc" in p:
            self.lrpc = {g: [(_store(p["lrpc"][g][str(l)]["weight"], device, dtype), _store(p["lrpc"][g][str(l)]["bias"], device, dtype))
                             for l in range(self.nl)] for g in ("vocab", "pf")}

    def get_tpe(self, tpe: torch.Tensor) -> torch.Tensor:
        """Text prompt embeddings (JAX `get_tpe`): the embeddings plus their SwiGLU residual, L2-normalised, in f32,
        with the `reprta` weights that `load_jax` installed."""
        x = _wide(tpe)
        return l2_normalize(x + self.reprta["m"].run(x))

    def get_vpe(self, xs: list, vp: torch.Tensor) -> torch.Tensor:
        """Visual prompt embeddings (JAX `get_vpe`) of (B, Q, H/8, W/8) masks on the P3 grid, from the head's inputs."""
        return self.savpe.run(xs, vp)

    def fuse_text(self, hp: dict, cls_pe) -> dict:
        """The final embed conv, the BN contrastive head and the class prompts (nc, embed) folded into per-level
        (nc, c3) linears, with numpy from the head's subtree `hp` (JAX `fuse_text`)."""
        pe = np.asarray(cls_pe, np.float32)
        pe = pe / np.maximum(np.linalg.norm(pe, axis=-1, keepdims=True), 1e-12)
        out = {}
        for l in range(self.nl):
            conv, head = hp["cv3"][str(l)]["2"], hp["cv4"][str(l)]
            w = np.asarray(conv["weight"], np.float32).reshape(-1, self.embed)  # (c3, embed) from HWIO
            b = np.asarray(conv["bias"], np.float32) if "bias" in conv else np.zeros((self.embed,), np.float32)
            bn = head["norm"]
            s = np.asarray(bn["weight"], np.float32) / np.sqrt(np.asarray(bn["running_var"], np.float32) + BN_EPS)
            wf = w * s[None]
            bf = np.asarray(bn["bias"], np.float32) + (b - np.asarray(bn["running_mean"], np.float32)) * s
            t = pe * np.exp(np.asarray(head["logit_scale"], np.float32))
            out[str(l)] = {"weight": (t @ wf.T).astype(np.float32),
                           "bias": (t @ bf + np.asarray(head["bias"], np.float32)[0]).astype(np.float32)}
        return out

    def forward_lrpc(self, xs: list, conf: float = 0.001):
        """The prompt-free path (JAX `forward_lrpc`) → (per-level f32 outputs, (B, A) keep mask). Each level's class
        features (the branch without its final conv, f32) score the proposal filter's first channel; anchors whose
        sigmoid is not above `conf` have their features zeroed, a static shape, so their logits fall to the fused
        bias. The last level runs unfiltered."""
        if self.lrpc is None:
            raise ValueError("prompt-free inference needs the fused vocabulary: load the tree YOLOEModel.set_vocab returns")
        outs, masks = [], []
        for l, x in enumerate(xs):
            box, emb = x, x
            for j in range(3):
                box = self.cv2[l][j](box)
            for m in self.cv3[l][:-1]:
                emb = m(emb)
            emb = _wide(emb)
            B, h, w, _ = emb.shape
            (vw, vb), (pw, pb) = self.lrpc["vocab"][l], self.lrpc["pf"][l]
            keep = torch.sigmoid((emb @ pw.t() + pb)[..., :1]) > conf
            if l != self.nl - 1:
                emb = emb * keep
                masks.append(keep.reshape(B, h * w))
            else:
                masks.append(torch.ones((B, h * w), dtype=torch.bool, device=emb.device))
            outs.append(torch.cat([_wide(box), emb @ vw.t() + vb], -1))
        return outs, torch.cat(masks, 1)


class YOLOESegment(YOLOEDetect):
    """YOLOEDetect with mask coefficients and prototypes (JAX YOLOESegment): `proto` (Proto on the P3 input) and `cv5`
    (3x3, 3x3, 1x1 to nm a level), plain torch convs as in Segment."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, embed: int = 512, with_bn: bool = True,
                 ch: tuple = (), legacy: bool = False):
        super().__init__(nc, embed, with_bn, ch, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c5 = max(ch[0] // 4, nm)
        self.cv5 = nn.ModuleList(nn.ModuleList([ConvBNAct(x, c5, 3), ConvBNAct(c5, c5, 3), Conv2d(c5, nm, 1)]) for x in ch)

    def init(self, rng) -> dict:
        p = super().init(rng)
        p["proto"] = self.proto.init(rng)
        p["cv5"] = _subtree_init(self.cv5, rng)
        return p

    def load_jax(self, p: dict, device, dtype) -> None:
        super().load_jax(p, device, dtype)
        self.proto.load_jax(p["proto"], device, dtype)
        _subtree_load(self.cv5, p["cv5"], device, dtype)

    def forward(self, xs: list, text: torch.Tensor):
        """(per-level detection outputs, per-level mask coefficients (B, H, W, nm), protos (B, 2H, 2W, nm))."""
        return self._levels(xs, text, False), _branch_walk(self.cv5, xs, False), self.proto(xs[0])

    def forward_train(self, xs: list, text: torch.Tensor):
        return self._levels(xs, text, True), _branch_walk(self.cv5, xs, True), self.proto.forward_train(xs[0])

    def decode_with_masks(self, outs):
        """(preds (B, 4 + nc + nm, A) f32: px xywh boxes, sigmoid scores, mask coefficients; protos), JAX's
        `decode_with_masks`."""
        det, mcs, protos = outs
        B = det[0].shape[0]
        dets = self.decode(det)
        mc = torch.cat([m.reshape(B, -1, self.nm) for m in mcs], 1)
        return torch.cat([dets, mc.transpose(1, 2).to(dets.dtype)], 1), protos
