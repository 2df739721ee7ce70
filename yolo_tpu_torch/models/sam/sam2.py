"""SAM2: the Hiera trunk, the FPN neck, the SAM2 mask decoder and the video memory path
(counterpart of yolo_tpu/models/sam/sam2.py).

The background positional table is interpolated through the matrix cv2's bicubic resize makes
of identity images (`_bicubic_matrix`, JAX's own construction), not `F.interpolate(mode="bicubic")`,
whose edges differ. The video half keeps JAX's fixed-capacity memory bank (one conditioning slot,
rings of recent frames and object pointers, invalid slots masked) as a dict of tensors on the
model's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.models.sam.memory import MemoryAttention, MemoryEncoder, get_1d_sine_pe, sine_pos_embed_2d
from yolo_tpu_torch.models.sam.modules import (
    MLP,
    LayerNorm,
    Linear,
    MaskDecoder,
    PatchEmbed,
    PromptEncoder,
    TwoWayTransformer,
    _Conv,
    _Embedding,
    _empty,
    _zeros,
    conv_nhwc,
    window_partition,
    window_unpartition,
)


def _do_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """MaxPool2d(k = s = stride) on NHWC, floor mode (JAX :30)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


def _bicubic_matrix(src_hw, dst_hw) -> np.ndarray:
    """(dst, src) matrix of cv2's INTER_CUBIC resize (torch's bicubic kernel, a = -0.75), from identity images (JAX :37)."""
    import cv2

    sh, sw = src_hw
    dh, dw = dst_hw
    basis = np.eye(sh * sw, dtype=np.float32).reshape(sh * sw, sh, sw)
    out = np.stack([cv2.resize(b, (dw, dh), interpolation=cv2.INTER_CUBIC) for b in basis])
    return out.reshape(sh * sw, dh * dw).T


class MultiScaleAttention(nn.Module):
    """Attention with the query max-pooled at a stage change (JAX :53)."""

    def __init__(self, dim, dim_out, num_heads, q_stride=None):
        super().__init__()
        self.dim, self.dim_out, self.nh = dim, dim_out, num_heads
        self.q_stride = q_stride
        self.qkv = Linear(dim, dim_out * 3)
        self.proj = Linear(dim_out, dim_out)

    def init(self, rng) -> dict:
        return {"qkv": self.qkv.init(rng), "proj": self.proj.init(rng)}

    def forward(self, x):
        B, H, W, _ = x.shape
        hd = self.dim_out // self.nh
        qkv = self.qkv(x).reshape(B, H * W, 3, self.nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.q_stride:
            q = _do_pool(q.reshape(B, H, W, -1), self.q_stride[0])
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.nh, hd)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, H, W, self.dim_out))


class MultiScaleBlock(nn.Module):
    """Hiera block: windowed attention (query pooling at a stage change), the GELU MLP (JAX :80)."""

    def __init__(self, dim, dim_out, num_heads, mlp_ratio=4.0, q_stride=None, window_size=0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size
        self.q_stride = q_stride
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_stride)
        self.norm2 = LayerNorm(dim_out, 1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        self.has_proj = dim != dim_out

    def init(self, rng) -> dict:
        p = {"norm1": self.norm1.init(rng), "attn": self.attn.init(rng), "norm2": self.norm2.init(rng),
             "mlp": self.mlp.init(rng)}
        if self.has_proj:
            p["proj"] = self.proj.init(rng)
        return p

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.has_proj:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = _do_pool(shortcut, self.q_stride[0])
        ws = self.window_size
        if ws > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride:
            ws = self.window_size // self.q_stride[0]
            H, W = shortcut.shape[1:3]
            pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        mlp = self.mlp.layers  # torch's MLP(act=GELU): layers.0 → GELU → layers.1
        return x + mlp[1](F.gelu(mlp[0](self.norm2(x))))


class Hiera(nn.Module):
    """Hierarchical ViT trunk with 4 stages → stage features fine to coarse, NHWC (JAX :133)."""

    def __init__(self, embed_dim=96, num_heads=1, q_pool=3, q_stride=(2, 2), stages=(2, 3, 16, 3), dim_mul=2.0,
                 head_mul=2.0, window_pos_embed_bkg_spatial_size=(14, 14), window_spec=(8, 4, 14, 7),
                 global_att_blocks=(12, 16, 20)):
        super().__init__()
        self.embed_dim = embed_dim
        self.window_spec = window_spec
        self.bkg_size = window_pos_embed_bkg_spatial_size
        depth = sum(stages)
        self.stage_ends = [sum(stages[: i + 1]) - 1 for i in range(len(stages))]
        q_pool_blocks = [x + 1 for x in self.stage_ends[:-1]][:q_pool]
        blocks, dim, heads, cur_stage = [], embed_dim, num_heads, 1
        self.out_dims = []
        for i in range(depth):
            dim_out = dim
            window_size = self.window_spec[cur_stage - 1]
            if global_att_blocks is not None and i in global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * dim_mul)
                heads = int(heads * head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(dim, dim_out, heads, q_stride=q_stride if i in q_pool_blocks else None,
                                          window_size=window_size))
            dim = dim_out
            if i in self.stage_ends:
                self.out_dims.append(dim_out)
        self.patch_embed = PatchEmbed(7, 3, embed_dim, stride=4, padding=3)
        self.pos_embed = _empty(1, embed_dim, *self.bkg_size)  # NCHW, as torch keeps it
        self.pos_embed_window = _empty(1, embed_dim, window_spec[0], window_spec[0])
        self.blocks = nn.ModuleList(blocks)
        self._interp_cache: dict = {}

    def init(self, rng) -> dict:
        k, c = 7, self.embed_dim
        bound = math.sqrt(1.0 / (3 * k * k))
        return {
            "patch_embed": {"proj": {"weight": rng.uniform(-bound, bound, (k, k, 3, c)).astype(np.float32),
                                     "bias": _zeros(c)}},
            "pos_embed": np.zeros((1, c, *self.bkg_size), np.float32),
            "pos_embed_window": np.zeros((1, c, self.window_spec[0], self.window_spec[0]), np.float32),
            "blocks": {str(i): b.init(rng) for i, b in enumerate(self.blocks)},
        }

    def _pos_embed(self, hw):
        """The bicubic-interpolated background table plus the tiled window table → (1, h, w, C) (JAX :184)."""
        h, w = hw
        if (h, w) not in self._interp_cache:
            self._interp_cache[(h, w)] = _bicubic_matrix(self.bkg_size, (h, w))
        pe = self.pos_embed
        m = torch.from_numpy(self._interp_cache[(h, w)]).to(pe.device, pe.dtype)  # (hw, bkg_hw)
        pos = (pe.reshape(pe.shape[1], -1) @ m.t()).reshape(-1, h, w)
        win = self.pos_embed_window[0]
        if h % win.shape[1] or w % win.shape[2]:
            raise ValueError(f"a {h}x{w} patch grid does not tile the {win.shape[1]}x{win.shape[2]} window table: "
                             "frames must be img_size square")
        tile = win.repeat(1, h // win.shape[1], w // win.shape[2])
        return (pos + tile).permute(1, 2, 0)[None]

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self._pos_embed(x.shape[1:3])
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x)
        return outs


class _Lateral(nn.Module):
    def __init__(self, c, d):
        super().__init__()
        self.conv = _Conv(c, d, 1)


class FpnNeck(nn.Module):
    """Lateral 1x1 convolutions, nearest x2 top-down fusion on `fpn_top_down_levels` (JAX :214)."""

    def __init__(self, d_model, backbone_channel_list, fpn_top_down_levels=(2, 3)):
        super().__init__()
        self.d_model = d_model
        self.ch = list(backbone_channel_list)  # coarse → fine
        self.top_down = set(fpn_top_down_levels)
        self.convs = nn.ModuleList(_Lateral(c, d_model) for c in self.ch)

    def init(self, rng) -> dict:
        p = {"convs": {}}
        for i, c in enumerate(self.ch):
            bound = math.sqrt(1.0 / c)
            p["convs"][str(i)] = {"conv": {
                "weight": rng.uniform(-bound, bound, (1, 1, c, self.d_model)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, (self.d_model,)).astype(np.float32)}}
        return p

    def forward(self, xs):
        """xs fine → coarse; the fused list in the same order."""
        n = len(self.ch) - 1
        out, prev = [None] * len(self.ch), None
        for i in range(n, -1, -1):
            c = self.convs[n - i].conv
            lateral = conv_nhwc(xs[i], c.weight, c.bias)
            if i in self.top_down and prev is not None:
                prev = lateral + prev.repeat_interleave(2, 1).repeat_interleave(2, 2)
            else:
                prev = lateral
            out[i] = prev
        return out


class SAM2MaskDecoder(MaskDecoder):
    """SAM's mask decoder with the object-score token and the high-resolution skips (JAX :257)."""

    def __init__(self, transformer_dim=256, num_multimask_outputs=3, iou_head_depth=3, iou_head_hidden_dim=256,
                 transformer=None, use_high_res_features=True, pred_obj_scores=True, pred_obj_scores_mlp=True,
                 iou_prediction_use_sigmoid=False, dynamic_multimask_via_stability=False,
                 dynamic_multimask_stability_delta=0.05, dynamic_multimask_stability_thresh=0.98,
                 use_multimask_token_for_obj_ptr=False):
        super().__init__(transformer_dim, num_multimask_outputs, iou_head_depth, iou_head_hidden_dim, transformer)
        td = transformer_dim
        if iou_prediction_use_sigmoid:
            self.iou_prediction_head = MLP(td, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth, sigmoid=True)
        self.use_high_res_features = use_high_res_features
        self.pred_obj_scores = pred_obj_scores
        self.pred_obj_scores_mlp = pred_obj_scores_mlp
        self.dynamic_multimask_via_stability = dynamic_multimask_via_stability
        self.dynamic_multimask_stability_delta = dynamic_multimask_stability_delta
        self.dynamic_multimask_stability_thresh = dynamic_multimask_stability_thresh
        self.use_multimask_token_for_obj_ptr = use_multimask_token_for_obj_ptr
        if pred_obj_scores:
            self.obj_score_token = _Embedding(1, td)
            self.pred_obj_score_head = MLP(td, td, 1, 3) if pred_obj_scores_mlp else Linear(td, 1)
        if use_high_res_features:
            self.conv_s0 = _Conv(td, td // 8, 1)
            self.conv_s1 = _Conv(td, td // 4, 1)

    def init(self, rng) -> dict:
        p = super().init(rng)
        td = self.td
        if self.pred_obj_scores:
            p["obj_score_token"] = {"weight": rng.normal(0, 1, (1, td)).astype(np.float32)}
            p["pred_obj_score_head"] = self.pred_obj_score_head.init(rng)
        if self.use_high_res_features:
            b0 = math.sqrt(1.0 / td)
            p["conv_s0"] = {"weight": rng.uniform(-b0, b0, (1, 1, td, td // 8)).astype(np.float32), "bias": _zeros(td // 8)}
            p["conv_s1"] = {"weight": rng.uniform(-b0, b0, (1, 1, td, td // 4)).astype(np.float32), "bias": _zeros(td // 4)}
        return p

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output, high_res_features=None):
        masks, iou_pred, _, obj = self.predict_masks_sam2(image_embeddings, image_pe, sparse, dense, high_res_features)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou_pred[:, sl], obj

    def _stability_scores(self, mask_logits):
        """IoU of the ±delta thresholdings (JAX :303)."""
        d = self.dynamic_multimask_stability_delta
        flat = mask_logits.reshape(*mask_logits.shape[:-2], -1)
        area_i = (flat > d).sum(-1).to(mask_logits.dtype)
        area_u = (flat > -d).sum(-1).to(mask_logits.dtype)
        return torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_u))

    def _dynamic_multimask_via_stability(self, masks, ious):
        """The single-mask output, swapped for the best multimask one where it is unstable (JAX :311)."""
        multi_m, multi_i = masks[:, 1:], ious[:, 1:]
        best = multi_i.argmax(-1)
        bi = torch.arange(masks.shape[0], device=masks.device)
        best_m, best_i = multi_m[bi, best][:, None], multi_i[bi, best][:, None]
        single_m, single_i = masks[:, 0:1], ious[:, 0:1]
        stable = self._stability_scores(single_m) >= self.dynamic_multimask_stability_thresh  # (B, 1)
        return torch.where(stable[..., None, None], single_m, best_m), torch.where(stable, single_i, best_i)

    def forward_video(self, image_embeddings, image_pe, sparse, dense, multimask_output, high_res_features=None):
        """(masks, iou, sam_tokens_out, obj_logits) with the tracking forward's selection (JAX :325)."""
        masks, iou_pred, mask_tokens_out, obj = self.predict_masks_sam2(image_embeddings, image_pe, sparse, dense,
                                                                        high_res_features)
        if multimask_output:
            masks, iou_pred = masks[:, 1:], iou_pred[:, 1:]
        elif self.dynamic_multimask_via_stability:
            masks, iou_pred = self._dynamic_multimask_via_stability(masks, iou_pred)
        else:
            masks, iou_pred = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and self.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return masks, iou_pred, sam_tokens_out, obj

    def predict_masks_sam2(self, image_embeddings, image_pe, sparse, dense, high_res_features=None):
        s = 1 if self.pred_obj_scores else 0
        tokens = self._tokens(sparse, (self.obj_score_token.weight,) if self.pred_obj_scores else ())
        B = sparse.shape[0]
        src = image_embeddings.expand(B, *image_embeddings.shape[1:]) + dense
        hs, src2 = self.transformer(src, image_pe, tokens)
        mask_tokens_out = hs[:, s + 1 : s + 1 + self.num_mask_tokens]
        high_res = high_res_features if self.use_high_res_features else None
        x = self._upscale(src2, B, src.shape[1], src.shape[2], high_res)
        masks = self._masks(mask_tokens_out, x)
        iou_pred = self.iou_prediction_head(hs[:, s])
        if self.pred_obj_scores:
            obj = self.pred_obj_score_head(hs[:, 0])
        else:
            obj = 10.0 * iou_pred.new_ones(iou_pred.shape[0], 1)
        return masks, iou_pred, mask_tokens_out, obj


class _ImageEncoder(nn.Module):
    def __init__(self, trunk, neck):
        super().__init__()
        self.trunk, self.neck = trunk, neck


class SAM2Model(nn.Module):
    """SAM2 promptable segmentation, image and video (JAX :391). `encode_image` returns (the coarsest kept
    level + no_mem_embed, (s0, s1) projected skips); scalp 1 drops the stride-32 level."""

    mask_threshold = 0.0
    NO_OBJ_SCORE = -1024.0

    def __init__(self, trunk: Hiera, neck: FpnNeck, img_size=1024, pixel_mean=(123.675, 116.28, 103.53),
                 pixel_std=(58.395, 57.12, 57.375), num_maskmem=7, mem_dim=64, max_obj_ptrs=16, memory_layers=4,
                 sam2_1=True):
        super().__init__()
        self.image_encoder = _ImageEncoder(trunk, neck)
        self.img_size = img_size
        grid = img_size // 16
        self.embed_hw = (grid, grid)
        self.hidden_dim = 256
        self.num_maskmem = num_maskmem
        self.mem_dim = mem_dim
        self.max_obj_ptrs = max_obj_ptrs
        self.sam2_1 = sam2_1
        self.sigmoid_scale_for_mem_enc = 20.0
        self.sigmoid_bias_for_mem_enc = -10.0
        self.sam_prompt_encoder = PromptEncoder(256, (grid, grid), (img_size, img_size), 16)
        self.sam_mask_decoder = SAM2MaskDecoder(
            256, 3, transformer=TwoWayTransformer(2, 256, 8, 2048, sam2=True), iou_prediction_use_sigmoid=True,
            dynamic_multimask_via_stability=True, use_multimask_token_for_obj_ptr=True)
        self.no_mem_embed = _empty(1, 1, 256)
        self.no_mem_pos_enc = _empty(1, 1, 256)
        self.memory_attention = MemoryAttention(256, memory_layers, 2048, mem_dim, feat_hw=self.embed_hw)
        self.memory_encoder = MemoryEncoder(out_dim=mem_dim, in_dim=256)
        self.obj_ptr_proj = MLP(256, 256, 256, 3)
        self.maskmem_tpos_enc = _empty(num_maskmem, 1, 1, mem_dim)
        self.no_obj_ptr = _empty(1, 256)
        if sam2_1:
            self.obj_ptr_tpos_proj = Linear(256, mem_dim)
            self.no_obj_embed_spatial = _empty(1, mem_dim)
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_std = np.asarray(pixel_std, np.float32)

    @property
    def trunk(self) -> Hiera:
        return self.image_encoder.trunk

    @property
    def neck(self) -> FpnNeck:
        return self.image_encoder.neck

    @property
    def prompt_encoder(self) -> PromptEncoder:
        return self.sam_prompt_encoder

    @property
    def mask_decoder(self) -> SAM2MaskDecoder:
        return self.sam_mask_decoder

    def init(self, seed: int = 0) -> dict:
        """The JAX package's `init(seed)` tree, drawn in its order."""
        rng = np.random.default_rng(seed)
        p = {
            "image_encoder": {"trunk": self.trunk.init(rng), "neck": self.neck.init(rng)},
            "sam_prompt_encoder": self.sam_prompt_encoder.init(rng),
            "sam_mask_decoder": self.sam_mask_decoder.init(rng),
            "no_mem_embed": rng.normal(0, 0.02, (1, 1, 256)).astype(np.float32),
            "no_mem_pos_enc": rng.normal(0, 0.02, (1, 1, 256)).astype(np.float32),
            "memory_attention": self.memory_attention.init(rng),
            "memory_encoder": self.memory_encoder.init(rng),
            "obj_ptr_proj": self.obj_ptr_proj.init(rng),
            "maskmem_tpos_enc": rng.normal(0, 0.02, (self.num_maskmem, 1, 1, self.mem_dim)).astype(np.float32),
            "no_obj_ptr": rng.normal(0, 0.02, (1, 256)).astype(np.float32),
        }
        if self.sam2_1:
            p["obj_ptr_tpos_proj"] = self.obj_ptr_tpos_proj.init(rng)
            p["no_obj_embed_spatial"] = rng.normal(0, 0.02, (1, self.mem_dim)).astype(np.float32)
        return p

    def normalize(self, x):
        w = self.no_mem_embed
        mean = torch.from_numpy(self.pixel_mean).to(w.device, w.dtype)
        std = torch.from_numpy(self.pixel_std).to(w.device, w.dtype)
        return (x.to(w.dtype) - mean) / std

    def encode_frame(self, x):
        """(B, H, W, 3) RGB [0, 255] → (the stride-16 level without no_mem_embed, (s0, s1) projected) (JAX :489)."""
        fpn = self.neck(self.trunk(self.normalize(x)))
        s0, s1, embed = fpn[0], fpn[1], fpn[2]
        d = self.sam_mask_decoder
        return embed, (conv_nhwc(s0, d.conv_s0.weight, d.conv_s0.bias), conv_nhwc(s1, d.conv_s1.weight, d.conv_s1.bias))

    def encode_image(self, x):
        """(B, H, W, 3) RGB [0, 255] → (embed + no_mem_embed, (s0, s1)) (JAX :458)."""
        embed, high_res = self.encode_frame(x)
        return embed + self.no_mem_embed.reshape(1, 1, 1, -1), high_res

    def predict_masks(self, image_embed, high_res, points=None, boxes=None, masks=None, multimask_output=True):
        sparse, dense = self.sam_prompt_encoder(points=points, boxes=boxes, masks=masks)
        image_pe = self.sam_prompt_encoder.get_dense_pe()
        return self.sam_mask_decoder(image_embed, image_pe, sparse, dense, multimask_output, high_res_features=high_res)

    # ---- the video memory path (JAX :489-675) ----
    def vision_pos_embed(self, like: torch.Tensor) -> torch.Tensor:
        """The neck's sine embedding of the stride-16 grid, (L, C)."""
        h, w = self.embed_hw
        return torch.from_numpy(sine_pos_embed_2d(h, w, self.hidden_dim).reshape(h * w, -1)).to(like.device, like.dtype)

    def forward_sam_heads(self, pix_feat, high_res=None, point_coords=None, point_labels=None, mask_inputs=None,
                          multimask_output=False) -> dict:
        """The SAM heads on (memory-conditioned) features (JAX :515): masks at both resolutions, the best one,
        obj_ptr (B, 256) and object_score_logits (B, 1)."""
        B = pix_feat.shape[0]
        if point_coords is None:
            point_coords = pix_feat.new_zeros(B, 1, 2)
            point_labels = -torch.ones(B, 1, dtype=torch.long, device=pix_feat.device)
        sparse, dense = self.sam_prompt_encoder(points=(point_coords, point_labels), masks=mask_inputs)
        image_pe = self.sam_prompt_encoder.get_dense_pe()
        masks, ious, sam_tokens, obj_logits = self.sam_mask_decoder.forward_video(
            pix_feat, image_pe, sparse, dense, multimask_output, high_res_features=high_res)
        is_obj = obj_logits > 0
        masks = torch.where(is_obj[..., None, None], masks, torch.full_like(masks, self.NO_OBJ_SCORE))
        high_res_masks = F.interpolate(masks, (self.img_size, self.img_size), mode="bilinear", align_corners=False)
        sam_token = sam_tokens[:, 0]
        if multimask_output:
            bi = torch.arange(B, device=masks.device)
            best = ious.argmax(-1)
            low_res, high_res_m = masks[bi, best][:, None], high_res_masks[bi, best][:, None]
            if sam_tokens.shape[1] > 1:
                sam_token = sam_tokens[bi, best]
        else:
            low_res, high_res_m = masks, high_res_masks
        obj_ptr = self.obj_ptr_proj(sam_token)
        lam = is_obj.to(obj_ptr.dtype)
        obj_ptr = lam * obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return {"low_res_multimasks": masks, "high_res_multimasks": high_res_masks, "ious": ious,
                "low_res_masks": low_res, "high_res_masks": high_res_m, "obj_ptr": obj_ptr,
                "object_score_logits": obj_logits}

    def encode_new_memory(self, pix_feat, high_res_masks, object_score_logits):
        """The frame's features and its predicted mask → (memory (B, L, mem_dim), positions (L, mem_dim)) (JAX :560)."""
        mask_for_mem = torch.sigmoid(high_res_masks) * self.sigmoid_scale_for_mem_enc + self.sigmoid_bias_for_mem_enc
        feats, pos = self.memory_encoder(pix_feat, mask_for_mem, skip_mask_sigmoid=True)
        if self.sam2_1:
            is_obj = (object_score_logits > 0).to(feats.dtype)
            feats = feats + (1.0 - is_obj)[..., None, None] * self.no_obj_embed_spatial[0]
        B, h, w, c = feats.shape
        return feats.reshape(B, h * w, c), pos.reshape(h * w, c)

    def init_memory_bank(self, B: int = 1) -> dict:
        """One conditioning slot, a ring of the last num_maskmem - 1 frames, a ring of object pointers (JAX :573)."""
        h, w = self.embed_hw
        Lm, R, P = h * w, self.num_maskmem - 1, self.max_obj_ptrs - 1
        ref = self.no_mem_embed
        return {"cond_feat": ref.new_zeros(B, Lm, self.mem_dim), "cond_ptr": ref.new_zeros(B, 256), "cond_idx": 0,
                "recent_feat": ref.new_zeros(B, R, Lm, self.mem_dim),
                "recent_valid": torch.zeros(B, R, dtype=torch.bool, device=ref.device),
                "ptrs": ref.new_zeros(B, P, 256), "ptr_valid": torch.zeros(B, P, dtype=torch.bool, device=ref.device),
                "frame_idx": 0}

    def prepare_memory_conditioned_features(self, embed, bank: dict, num_frames: int, reverse: bool = False):
        """The current features fused with the bank (JAX :593). The pointers' temporal distances are processing
        order, positive in both directions, so `reverse` changes nothing here (as in JAX)."""
        B, H, W, C = embed.shape
        Lm, R, M = H * W, self.num_maskmem - 1, self.num_maskmem
        curr = embed.reshape(B, Lm, C)
        curr_pos = self.vision_pos_embed(curr)[None].expand(B, Lm, C)
        mem_pos_spatial = torch.from_numpy(sine_pos_embed_2d(H, W, self.mem_dim).reshape(Lm, -1)).to(curr.device, curr.dtype)
        tpos = self.maskmem_tpos_enc.reshape(M, self.mem_dim)
        blocks = torch.cat([bank["cond_feat"][:, None], bank["recent_feat"]], 1)  # (B, M, Lm, mem)
        block_tpos = torch.cat([tpos[M - 1][None], tpos[:R]], 0)
        pos_blocks = mem_pos_spatial[None] + block_tpos[:, None]
        mem_spatial = blocks.reshape(B, M * Lm, self.mem_dim)
        pos_spatial = pos_blocks.reshape(1, M * Lm, self.mem_dim).expand(B, M * Lm, self.mem_dim)
        valid_blocks = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=curr.device), bank["recent_valid"]], 1)
        mask_spatial = valid_blocks.repeat_interleave(Lm, 1)

        P = self.max_obj_ptrs - 1
        split = C // self.mem_dim
        ptrs = torch.cat([bank["cond_ptr"][:, None], bank["ptrs"]], 1)  # (B, P + 1, C)
        ptr_valid = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=curr.device), bank["ptr_valid"]], 1)
        tdiff = torch.tensor([bank["frame_idx"] - bank["cond_idx"], *range(1, P + 1)], dtype=curr.dtype,
                             device=curr.device)
        t_diff_max = max(min(num_frames, self.max_obj_ptrs) - 1, 1)
        if self.sam2_1:
            obj_pos = self.obj_ptr_tpos_proj(get_1d_sine_pe(tdiff / t_diff_max, dim=C))
        else:
            obj_pos = curr.new_zeros(P + 1, self.mem_dim)
        ptr_tokens = ptrs.reshape(B, (P + 1) * split, self.mem_dim)
        ptr_pos = obj_pos.repeat_interleave(split, 0)[None].expand(B, (P + 1) * split, self.mem_dim)
        mask_ptr = ptr_valid.repeat_interleave(split, 1)

        memory = torch.cat([mem_spatial, ptr_tokens], 1)
        memory_pos = torch.cat([pos_spatial, ptr_pos], 1)
        key_mask = torch.cat([mask_spatial, mask_ptr], 1)
        out = self.memory_attention(curr, memory, curr_pos, memory_pos, num_obj_ptr_tokens=(P + 1) * split,
                                    key_mask=key_mask)
        return out.reshape(B, H, W, C)

    def update_memory_bank(self, bank: dict, mem_feat, obj_ptr, is_cond: bool) -> dict:
        """The bank after a frame: a conditioning frame seeds its slot, a tracked one shifts into the rings (JAX :655)."""
        bank = dict(bank)
        if is_cond:
            bank.update(cond_feat=mem_feat, cond_ptr=obj_ptr, cond_idx=bank["frame_idx"])
            return bank
        ones = torch.ones(mem_feat.shape[0], 1, dtype=torch.bool, device=mem_feat.device)
        bank["recent_feat"] = torch.cat([mem_feat[:, None], bank["recent_feat"][:, :-1]], 1)
        bank["recent_valid"] = torch.cat([ones, bank["recent_valid"][:, :-1]], 1)
        bank["ptrs"] = torch.cat([obj_ptr[:, None], bank["ptrs"][:, :-1]], 1)
        bank["ptr_valid"] = torch.cat([ones, bank["ptr_valid"][:, :-1]], 1)
        return bank


def build_sam2_t(img_size=1024):
    """SAM2 Hiera-Tiny (JAX :676)."""
    trunk = Hiera(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9),
                  window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 14, 7))
    return SAM2Model(trunk, FpnNeck(256, [768, 384, 192, 96]), img_size=img_size)


def build_sam2_s(img_size=1024):
    trunk = Hiera(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2), global_att_blocks=(7, 10, 13),
                  window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 14, 7))
    return SAM2Model(trunk, FpnNeck(256, [768, 384, 192, 96]), img_size=img_size)


def build_sam2_b(img_size=1024):
    trunk = Hiera(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3), global_att_blocks=(12, 16, 20),
                  window_pos_embed_bkg_spatial_size=(14, 14), window_spec=(8, 4, 14, 7))
    return SAM2Model(trunk, FpnNeck(256, [896, 448, 224, 112]), img_size=img_size)
