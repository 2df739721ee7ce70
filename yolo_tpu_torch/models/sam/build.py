"""SAM builders and the bridge from JAX trees (counterpart of yolo_tpu/models/sam/build.py).

`SAM_BUILDERS` builds each variant's `nn.Module` without weights; `sam_params_from_jax(model, tree)`
installs a JAX-layout tree (the port's `model.init(seed)` draws the JAX package's, so the two
packages' `SAM(name)` hold the same numbers). The tree's paths are the state_dict's keys; the
only change is the layout rule of the JAX package's `nn/torch_import.py::_convert`, undone:
4-D kernels HWIO → OIHW (a ConvTranspose's (kh, kw, co, ci) → (ci, co, kh, kw)), while the
4-D tables kept in torch's own layout (`pos_embed`, `pos_embed_window`, `maskmem_tpos_enc`)
pass through.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.models.sam.modules import ImageEncoderViT, MaskDecoder, PromptEncoder, SAMModel, TwoWayTransformer
from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.utils import LOGGER


def _build_sam(encoder_embed_dim, encoder_depth, encoder_num_heads, encoder_global_attn_indexes, img_size=1024):
    prompt_embed_dim, vit_patch_size = 256, 16
    grid = img_size // vit_patch_size
    image_encoder = ImageEncoderViT(
        img_size=img_size, patch_size=vit_patch_size, embed_dim=encoder_embed_dim, depth=encoder_depth,
        num_heads=encoder_num_heads, mlp_ratio=4, qkv_bias=True, use_rel_pos=True,
        global_attn_indexes=tuple(encoder_global_attn_indexes), window_size=14, out_chans=prompt_embed_dim)
    return SAMModel(image_encoder, *_prompt_heads(grid, img_size))


def _prompt_heads(grid: int, img_size: int):
    return (PromptEncoder(embed_dim=256, image_embedding_size=(grid, grid), input_image_size=(img_size, img_size),
                          mask_in_chans=16),
            MaskDecoder(transformer_dim=256, num_multimask_outputs=3,
                        transformer=TwoWayTransformer(depth=2, embedding_dim=256, num_heads=8, mlp_dim=2048),
                        iou_head_depth=3, iou_head_hidden_dim=256))


def build_mobile_sam(img_size=1024):
    """MobileSAM: the TinyViT-5M encoder and SAM's prompt and mask heads (JAX :48)."""
    from yolo_tpu_torch.models.sam.tiny_encoder import TinyViT

    return SAMModel(TinyViT(img_size=img_size, embed_dims=(64, 128, 160, 320), depths=(2, 2, 6, 2),
                            num_heads=(2, 4, 5, 10), window_sizes=(7, 7, 14, 7)), *_prompt_heads(img_size // 16, img_size))


def build_sam_vit_b(img_size=1024):
    return _build_sam(768, 12, 12, (2, 5, 8, 11), img_size)


def build_sam_vit_l(img_size=1024):
    return _build_sam(1024, 24, 16, (5, 11, 17, 23), img_size)


def build_sam_vit_h(img_size=1024):
    return _build_sam(1280, 32, 16, (7, 15, 23, 31), img_size)


def _sam2(name):
    def build(img_size=1024):
        from yolo_tpu_torch.models.sam import sam2

        return getattr(sam2, f"build_sam2_{name}")(img_size)

    return build


SAM_BUILDERS = {
    "sam_b": build_sam_vit_b,
    "sam_l": build_sam_vit_l,
    "sam_h": build_sam_vit_h,
    "mobile_sam": build_mobile_sam,
    "sam2_t": _sam2("t"),
    "sam2_s": _sam2("s"),
    "sam2_b": _sam2("b"),
}

TORCH_LAYOUT_TABLES = ("pos_embed", "rel_pos", "maskmem_tpos_enc")


def to_torch_layout(key: str, arr: np.ndarray, shape) -> np.ndarray:
    """One JAX leaf in its torch parameter's layout (the inverse of the JAX package's `_convert`)."""
    if arr.ndim == 4:
        t = arr.transpose(3, 2, 0, 1)
        if tuple(arr.shape) == tuple(shape) and tuple(t.shape) == tuple(shape):
            if not any(s in key for s in TORCH_LAYOUT_TABLES):
                arr = t
        elif tuple(arr.shape) != tuple(shape):
            arr = t
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: tree {arr.shape} vs module {tuple(shape)}")
    return arr


def sam_params_from_jax(model: torch.nn.Module, tree: dict, dtype: torch.dtype | None = None) -> torch.nn.Module:
    """Install a JAX-layout tree (the JAX package's `params`, or the port's `model.init(seed)`) into `model`,
    every leaf by its path; `dtype` casts the model first. Raises on a missing or unknown path."""
    if dtype is not None:
        model.to(dtype)
    sd = model.state_dict()
    new = {}
    for key, arr in flatten_tree(tree).items():
        if key not in sd:
            raise KeyError(f"{key} of the tree is not a parameter of {type(model).__name__}")
        new[key] = torch.from_numpy(np.ascontiguousarray(to_torch_layout(key, np.asarray(arr, np.float32), sd[key].shape)))
    missing = set(sd) - set(new)
    if missing:
        raise KeyError(f"the tree has no leaf for {sorted(missing)[:8]}")
    model.load_state_dict(new)
    return model


def load_state_dict_checked(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """A torch-layout state dict into `model` by name, as the JAX package's `state_dict_to_params` fills its tree:
    keys the model lacks are reported and skipped, parameters the file lacks keep their values (with a warning)."""
    own = model.state_dict()
    use = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items() if k in own}
    missing = sorted(set(own) - set(use))
    if missing:
        LOGGER.warning(f"torch import: {len(missing)} params not found in checkpoint, kept init values: {missing[:8]}...")
    unused = sorted(k for k in set(sd) - set(own) if not k.endswith("num_batches_tracked"))
    if unused:
        LOGGER.info(f"torch import: {len(unused)} checkpoint tensors unused (e.g. {unused[:5]})")
    model.load_state_dict(use, strict=False)
    return model


def param_count(model: torch.nn.Module) -> int:
    """The values of the model's state dict: the JAX tree's leaf count (BN running statistics included)."""
    return sum(t.numel() for t in model.state_dict().values())
