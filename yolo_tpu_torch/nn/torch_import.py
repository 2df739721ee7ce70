"""Torch checkpoints (`.pt` of either package, plain state_dicts, {"state_dict": ...}
wrappers, ultralytics model checkpoints) into parameter trees (counterpart of
yolo_tpu/nn/torch_import.py).

The tree's paths are torch submodule names: each leaf takes the tensor of its
dotted path, converted from the torch layout (OIHW → HWIO for 4-D conv weights,
so the DFL's (1, c, 1, 1) becomes (1, 1, c, 1), and a ConvTranspose's (c1, c2, kh, kw)
becomes (kh, kw, c2, c1)); BN's `num_batches_tracked` has no leaf. The tree is the port's JAX-style numpy tree, which `params_from_jax`
installs.
"""

from __future__ import annotations

import numpy as np

from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.utils import LOGGER


def load_torch_checkpoint(path):
    """→ ({name: ndarray}, metadata: epoch, train_args, date, version, yaml, names where present).

    Loads with `weights_only=True` first; only a file that needs more (a pickled module) is
    unpickled in full, with a warning: unpickling runs the file's code."""
    import torch

    try:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:  # any refusal of the safe loader; the full load below raises its own errors
        LOGGER.warning(
            f"{path} is not loadable with weights_only=True; falling back to full unpickling. "
            "Only load checkpoints from sources you trust."
        )
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    meta = {}
    if isinstance(ckpt, dict):
        meta = {k: v for k, v in ckpt.items() if k in ("epoch", "train_args", "date", "version", "yaml", "names")}
        obj = ckpt.get("ema") or ckpt.get("model") or ckpt.get("state_dict") or ckpt
    else:
        obj = ckpt
    if hasattr(obj, "state_dict"):  # an nn.Module
        if hasattr(obj, "yaml"):
            meta["yaml"] = obj.yaml
        if hasattr(obj, "names"):
            meta["names"] = obj.names
        sd = obj.float().state_dict()
    else:
        sd = obj
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in sd.items()}, meta


def _convert(torch_key: str, arr: np.ndarray, target_shape) -> np.ndarray:
    """One torch tensor in the layout of its tree leaf."""
    if arr.ndim == 4:
        t = arr.transpose(2, 3, 1, 0)  # OIHW → HWIO
        if tuple(arr.shape) == tuple(target_shape) and tuple(t.shape) == tuple(target_shape):
            # ambiguous (O == kH and I == kW): conv kernels transpose, channels-last buffers do not
            if not any(s in torch_key for s in ("pos_embed", "rel_pos")):
                arr = t
        elif tuple(arr.shape) != tuple(target_shape):
            arr = t
    if tuple(arr.shape) != tuple(target_shape):
        raise ValueError(f"shape mismatch for {torch_key}: torch {arr.shape} vs model {tuple(target_shape)}")
    return arr


def state_dict_to_params(state_dict: dict, params_template: dict) -> dict:
    """The template tree with each leaf taken from `state_dict` by its dotted path (in the
    leaf's dtype); leaves the checkpoint lacks keep the template's values, with a warning."""
    flat = flatten_tree(params_template)
    missing = [k for k in flat if k not in state_dict]
    if missing:
        LOGGER.warning(f"torch import: {len(missing)} params not found in checkpoint, kept init values: {missing[:8]}...")
    unused = {k for k in set(state_dict) - set(flat) if not k.endswith("num_batches_tracked")}
    if unused:
        LOGGER.info(f"torch import: {len(unused)} checkpoint tensors unused (e.g. {sorted(unused)[:5]})")

    def fill(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                out[k] = fill(v, key)
            elif key in state_dict:
                out[k] = np.asarray(_convert(key, state_dict[key], np.shape(v)), dtype=np.asarray(v).dtype)
            else:
                out[k] = v
        return out

    return fill(params_template)


def load_pt(path, model=None, device=None):
    """A `.pt` → (the model its embedded config and task name, built: DetectionModel, SegmentationModel,
    PoseModel or ClassificationModel, or `model`; the parameter tree; the metadata). Another task raises
    NotImplementedError. The model's modules are empty until the tree is installed; `device=None`
    is the card."""
    from yolo_tpu_torch.nn.tasks import model_class_for

    sd, meta = load_torch_checkpoint(path)
    if model is None:
        yaml_cfg = meta.get("yaml")
        if yaml_cfg is None:
            raise ValueError(f"{path} has no embedded yaml; pass model= explicitly")
        task = (meta.get("train_args") or {}).get("task") if isinstance(meta.get("train_args"), dict) else None
        model = model_class_for(dict(yaml_cfg), task)(dict(yaml_cfg), device=device)
    params = state_dict_to_params(sd, model.init(0))
    return model, params, meta
