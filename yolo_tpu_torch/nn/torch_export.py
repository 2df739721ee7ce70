"""Parameter trees to torch-layout `.pt` checkpoints (counterpart of yolo_tpu/nn/torch_export.py).

The tree's paths are torch submodule names, so the state_dict falls out
mechanically: 4-D conv kernels go HWIO → OIHW (the DFL's (1, 1, c, 1) becomes
(1, c, 1, 1)), everything else passes through. The file is a plain
{"state_dict", "yaml", "names", "train_args", "format"} dict of tensors, the
JAX package's format: either package reads what the other writes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict tree, in its insertion order."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def params_to_state_dict(params: dict) -> dict:
    """Parameter tree → {torch name: f32 ndarray} in torch layouts (4-D kernels HWIO → OIHW;
    channels-last `pos_embed` / `rel_pos` buffers pass through)."""
    sd = {}
    for key, leaf in flatten_tree(params).items():
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.ndim == 4 and not any(s in key for s in ("pos_embed", "rel_pos")):
            arr = arr.transpose(3, 2, 0, 1)
        sd[key] = arr
    return sd


def save_pt(model, params: dict, filename, names=None, train_args=None) -> Path:
    """Write `params` as a `.pt` with the model's config and class names; no module code is
    pickled, so `torch.load(weights_only=True)` reads it."""
    import torch

    filename = Path(filename)
    yaml_cfg = getattr(model, "yaml", None)
    ckpt = {
        "state_dict": {k: torch.from_numpy(v.copy()) for k, v in params_to_state_dict(params).items()},
        "yaml": dict(yaml_cfg) if isinstance(yaml_cfg, dict) else yaml_cfg,
        "names": names or getattr(model, "names", None),
        "train_args": dict(train_args or {}),
        "format": "yolo_tpu.state_dict.v1",
    }
    torch.save(ckpt, filename)
    return filename
