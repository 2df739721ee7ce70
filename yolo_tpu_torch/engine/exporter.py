"""Reader of the `.npz` checkpoints the JAX package writes (yolo_tpu/engine/exporter.py::save_npz).

The file holds `param::<dotted.path>` arrays (HWIO convs, BN groups unless the
model was fused before saving), the model config as JSON bytes under
`__yaml__` and metadata under `__meta__`. It is read with numpy alone.
"""

from __future__ import annotations

import json

import numpy as np


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_npz(filename, device=None):
    """→ (DetectionModel built from the embedded config, numpy parameter tree, meta).

    The model's modules are empty until `params_from_jax(model, params)` (or a
    FusedDetectTrack built from them) loads the tree; `device=None` is the card."""
    from yolo_tpu_torch.nn.tasks import DetectionModel

    with np.load(filename, allow_pickle=False) as data:
        cfg = json.loads(bytes(data["__yaml__"]).decode())
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data.files else {}
        flat = {k[len("param::") :]: np.asarray(data[k]) for k in data.files if k.startswith("param::")}
    if meta.get("task", "detect") != "detect":
        raise NotImplementedError(f"only detection checkpoints are ported, got task '{meta['task']}'")
    model = DetectionModel(cfg, device=device)
    if meta.get("names"):
        model.names = {int(k): v for k, v in meta["names"].items()}
    params = _unflatten(flat)
    # parameterless layers (Upsample, Concat) flatten to nothing
    for i in range(len(model.layers)):
        params.setdefault("model", {}).setdefault(str(i), {})
    return model, params, meta
