"""The `.npz` checkpoints of both packages (counterpart of save_npz / load_npz in
yolo_tpu/engine/exporter.py), `Exporter` (`YOLO.export`: npz and pt), and the
trainer's full train state.

The file holds `param::<dotted.path>` arrays (HWIO convs, BN groups unless the
model was fused before saving), the model config as JSON bytes under
`__yaml__` and metadata under `__meta__`. It is written and read with numpy
alone, so either package reads what the other writes.

The train state (parameters, optimizer moments, EMA, update count) is the
port's own file, `<dir>/state.pt` (torch.save); the JAX package keeps an orbax
checkpoint in the same folder, which the port does not read.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.utils import LOGGER


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
    """→ (the model its config and task name, built (`nn.tasks.model_class_for`: DetectionModel, SegmentationModel,
    PoseModel, OBBModel, ClassificationModel, RTDETRDetectionModel, WorldModel or YOLOEModel, the last two with the
    placeholder prompts); numpy parameter tree; meta). Another task's checkpoint raises NotImplementedError.

    The model's modules are empty until `params_from_jax(model, params)` (or a
    FusedDetectTrack built from them) loads the tree; `device=None` is the card."""
    from yolo_tpu_torch.nn.tasks import model_class_for

    with np.load(filename, allow_pickle=False) as data:
        cfg = json.loads(bytes(data["__yaml__"]).decode())
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data.files else {}
        flat = {k[len("param::") :]: np.asarray(data[k]) for k in data.files if k.startswith("param::")}
    model = model_class_for(cfg, meta.get("task"))(cfg, device=device)
    if meta.get("names"):
        model.names = {int(k): v for k, v in meta["names"].items()}
    params = _unflatten(flat)
    # parameterless layers (Upsample, Concat) flatten to nothing
    for i in range(len(model.layers)):
        params.setdefault("model", {}).setdefault(str(i), {})
    return model, params, meta


def save_npz(model, params: dict, filename="model.npz", meta: dict | None = None) -> Path:
    """Write a numpy parameter tree and the model's config (and `meta`) to one .npz, in the
    JAX package's keys; a pose model's meta names its `kpt_shape` too (its config holds it)."""
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    payload = {f"param::{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    payload["__yaml__"] = np.frombuffer(json.dumps(model.yaml, default=str).encode(), dtype=np.uint8)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"names": getattr(model, "names", {}), "task": getattr(model, "task", "detect"), **_kpt_meta(model), **(meta or {})},
                   default=str).encode(),
        dtype=np.uint8,
    )
    np.savez(filename, **payload)
    LOGGER.info(f"saved {filename} ({filename.stat().st_size / 1e6:.1f} MB)")
    return filename


def _kpt_meta(model) -> dict:
    kpt_shape = getattr(getattr(model, "head", None), "kpt_shape", None)
    return {"kpt_shape": list(kpt_shape)} if kpt_shape else {}


class Exporter:
    """`YOLO.export`: the format in `args` ('npz', its aliases 'savedmodel' and '-', or 'pt'),
    written to <the model's stem>.<suffix> in the working directory, as the JAX package names it.
    Its 'orbax', 'stablehlo' and 'tflite' formats are not ported."""

    def __init__(self, args=None):
        from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg

        self.args = get_cfg(overrides={k: v for k, v in (args or {}).items() if k in DEFAULT_CFG_DICT})

    def __call__(self, model, params) -> Path:
        fmt = (self.args.format or "npz").lower()
        name = Path(str(self.args.model or "model")).stem
        if fmt in ("npz", "savedmodel", "-"):
            return save_npz(model, params, f"{name}.npz")
        if fmt == "pt":
            from yolo_tpu_torch.nn.torch_export import save_pt

            return save_pt(model, params, f"{name}.pt", names=getattr(model, "names", None))
        if fmt in ("orbax", "stablehlo", "tflite"):
            raise NotImplementedError(f"export format '{fmt}' is not ported (npz | pt)")
        raise ValueError(f"unsupported export format '{fmt}' (npz | orbax | stablehlo | pt | tflite)")


def save_train_state(dirname, state: dict) -> Path:
    """Write the trainer's state (tensors, lists of tensors, numbers) to `<dirname>/state.pt`."""
    import torch

    path = Path(dirname) / "state.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)
    return path


def load_train_state(dirname, device) -> dict:
    """The state `save_train_state` wrote, its tensors on `device`."""
    import torch

    return torch.load(Path(dirname) / "state.pt", map_location=device, weights_only=True)
