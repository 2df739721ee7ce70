"""YAML → model builder, the BN fold, the weight bridge and the detection model.

Counterpart of yolo_tpu/nn/tasks.py for the detect main path: the same scale
math (c2 = make_divisible(min(c2, max_channels) * width, 8), n = max(round(n *
depth), 1)), the same static stride propagation, the neck fold detection of
`_build_neck_opt` and `predict_parts`. Here the neck fold is always on and
every C2f and Detect level goes through the hand-written kernels (their plain
twins with `plain=True`, or on the CPU).

Weights come from a JAX parameter tree (nested dicts of arrays, HWIO convs),
the format of `DetectionModel.init`/`fuse` and of the `.npz` checkpoints
(engine/exporter.load_npz): `fuse` folds BN on such a tree with numpy, and
`params_from_jax` converts a tree into the modules' OIHW buffers.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn import modules as M

CFG_DIR = Path(__file__).resolve().parents[1] / "cfg"
BN_EPS = 1e-3  # BatchNorm eps of the JAX package (and of torch BatchNorm2d's reference models)

MODULE_MAP = {
    "Conv": M.ConvBNAct,
    "C2f": M.C2f,
    "SPPF": M.SPPF,
    "Concat": M.Concat,
    "Detect": M.Detect,
    "nn.Upsample": M.Upsample,
}


def make_divisible(x, divisor: int = 8) -> int:
    return math.ceil(x / divisor) * divisor


def yaml_model_load(cfg) -> dict:
    """Load a model YAML of the package's cfg/, inferring the scale from a
    letter after the version digits (`yolov8n.yaml` → yolov8.yaml, scale n)."""
    import yaml

    path = Path(cfg)
    stem = path.stem
    m = re.search(r"(\d+)([nslmx])(.*)$", stem)
    scale = ""

    def find(name):
        if path.is_file() and path.name == name:
            return path
        hits = sorted(CFG_DIR.rglob(name))
        return hits[0] if hits else None

    found = find(path.name)
    if found is None and m:
        scale = m.group(2)
        found = find(f"{stem[: m.start(2)]}{m.group(3)}{path.suffix}")
    if found is None:
        raise FileNotFoundError(f"model yaml '{cfg}' not found under {CFG_DIR}")
    d = yaml.safe_load(found.read_text()) or {}
    d["scale"] = d.get("scale") or scale
    return d


def parse_model(d: dict, ch: int):
    """Build the layer modules from a model dict → (layers, froms, save list)."""
    nc, scales = d["nc"], d.get("scales")
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    if scales:
        depth, width, max_channels = scales[d.get("scale") or next(iter(scales))]
    chs, layers, froms, save = [ch], [], [], []
    for i, (f, n, mname, args) in enumerate(d["backbone"] + d["head"]):
        if mname not in MODULE_MAP:
            raise NotImplementedError(f"module '{mname}' is not ported yet")
        mcls = MODULE_MAP[mname]
        args = [
            {"nc": nc, "True": True, "False": False, "None": None}.get(a, a) if isinstance(a, str) else a for a in args
        ]
        n = max(round(n * depth), 1) if n > 1 else n
        if mcls in (M.ConvBNAct, M.C2f, M.SPPF):
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if mcls is M.C2f:
                args.insert(2, n)
                n = 1
        elif mcls is M.Concat:
            c2 = sum(chs[x] for x in f)
        elif mcls is M.Detect:
            args = [args[0], [chs[x] for x in f]]
            c2 = None
        else:
            c2 = chs[f]
        if n > 1:
            raise NotImplementedError(f"repeated '{mname}' layers are not ported yet")
        layers.append(mcls(*args))
        froms.append(f)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)
    return layers, froms, sorted(set(save))


def _compute_strides(layers, froms) -> None:
    """Propagate spatial strides through the graph and set the Detect head's."""
    stride = {}
    for i, (m, f) in enumerate(zip(layers, froms)):
        src = stride.get((f if isinstance(f, int) else f[0]) % i, 1) if i else 1
        if isinstance(m, M.Detect):
            m.stride = [stride[x] for x in f]
            s = None
        elif isinstance(m, M.ConvBNAct):
            s = src * m.s
        elif isinstance(m, M.Upsample):
            s = src // m.scale
        else:
            s = src
        stride[i] = s


def _fold_bn(p: dict) -> dict:
    bn = p["bn"]
    w = np.asarray(p["conv"]["weight"], np.float32)
    scale = np.asarray(bn["weight"], np.float32) / np.sqrt(np.asarray(bn["running_var"], np.float32) + BN_EPS)
    b = np.asarray(bn["bias"], np.float32) - np.asarray(bn["running_mean"], np.float32) * scale
    return {"conv": {"weight": w * scale[None, None, None, :], "bias": b}}


def fuse(params: dict) -> dict:
    """Fold every conv's BN into its weight and bias (exact inference form), with numpy.

    Every subtree holding `conv` and `bn` groups is a ConvBNAct of the JAX
    package; other leaves pass through as numpy arrays."""
    if not isinstance(params, dict):
        return np.asarray(params)
    if "bn" in params and "conv" in params:
        return _fold_bn(params)
    return {k: fuse(v) for k, v in params.items()}


def params_are_fused(params) -> bool:
    if not isinstance(params, dict):
        return True
    return "bn" not in params and all(params_are_fused(v) for v in params.values())


class DetectionModel(nn.Module):
    """YOLO detection model (JAX DetectionModel), inference on fused weights.

    The modules start with zero weights; `params_from_jax` loads a JAX
    parameter tree. `device=None` means the CUDA card (raises without one)."""

    def __init__(self, cfg="yolov8n.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__()
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml["nc"]
        layers, self.froms, self.save = parse_model(self.yaml, ch)
        self.layers = nn.ModuleList(layers)
        _compute_strides(self.layers, self.froms)
        self.head = self.layers[-1]
        self.stride = self.head.stride
        self._build_neck_opt()
        self.device = resolve_device(device)
        self.to(self.device)

    def _build_neck_opt(self) -> None:
        """Find the Upsample→Concat→C2f chains that C2f.call_upconcat folds
        (nearest Upsample(-1) → Concat([-1, skip]) → plain C2f(-1), neither
        intermediate saved): _upconcat {c2f index: skip index}, _neck_skip."""
        self._upconcat, self._neck_skip = {}, set()
        L, Fr = self.layers, self.froms
        for a in range(len(L) - 2):
            b, c = a + 1, a + 2
            if (
                isinstance(L[a], M.Upsample)
                and Fr[a] == -1
                and isinstance(L[b], M.Concat)
                and isinstance(Fr[b], list)
                and len(Fr[b]) == 2
                and Fr[b][0] == -1
                and Fr[b][1] >= 0
                and isinstance(L[c], M.C2f)
                and Fr[c] == -1
                and L[a].scale == 2
                and a not in self.save
                and b not in self.save
            ):
                self._upconcat[c] = Fr[b][1]
                self._neck_skip |= {a, b}

    @torch.no_grad()
    def predict_parts(self, x: torch.Tensor, plain: bool = False):
        """Decoded (boxes (B, A, 4) px xywh, scores (B, A, nc)), f32, from NHWC
        images in the model's dtype. `plain=True` runs the kernels' plain twins."""
        y = {}
        for i, (m, f) in enumerate(zip(self.layers, self.froms)):
            if i in self._neck_skip:
                continue
            if isinstance(m, M.Detect):
                return m.decode_from_inputs([x if j == -1 else y[j] for j in f], plain=plain)
            if i in self._upconcat:
                x = m.call_upconcat(x, y[self._upconcat[i]], plain=plain)
            else:
                x_in = [x if j == -1 else y[j] for j in f] if isinstance(f, list) else (x if f == -1 else y[f])
                x = m(x_in, plain=plain) if isinstance(m, M.C2f) else m(x_in)
            if i in self.save:
                y[i] = x
        raise ValueError("the model has no Detect head")


def params_from_jax(model: DetectionModel, params: dict, dtype=None) -> DetectionModel:
    """Load a JAX parameter tree ({"model": {"<layer>": subtree}}, numpy or JAX
    arrays, HWIO convs; fused or not) into `model`'s modules, on its device,
    in `dtype` (the compute dtype; default f32). Returns the model."""
    if not params_are_fused(params):
        params = fuse(params)
    dtype = dtype or torch.float32
    mp = params["model"]
    for i, m in enumerate(model.layers):
        if hasattr(m, "load_jax"):
            m.load_jax(mp[str(i)], model.device, dtype)
    return model
