"""YAML → model builder, the BN fold, the weight bridge, the detection, segmentation, pose and classification models.

Counterpart of yolo_tpu/nn/tasks.py for the detect, segment, pose, obb and classify tasks: the same scale
math (c2 = make_divisible(min(c2, max_channels) * width, 8), n = max(round(n *
depth), 1)), the same static stride propagation, the neck fold detection of
`_build_neck_opt`, `predict_parts` and `predict`. Every C2f and Detect level
goes through the hand-written kernels (their plain twins with `plain=True`,
or on the CPU); both fold the neck unless `neck_opt=False`. An int8 tree
(nn/quantize.py) walks without the fold and without the C2f and head kernels.
`predict_augment` (test-time augmentation: three scales, one flipped, through
`predict`), `embed_features` (pooled layer outputs) and the NMS `Ensemble` of
several models are the JAX package's too. `SegmentationModel` (the segment task,
a Segment head: the detection forward plus mask coefficients and prototypes), `PoseModel`
(the pose task, a Pose head: the detection forward plus decoded keypoints) and
`OBBModel` (the obb task, an OBB head: the detection forward plus rotated boxes and their angles) and
`ClassificationModel` (the classify task, a Classify head) share the build and both
walks (`BaseModel`); `model_class_for` picks a checkpoint's class from its config and task.

Weights come from a JAX parameter tree (nested dicts of arrays, HWIO convs),
the format of `DetectionModel.init`/`fuse` and of the `.npz` checkpoints
(engine/exporter.load_npz): `fuse` folds BN on such a tree with numpy, and
`params_from_jax` converts a tree into the modules' OIHW buffers. Training
(`forward_features`) runs the modules' train form: `load_train_params` loads
an unfused tree into it as it is, and `params_to_jax` returns it as such a
tree, which the validator, the checkpoints and the inference path then take.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn import modules as M

CFG_DIR = Path(__file__).resolve().parents[1] / "cfg"
BN_EPS = M.BN_EPS
EXTRA_OUTPUT_TASKS = ("segment", "pose", "obb")  # masks, keypoints or angles beside the boxes: the detect-only entry points refuse them

MODULE_MAP = {
    "Conv": M.ConvBNAct,
    "C2f": M.C2f,
    "SPPF": M.SPPF,
    "Concat": M.Concat,
    "Detect": M.Detect,
    "Segment": M.Segment,
    "Pose": M.Pose,
    "OBB": M.OBB,
    "Classify": M.Classify,
    "nn.Upsample": M.Upsample,
}


def make_divisible(x, divisor: int = 8) -> int:
    return math.ceil(x / divisor) * divisor


def yaml_model_load(cfg) -> dict:
    """Load a model YAML of the package's cfg/, inferring the scale from a
    letter after the version digits (`yolov8n.yaml` → yolov8.yaml, scale n;
    `yolov5n6.yaml` → yolov5-p6.yaml; `yolo_nas_s.yaml` → yolo_nas.yaml, scale s).
    A file named exactly wins over the unified one: some families have a graph per scale."""
    import yaml

    path = Path(cfg)
    stem = re.sub(r"(\d+)([nslmx])6(.+)?$", r"\1\2-p6\3", path.stem)
    path = path.with_name(stem + path.suffix)
    m = re.search(r"(\d+)([nslmx])(.*)$", stem)
    nas = re.fullmatch(r"yolo_nas_([sml])", stem)
    scale = ""

    def find(name):
        if path.is_file() and path.name == name:
            return path
        hits = sorted(CFG_DIR.rglob(name))
        return hits[0] if hits else None

    found = find(path.name)
    if found is None and nas:
        scale = nas.group(1)
        found = find(f"yolo_nas{path.suffix}")
    elif found is None and m:
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
    if d.get("activation") and "silu" not in str(d["activation"]).lower():
        raise NotImplementedError(f"module 'Conv' with activation {d['activation']} is not ported yet (the port's ConvBNAct is SiLU)")
    chs, layers, froms, save = [ch], [], [], []
    for i, (f, n, mname, args) in enumerate(d["backbone"] + d["head"]):
        if mname not in MODULE_MAP:
            raise NotImplementedError(f"module '{mname}' is not ported yet")
        mcls = MODULE_MAP[mname]
        args = [
            {"nc": nc, "True": True, "False": False, "None": None}.get(a, a) if isinstance(a, str) else a for a in args
        ]
        if mname == "Conv":
            _check_conv_args(args)
            args = args[:3]
        n = max(round(n * depth), 1) if n > 1 else n
        if mcls in (M.ConvBNAct, M.C2f, M.SPPF, M.Classify):
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
        elif mcls is M.Segment:  # npr width-scales, as in the JAX package
            args = [args[0], args[1], make_divisible(min(args[2], max_channels) * width, 8), [chs[x] for x in f]]
            c2 = None
        elif mcls is M.Pose:  # the yaml's kpt_shape, as in the JAX package
            args = [args[0], tuple(d["kpt_shape"]) if d.get("kpt_shape") else args[1], [chs[x] for x in f]]
            c2 = None
        elif mcls is M.OBB:
            args = [*args[:2], [chs[x] for x in f]]
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


def _check_conv_args(args) -> None:
    """A `Conv` row is [c2, k, s, p, g, d, act]; the port's ConvBNAct takes c2, k and s, pads k // 2 and
    ends in SiLU. Any other padding, groups, dilation or activation raises NotImplementedError naming it."""
    k = args[1] if len(args) > 1 else 1
    names = ("padding", "groups", "dilation", "activation")
    defaults = ((None, k // 2), (1,), (1,), (True,))
    for name, v, ok in zip(names, args[3:], defaults):
        if v not in ok:
            raise NotImplementedError(f"module 'Conv' with {name} {v!r} is not ported yet (the port's ConvBNAct pads k // 2, "
                                      "has no groups or dilation and ends in SiLU)")
    if len(args) > 7:
        raise NotImplementedError(f"module 'Conv' with arguments {args[7:]!r} is not ported yet")


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
    """A ConvBNAct's `conv` + `bn` → {conv: {weight, bias}}; a ConvTranspose's `conv_transpose` + `bn` →
    {conv_transpose: {weight}, bias} (its kernel (kh, kw, c2, c1) scaled on the output axis 2)."""
    bn = p["bn"]
    scale = np.asarray(bn["weight"], np.float32) / np.sqrt(np.asarray(bn["running_var"], np.float32) + BN_EPS)
    b = np.asarray(bn["bias"], np.float32) - np.asarray(bn["running_mean"], np.float32) * scale
    if "conv_transpose" in p:
        w = np.asarray(p["conv_transpose"]["weight"], np.float32)
        return {"conv_transpose": {"weight": w * scale[None, None, :, None]}, "bias": b}
    w = np.asarray(p["conv"]["weight"], np.float32)
    return {"conv": {"weight": w * scale[None, None, None, :], "bias": b}}


def fuse(params: dict) -> dict:
    """Fold every conv's BN into its weight and bias (exact inference form), with numpy.

    Every subtree holding `conv` (or `conv_transpose`) and `bn` groups is a ConvBNAct (a
    ConvTranspose) of the JAX package; other leaves pass through as numpy arrays."""
    if not isinstance(params, dict):
        return np.asarray(params)
    if "bn" in params and ("conv" in params or "conv_transpose" in params):
        return _fold_bn(params)
    return {k: fuse(v) for k, v in params.items()}


def params_are_fused(params) -> bool:
    if not isinstance(params, dict):
        return True
    return "bn" not in params and all(params_are_fused(v) for v in params.values())


class BaseModel(nn.Module):
    """A model built from a YAML (JAX BaseModel): the layers, the graph walk of the inference form
    (`_walk`, `embed_features`) and of the train form (`forward_features`), and `init`.

    The modules start with zero weights; `params_from_jax` loads a JAX parameter
    tree into the inference form, `load_train_params` into the train form.
    `device=None` means the CUDA card (raises without one)."""

    task = None

    def __init__(self, cfg, ch: int = 3, nc: int | None = None, device=None):
        super().__init__()
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml["nc"]
        self.names = {i: f"{i}" for i in range(self.nc)}
        layers, self.froms, self.save = parse_model(self.yaml, ch)
        self.layers = nn.ModuleList(layers)
        _compute_strides(self.layers, self.froms)
        self._build_neck_opt()
        for name, m in self.named_modules():
            if isinstance(m, M.ConvBNAct):
                m.path = "/".join(["model", *name.split(".")[1:]])
        self.int8 = False  # whether the loaded inference form holds int8 convs (nn/quantize.py); params_from_jax sets it
        self.device = resolve_device(device)
        self.to(self.device)
        self.eval()  # the train form's BN follows `.train()` / `.eval()`; the inference form never looks

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

    def init(self, seed: int = 0) -> dict:
        """The JAX package's initial parameter tree for this model, bit for bit: one
        `np.random.default_rng(seed)` walked through the layers in order, each module
        drawing as its JAX counterpart does (unfused: `conv` and `bn` groups, HWIO)."""
        rng = np.random.default_rng(seed)
        return {"model": {str(i): m.init(rng) for i, m in enumerate(self.layers)}}

    def int8_flow_paths(self) -> set:
        """Tree paths of the convs that may emit int8 (JAX `int8_flow_paths`): every plain ConvBNAct
        layer, SPPF's two, a C2f's cv1 and cv2 and its bottlenecks' cv1 (and cv2 without a residual)."""
        paths = set()
        for i, m in enumerate(self.layers):
            base = f"model/{i}"
            if isinstance(m, M.C2f):
                paths |= {f"{base}/cv1", f"{base}/cv2"}
                for j, b in enumerate(m.m):
                    paths |= {f"{base}/m/{j}/cv1"} if b.add else {f"{base}/m/{j}/cv1", f"{base}/m/{j}/cv2"}
            elif isinstance(m, M.SPPF):
                paths |= {f"{base}/cv1", f"{base}/cv2"}
            elif isinstance(m, M.ConvBNAct):
                paths.add(base)
        return paths

    def forward_features(self, x: torch.Tensor, remat: bool = False):
        """Per-level raw head outputs [(B, H, W, 4*reg_max + nc)] of NHWC images, computed in
        x's dtype through the train form (JAX `forward_features`): every layer materialised,
        no neck fold and no kernel. In training mode (`.train()`) BN takes the batch's
        moments and each ConvBNAct keeps them for `utils.optim.apply_bn_stats`. `remat`
        checkpoints every layer but the head (torch.utils.checkpoint): its activations are
        recomputed in the backward, its BN moments recorded once."""
        y = {}
        for i, (m, f) in enumerate(zip(self.layers, self.froms)):
            x_in = [x if j == -1 else y[j] for j in f] if isinstance(f, list) else (x if f == -1 else y[f])
            if remat and not isinstance(m, M.Detect):
                x = _remat(m, x_in)
            else:
                x = m.forward_train(x_in) if hasattr(m, "forward_train") else m(x_in)
            if i in self.save:
                y[i] = x
        return x

    def _walk(self, x: torch.Tensor, plain: bool, neck_opt: bool = True, upto: int | None = None, collect=()):
        """Walk the inference modules over layers [0, upto) → (the Detect head's input maps, or
        the last layer's output where the walk ends before the head; {i: output} of the layers in
        `collect`). `neck_opt` folds the Upsample→Concat→C2f chains into `C2f.call_upconcat`."""
        y, col = {}, {}
        for i, (m, f) in enumerate(zip(self.layers[:upto], self.froms[:upto])):
            if neck_opt and i in self._neck_skip:
                continue
            if isinstance(m, M.Detect):
                return [x if j == -1 else y[j] for j in f], col
            if neck_opt and i in self._upconcat:
                x = m.call_upconcat(x, y[self._upconcat[i]], plain=plain)
            else:
                x_in = [x if j == -1 else y[j] for j in f] if isinstance(f, list) else (x if f == -1 else y[f])
                x = m(x_in, plain=plain) if isinstance(m, M.C2f) else m(x_in)
            if i in self.save:
                y[i] = x
            if i in collect:
                col[i] = x
        return x, col

    @torch.no_grad()
    def embed_features(self, x: torch.Tensor, idx=None, plain: bool = False) -> torch.Tensor:
        """Pooled embeddings (JAX `embed_features`): the outputs of layers `idx` (default the one
        before the head) of NHWC images, each mean-pooled over the map to (B, C), concatenated. The
        walk folds the neck unless a requested layer is an Upsample or Concat the fold skips."""
        idx = sorted(set(idx or [len(self.layers) - 2]))
        _, col = self._walk(x, plain, neck_opt=not set(idx) & self._neck_skip, upto=max(idx) + 1, collect=set(idx))
        return torch.cat([col[i].mean(dim=(1, 2)) if col[i].ndim == 4 else col[i] for i in idx if i in col], -1)


class DetectionModel(BaseModel):
    """YOLO detection model (JAX DetectionModel): inference on fused weights, training on the unfused ones."""

    task = "detect"

    def __init__(self, cfg="yolov8n.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        self.head = self.layers[-1]
        if not isinstance(self.head, M.Detect):
            raise ValueError(f"a DetectionModel's last layer is a Detect head, not {type(self.head).__name__}")
        self.stride = self.head.stride

    def _head_inputs(self, x: torch.Tensor, plain: bool, neck_opt: bool = True):
        """The Detect head's input maps (the graph walked up to the head)."""
        xs, _ = self._walk(x, plain, neck_opt)
        if not isinstance(xs, list):
            raise ValueError("the model has no Detect head")
        return xs

    def _decode_head(self, xs, plain: bool, head_cm: bool = False):
        if self.int8:  # no kernel takes int8: the head conv by conv
            return self.head.decode_parts(self.head(xs))
        decode = self.head.decode_from_inputs_cm if head_cm else self.head.decode_from_inputs
        return decode(xs, plain=plain)

    @torch.no_grad()
    def predict_parts(self, x: torch.Tensor, plain: bool = False, head_cm: bool = False, neck_opt: bool | None = None):
        """Decoded (boxes (B, A, 4) px xywh, scores (B, A, nc)), f32, from NHWC
        images in the model's dtype. `plain=True` runs the kernels' plain twins.
        `head_cm=True` sends the Detect levels through the channel-major head
        kernel instead of the default one. `neck_opt` (None: on for a float model,
        off for an int8 one) folds the neck."""
        xs = self._head_inputs(x, plain, not self.int8 if neck_opt is None else neck_opt)
        return self._decode_head(xs, plain, head_cm)

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False) -> torch.Tensor:
        """Decoded predictions (B, 4 + nc, A): px xywh boxes, then sigmoid
        scores, the layout `ops.nms.non_max_suppression` takes. The C2f blocks
        and the Detect levels go through the kernels (`plain=True`: their
        twins); `neck_opt=False` materialises the neck's upsample and concat.
        An int8 model walks its convs one by one (pass neck_opt=False)."""
        xs = self._head_inputs(x, plain, neck_opt)
        return self.head.pack(*self._decode_head(xs, plain))

    @torch.no_grad()
    def predict_augment(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Test-time augmentation (JAX `predict_augment`): the images at scales 1, 0.83 (flipped
        left-right) and 0.67, each through `predict` (the neck folded, the kernels), boxes mapped
        back to the input's pixels; the full-scale pass drops its coarsest level's anchors and the
        smallest pass its finest level's, then all three join on the anchor axis → (B, 4 + nc, A')."""
        W = x.shape[2]
        gs = int(max(self.stride))
        ys = []
        for ratio, flip in zip(AUGMENT_SCALES, AUGMENT_FLIPS):
            yi = self.predict(_scale_img(x.flip(2) if flip else x, ratio, gs), neck_opt=not self.int8, plain=plain)
            bx = yi[:, 0:1] / ratio
            if flip:
                bx = W - bx
            ys.append(torch.cat([bx, yi[:, 1:2] / ratio, yi[:, 2:4] / ratio, yi[:, 4:]], 1))
        nl = len(self.stride)
        g = sum(4**k for k in range(nl))  # anchors per coarsest-level anchor, the levels 2x apart
        ys[0] = ys[0][..., : -(ys[0].shape[-1] // g)]
        ys[-1] = ys[-1][..., (ys[-1].shape[-1] // g) * 4 ** (nl - 1) :]
        return torch.cat(ys, -1)

AUGMENT_SCALES = (1.0, 0.83, 0.67)
AUGMENT_FLIPS = (False, True, False)
AUGMENT_PAD = 0.447  # the gray of the padded border, after /255


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) f32 weights of `jax.image.resize(..., "bilinear")` along one axis: JAX's
    scale_and_translate with the triangle kernel, widened by 1/scale when it shrinks (antialias,
    JAX's default), columns normalised, samples outside the input zeroed."""
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / torch.clamp(inv, min=1.0)
    w = torch.clamp(1.0 - dist.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


def _scale_img(x: torch.Tensor, ratio: float, gs: int) -> torch.Tensor:
    """NHWC images scaled by `ratio` (JAX's antialiased bilinear resize, in x's dtype), then padded
    at the bottom and right to multiples of `gs` with AUGMENT_PAD."""
    if ratio == 1.0:
        return x
    B, H, W, C = x.shape
    h, w = int(H * ratio), int(W * ratio)
    wh = _resize_weights(H, h).to(device=x.device, dtype=x.dtype)
    ww = _resize_weights(W, w).to(device=x.device, dtype=x.dtype)
    xi = torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)
    return F.pad(xi, (0, 0, 0, -w % gs, 0, -h % gs), value=AUGMENT_PAD)


def param_count(params) -> int:
    """The number of values in a parameter tree (nested dicts, lists or tuples of arrays)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return int(np.size(params))


class ClassificationModel(BaseModel):
    """YOLO classification model (JAX ClassificationModel): the backbone (its C2f blocks through the
    kernel, `plain=True`: the twin) and the Classify head; `stride` is [1] (no multi-scale head)."""

    task = "classify"

    def __init__(self, cfg="yolov8n-cls.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        self.head = self.layers[-1]
        if not isinstance(self.head, M.Classify):
            raise ValueError(f"a ClassificationModel's last layer is a Classify head, not {type(self.head).__name__}")
        self.stride = [1]

    @torch.no_grad()
    def predict(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Class probabilities (B, nc) in f32 from NHWC images in the model's dtype: the softmax of
        the head's f32 logits."""
        logits, _ = self._walk(x, plain, neck_opt=False)
        return torch.softmax(logits.float(), -1)


class SegmentationModel(DetectionModel):
    """YOLO segmentation model (JAX SegmentationModel): the detection graph with a Segment head."""

    task = "segment"

    def __init__(self, cfg="yolov8n-seg.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        if not isinstance(self.head, M.Segment):
            raise ValueError(f"a SegmentationModel's last layer is a Segment head, not {type(self.head).__name__}")

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False):
        """(preds (B, 4 + nc + nm, A) f32: px xywh boxes, sigmoid scores, mask coefficients; protos
        (B, H/4, W/4, nm) in the model's dtype) from NHWC images in the model's dtype. The C2f blocks, the
        neck fold and the box and class branches go through the kernels (`plain=True`: their twins); the
        coefficient branch and the prototypes are plain torch convs."""
        if self.int8:
            raise NotImplementedError("int8 inference of a segment model is not ported (ROADMAP item 2)")
        xs = self._head_inputs(x, plain, neck_opt)
        boxes, scores = self._decode_head(xs, plain)
        coefs = self.head.coefficients(xs)
        return torch.cat([boxes, scores, coefs.float()], -1).transpose(1, 2), self.head.proto(xs[0])


class PoseModel(DetectionModel):
    """YOLO pose model (JAX PoseModel): the detection graph with a Pose head."""

    task = "pose"

    def __init__(self, cfg="yolov8n-pose.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        if not isinstance(self.head, M.Pose):
            raise ValueError(f"a PoseModel's last layer is a Pose head, not {type(self.head).__name__}")

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False) -> torch.Tensor:
        """Predictions (B, 4 + nc + nk, A) f32: px xywh boxes, sigmoid scores, then each anchor's keypoints
        (x, y in pixels and the visibility's sigmoid, keypoint by keypoint) from NHWC images in the model's
        dtype. The C2f blocks, the neck fold and the box and class branches go through the kernels
        (`plain=True`: their twins); the keypoint branch is plain torch convs."""
        if self.int8:
            raise NotImplementedError("int8 inference of a pose model is not ported (ROADMAP item 2)")
        xs = self._head_inputs(x, plain, neck_opt)
        boxes, scores = self._decode_head(xs, plain)
        return torch.cat([boxes, scores, self.head.keypoints(xs)], -1).transpose(1, 2)


class OBBModel(DetectionModel):
    """YOLO oriented-box model (JAX OBBModel): the detection graph with an OBB head."""

    task = "obb"

    def __init__(self, cfg="yolov8n-obb.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        if not isinstance(self.head, M.OBB):
            raise ValueError(f"an OBBModel's last layer is an OBB head, not {type(self.head).__name__}")

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False) -> torch.Tensor:
        """Predictions (B, 4 + nc + 1, A) f32: the rotated px (cx, cy, w, h), sigmoid scores, then the angle
        in radians, from NHWC images in the model's dtype. The C2f blocks, the neck fold and the box and class
        branches go through the kernels (`plain=True`: their twins); the angle branch is plain torch convs."""
        if self.int8:
            raise NotImplementedError("int8 inference of an obb model is not ported (ROADMAP item 2)")
        xs = self._head_inputs(x, plain, neck_opt)
        dists, clss = self.head.head_levels(xs, plain)
        return self.head.decode_rotated(dists, clss, self.head.angles(xs), [(x.shape[1], x.shape[2]) for x in xs])


def guess_model_task(cfg: dict) -> str:
    """The task of a model yaml, from its head module (JAX `guess_model_task`)."""
    rows = list(cfg.get("head", [])) or list(cfg.get("backbone", []))
    head = str(rows[-1][2]) if rows else "Detect"
    if head in ("Classify",):
        return "classify"
    if head in ("Segment", "YOLOESegment"):
        return "segment"
    if head in ("Pose",):
        return "pose"
    if head in ("OBB",):
        return "obb"
    return "detect"


def model_class_for(cfg: dict, task: str | None = None):
    """The model class of a checkpoint's config and task (JAX `model_class_for`): DetectionModel,
    SegmentationModel, PoseModel, OBBModel or ClassificationModel; the other families raise
    NotImplementedError naming them."""
    rows = list(cfg.get("head", []))
    head = str(rows[-1][2]) if rows else "Detect"
    if head in ("RTDETRDecoder", "WorldDetect", "YOLOEDetect", "YOLOESegment"):
        raise NotImplementedError(f"models with a {head} head are not ported (ROADMAP item 5)")
    task = task or guess_model_task(cfg)
    if task == "classify":
        return ClassificationModel
    if task == "segment":
        return SegmentationModel
    if task == "pose":
        return PoseModel
    if task == "obb":
        return OBBModel
    if task != "detect":
        raise NotImplementedError(f"the {task} task is not ported (only detect, segment, pose, obb and classify)")
    return DetectionModel


class Ensemble:
    """NMS ensemble of detection models (JAX `Ensemble`): every member's decoded predictions
    joined on the anchor axis, which the predictor's NMS merges. The members must agree on nc;
    names, task and yaml are the first member's; `stride` is the coarsest member's, which the
    predictor snaps sizes to. The parameter tree is a tuple of the members' trees."""

    def __init__(self, models):
        if not models:
            raise ValueError("an ensemble needs at least one model")
        ncs = {m.nc for m in models}
        if len(ncs) != 1:
            raise ValueError(f"ensemble members disagree on nc: {ncs}")
        self.models = list(models)
        first = self.models[0]
        self.nc, self.names, self.yaml = first.nc, first.names, first.yaml
        self.stride = [max(int(max(m.stride)) for m in self.models)]

    def init(self, seed: int = 0) -> tuple:
        return tuple(m.init(seed + i) for i, m in enumerate(self.models))

    def fuse(self, params) -> tuple:
        return tuple(fuse(p) for p in params)

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False) -> torch.Tensor:
        return torch.cat([m.predict(x, neck_opt=neck_opt, plain=plain) for m in self.models], -1)


def params_from_jax(model: DetectionModel, params: dict, dtype=None) -> DetectionModel:
    """Load a JAX parameter tree ({"model": {"<layer>": subtree}}, numpy or JAX
    arrays, HWIO convs; fused or not) into `model`'s modules, on its device,
    in `dtype` (the compute dtype; default f32). Returns the model, which
    records what it holds in `held` (this tree, its device, the dtype)."""
    dtype = dtype or torch.float32
    mp = (params if params_are_fused(params) else fuse(params))["model"]
    for m in model.modules():
        m.compute_dtype = dtype
    for i, m in enumerate(model.layers):
        if hasattr(m, "load_jax"):
            m.load_jax(mp[str(i)], model.device, dtype)
    model.int8 = any(m.q is not None for m in model.modules() if isinstance(m, M.ConvBNAct))
    model.held = (params, model.device, dtype)
    return model


def install_params(model, params, device, dtype) -> None:
    """Move `model` to `device` and load `params` in `dtype`, unless the model already
    holds this very tree there in that dtype. The record lives on the model, so its
    users (the predictor, the validator) each see what the other installed. An
    Ensemble installs each member's tree in its member."""
    if isinstance(model, Ensemble):
        for m, p in zip(model.models, params):
            install_params(m, p, device, dtype)
        return
    held = getattr(model, "held", None)
    if held is not None and held[0] is params and held[1:] == (device, dtype):
        return
    model.device = device
    model.to(device)
    params_from_jax(model, params, dtype)


def _remat(m, x_in):
    """One train-form layer under torch.utils.checkpoint: its activations are dropped after the
    forward and recomputed in the backward. The recompute keeps no BN moments: the first forward
    recorded them (JAX `_apply_layer` under ctx.remat)."""
    from torch.utils.checkpoint import checkpoint

    calls = [0]
    multi = isinstance(x_in, list)

    def fn(*xs):
        calls[0] += 1
        with M.recording_bn(m, calls[0] == 1):
            inp = list(xs) if multi else xs[0]
            return m.forward_train(inp) if hasattr(m, "forward_train") else m(inp)

    return checkpoint(fn, *(x_in if multi else [x_in]), use_reentrant=False)


def validate_s2d_stem(model) -> None:
    """The JAX package's check of a space-to-depth stem setting: layers 0 and 1 are the yolov8
    stem, plain 3x3 stride-2 convs (the port's ConvBNAct pads k // 2, has no groups or dilation
    and ends in SiLU). ValueError otherwise."""
    for i in (0, 1):
        m = model.layers[i]
        if type(m) is not M.ConvBNAct:
            raise ValueError(f"s2d stem fold: layer {i} is {type(m).__name__}, not a plain stem conv")
        if (m.k, m.s) != (3, 2):
            raise ValueError(f"s2d stem fold: layer {i} has k, s = {(m.k, m.s)}, not (3, 2)")


def train_leaves(model: DetectionModel) -> dict:
    """{JAX tree path ('model/<layer>/.../weight'): tensor} over the train form: the
    parameters, the BN running moments and the DFL's fixed projection, in module order."""
    out = {}
    for name, m in model.named_modules():
        if hasattr(m, "train_leaves"):
            prefix = "/".join(["model", *name.split(".")[1:]])
            out.update({f"{prefix}/{rel}": t for rel, t in m.train_leaves().items()})
    return out


def _to_jax_layout(path: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().cpu().numpy()
    if path.endswith("dfl/conv/weight"):
        return a.reshape(1, 1, -1, 1)
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a  # OIHW → HWIO


def tree_from_leaves(model: DetectionModel, leaves: dict) -> dict:
    """{path: tensor} (the train form's, or copies of them such as the EMA) → the JAX
    package's nested numpy tree, with the empty groups of the parameterless layers."""
    tree = {"model": {str(i): {} for i in range(len(model.layers))}}
    for path, t in leaves.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_jax_layout(path, t)
    return tree


def params_to_jax(model: DetectionModel) -> dict:
    """The train form as the JAX package's unfused numpy tree (HWIO convs, `bn` groups)."""
    return tree_from_leaves(model, train_leaves(model))


@torch.no_grad()
def load_train_params(model: DetectionModel, params: dict) -> DetectionModel:
    """Load an unfused JAX parameter tree into the train form, in f32, without folding
    (a fused tree has no BN to train: ValueError)."""
    if params_are_fused(params):
        raise ValueError("the train form takes an unfused tree (with `bn` groups), as DetectionModel.init gives")
    for path, t in train_leaves(model).items():
        node = params
        for k in path.split("/"):
            node = node[k]
        a = np.asarray(node, np.float32)
        a = a.reshape(-1) if path.endswith("dfl/conv/weight") else (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model
