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
The v8 variant yamls (p6, ghost, ghost-p2, ghost-p6, seg-p6, pose-p6, cls-resnet50/101) and
yolov5 / yolov5-p6 build from the same rows (C2, C3, C3Ghost, GhostConv, ResNetLayer, DWConv,
MaxPool2d, a padded Conv); a layer without an int8 path takes its inputs dense, as in JAX. The yolo11 and
yolo12 yamls build with C3k2, C2PSA and A2C2f under JAX's parse rules (`legacy` off, so their heads take the
depth-wise class branch and no head kernel; C3k blocks at scales m-x; A2C2f's residual gamma at l and x). yolov3,
yolov6, YOLO-NAS and yolov9 build with their blocks (a yaml's `activation:` for that build only; a row repeated n
times whose module takes no repeats is a `Seq` of n copies; a CBLinear layer's list of splits reaches its CBFuse
through the save dict); their legacy heads take the head kernel where they end in SiLU (yolov3, yolov9) and walk conv
by conv where they end in ReLU (yolov6, YOLO-NAS). The YOLO-World and YOLOE yamls build `WorldModel` and `YOLOEModel`
(nn/open_vocab.py's blocks): their classes are prompt embeddings (1 or B, nc, 512) that the walk threads as an explicit
argument (`guide`: each C2fAttn reads it, an ImagePoolingAttn returns it refreshed, the head reads the original), and a
`DetectionModel` of such a yaml raises, as JAX's fails at its first forward without prompts.

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
from yolo_tpu_torch.nn import open_vocab as OV
from yolo_tpu_torch.nn import quantize as Q
from yolo_tpu_torch.nn import transformer as T

CFG_DIR = Path(__file__).resolve().parents[1] / "cfg"
BN_EPS = M.BN_EPS
QTENSOR_MODULES = (M.ConvBNAct, M.Conv2d, M.Bottleneck, M.C2f, M.SPPF, M.Concat, M.Upsample, M.Detect)  # JAX's: take int8 maps
EXTRA_OUTPUT_TASKS = ("segment", "pose", "obb")  # masks, keypoints or angles beside the boxes: the detect-only entry points refuse them

MODULE_MAP = {
    "Conv": M.ConvBNAct,
    "DWConv": M.DWConv,
    "C2f": M.C2f,
    "C2": M.C2,
    "C3": M.C3,
    "C3Ghost": M.C3Ghost,
    "C3k": M.C3k,
    "C3k2": M.C3k2,
    "C2PSA": M.C2PSA,
    "A2C2f": M.A2C2f,
    "GhostConv": M.GhostConv,
    "GhostBottleneck": M.GhostBottleneck,
    "ResNetLayer": M.ResNetLayer,
    "Bottleneck": M.Bottleneck,
    "nn.MaxPool2d": M.MaxPool2d,
    "nn.ZeroPad2d": M.ZeroPad2d,
    "nn.Identity": M.Identity,
    "nn.ConvTranspose2d": M.ConvTranspose,
    "SPPF": M.SPPF,
    "SPP": M.SPP,
    "NASCSP": M.NASCSP,
    "RepConv": M.RepConv,
    "RepCSP": M.RepCSP,
    "RepNCSPELAN4": M.RepNCSPELAN4,
    "ELAN1": M.ELAN1,
    "AConv": M.AConv,
    "ADown": M.ADown,
    "SPPELAN": M.SPPELAN,
    "CBLinear": M.CBLinear,
    "CBFuse": M.CBFuse,
    "SCDown": M.SCDown,
    "CIB": M.CIB,
    "C2fCIB": M.C2fCIB,
    "PSA": M.PSA,
    "Concat": M.Concat,
    "Detect": M.Detect,
    "v10Detect": M.v10Detect,
    "Segment": M.Segment,
    "Pose": M.Pose,
    "OBB": M.OBB,
    "Classify": M.Classify,
    "nn.Upsample": M.Upsample,
    "TorchVision": M.TorchVision,
    "HGStem": M.HGStem,
    "HGBlock": M.HGBlock,
    "RepC3": M.RepC3,
    "AIFI": T.AIFI,
    "RTDETRDecoder": T.RTDETRDecoder,
    "C2fAttn": OV.C2fAttn,
    "ImagePoolingAttn": OV.ImagePoolingAttn,
    "WorldDetect": OV.WorldDetect,
    "YOLOEDetect": OV.YOLOEDetect,
    "YOLOESegment": OV.YOLOESegment,
}
SCALED = (M.ConvBNAct, M.DWConv, M.C2f, M.C2, M.C3, M.C3Ghost, M.C3k, M.C3k2, M.C2PSA, M.A2C2f, M.GhostConv,
          M.GhostBottleneck, M.SPPF, M.SPP, M.Bottleneck, M.NASCSP, M.RepConv, M.RepCSP, M.RepNCSPELAN4, M.ELAN1,
          M.AConv, M.ADown, M.SPPELAN, M.ConvTranspose, M.Classify, M.SCDown, M.CIB, M.C2fCIB,
          M.PSA, M.RepC3)  # c2 width-scaled (JAX's list)
REPEATED = (M.C2f, M.C2, M.C3, M.C3Ghost, M.C3k, M.C3k2, M.C2PSA, M.A2C2f, M.NASCSP, M.RepCSP, M.C2fCIB, M.RepC3)  # take the row's n
HEADS = (M.Detect, T.RTDETRDecoder)  # the layer a walk of the inference form ends at
GUIDED = (OV.C2fAttn,)  # layers that read the running text embeddings (the guide)
REFRESHING = (OV.ImagePoolingAttn,)  # layers whose output is the refreshed guide
PROMPTED = (OV.WorldDetect, OV.YOLOEDetect)  # heads that read the original class prompts (guide0)


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
    """Build the layer modules from a model dict → (layers, froms, save list). A yaml's `activation:` is the
    default of every `act=True` conv while this model's modules are built, and only then (JAX's mapping: a name
    holding 'relu' is ReLU, 'gelu' GELU, anything else SiLU)."""
    prev = M.ConvBNAct.DEFAULT_ACT
    if d.get("activation"):
        M.ConvBNAct.DEFAULT_ACT = M.act_name(d["activation"])
    try:
        return _parse_rows(d, ch)
    finally:
        M.ConvBNAct.DEFAULT_ACT = prev


def _parse_rows(d: dict, ch: int):
    nc, scales = d["nc"], d.get("scales")
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    if scales:
        depth, width, max_channels = scales[d.get("scale") or next(iter(scales))]
    chs, layers, froms, save = [ch], [], [], []
    legacy = not any(row[2] in ("C3k2", "A2C2f", "C2fCIB") for row in d["backbone"] + d["head"])  # the v8 Detect branches
    for i, (f, n, mname, args) in enumerate(d["backbone"] + d["head"]):
        if mname not in MODULE_MAP:
            raise NotImplementedError(f"module '{mname}' is not ported yet")
        mcls = MODULE_MAP[mname]
        args = [
            {"nc": nc, "True": True, "False": False, "None": None}.get(a, a) if isinstance(a, str) else a for a in args
        ]
        if mname == "Conv" and len(args) > 7:  # [c2, k, s, p, g, d, act]; ConvBNAct names a dilation or activation it lacks
            raise NotImplementedError(f"module 'Conv' with arguments {args[7:]!r} is not ported yet")
        n = max(round(n * depth), 1) if n > 1 else n
        if mcls is M.ResNetLayer:  # explicit [c1, c2, s, is_first, n]; 4 · c2 out unless the stem
            c2 = args[1] if args[3] else args[1] * 4
        elif mcls is M.TorchVision:  # the declared output channels, not width-scaled
            c2 = args[0]
        elif mcls in (M.HGStem, M.HGBlock):  # [cm, c2, ...], neither width-scaled; an HGBlock takes the row's n
            c2 = args[1]
            args = [chs[f], *args]
            if mcls is M.HGBlock:
                args.insert(4, n)
                n = 1
        elif mcls is T.AIFI:
            c2 = chs[f]
            args = [chs[f], *args]
        elif mcls is T.RTDETRDecoder:
            args.insert(1, [chs[x] for x in f])
            c2 = None
        elif mcls is OV.C2fAttn:  # ec width-scales capped at max_channels / 2; nh scales where above 1
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            ec = make_divisible(min(args[1], max_channels // 2) * width, 8)
            nh = int(max(round(min(args[2], max_channels // 2 // 32)) * width, 1) if args[2] > 1 else args[2])
            args = [c1, c2, n, ec, nh, *args[3:]]
            n = 1
        elif mcls is OV.ImagePoolingAttn:
            args = [*args, [chs[x] for x in f]]
            c2 = None
        elif mcls in (OV.WorldDetect, OV.YOLOEDetect):
            args = [*args, [chs[x] for x in f], legacy]
            c2 = None
        elif mcls is OV.YOLOESegment:  # npr width-scales, as Segment's
            args = [args[0], args[1], make_divisible(min(args[2], max_channels) * width, 8), *args[3:], [chs[x] for x in f], legacy]
            c2 = None
        elif mcls in SCALED:
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if mcls in REPEATED:  # the repeats are the block's n
                args.insert(2, n)
                n = 1
            if mcls is M.C3k2 and d.get("scale") in ("m", "l", "x"):
                args[3] = True  # C3k blocks at the deeper scales, as in the JAX package
            if mcls is M.A2C2f and d.get("scale") in ("l", "x"):
                args.extend((True, 1.2))  # the residual gamma and an MLP 1.2 wide
            if mname == "nn.ConvTranspose2d":  # the raw torch module: no BN, no activation
                args = args[:5] + [False, False]
        elif mcls is M.CBLinear:  # a list of split widths, not width-scaled
            c2 = args[0]
            args = [chs[f], c2, *args[1:]]
        elif mcls is M.CBFuse:
            c2 = chs[f[-1]]
        elif mcls is M.Concat:
            c2 = sum(chs[x] for x in f)
        elif mcls in (M.Detect, M.v10Detect):
            args = [args[0], [chs[x] for x in f], legacy]
            c2 = None
        elif mcls is M.Segment:  # npr width-scales, as in the JAX package
            args = [args[0], args[1], make_divisible(min(args[2], max_channels) * width, 8), [chs[x] for x in f], legacy]
            c2 = None
        elif mcls is M.Pose:  # the yaml's kpt_shape, as in the JAX package
            args = [args[0], tuple(d["kpt_shape"]) if d.get("kpt_shape") else args[1], [chs[x] for x in f], legacy]
            c2 = None
        elif mcls is M.OBB:
            args = [*args[:2], [chs[x] for x in f], legacy]
            c2 = None
        else:
            c2 = chs[f]
        # a module that takes no repeats of its own, on a row with n > 1: n copies in a row (JAX _SeqN)
        layers.append(M.Seq(*(mcls(*args) for _ in range(n))) if n > 1 else mcls(*args))
        layers[-1].c_out = c2  # output channels (None for a head)
        froms.append(f)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)
    return layers, froms, sorted(set(save))


def _compute_strides(layers, froms) -> dict:
    """Propagate spatial strides through the graph and set the Detect head's → {layer: its output's stride}."""
    stride = {}
    for i, (m, f) in enumerate(zip(layers, froms)):
        src = stride.get((f if isinstance(f, int) else f[0]) % i, 1) if i else 1
        if isinstance(m, M.Detect):
            m.stride = [stride[x] for x in f]
            s = None
        elif isinstance(m, (M.ConvBNAct, M.MaxPool2d, M.GhostConv, M.GhostBottleneck, M.AConv, M.ADown, M.SCDown)):
            s = src * m.s
        elif isinstance(m, (M.ResNetLayer, M.TorchVision)):
            s = src * m.s_total
        elif isinstance(m, M.HGStem):  # two stride-2 convs
            s = src * 4
        elif isinstance(m, T.RTDETRDecoder):  # a head: its strides are preset
            s = None
        elif isinstance(m, M.Upsample):
            s = src // m.scale
        elif isinstance(m, M.ConvTranspose):
            s = max(src // m.s, 1)
        elif isinstance(m, M.CBFuse):
            s = stride[f[-1] % i]
        elif isinstance(m, M.Seq):  # a repeated row: its convs' strides multiply, as JAX's _SeqN's
            s = src
            for c in m:
                s *= c.s if isinstance(c, M.ConvBNAct) else 1
        else:
            s = src
        stride[i] = s
    return stride


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


def unfused_keys(params: dict, model_walk: bool = False) -> set:
    """The groups of a subtree that the JAX package's fuse leaves with their BN, by their owner: its walk looks each
    key up as an attribute of the module that owns it and finds none for a PSA's or PSABlock's `ffn` (a group beside
    `attn`), a MaxSigmoidAttnBlock's `ec` (beside `gl`) or SAVPE's `cv6`, and hands each SAVPE `cv2` level (its conv
    under '0') to a ConvBNAct's fuse, which finds no `bn` there; nor for a CIB's `cv1` (the block's only group: five
    convs in a sequence, '0'..'4'), nor, where the whole
    model is walked (`model_walk`: a detection model's tree; JAX's ClassificationModel has no fuse, its trees fold
    conv by conv), for a ResNetLayer's `layer` (its only group; rtdetr-resnet50 / 101). ConvBNAct runs these BNs in
    f32. Every other group folds, every other `cv1` included; an RTDETRDecoder's `input_proj` holds no `conv` / `bn`
    pair (its groups are `0` and `1`) and stays as it is."""
    keys = set()
    if "attn" in params and "ffn" in params:
        keys.add("ffn")
    if "gl" in params and "ec" in params:  # a MaxSigmoidAttnBlock's `ec` (its module attribute is `ec_conv` in JAX)
        keys.add("ec")
    if set(params) == {"cv1", "cv2", "cv3", "cv4", "cv5", "cv6"}:  # SAVPE: each `cv2` level holds its conv under '0',
        keys |= {"cv2", "cv6"}  # which JAX hands whole to the ConvBNAct; `cv6` is an attribute JAX names `cv6_0`
    cv1 = params.get("cv1")
    if set(params) == {"cv1"} and isinstance(cv1, dict) and cv1 and all(k.isdigit() for k in cv1):
        keys.add("cv1")
    if model_walk and set(params) == {"layer"}:
        keys.add("layer")
    return keys


def _model_walk(params: dict) -> bool:
    """Whether JAX folds this tree with its model walk: a whole tree ({"model": ...}) whose last layer is not a
    Classify head (its group holds `linear`)."""
    layers = params.get("model") if isinstance(params, dict) else None
    if not isinstance(layers, dict) or not layers:
        return False
    last = layers[max(layers, key=int)]
    return not (isinstance(last, dict) and "linear" in last)


def _as_numpy(params):
    return {k: _as_numpy(v) for k, v in params.items()} if isinstance(params, dict) else np.asarray(params)


def _fold_repconv(p: dict) -> dict:
    """A RepConv's `conv1` (3x3 + BN) and `conv2` (1x1 + BN) → one {conv: {weight, bias}}: each BN folded, the 1x1
    padded into the 3x3's centre (JAX RepConv.fuse), and the identity BN (`bn`, where the RepConv has one) folded
    into the centre tap of each channel's own input, which JAX's fuse leaves out (ROADMAP §3)."""
    f1, f2 = _fold_bn(p["conv1"])["conv"], _fold_bn(p["conv2"])["conv"]
    w = f1["weight"] + np.pad(f2["weight"], ((1, 1), (1, 1), (0, 0), (0, 0)))
    b = f1["bias"] + f2["bias"]
    if "bn" in p:
        bn = p["bn"]
        scale = np.asarray(bn["weight"], np.float32) / np.sqrt(np.asarray(bn["running_var"], np.float32) + BN_EPS)
        w = w.copy()
        cg = w.shape[2]  # inputs per group: channel i reads its own input at i % cg of its group
        w[1, 1, np.arange(len(scale)) % cg, np.arange(len(scale))] += scale
        b = b + (np.asarray(bn["bias"], np.float32) - np.asarray(bn["running_mean"], np.float32) * scale)
    return {"conv": {"weight": w, "bias": b}}


def _is_repconv(p: dict) -> bool:
    """Whether a subtree holding `conv1` and `conv2` is a RepConv's (a 3x3 `conv1` beside a 1x1), not a LightConv's (a
    1x1 `conv1`, then a depth-wise `conv2`), which folds group by group."""
    c1 = p["conv1"].get("conv", {}) if isinstance(p["conv1"], dict) else {}
    return "weight" in c1 and np.shape(c1["weight"])[:2] == (3, 3)


def fuse(params: dict) -> dict:
    """Fold every conv's BN into its weight and bias (exact inference form), with numpy, as the JAX package's
    `fuse` folds them: the groups `unfused_keys` names keep their BN (ConvBNAct runs it in f32).

    Every subtree holding `conv` (or `conv_transpose`) and `bn` groups is a ConvBNAct (a
    ConvTranspose) of the JAX package, one holding a 3x3 `conv1` and `conv2` a RepConv; other leaves pass
    through as numpy arrays. An RTDETRDecoder's input projections (`input_proj/<i>/0` the conv, `/1` the BN)
    stay unfolded, as JAX's generic fold finds no module under that key."""
    return _fuse(params, _model_walk(params))


def _fuse(params, model_walk: bool):
    """`fuse` below the root, `model_walk` read from the whole tree there (`_model_walk`)."""
    if not isinstance(params, dict):
        return np.asarray(params)
    if "conv1" in params and "conv2" in params and _is_repconv(params):
        return _fold_repconv(params)
    if "bn" in params and ("conv" in params or "conv_transpose" in params):
        return _fold_bn(params)
    keep = unfused_keys(params, model_walk)
    return {k: _as_numpy(v) if k in keep else _fuse(v, model_walk) for k, v in params.items()}


def params_are_fused(params) -> bool:
    """Whether `fuse` would leave the tree as it is."""
    return _are_fused(params, isinstance(params, dict) and _model_walk(params))


def _are_fused(params, model_walk: bool) -> bool:
    if not isinstance(params, dict):
        return True
    keep = unfused_keys(params, model_walk)
    return "bn" not in params and all(k in keep or _are_fused(v, model_walk) for k, v in params.items())


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
        self.layer_strides = _compute_strides(self.layers, self.froms)
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
                and type(L[b]) is M.Concat
                and isinstance(Fr[b], list)
                and len(Fr[b]) == 2
                and Fr[b][0] == -1
                and Fr[b][1] >= 0
                and type(L[c]) is M.C2f  # a C3k2 is walked, as the JAX package's exact-type check leaves it
                and Fr[c] == -1
                and L[a].scale == 2
                and a not in self.save
                and b not in self.save
            ):
                self._upconcat[c] = Fr[b][1]
                self._neck_skip |= {a, b}

    def c2f_instances(self, H: int, W: int) -> list:
        """The C2f kernel's instances of this model on an H x W input, in layer order: (c1, cs, c, c2o, n, h, w) per
        block that reaches the kernel (an exact C2f: a C3k2 or C2fCIB walks its modules), cs > 0 (the small input's
        channels) where the neck fold takes it, h x w its output map (ops/cuda_c2f.py::C2F_WIDTHS lists them)."""
        out = []
        for i, m in enumerate(self.layers):
            if type(m) is not M.C2f:
                continue
            s = self.layer_strides[i]
            cs = m.cv1.c1 - self.layers[self._upconcat[i]].c_out if i in self._upconcat else 0
            out.append((m.cv1.c1, cs, m.c, m.cv2.c2, m.n, H // s, W // s))
        return out

    def init(self, seed: int = 0) -> dict:
        """The JAX package's initial parameter tree for this model, bit for bit: one
        `np.random.default_rng(seed)` walked through the layers in order, each module
        drawing as its JAX counterpart does (unfused: `conv` and `bn` groups, HWIO)."""
        rng = np.random.default_rng(seed)
        return {"model": {str(i): m.init(rng) for i, m in enumerate(self.layers)}}

    def int8_flow_paths(self) -> set:
        """Tree paths of the convs that may emit int8 (JAX `int8_flow_paths`): every plain ConvBNAct
        layer, SPPF's two, a C2f's cv1 and cv2 and its bottlenecks' cv1 (and cv2 without a residual), and
        the same two of a Bottleneck row; none inside a repeated row."""
        paths = set()
        for i, m in enumerate(self.layers):
            base = f"model/{i}"
            if isinstance(m, M.C2f):  # a C3k2's C3k blocks emit none
                paths |= {f"{base}/cv1", f"{base}/cv2"}
                for j, b in enumerate(m.m):
                    if isinstance(b, M.Bottleneck):
                        paths |= {f"{base}/m/{j}/cv1"} if b.add else {f"{base}/m/{j}/cv1", f"{base}/m/{j}/cv2"}
            elif isinstance(m, M.Bottleneck):  # a yaml row (yolov3)
                paths |= {f"{base}/cv1"} if m.add else {f"{base}/cv1", f"{base}/cv2"}
            elif isinstance(m, M.SPPF):
                paths |= {f"{base}/cv1", f"{base}/cv2"}
            elif isinstance(m, M.ConvBNAct):
                paths.add(base)
        return paths

    def forward_features(self, x: torch.Tensor, remat: bool = False, guide: torch.Tensor | None = None):
        """Per-level raw head outputs [(B, H, W, 4*reg_max + nc)] of NHWC images, computed in
        x's dtype through the train form (JAX `forward_features`): every layer materialised,
        no neck fold and no kernel. In training mode (`.train()`) BN takes the batch's
        moments and each ConvBNAct keeps them for `utils.optim.apply_bn_stats`. `remat`
        checkpoints every layer but the head (torch.utils.checkpoint): its activations are
        recomputed in the backward, its BN moments recorded once. `guide` (a World or YOLOE model's
        class prompts, (B, nt, 512)) goes to each C2fAttn, an ImagePoolingAttn returns it refreshed
        for the layers after it, and the head takes it as it came in (JAX's `guide` and `guide0`);
        an ImagePoolingAttn and the head run outside the checkpoints, as in JAX."""
        y, guide0 = {}, guide
        for i, (m, f) in enumerate(zip(self.layers, self.froms)):
            x_in = [x if j == -1 else y[j % i] for j in f] if isinstance(f, list) else (x if f == -1 else y[f % i])
            if isinstance(m, GUIDED):
                g = _require_guide(guide, m)
                out = _remat(m, x_in, g) if remat else m.forward_train(x_in, g)
            elif isinstance(m, REFRESHING):
                out = guide = m.forward_train(x_in, _require_guide(guide, m))
            elif isinstance(m, PROMPTED):
                out = m.forward_train(x_in, _require_guide(guide0, m))
            elif remat and not isinstance(m, HEADS):
                out = _remat(m, x_in)
            else:
                out = m.forward_train(x_in) if hasattr(m, "forward_train") else m(x_in)
            if i in self.save:
                y[i] = out
            x = out if not isinstance(out, list) else x  # a CBLinear's list of splits is read through the save dict
        return out

    def _walk(self, x: torch.Tensor, plain: bool, neck_opt: bool = True, upto: int | None = None, collect=(),
              guide: torch.Tensor | None = None):
        """Walk the inference modules over layers [0, upto) → (the head's input maps (a Detect's or an RTDETRDecoder's), or
        the last layer's output where the walk ends before the head; {i: output} of the layers in
        `collect`). `neck_opt` folds the Upsample→Concat→C2f chains into `C2f.call_upconcat`. `guide` is a World
        model's text embeddings: each C2fAttn reads the running ones, an ImagePoolingAttn returns them refreshed."""
        y, col = {}, {}
        for i, (m, f) in enumerate(zip(self.layers[:upto], self.froms[:upto])):
            if neck_opt and i in self._neck_skip:
                continue
            if isinstance(m, HEADS):
                return [x if j == -1 else y[j % i] for j in f], col
            if neck_opt and i in self._upconcat:
                x = m.call_upconcat(x, y[self._upconcat[i]], plain=plain)
            else:
                x_in = [x if j == -1 else y[j % i] for j in f] if isinstance(f, list) else (x if f == -1 else y[f % i])
                if not isinstance(m, QTENSOR_MODULES):  # a layer without an int8 path takes dense maps (JAX `_apply_layer`)
                    x_in = [Q.deq(v, M._dtype_of(m)) for v in x_in] if isinstance(x_in, list) else Q.deq(x_in, M._dtype_of(m))
                if isinstance(m, M.C2f):
                    x_out = m(x_in, plain=plain)
                elif isinstance(m, GUIDED):
                    x_out = m(x_in, _require_guide(guide, m))
                elif isinstance(m, REFRESHING):
                    x_out = guide = m(x_in, _require_guide(guide, m))
                else:
                    x_out = m(x_in)
                if isinstance(x_out, list):  # a CBLinear's splits: the later layers read them through the save dict
                    if i in self.save:
                        y[i] = x_out
                    continue
                x = x_out
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
        return torch.cat([col[i].mean(dim=(1, 2)) if col[i].ndim == 4 else col[i] for i in idx if i in col], -1)  # a CBLinear's list: none


class DetectionModel(BaseModel):
    """YOLO detection model (JAX DetectionModel): inference on fused weights, training on the unfused ones."""

    task = "detect"

    def __init__(self, cfg="yolov8n.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        self.head = self.layers[-1]
        if not isinstance(self.head, M.Detect):
            raise ValueError(f"a DetectionModel's last layer is a Detect head, not {type(self.head).__name__}")
        if isinstance(self.head, PROMPTED) and not isinstance(self, (WorldModel, YOLOEModel)):
            raise NotImplementedError(f"a {type(self.head).__name__} head scores classes against class prompts: build the "
                                      "model as a WorldModel or YOLOEModel (YOLOWorld / YOLOE); the JAX package's "
                                      "DetectionModel of this yaml fails at its first forward (ROADMAP item 5c)")
        self.stride = self.head.stride

    def _head_inputs(self, x: torch.Tensor, plain: bool, neck_opt: bool = True, guide: torch.Tensor | None = None):
        """The Detect head's input maps (the graph walked up to the head)."""
        xs, _ = self._walk(x, plain, neck_opt, guide=guide)
        if not isinstance(xs, list):
            raise ValueError("the model has no Detect head")
        return xs

    def _decode_head(self, xs, plain: bool, head_cm: bool = False):
        if self.int8:  # no kernel takes int8: the head conv by conv
            return self.head.decode_parts(self.head(xs))
        decode = self.head.decode_from_inputs_cm if head_cm else self.head.decode_from_inputs
        return decode(xs, plain=plain)

    @property
    def end2end(self) -> bool:
        """Whether the head is yolov10's end-to-end one: `predict` returns its final rows, and no NMS runs."""
        return getattr(self.head, "end2end", False)

    @torch.no_grad()
    def predict_parts(self, x: torch.Tensor, plain: bool = False, head_cm: bool = False, neck_opt: bool | None = None):
        """Decoded (boxes (B, A, 4) px xywh, scores (B, A, nc)), f32, from NHWC
        images in the model's dtype. `plain=True` runs the kernels' plain twins.
        `head_cm=True` sends the Detect levels through the channel-major head
        kernel instead of the default one. `neck_opt` (None: on for a float model,
        off for an int8 one) folds the neck. An end-to-end head has no such parts
        (NotImplementedError), as the JAX package asserts."""
        if self.end2end:
            raise NotImplementedError("the end-to-end v10Detect head decodes its own (B, max_det, 6) rows: "
                                      "use predict(); no parts path or fused pipeline takes it")
        xs = self._head_inputs(x, plain, not self.int8 if neck_opt is None else neck_opt)
        return self._decode_head(xs, plain, head_cm)

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False) -> torch.Tensor:
        """Decoded predictions (B, 4 + nc, A): px xywh boxes, then sigmoid
        scores, the layout `ops.nms.non_max_suppression` takes. The C2f blocks
        and the Detect levels go through the kernels (`plain=True`: their
        twins); `neck_opt=False` materialises the neck's upsample and concat.
        An int8 model walks its convs one by one (pass neck_opt=False). An
        end-to-end head (yolov10) returns its final (B, max_det, 6) rows instead:
        xyxy px boxes, score, class (`v10Detect.decode_end2end`), which no NMS takes."""
        xs = self._head_inputs(x, plain, neck_opt)
        if self.end2end:
            return self.head.decode_end2end(xs)
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
        coefficient branch and the prototypes are plain torch convs. An int8 model walks its convs one by
        one, without the fold and the kernels (the transposed conv takes the float map)."""
        xs = self._head_inputs(x, plain, neck_opt and not self.int8)
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
        (`plain=True`: their twins); the keypoint branch is plain torch convs. An int8 model walks its convs
        one by one, without the fold and the kernels."""
        xs = self._head_inputs(x, plain, neck_opt and not self.int8)
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
        branches go through the kernels (`plain=True`: their twins); the angle branch is plain torch convs. An
        int8 model walks its convs one by one, without the fold and the kernels."""
        xs = self._head_inputs(x, plain, neck_opt and not self.int8)
        dists, clss = self.head.levels_from_outputs(self.head(xs)) if self.int8 else self.head.head_levels(xs, plain)
        return self.head.decode_rotated(dists, clss, self.head.angles(xs), [(x.shape[1], x.shape[2]) for x in xs])


class RTDETRDetectionModel(DetectionModel):
    """RT-DETR (JAX RTDETRDetectionModel): a backbone and neck (HGNetV2, a ResNet, or yolov8's with its C2f blocks
    through the kernel and the neck fold) feeding the RTDETRDecoder head. `predict` returns the decoder's
    (B, nq, 4 + nc) f32 rows: normalized xywh boxes and sigmoid scores, which no NMS takes (the predictor and
    the validator threshold them). The strides are the head's preset ones. No parts path or fused pipeline
    takes the head (NotImplementedError, ROADMAP item 5b), as the JAX package asserts."""

    is_rtdetr = True

    def __init__(self, cfg="rtdetr-l.yaml", ch: int = 3, nc: int | None = None, device=None):
        BaseModel.__init__(self, cfg, ch, nc, device)
        self.head = self.layers[-1]
        if not isinstance(self.head, T.RTDETRDecoder):
            raise ValueError(f"an RTDETRDetectionModel's last layer is an RTDETRDecoder, not {type(self.head).__name__}")
        self.stride = self.head.stride

    def predict_parts(self, x: torch.Tensor, plain: bool = False, head_cm: bool = False, neck_opt: bool | None = None):
        raise NotImplementedError("the RTDETRDecoder head gives (B, nq, 4 + nc) query rows, not per-anchor parts: use "
                                  "predict(); no parts path or fused pipeline takes it (ROADMAP item 5b)")

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False) -> torch.Tensor:
        """(B, nq, 4 + nc) f32 rows of NHWC images in the model's dtype: the walk (the C2f blocks of a yolov8 neck
        through the kernel, `plain=True` their twins; `neck_opt` folds the neck), then the decoder in f32."""
        xs, _ = self._walk(x, plain, neck_opt and not self.int8)
        return self.head(xs)

    def forward_features(self, x: torch.Tensor, remat: bool = False, dn: dict | None = None):
        """The train forward (BaseModel's) → the decoder's train outputs; `dn` (dn_cls, dn_bbox, dn_valid and the
        attention mask, on the device) prepends the denoising queries (JAX `ctx.dn`)."""
        self.head.dn = dn
        try:
            return super().forward_features(x, remat)
        finally:
            self.head.dn = None


def refuse_prompted_segment(model, what: str) -> None:
    """NotImplementedError where `what` (a predictor, a validator, a trainer, an ensemble, the parts path) would take
    a YOLOE segment model: its `predict` gives (preds, protos) while the JAX package's YOLOE is a detect model, whose
    predictor, validator, trainer, ensemble and parts path all fail on that pair."""
    if getattr(model, "is_yoloe", False) and model.segment:
        raise NotImplementedError(f"{what} of a YOLOE segment model is not ported: the JAX package's YOLOE fixes the task "
                                  "to detect and fails on its (preds, protos); YOLOEModel.predict is ported (ROADMAP item 5c)")


class _PromptedModel(DetectionModel):
    """What WorldModel and YOLOEModel share: the class prompts (B or 1, nc, 512) as a numpy array, `prompts`, moved
    to the device once per array and dtype, and the resize of the class axis when they change."""

    def __init__(self, cfg, ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)
        # the JAX package's placeholder (its checkpoints hold no prompts, so a reloaded model carries exactly this draw)
        self.prompts = np.random.default_rng(0).normal(0, 1, (1, self.nc, 512)).astype(np.float32)
        self._on_device = None

    def _set_prompts(self, pe) -> None:
        self.prompts = np.asarray(pe, np.float32)
        self.nc = self.head.nc = self.prompts.shape[1]  # the class count follows the prompts, as in JAX

    def _prompts(self, x: torch.Tensor, pe=None) -> torch.Tensor:
        """`pe` (default the model's prompts) on x's device in f32 (f64 for an f64 input), broadcast to x's batch."""
        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        arr = self.prompts if pe is None else pe
        if isinstance(arr, torch.Tensor):
            t = arr.to(x.device, dtype)
        else:
            held = self._on_device
            if held is None or held[0] is not arr or held[1] != (x.device, dtype):
                held = self._on_device = (arr, (x.device, dtype), torch.as_tensor(np.asarray(arr, np.float32)).to(x.device, dtype))
            t = held[2]
        return t.expand(x.shape[0], *t.shape[1:]) if t.shape[0] != x.shape[0] else t

    def _forward(self, x, plain: bool, neck_opt: bool, pe=None):
        """The walk (the guide threaded through it) and the head's raw outputs on the prompts."""
        g = self._prompts(x, pe)
        return self.head(self._head_inputs(x, plain, neck_opt, guide=g), g)

    @property
    def segment(self) -> bool:
        return isinstance(self.head, OV.YOLOESegment)

    @torch.no_grad()
    def predict_parts(self, x: torch.Tensor, plain: bool = False, head_cm: bool = False, neck_opt: bool | None = None):
        """(boxes (B, A, 4) px xywh, scores (B, A, nc)) f32, the head walked conv by conv on the prompts (JAX's
        `predict_parts` of a head that is not the plain Detect). `head_cm` raises ValueError (JAX asserts)."""
        refuse_prompted_segment(self, "the parts path")
        if head_cm:
            self.head.check_cm()
        return self.head.decode_parts(self._forward(x, plain, not self.int8 if neck_opt is None else neck_opt))


class WorldModel(_PromptedModel):
    """YOLO-World (JAX WorldModel): the classes are text embeddings (1, nc, 512), `txt_feats`. The C2f blocks of the
    backbone go through the C2f kernel (kernel 1); the C2fAttn neck, the ImagePoolingAttn and the WorldDetect head are
    plain torch, as in JAX. `set_classes` embeds class names with the CLIP text tower (nn/text_model.py; a seeded one
    unless weights are given), `set_text_features` takes embeddings."""

    is_world = True

    def __init__(self, cfg="yolov8s-world.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)

    @property
    def txt_feats(self) -> np.ndarray:
        return self.prompts

    def set_text_features(self, txt_feats) -> None:
        """Install text embeddings (1, n, 512); the class count becomes n."""
        self._set_prompts(txt_feats)

    def set_classes(self, text, text_model=None, clip_ckpt=None) -> None:
        """Embed the class names with `text_model` (default `build_text_model()`, a seeded tower, on this model's
        device; `clip_ckpt` loads an OpenAI CLIP checkpoint into it) and install them, with their names."""
        feats = _text_model(text_model, clip_ckpt, self.device).encode_text(list(text))
        self.set_text_features(feats.float().cpu().numpy()[None])
        self.names = dict(enumerate(text))

    def forward_features(self, x: torch.Tensor, remat: bool = False, txt_feats=None):
        """The train forward on the text embeddings (`txt_feats`, default the model's)."""
        return super().forward_features(x, remat, guide=self._prompts(x, txt_feats))

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False, txt_feats=None) -> torch.Tensor:
        """(B, 4 + nc, A) f32: px xywh boxes and the sigmoid of the region-text scores."""
        return self.head.decode(self._forward(x, plain, neck_opt and not self.int8, txt_feats))


class YOLOEModel(_PromptedModel):
    """YOLOE (JAX YOLOEModel): the classes are prompt embeddings (1 or B, nc, 512), `cls_pe`: text embeddings through
    the head's SwiGLU residual (`set_text_features`, `set_classes`), or visual prompt embeddings from SAVPE
    (`get_visual_pe`, `set_visual_pe`); `set_vocab` fuses a vocabulary for the prompt-free `predict_lrpc`. The C2f
    blocks go through kernel 1 and the neck fold through kernel 2 where the yaml has them (yoloe-v8); the head is plain
    torch. A YOLOESegment head's `predict` gives (preds, protos)."""

    is_yoloe = True

    def __init__(self, cfg="yoloe-11s.yaml", ch: int = 3, nc: int | None = None, device=None):
        super().__init__(cfg, ch, nc, device)

    @property
    def cls_pe(self) -> np.ndarray:
        return self.prompts

    def _load_head(self, params: dict) -> dict:
        """The head's subtree of `params`, its SwiGLU residual loaded in f32 (what `get_tpe` reads)."""
        hp = params["model"][str(len(self.layers) - 1)]
        M._subtree_load(self.head.reprta, hp["reprta"], self.device, torch.float32)
        return hp

    def text_prompts(self, params: dict, txt_feats) -> np.ndarray:
        """Text embeddings (1, n, 512) → prompt embeddings (JAX `get_tpe`, with the head's weights of `params`)."""
        self._load_head(params)
        t = torch.as_tensor(np.asarray(txt_feats, np.float32), device=self.device)
        return self.head.get_tpe(t).float().cpu().numpy()

    def set_text_features(self, params: dict, txt_feats) -> None:
        """Install text embeddings (1, n, 512) as the class prompts, through `get_tpe`."""
        self._set_prompts(self.text_prompts(params, txt_feats))

    def set_classes(self, text, params: dict, text_model=None, clip_ckpt=None) -> None:
        """Embed the class names with the text tower (as WorldModel.set_classes) and install them through `get_tpe`."""
        feats = _text_model(text_model, clip_ckpt, self.device).encode_text(list(text))
        self.set_text_features(params, feats.float().cpu().numpy()[None])
        self.names = dict(enumerate(text))

    def set_visual_pe(self, vpe) -> None:
        """Use visual prompt embeddings (B, Q, 512) as the class prompts."""
        self._set_prompts(vpe)

    @torch.no_grad()
    def get_visual_pe(self, x: torch.Tensor, vp: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Visual prompt embeddings (B, Q, 512) f32 of (B, Q, H/8, W/8) masks on NHWC images (the installed tree)."""
        return self.head.get_vpe(self._head_inputs(x, plain, not self.int8), vp)

    def set_vocab(self, params: dict, texts, text_model=None, clip_ckpt=None) -> dict:
        """The prompt-free re-parameterisation (JAX `set_vocab`): `texts` embedded and fused into per-level vocabulary
        linears, the current prompts into the proposal filter → a copy of `params` whose head holds them (`lrpc`);
        the names and the class count become the texts'."""
        hp = self._load_head(params)
        feats = _text_model(text_model, clip_ckpt, self.device).encode_text(list(texts))
        feats = feats.float().cpu().numpy() if isinstance(feats, torch.Tensor) else np.asarray(feats, np.float32)
        tpe = self.text_prompts(params, feats[None])[0]
        hi = str(len(self.layers) - 1)
        out = {**params, "model": {**params["model"], hi: {**hp, "lrpc": {"vocab": self.head.fuse_text(hp, tpe),
                                                                           "pf": self.head.fuse_text(hp, self.prompts[0])}}}}
        self.names = dict(enumerate(texts))
        self.nc = self.head.nc = len(texts)
        return out

    @torch.no_grad()
    def predict_lrpc(self, x: torch.Tensor, conf: float = 0.001, plain: bool = False):
        """The prompt-free path on the installed `set_vocab` tree → ((B, 4 + nc, A) f32 preds, (B, A) keep mask)."""
        outs, keep = self.head.forward_lrpc(self._head_inputs(x, plain, not self.int8), conf=conf)
        return self.head.decode(outs), keep

    def forward_features(self, x: torch.Tensor, remat: bool = False, cls_pe=None):
        """The train forward on the prompts (`cls_pe`, default the model's)."""
        return super().forward_features(x, remat, guide=self._prompts(x, cls_pe))

    @torch.no_grad()
    def predict(self, x: torch.Tensor, neck_opt: bool = True, plain: bool = False, cls_pe=None):
        """(B, 4 + nc, A) f32 predictions; a YOLOESegment head's (preds (B, 4 + nc + nm, A), protos) as
        SegmentationModel's."""
        outs = self._forward(x, plain, neck_opt and not self.int8, cls_pe)
        return self.head.decode_with_masks(outs) if self.segment else self.head.decode(outs)


def _text_model(text_model, clip_ckpt, device):
    """`text_model`, or the seeded CLIP text tower on `device` (with `clip_ckpt`'s weights where given; JAX warns that a
    tower without weights aligns nothing)."""
    if text_model is not None:
        return text_model
    from yolo_tpu_torch.nn.text_model import build_text_model
    from yolo_tpu_torch.utils import LOGGER

    tm = build_text_model(device=device)
    if clip_ckpt:
        tm.load_torch(clip_ckpt)
    else:
        LOGGER.warning("set_classes: no text_model/clip_ckpt supplied — embedding class names with a RANDOMLY-initialized "
                       "CLIP text tower. The pipeline runs, but open-vocab alignment is meaningless until real CLIP "
                       "weights are loaded (pass clip_ckpt=... or text_model=...).")
    return tm


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
    """The model class of a checkpoint's config and task (JAX `model_class_for`): RTDETRDetectionModel for an
    RTDETRDecoder head, WorldModel for a WorldDetect one, YOLOEModel for a YOLOEDetect or YOLOESegment one, else
    DetectionModel, SegmentationModel, PoseModel, OBBModel or ClassificationModel."""
    rows = list(cfg.get("head", []))
    head = str(rows[-1][2]) if rows else "Detect"
    if head == "RTDETRDecoder":
        return RTDETRDetectionModel
    if head == "WorldDetect":
        return WorldModel
    if head in ("YOLOEDetect", "YOLOESegment"):
        return YOLOEModel
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
        if any(getattr(m, "is_rtdetr", False) for m in models):
            raise NotImplementedError("an ensemble joins its members' per-anchor predictions for one NMS; RT-DETR's query "
                                      "rows take no NMS (the JAX package's ensemble runs one over them; ROADMAP item 5b)")
        if any(getattr(m, "end2end", False) for m in models):
            raise NotImplementedError("an ensemble joins its members' predictions for one NMS; an end-to-end v10Detect "
                                      "head gives final rows that no NMS takes (the JAX package's ensemble mixes them up)")
        for m in models:
            refuse_prompted_segment(m, "an ensemble")
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
    model.int8 = any(getattr(m, "q", None) is not None for m in model.modules())  # ConvBNAct, RepConv, CBLinear
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


def _remat(m, x_in, guide: torch.Tensor | None = None):
    """One train-form layer under torch.utils.checkpoint: its activations are dropped after the
    forward and recomputed in the backward. The recompute keeps no BN moments: the first forward
    recorded them (JAX `_apply_layer` under ctx.remat). A C2fAttn's guide is one of the
    checkpoint's inputs, so its gradient flows back as the maps' do."""
    from torch.utils.checkpoint import checkpoint

    calls = [0]
    multi = isinstance(x_in, list)
    n = len(x_in) if multi else 1

    def fn(*xs):
        calls[0] += 1
        with M.recording_bn(m, calls[0] == 1):
            inp = list(xs[:n]) if multi else xs[0]
            if guide is not None:
                return m.forward_train(inp, xs[n])
            return m.forward_train(inp) if hasattr(m, "forward_train") else m(inp)

    return checkpoint(fn, *(x_in if multi else [x_in]), *([] if guide is None else [guide]), use_reentrant=False)


def _require_guide(guide, m):
    """The guide a layer reads; a World or YOLOE layer walked without class prompts raises NotImplementedError (the
    JAX package fails there on its missing guide)."""
    if guide is None:
        raise NotImplementedError(f"a {type(m).__name__} reads class prompts: build the model as a WorldModel or "
                                  "YOLOEModel (YOLOWorld / YOLOE), which hold them (ROADMAP item 5c)")
    return guide


def validate_s2d_stem(model) -> None:
    """The JAX package's check of a space-to-depth stem setting: layers 0 and 1 are the yolov8
    stem, plain 3x3 stride-2 convs padded 1, without groups, ending in SiLU. ValueError otherwise."""
    for i in (0, 1):
        m = model.layers[i]
        if type(m) is not M.ConvBNAct:
            raise ValueError(f"s2d stem fold: layer {i} is {type(m).__name__}, not a plain stem conv")
        if (m.k, m.s, m.p, m.g) != (3, 2, 1, 1):
            raise ValueError(f"s2d stem fold: layer {i} has k, s, p, g = {(m.k, m.s, m.p, m.g)}, not (3, 2, 1, 1)")
        if m.act != "silu":
            raise ValueError(f"s2d stem fold: layer {i} ends in {m.act or 'no activation'}, not SiLU (the packed stem's)")


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
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(t.shape))  # a 0-d leaf (NAS alpha) comes back 1-d
    return model
