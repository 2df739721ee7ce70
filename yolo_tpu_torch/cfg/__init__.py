"""Settings: the defaults of `default.yaml` (the port's copy of the JAX package's),
overrides checked against them, and the run directory (counterpart of
`DEFAULT_CFG_DICT`, `get_cfg` and `get_save_dir` in yolo_tpu/cfg/__init__.py).

The user settings file (its `runs_dir`, `datasets_dir`) and the CLI are not
ported: runs go to `runs/<task>` unless `project` names another place.
"""

from __future__ import annotations

import difflib
from pathlib import Path
from types import SimpleNamespace

import yaml

from yolo_tpu_torch.utils.files import increment_path

CFG_DIR = Path(__file__).resolve().parent

# typed keys, checked as the JAX package checks them
CFG_FLOAT_KEYS = frozenset({"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "workspace", "batch"})
CFG_FRACTION_KEYS = frozenset({
    "dropout", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr", "hsv_h", "hsv_s", "hsv_v",
    "translate", "scale", "perspective", "flipud", "fliplr", "bgr", "mosaic", "mixup", "cutmix", "copy_paste", "conf",
    "iou", "fraction", "erasing", "lr0",
})
CFG_INT_KEYS = frozenset({
    "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "max_det", "vid_stride", "line_width", "nbs",
    "save_period", "opset", "n_devices",
})
CFG_BOOL_KEYS = frozenset({
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr", "overlap_mask", "val", "save_json",
    "half", "dnn", "plots", "show", "save_txt", "save_conf", "save_crop", "save_frames", "show_labels", "show_conf",
    "visualize", "augment", "agnostic_nms", "retina_masks", "show_boxes", "keras", "optimize", "dynamic", "simplify",
    "nms", "profile", "multi_scale", "stream_buffer", "donate", "remat",
})

DEFAULT_CFG_DICT = {
    k: (None if v == "None" else v) for k, v in yaml.safe_load((CFG_DIR / "default.yaml").read_text(encoding="utf-8")).items()
}


def check_cfg(cfg: dict) -> None:
    """Raise TypeError for a value of the wrong type, ValueError for a fraction outside [0, 1]."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS and not isinstance(v, (int, float)):
            raise TypeError(f"'{k}={v}' must be an int or float")
        if k in CFG_FRACTION_KEYS:
            if not isinstance(v, (int, float)):
                raise TypeError(f"'{k}={v}' must be an int or float")
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"'{k}={v}' must be between 0.0 and 1.0")
        elif k in CFG_INT_KEYS and not isinstance(v, int):
            raise TypeError(f"'{k}={v}' must be an int")
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a bool")


def get_cfg(overrides: dict | None = None) -> SimpleNamespace:
    """The defaults updated by `overrides` (whose keys must be cfg keys: SyntaxError with the
    nearest names otherwise), type-checked → a namespace."""
    cfg = dict(DEFAULT_CFG_DICT)
    if overrides:
        overrides = dict(overrides)
        overrides.pop("save_dir", None)
        unknown = [k for k in overrides if k not in cfg]
        if unknown:
            raise SyntaxError("\n".join(f"'{k}' is not a valid key. Similar: {difflib.get_close_matches(k, list(cfg), n=3, cutoff=0.5)}"
                                        for k in unknown))
        cfg.update(overrides)
    for k in ("project", "name"):
        if isinstance(cfg.get(k), (int, float)):
            cfg[k] = str(cfg[k])
    if cfg.get("name") == "model" and cfg.get("model"):
        cfg["name"] = str(cfg["model"]).split(".")[0]
    check_cfg(cfg)
    return SimpleNamespace(**cfg)


def get_save_dir(args, name: str | None = None) -> Path:
    """The run directory: `save_dir` if set, else <project or runs/<task>>/<name or mode>, numbered
    past the existing ones unless `exist_ok`."""
    if getattr(args, "save_dir", None):
        return Path(args.save_dir)
    project = Path(args.project) if args.project else Path("runs") / args.task
    return increment_path(project / (name or args.name or f"{args.mode}"), exist_ok=getattr(args, "exist_ok", False))
