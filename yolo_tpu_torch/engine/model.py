"""YOLO model facade of the detect, segment, pose, obb and classify tasks (counterpart of yolo_tpu/engine/model.py).

    YOLO("yolov8-small.yaml")      # fresh DetectionModel, seeded random weights
    YOLO("yolov8n-cls.yaml")       # fresh ClassificationModel (a name with '-cls', or task="classify")
    YOLO("yolov8n-seg.yaml")       # fresh SegmentationModel (a name with '-seg', or task="segment")
    YOLO("yolov8n-pose.yaml")      # fresh PoseModel (a name with '-pose', or task="pose")
    YOLO("yolov8n-obb.yaml")       # fresh OBBModel (a name with '-obb', or task="obb")
    YOLO("weights/best.npz")       # a checkpoint the JAX package saved
    YOLO("weights/best.pt")        # a torch-layout state_dict of either package (nn/torch_export.py)
    YOLO("tcp://host:8777/0")      # lane 0 of a detection server (serve.py): predict and track only
    YOLO(["a.npz", "b.npz"])       # an NMS ensemble of the listed models
    results = YOLO(...).predict(frame, conf=0.25)   # or files, directories, globs, videos, streams
    results = YOLO(...).predict(frame, augment=True)  # test-time augmentation: 3 scales, one flipped
    YOLO(...).info()               # {layers, parameters, stride}
    vectors = YOLO(...).embed(frames, imgsz=640)      # pooled features of the layer before the head
    tracked = YOLO(...).track(frame, persist=True, tracker="bytetrack.yaml")
    metrics = YOLO(...).val(data="dataset.yaml", imgsz=640)   # P, R, mAP50, mAP50-95, fitness
    metrics = YOLO(...).train(data="dataset.yaml", epochs=3)  # best.npz / last.npz under runs/detect/train
    YOLO(...).export(format="pt")  # <stem>.pt (or npz) in the working directory
    rows = YOLO(...).benchmark(imgsz=640)                     # latency / fps at batch 1, 8, 32
    best = YOLO(...).tune(data="dataset.yaml", iterations=10, epochs=10)  # hyperparameter evolution

A classify YOLO predicts Results with `probs` (top-5 and their confidences), validates to
top1 / top5 / fitness and trains on a folder-per-class dataset (engine/classify.py). A segment
YOLO predicts Results with `masks` (engine/segment_predictor.py), validates to box and `mask_`
metrics and trains on polygon labels (the detect trainer with the segmentation loss). A pose
YOLO predicts Results with `keypoints` (engine/pose_predictor.py), validates to box and `pose_`
(OKS) metrics and trains on keypoint labels (the detect trainer with the pose loss). An obb YOLO
predicts Results with `obb` (oriented boxes, engine/obb_predictor.py), validates to box metrics on
probiou and trains on DOTA corner labels (the detect trainer with the rotated loss). All three
track (their masks or keypoints follow their boxes; oriented boxes keep their angle); their
`benchmark`, `tune` and ensembles raise NotImplementedError (ROADMAP item 2). Runs on the CUDA
card unless `device="cpu"` is passed. Orbax checkpoints are not ported, nor the orbax, stablehlo
and tflite exports.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn.tasks import (
    EXTRA_OUTPUT_TASKS,
    ClassificationModel,
    DetectionModel,
    Ensemble,
    OBBModel,
    PoseModel,
    SegmentationModel,
    fuse,
    install_params,
    param_count,
)
from yolo_tpu_torch.utils import LOGGER

PORTED_TASKS = ("detect", "segment", "pose", "obb", "classify")
MODEL_CLASS = {"detect": DetectionModel, "segment": SegmentationModel, "pose": PoseModel, "obb": OBBModel,
               "classify": ClassificationModel}


def _task_of(model: str, task: str | None) -> str:
    """The task named, else the JAX package's guess from a model yaml's name ('-cls' classify, '-seg'
    segment, '-pose' pose, '-obb' obb, else detect); a task the port lacks raises NotImplementedError."""
    task = task or ("classify" if "-cls" in model else "segment" if "-seg" in model else "pose" if "-pose" in model
                    else "obb" if "-obb" in model else "detect")
    if task not in PORTED_TASKS:
        raise NotImplementedError(f"the {task} task is not ported (only detect, segment, pose, obb and classify)")
    return task


class YOLO:
    """User-facing model handle: a DetectionModel (or its segment, pose or obb subclass) or a
    ClassificationModel, its parameter tree and a lazily built predictor."""

    def __init__(self, model="yolov8n.yaml", task: str | None = None, device=None):
        self.predictor = None
        self.ckpt_path = None
        self.remote = None
        if isinstance(model, (list, tuple)):
            self.task = _task_of("", task)
            self._load_ensemble([str(m) for m in model], device)
            return
        model = str(model)
        if model.startswith("tcp://"):
            self.task = _task_of("", task)
            self._load_remote(model)
            return
        self.task = _task_of(model if model.endswith((".yaml", ".yml")) else "", task)  # a checkpoint names its own
        self.device = resolve_device(device)
        self.overrides: dict = {}
        if model.endswith((".yaml", ".yml")):
            self._new(model)
        else:
            self._load(model)
        self.overrides["model"] = model
        self.overrides["task"] = self.task

    def _new(self, cfg: str) -> None:
        self.model = MODEL_CLASS[self.task](cfg, device=self.device)
        self.params = self.model.init(0)

    def _load(self, weights: str) -> None:
        """A .npz, or a .pt whose `train_args` become the overrides (all cfg keys but model, data, device)."""
        path = Path(weights)
        self.ckpt_path = str(path)
        if path.suffix == ".pt":
            from yolo_tpu_torch.nn.torch_import import load_pt

            self.model, self.params, meta = load_pt(path, device=self.device)
            if meta.get("names"):
                self.model.names = dict(meta["names"])
            if meta.get("train_args"):
                self.overrides = {k: v for k, v in dict(meta["train_args"]).items()
                                  if k in DEFAULT_CFG_DICT and k not in ("model", "data", "device")}
        elif path.suffix == ".npz":
            from yolo_tpu_torch.engine.exporter import load_npz

            self.model, self.params, _ = load_npz(path, device=self.device)
        else:
            raise ValueError(f"unsupported model source: {weights} (a model YAML, a .npz or .pt checkpoint, or a tcp:// URL)")
        self.task = self.model.task  # the checkpoint's own task wins over the name's

    def _load_ensemble(self, weights: list, device) -> None:
        """An NMS ensemble of the listed sources (each a YAML, .npz or .pt), on one device."""
        members = [YOLO(w, device=device) for w in weights]
        for m in members:
            if m.task in EXTRA_OUTPUT_TASKS:
                raise NotImplementedError(f"an ensemble of {m.task} models is not ported (ROADMAP item 2)")
        self.device = members[0].device
        self.overrides = {"model": ",".join(weights), "task": self.task}
        self.model = Ensemble([m.model for m in members])
        self.params = tuple(m.params for m in members)

    def _load_remote(self, url: str) -> None:
        """Predict and track through lane <id> of a detection server; nothing runs here."""
        from types import SimpleNamespace

        from yolo_tpu_torch.utils.remote import RemoteModel

        self.remote = RemoteModel(url)
        self.device = None
        self.overrides = {"model": url, "task": self.task}
        self.model = SimpleNamespace(task=self.task, names={})

    @property
    def names(self):
        return self.model.names

    @property
    def stride(self):
        return self.model.stride

    def fuse(self):
        """Fold BN into the convs of the parameter tree (inference form)."""
        self.params = self.model.fuse(self.params) if isinstance(self.model, Ensemble) else fuse(self.params)
        return self

    def info(self, verbose: bool = True) -> dict:
        """{layers, parameters (the values of the parameter tree as it stands: fused or not), stride}."""
        n_params = param_count(self.params)
        n_layers = len(self.model.layers)
        if verbose:
            LOGGER.info(f"model: {n_layers} layers, {n_params:,} params, strides {self.model.stride}")
        return {"layers": n_layers, "parameters": n_params, "stride": self.model.stride}

    def embed(self, source=None, layers=None, imgsz: int = 640, plain: bool = False) -> list:
        """Pooled embeddings, one f32 vector per image of `source` (any predict source): each image
        letterboxed square to `imgsz` (cv2, no stride snap), RGB in [0, 1], walked in f32 through
        the inference modules (C2f through the kernel; `plain=True`: its twin) and the outputs of
        `layers` (default the one before the head) mean-pooled and concatenated."""
        self._require_local("embed")
        from yolo_tpu_torch.engine.predictor import _iter_source
        from yolo_tpu_torch.ops.letterbox import LetterBox

        install_params(self.model, self.params, self.device, torch.float32)
        lb = LetterBox((imgsz, imgsz), auto=False)
        out = []
        for img, _path, _ in _iter_source(source):
            x = torch.from_numpy(np.ascontiguousarray(lb(img)[None, ..., ::-1], np.float32) / 255.0).to(self.device)
            out.append(self.model.embed_features(x, idx=layers, plain=plain)[0].cpu().numpy())
        return out

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)

    def predict(self, source=None, stream: bool = False, predictor=None, **kwargs):
        """Run inference → list of Results (a generator with `stream=True`)."""
        args = {**self.overrides, "conf": 0.25, "batch": 1, "save": False, "mode": "predict", **kwargs}
        if self.remote is not None:
            from yolo_tpu_torch.engine.remote_predictor import RemotePredictor

            if self.predictor is None:
                self.predictor = RemotePredictor(self.remote, overrides=args, names=self.model.names)
            return self.predictor(source, stream=stream, **kwargs)
        if self.predictor is None or predictor is not None:
            if predictor is None and self.task == "segment":
                from yolo_tpu_torch.engine.segment_predictor import SegmentationPredictor as predictor
            elif predictor is None and self.task == "pose":
                from yolo_tpu_torch.engine.pose_predictor import PosePredictor as predictor
            elif predictor is None and self.task == "obb":
                from yolo_tpu_torch.engine.obb_predictor import OBBPredictor as predictor
            elif predictor is None:
                from yolo_tpu_torch.engine.predictor import BasePredictor as predictor
            self.predictor = predictor(
                self.model, self.params, overrides={"device": str(self.device), **args}, names=self.model.names
            )
        else:
            self.predictor.args.update(kwargs)
            self.predictor.set_params(self.params)
        return self.predictor(source, stream=stream)

    def track(self, source=None, stream: bool = False, persist: bool = False, **kwargs):
        """Predict, then track (trackers/track.py) → Results whose boxes carry track ids, a segment or
        pose result's masks or keypoints kept with their boxes. `conf` defaults to 0.1 and `batch` to 1;
        `persist=True` keeps the tracker of the previous call, so frames passed one call at a time form
        one stream."""
        kwargs.setdefault("conf", 0.1)
        kwargs.setdefault("batch", 1)
        kwargs["mode"] = "track"
        results = self.predict(source, stream=stream, **kwargs)
        from yolo_tpu_torch.trackers.track import attach_tracker

        return attach_tracker(self, results, persist=persist, stream=stream, tracker_cfg=kwargs.get("tracker"))

    def _refuse_extra_outputs(self, what: str) -> None:
        if self.task in EXTRA_OUTPUT_TASKS:
            raise NotImplementedError(f"YOLO.{what} with a {self.task} model is not ported (ROADMAP item 2)")

    def _require_local(self, mode: str) -> None:
        if self.remote is not None:
            raise RuntimeError(
                f"{mode} needs the local params tree; a tcp:// remote model only supports predict/track "
                f"(load the checkpoint locally instead of {self.overrides.get('model')})"
            )

    def val(self, validator=None, **kwargs) -> dict:
        """Validate on a dataset split (`data`, `split`, `imgsz`, `batch`, `conf`, ...) →
        {precision, recall, mAP50, mAP50-95, fitness} (classify: {top1, top5, fitness}), also kept
        in `self.metrics`. The forward computes in f32 unless `half=True`; `plain=True` runs the
        kernels' twins."""
        self._require_local("val")
        args = {"device": str(self.device), **self.overrides, **kwargs, "mode": "val"}
        if validator is None:
            from yolo_tpu_torch.engine.validator import validator_for

            validator = validator_for(self.model)
        self.validator = validator(args=args)
        self.metrics = self.validator(model=self.model, params=self.params)
        return self.metrics

    def train(self, trainer=None, **kwargs):
        """Train on a dataset (`data`, `epochs`, `imgsz`, `batch`, ...; engine/trainer.py, classify:
        engine/classify.py on a folder-per-class dataset) → the last validation's metrics. The YOLO
        then holds the trained model (rebuilt when the dataset's nc differs) and the best EMA weights
        (the last ones without validation; classify: the best top-1's), and builds a new predictor at
        its next predict."""
        self._require_local("train")
        overrides = {"device": str(self.device), **self.overrides, **kwargs, "mode": "train"}
        if trainer is None and self.task == "classify":
            from yolo_tpu_torch.engine.classify import ClassificationTrainer as trainer
        elif trainer is None:
            from yolo_tpu_torch.engine.trainer import DetectionTrainer as trainer
        self.trainer = trainer(overrides=overrides, model=self.model, params=self.params)
        self.trainer.train()
        self.model = self.trainer.model
        self.params = self.trainer.best_params if self.trainer.best_params is not None else self.trainer.params
        self.predictor = None
        self.metrics = getattr(self.trainer, "metrics", None)
        return self.metrics

    def tune(self, iterations: int = 10, use_ray: bool = False, **kwargs):
        """Hyperparameter evolution (engine/tuner.py): `iterations` short trainings of a fresh model
        built from this one's source, on this YOLO's device → {best_fitness, best_hyperparameters,
        best_iteration}. `use_ray=True` runs the Ray Tune search instead (needs ray)."""
        self._require_local("tune")
        self._refuse_extra_outputs("tune")
        if use_ray:
            from yolo_tpu_torch.engine.tuner import run_ray_tune

            return run_ray_tune(self, max_samples=iterations, **kwargs)
        from yolo_tpu_torch.engine.tuner import Tuner

        args = {"device": str(self.device), **self.overrides, **kwargs, "mode": "train"}
        return Tuner(args=args)(model=self, iterations=iterations, **kwargs)

    def benchmark(self, **kwargs) -> list:
        """Latency and frames/s of this model's forward at batch 1, 8 and 32 (utils/benchmarks.py):
        `imgsz` (640), `half` (True: bf16; False: f32)."""
        self._require_local("benchmark")
        self._refuse_extra_outputs("benchmark")
        from yolo_tpu_torch.utils.benchmarks import benchmark

        return benchmark(model=self, **kwargs)

    def export(self, **kwargs) -> Path:
        """Write the model in `format` ('npz' or 'pt') to <the model's stem>.<suffix> in the working directory."""
        self._require_local("export")
        from yolo_tpu_torch.engine.exporter import Exporter

        return Exporter(args={**self.overrides, **kwargs, "mode": "export"})(model=self.model, params=self.params)

    def save(self, filename="model.npz") -> Path:
        from yolo_tpu_torch.engine.exporter import save_npz

        return save_npz(self.model, self.params, filename)
