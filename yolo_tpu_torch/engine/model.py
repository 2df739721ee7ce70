"""YOLO model facade of the detect task (counterpart of yolo_tpu/engine/model.py).

    YOLO("yolov8-small.yaml")      # fresh DetectionModel, seeded random weights
    YOLO("weights/best.npz")       # a checkpoint the JAX package saved
    results = YOLO(...).predict(frame, conf=0.25)
    tracked = YOLO(...).track(frame, persist=True, tracker="bytetrack.yaml")
    metrics = YOLO(...).val(data="dataset.yaml", imgsz=640)   # P, R, mAP50, mAP50-95, fitness
    metrics = YOLO(...).train(data="dataset.yaml", epochs=3)  # best.npz / last.npz under runs/detect/train

Runs on the CUDA card unless `device="cpu"` is passed. `.pt` / orbax loading,
remote and ensemble models, and the export mode are not ported.
"""

from __future__ import annotations

from pathlib import Path

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn.tasks import DetectionModel, fuse


class YOLO:
    """User-facing model handle: a DetectionModel, its parameter tree and a lazily built predictor."""

    def __init__(self, model="yolov8n.yaml", task: str | None = None, device=None):
        if task not in (None, "detect"):
            raise NotImplementedError(f"only the detect task is ported, got task '{task}'")
        self.task = "detect"
        self.device = resolve_device(device)
        self.overrides: dict = {}
        self.predictor = None
        self.ckpt_path = None
        model = str(model)
        if model.endswith((".yaml", ".yml")):
            self._new(model)
        else:
            self._load(model)

    def _new(self, cfg: str) -> None:
        self.model = DetectionModel(cfg, device=self.device)
        self.params = self.model.init(0)

    def _load(self, weights: str) -> None:
        path = Path(weights)
        if path.suffix != ".npz":
            raise ValueError(f"unsupported model source: {weights} (a model YAML or a .npz checkpoint)")
        from yolo_tpu_torch.engine.exporter import load_npz

        self.ckpt_path = str(path)
        self.model, self.params, _ = load_npz(path, device=self.device)

    @property
    def names(self):
        return self.model.names

    @property
    def stride(self):
        return self.model.stride

    def fuse(self):
        """Fold BN into the convs of the parameter tree (inference form)."""
        self.params = fuse(self.params)
        return self

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)

    def predict(self, source=None, stream: bool = False, predictor=None, **kwargs):
        """Run inference → list of Results (a generator with `stream=True`)."""
        args = {**self.overrides, "conf": 0.25, "batch": 1, **kwargs}
        if self.predictor is None or predictor is not None:
            if predictor is None:
                from yolo_tpu_torch.engine.predictor import BasePredictor as predictor
            self.predictor = predictor(
                self.model, self.params, overrides={"device": str(self.device), **args}, names=self.model.names
            )
        else:
            self.predictor.args.update(kwargs)
            self.predictor.set_params(self.params)
        return self.predictor(source, stream=stream)

    def track(self, source=None, stream: bool = False, persist: bool = False, **kwargs):
        """Predict, then track (trackers/track.py) → Results whose boxes carry track ids.
        `conf` defaults to 0.1 and `batch` to 1; `persist=True` keeps the tracker
        of the previous call, so frames passed one call at a time form one stream."""
        kwargs.setdefault("conf", 0.1)
        kwargs.setdefault("batch", 1)
        kwargs["mode"] = "track"
        results = self.predict(source, stream=stream, **kwargs)
        from yolo_tpu_torch.trackers.track import attach_tracker

        return attach_tracker(self, results, persist=persist, stream=stream, tracker_cfg=kwargs.get("tracker"))

    def val(self, validator=None, **kwargs) -> dict:
        """Validate on a dataset split (`data`, `split`, `imgsz`, `batch`, `conf`, ...) →
        {precision, recall, mAP50, mAP50-95, fitness}, also kept in `self.metrics`. The
        forward computes in f32 unless `half=True`; `plain=True` runs the kernels' twins."""
        args = {"device": str(self.device), **self.overrides, **kwargs, "mode": "val"}
        if validator is None:
            from yolo_tpu_torch.engine.validator import validator_for

            validator = validator_for(self.model)
        self.validator = validator(args=args)
        self.metrics = self.validator(model=self.model, params=self.params)
        return self.metrics

    def train(self, trainer=None, **kwargs):
        """Train on a dataset (`data`, `epochs`, `imgsz`, `batch`, ...; engine/trainer.py) → the last
        validation's metrics. The YOLO then holds the trained model (rebuilt when the dataset's nc
        differs) and the best EMA weights (the last ones without validation), and builds a new
        predictor at its next predict."""
        overrides = {"device": str(self.device), **self.overrides, **kwargs, "mode": "train"}
        if trainer is None:
            from yolo_tpu_torch.engine.trainer import DetectionTrainer as trainer
        self.trainer = trainer(overrides=overrides, model=self.model, params=self.params)
        self.trainer.train()
        self.model = self.trainer.model
        self.params = self.trainer.best_params if self.trainer.best_params is not None else self.trainer.params
        self.predictor = None
        self.metrics = getattr(self.trainer, "metrics", None)
        return self.metrics
