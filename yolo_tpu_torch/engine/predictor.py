"""Streaming predictor of the detect task (counterpart of yolo_tpu/engine/predictor.py).

Host side: source iteration, letterbox, batching (batch sizes snap to powers
of two), then the inverse letterbox and the Results. Device side, one pass per
batch: uint8 BGR → RGB in [0, 1], forward through the C2f and head kernels,
DFL decode and fixed-shape NMS, with one device synchronisation where the
outputs are copied to the host. The other tasks' branches, test-time
augmentation, int8, lazy decode, the native letterbox and saving/plotting are
not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.engine.results import Results
from yolo_tpu_torch.nn.tasks import install_params
from yolo_tpu_torch.ops.boxes import scale_boxes
from yolo_tpu_torch.ops.letterbox import LetterBox
from yolo_tpu_torch.ops.nms import non_max_suppression

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}


def _snap_batch(n: int) -> int:
    """Round a batch size up to a power of two (bounds the set of shapes the device sees)."""
    b = 1
    while b < n:
        b *= 2
    return b


# cfg settings the detect predictor would act on but the port does not have, with
# the value that asks for nothing; any other value raises NotImplementedError
UNPORTED = {"save": False, "save_txt": False, "save_crop": False, "show": False, "augment": False,
            "visualize": False, "embed": None, "int8": False}


@dataclass
class PredictArgs:
    """The settings the detect predictor reads, with the defaults of the JAX package's
    cfg/default.yaml: bf16 compute (`half` or compute_dtype 'bfloat16' selects bf16;
    compute_dtype 'float32' without `half` selects f32)."""

    conf: float = 0.25
    iou: float = 0.7
    imgsz: int | tuple = 640
    half: bool = False
    compute_dtype: str = "bfloat16"
    classes: list | None = None
    agnostic_nms: bool = False
    max_det: int = 300
    batch: int = 16
    vid_stride: int = 1
    verbose: bool = True
    device: str | None = None
    plain: bool = False  # the kernels' plain twins instead of the kernels (the reference on the card)

    def update(self, overrides: dict) -> None:
        """Take settings by name. Every cfg key is accepted (`persist` too, which
        `YOLO.track` sends): the ones above are set, the others change nothing
        here (train, val, export, plotting and tracker keys), except those in
        UNPORTED, which raise NotImplementedError when they ask for something.
        A name no cfg has raises TypeError."""
        for k, v in overrides.items():
            if hasattr(self, k):
                setattr(self, k, v)
            elif k in UNPORTED:
                if v != UNPORTED[k]:
                    raise NotImplementedError(f"predict setting {k}={v!r} is not ported (only {k}={UNPORTED[k]!r})")
            elif k != "persist" and k not in DEFAULT_CFG_DICT:
                raise TypeError(f"'{k}' is not a setting of the detect predictor nor a cfg key")


class BasePredictor:
    """Detection predictor over a DetectionModel and a JAX-style parameter tree."""

    def __init__(self, model, params, overrides: dict | None = None, names: dict | None = None):
        self.args = PredictArgs()
        self.args.update(overrides or {})
        if self.args.conf is None:
            self.args.conf = 0.25
        self.model = model
        self.names = names or getattr(model, "names", {})
        self.set_params(params)

    @property
    def device(self) -> torch.device:
        return resolve_device(self.args.device)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of the forward: bf16 with `half` or compute_dtype 'bfloat16', else f32."""
        return torch.bfloat16 if self.args.half or str(self.args.compute_dtype) == "bfloat16" else torch.float32

    def set_params(self, params) -> None:
        """Install a parameter tree: BN folded (`params_from_jax` fuses), on the
        device and in the compute dtype the settings name now. The model records
        what it holds, so the tree is reloaded only when another user of the
        model (the validator) or a change of `device` or dtype replaced it."""
        self._params = params
        install_params(self.model, params, self.device, self.dtype)

    @torch.no_grad()
    def _predict(self, imgs: torch.Tensor) -> dict:
        """The device pass of one uint8 NHWC BGR batch (the cv2 convention),
        under the settings as they stand now: RGB in [0, 1], forward, NMS."""
        a = self.args
        x = imgs.flip(-1).to(self.dtype) / 255.0
        preds = self.model.predict(x, neck_opt=True, plain=a.plain)
        return non_max_suppression(
            preds, conf_thres=a.conf, iou_thres=a.iou, classes=a.classes, agnostic=a.agnostic_nms,
            max_det=a.max_det, plain=a.plain,
        )

    # --- host pipeline ---------------------------------------------------------

    def pre_transform(self, im: np.ndarray):
        """Letterbox one image to the target size → (img, (ratio, pad)).
        Grayscale inputs (2-D or single-channel) are expanded to 3 channels."""
        if im.ndim == 2:
            im = im[..., None]
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, axis=-1)
        imgsz = self.args.imgsz
        if isinstance(imgsz, int):
            imgsz = (imgsz, imgsz)
        lb = LetterBox(tuple(imgsz), auto=False, stride=max(self.model.stride))
        return lb(im, return_meta=True)

    def __call__(self, source, stream: bool = False, **kwargs):
        gen = self.stream_inference(source, **kwargs)
        return gen if stream else list(gen)

    def stream_inference(self, source, **kwargs):
        """Generator over Results, one per source image, in source order."""
        self.args.update(kwargs)
        self.set_params(self._params)  # `half` or `device` may have changed
        batch_imgs, batch_meta = [], []
        max_b = max(1, int(self.args.batch)) if self.args.batch and self.args.batch > 0 else 16
        for img, path, frame_info in _iter_source(source, vid_stride=self.args.vid_stride):
            batch_imgs.append(img)
            batch_meta.append((path, frame_info))
            if len(batch_imgs) >= max_b:
                yield from self._run_batch(batch_imgs, batch_meta)
                batch_imgs, batch_meta = [], []
        if batch_imgs:
            yield from self._run_batch(batch_imgs, batch_meta)

    def _run_batch(self, imgs: list, metas: list) -> list:
        t0 = time.perf_counter()
        proc, lb_meta = [], []
        for im in imgs:
            p, meta = self.pre_transform(im)
            proc.append(p)
            lb_meta.append(meta)
        n = len(proc)
        h, w, c = proc[0].shape
        batch = np.zeros((_snap_batch(n), h, w, c), np.uint8)
        for i, p in enumerate(proc):
            batch[i] = p

        t1 = time.perf_counter()
        out = self._predict(torch.from_numpy(batch).to(self.device))
        out = {k: v.cpu().numpy() for k, v in out.items()}  # the batch's one wait for the device

        t2 = time.perf_counter()
        results = []
        for i in range(n):
            valid = out["valid"][i]
            boxes = scale_boxes((h, w), out["boxes"][i][valid], imgs[i].shape[:2], ratio_pad=lb_meta[i])
            data = np.concatenate(
                [boxes, out["scores"][i][valid][:, None], out["cls"][i][valid][:, None].astype(np.float32)], axis=-1
            )
            results.append(Results(imgs[i], metas[i][0], self.names, boxes=data))
        t3 = time.perf_counter()
        speed = {"preprocess": (t1 - t0) * 1e3 / n, "inference": (t2 - t1) * 1e3 / n, "postprocess": (t3 - t2) * 1e3 / n}
        for r, (path, _) in zip(results, metas):
            r.speed = speed
            if self.args.verbose:
                print(f"{path}: {r.verbose()}{speed['inference']:.1f}ms")
        return results


def _iter_source(source, vid_stride: int = 1):
    """Yield (bgr_image, path, frame_idx) from an ndarray frame, an (N, H, W, C)
    ndarray batch, a list of either, or the path of a video file (opened with
    cv2, imported here only)."""
    if isinstance(source, np.ndarray):
        if source.ndim == 4:
            if source.dtype != np.uint8 or source.shape[-1] not in (1, 3):
                raise ValueError(f"an array batch is (N, H, W, 1 or 3) uint8, got {source.shape} {source.dtype}")
            for i, frame in enumerate(source):
                yield frame, f"image{i}.jpg", 0
        else:
            yield source, "array", 0
        return
    if isinstance(source, (list, tuple)):
        for i, s in enumerate(source):
            if isinstance(s, np.ndarray) and s.ndim != 4:
                yield s, f"array{i}", 0
            else:
                yield from _iter_source(s, vid_stride)
        return
    path = Path(str(source))
    if path.suffix.lower().lstrip(".") not in VID_FORMATS:
        raise ValueError(f"unsupported source {source!r}: pass an ndarray, a list of ndarrays or a video file")
    if not path.exists():
        raise FileNotFoundError(f"video not found: {path}")
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        if not cap.isOpened():
            raise RuntimeError(f"cannot open video: {path}")
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % max(1, int(vid_stride)) == 0:
                yield frame, str(path), idx
            idx += 1
    finally:
        cap.release()
