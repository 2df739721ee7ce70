"""Streaming predictor of the detect task (counterpart of yolo_tpu/engine/predictor.py).

Host side: source iteration (`data/loaders.py`), letterbox (the native C++
library, or cv2), batching (batch sizes snap to powers of two), then the
inverse letterbox, the Results and what `save`, `save_txt` and `save_crop`
write. Device side, one pass per batch: uint8 BGR → RGB in [0, 1], forward
through the C2f and head kernels, DFL decode and fixed-shape NMS, with one
device synchronisation where the outputs are copied to the host. `augment=True`
runs test-time augmentation (`DetectionModel.predict_augment`); an Ensemble's
members' predictions meet in one NMS. An end-to-end head (yolov10's v10Detect) gives
its own final rows, which skip NMS (`ops.nms.end2end_select`: conf, classes,
max_det; `augment=True` warns and predicts at one scale). RT-DETR's decoder gives (B, nq, 4 + nc) query rows, which
skip NMS too (`ops.nms.rtdetr_select`: the best class and its score over conf, the top max_det; `augment` changes
nothing there, as in the JAX predictor). A World or YOLOE model predicts on its prompts through the same route (its
C2f blocks through the kernels, its head conv by conv); a YOLOE segment model's predictor raises NotImplementedError, as
JAX's fails on its (preds, protos) pair. `int8=True` quantizes the fused tree
(nn/quantize.py, dynamic activation scales) and re-quantizes it when the
parameters change. YOLO_TPU_LAZY_DECODE=1 runs the default route: the JAX
package's lazy decode computes the same outputs and was not faster on the H100
(ROADMAP.md). `visualize` writes each layer's feature maps of the batch's first
image; `show` opens a window where a display exists and warns once where none
does (the JAX package's cv2.imshow aborts the process there). `embed` is taken
and changes nothing, as in the JAX predictor (`YOLO.embed` gives embeddings).
A classify model's route: each image resized square to `imgsz` by cv2 (no
letterbox, as the classify dataset trains), the forward to softmax
probabilities (the C2f kernel), no NMS, and Results with `probs`. The other
tasks' branches are not ported.
"""

from __future__ import annotations

import copy
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch import native
from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, check_cfg, get_save_dir
from yolo_tpu_torch.data.loaders import VID_FORMATS
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.engine.results import Results
from yolo_tpu_torch.nn.quantize import quantize_params
from yolo_tpu_torch.nn.tasks import (
    BaseModel,
    DetectionModel,
    Ensemble,
    fuse,
    install_params,
    params_from_jax,
    refuse_prompted_segment,
)
from yolo_tpu_torch.ops.boxes import scale_boxes
from yolo_tpu_torch.ops.letterbox import LetterBox
from yolo_tpu_torch.ops.nms import end2end_select, non_max_suppression, rtdetr_select
from yolo_tpu_torch.utils import LOGGER
from yolo_tpu_torch.utils.files import imwrite


def _snap_batch(n: int) -> int:
    """Round a batch size up to a power of two (bounds the set of shapes the device sees)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _has_display() -> bool:
    """Whether a window can open: on Linux an X or Wayland display must be named."""
    if not sys.platform.startswith("linux"):
        return True
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


@dataclass
class PredictArgs:
    """The settings the detect predictor reads, with the defaults of the JAX package's
    cfg/default.yaml: bf16 compute (`half` or compute_dtype 'bfloat16' selects bf16;
    compute_dtype 'float32' without `half` selects f32). `save` defaults to False: the
    cfg's True is the trainer's (checkpoints), and `YOLO.predict` passes False in both packages."""

    conf: float = 0.25
    iou: float = 0.7
    imgsz: int | tuple = 640
    half: bool = False
    compute_dtype: str = "bfloat16"
    classes: list | None = None
    agnostic_nms: bool = False
    augment: bool = False  # test-time augmentation, for a plain DetectionModel
    int8: bool = False  # PTQ int8 convs, dynamic activation scales (nn/quantize.py)
    show: bool = False  # a window per image, where a display exists
    retina_masks: bool = False  # segment: masks resized once from prototype scale to the original image
    visualize: bool = False  # per-layer feature maps of each batch's first image, under the run directory
    max_det: int = 300
    batch: int = 16
    vid_stride: int = 1
    verbose: bool = True
    device: str | None = None
    plain: bool = False  # the kernels' plain twins instead of the kernels (the reference on the card)
    stream_buffer: bool = False
    # outputs: annotated images / videos, YOLO label files, crops, under <project>/<name>
    save: bool = False
    save_txt: bool = False
    save_conf: bool = False
    save_crop: bool = False
    save_frames: bool = False
    project: str | None = None
    name: str | None = None
    exist_ok: bool = False
    line_width: int | None = None
    show_labels: bool = True
    show_conf: bool = True
    show_boxes: bool = True
    task: str = "detect"
    mode: str = DEFAULT_CFG_DICT["mode"]

    def update(self, overrides: dict) -> None:
        """Take settings by name. Every cfg key is accepted (`persist` too, which
        `YOLO.track` sends): the ones above are set, the others change nothing
        here (train, val, export, plotting and tracker keys, and `embed`, as in
        the JAX predictor). A name no cfg has raises TypeError; a value of the wrong type TypeError, and a
        fraction (conf, iou) outside [0, 1] ValueError, as the JAX package's `get_cfg`."""
        check_cfg(dict(overrides))
        for k, v in overrides.items():
            if hasattr(self, k):
                setattr(self, k, v)
            elif k != "persist" and k not in DEFAULT_CFG_DICT:
                raise TypeError(f"'{k}' is not a setting of the detect predictor nor a cfg key")


class BasePredictor:
    """Detection predictor over a DetectionModel and a JAX-style parameter tree.

    `timings`, when set to a list, gets one dict a batch from `_run_batch`: the frame
    count and padded batch size, host seconds of the letterbox and assembly, of the
    enqueue (upload, forward and NMS issued), of the wait for the outputs and of the
    Results, and on a card the CUDA events around the upload and the device pass."""

    def __init__(self, model, params, overrides: dict | None = None, names: dict | None = None):
        self.args = PredictArgs()
        self.args.update(overrides or {})
        if self.args.conf is None:
            self.args.conf = 0.25
        refuse_prompted_segment(model, "the predictor")
        self.model = model
        self.names = names or getattr(model, "names", {})
        self.done_warmup = False
        self.save_dir = None
        self.timings = None
        self._vid_writers = {}
        self.set_params(params)

    @property
    def device(self) -> torch.device:
        return resolve_device(self.args.device)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of the forward: bf16 with `half` or compute_dtype 'bfloat16', else f32."""
        return torch.bfloat16 if self.args.half or str(self.args.compute_dtype) == "bfloat16" else torch.float32

    def set_params(self, params) -> None:
        """Install a parameter tree: BN folded (`params_from_jax` fuses), and with `int8`
        quantized (re-quantized when the tree changes, as JAX `set_params`), on the device
        and in the compute dtype the settings name now. The model records what it holds, so
        the tree is reloaded only when another user of the model (the validator) or a change
        of `device`, dtype or `int8` replaced it."""
        self._params = params
        tree = params
        if self.args.int8:
            if getattr(self, "_quantized", (None,))[0] is not params:
                fused = self.model.fuse(params) if isinstance(self.model, Ensemble) else fuse(params)
                self._quantized = (params, quantize_params(fused))
            tree = self._quantized[1]
        install_params(self.model, tree, self.device, self.dtype)

    @torch.no_grad()
    def _predict(self, imgs: torch.Tensor) -> dict:
        """The device pass of one uint8 NHWC BGR batch (the cv2 convention),
        under the settings as they stand now: RGB in [0, 1], forward, NMS."""
        a = self.args
        x = imgs.flip(-1).to(self.dtype) / 255.0
        if self._classify:
            return {"probs": self.model.predict(x, plain=a.plain)}
        if getattr(self.model, "is_rtdetr", False):  # the query rows, thresholded: no NMS, and one scale (as in JAX)
            rows = self.model.predict(x, neck_opt=not self.model.int8, plain=a.plain)
            return rtdetr_select(rows, x.shape[1:3], conf_thres=a.conf, classes=a.classes, max_det=a.max_det)
        if a.augment and self._takes_augment():
            preds = self.model.predict_augment(x, plain=a.plain)
        else:  # an int8 model walks without the neck fold
            preds = self.model.predict(x, neck_opt=not getattr(self.model, "int8", False), plain=a.plain)
        if getattr(self.model, "end2end", False):  # the head's own rows: no NMS (the JAX package runs one, a fault)
            return end2end_select(preds, conf_thres=a.conf, classes=a.classes, max_det=a.max_det, nc=self.model.nc)
        return non_max_suppression(
            preds, conf_thres=a.conf, iou_thres=a.iou, classes=a.classes, agnostic=a.agnostic_nms,
            max_det=a.max_det, plain=a.plain,
        )

    @property
    def _classify(self) -> bool:
        return getattr(self.model, "task", "detect") == "classify"

    def _takes_augment(self) -> bool:
        """Test-time augmentation is for a plain DetectionModel (as in the JAX package); for
        another model (an Ensemble, an end-to-end head) `augment=True` warns once and predicts at one scale."""
        if type(self.model) is DetectionModel and not self.model.end2end:
            return True
        if not getattr(self, "_augment_warned", False):
            LOGGER.warning("model does not support augment=True, using single-scale prediction")
            self._augment_warned = True
        return False

    def warmup(self, imgsz=(1, 640, 640, 3)) -> None:
        """One zero batch of shape `imgsz` (B, H, W, 3) through the device pass, waited for: on a
        card it builds the kernels and plans that batch size."""
        out = self._predict(torch.zeros(tuple(imgsz), dtype=torch.uint8, device=self.device))
        next(iter(out.values())).cpu()  # waits for the pass
        self.done_warmup = True

    # --- host pipeline ---------------------------------------------------------

    def pre_transform(self, im: np.ndarray):
        """Letterbox one image to the target size → (img, (ratio, pad)); a classify model's image is
        resized square instead. Grayscale inputs (2-D or single-channel) are expanded to 3 channels. A uint8 image goes through the native library
        (ratio in f32, as the JAX package's) unless it is unavailable or YOLO_TPU_NATIVE_PRE is "0"
        (the JAX package's setting), then through cv2; the two resizers differ by one grey level."""
        if im.ndim == 2:
            im = im[..., None]
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, axis=-1)
        imgsz = self.args.imgsz
        if isinstance(imgsz, int):
            imgsz = (imgsz, imgsz)
        if self._classify:  # square-resized, as the classify dataset trains and validates
            import cv2

            return cv2.resize(im, (imgsz[1], imgsz[0]), interpolation=cv2.INTER_LINEAR), ((1.0, 1.0), (0.0, 0.0))
        if im.dtype == np.uint8 and native.available() and os.environ.get("YOLO_TPU_NATIVE_PRE", "1") != "0":
            return native.letterbox(im, tuple(imgsz))
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
        try:
            for img, path, frame_info in _iter_source(source, self.args.vid_stride, self.args.stream_buffer):
                batch_imgs.append(img)
                batch_meta.append((path, frame_info))
                if len(batch_imgs) >= max_b:
                    yield from self._run_batch(batch_imgs, batch_meta)
                    batch_imgs, batch_meta = [], []
            if batch_imgs:
                yield from self._run_batch(batch_imgs, batch_meta)
        finally:
            self.close()

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
        events = None
        if self.timings is not None and self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
        x = torch.from_numpy(batch).to(self.device)
        if events:
            events[1].record()
        out = self._predict(x)
        if events:
            events[2].record()
        t_enq = time.perf_counter()
        out = self._fetch(out)  # the batch's wait for the device
        t2 = time.perf_counter()
        if self.args.visualize and isinstance(self.model, BaseModel):
            self._visualize_features(batch[:1])

        self._host_s = {}
        results = [self._result(imgs[i], metas[i][0], {k: v[i] for k, v in out.items()}, (h, w), lb_meta[i]) for i in range(n)]
        t3 = time.perf_counter()
        speed = {"preprocess": (t1 - t0) * 1e3 / n, "inference": (t2 - t1) * 1e3 / n, "postprocess": (t3 - t2) * 1e3 / n}
        for r, (path, _) in zip(results, metas):
            r.speed = speed
            if self.args.verbose:
                print(f"{path}: {r.verbose()}{speed['inference']:.1f}ms")
        if self.args.show:
            self._show_results(results)
        if self.timings is not None:
            self.timings.append({"n": n, "B": len(batch), "pre_s": t1 - t0, "enqueue_s": t_enq - t1, "wait_s": t2 - t_enq,
                                 "post_s": t3 - t2, "events": events, **self._host_s})
        if self.args.save or self.args.save_txt or self.args.save_crop:
            self._write_results(results, metas)
        return results

    def _fetch(self, out: dict) -> dict:
        """The device pass's outputs as numpy arrays on the host."""
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _result(self, img: np.ndarray, path, out: dict, hw, lb_meta) -> Results:
        """The Results of one image from its rows of the fetched outputs: its valid boxes mapped back
        through the letterbox (`hw` the letterboxed size), or a classify model's probabilities."""
        if "probs" in out:  # classify: probabilities, no boxes
            return Results(img, path, self.names, probs=out["probs"])
        valid = out["valid"]
        boxes = scale_boxes(hw, out["boxes"][valid], img.shape[:2], ratio_pad=lb_meta)
        data = np.concatenate([boxes, out["scores"][valid][:, None], out["cls"][valid][:, None].astype(np.float32)], axis=-1)
        return Results(img, path, self.names, boxes=data)

    def _show_results(self, results) -> None:
        """One window frame per result. Without a display (or where cv2 cannot open one) the JAX
        package's warning, once, and `show` turns off; the Results are unchanged."""
        reason = None if _has_display() else "no display (DISPLAY and WAYLAND_DISPLAY are unset)"
        if reason is None:
            import cv2

            try:
                for r in results:
                    cv2.imshow("yolo_tpu", r.plot(**self._plot_kwargs()))
                    cv2.waitKey(1)
                return
            except cv2.error as e:
                reason = e
        if not getattr(self, "_show_warned", False):
            LOGGER.warning(f"show=True unavailable (headless?): {reason}")
            self._show_warned = True
        self.args.show = False

    def _visualize_features(self, imgs: np.ndarray) -> None:
        """Every layer's output for image 0 of the batch (uint8 BGR), from an f32 walk without the neck
        fold (a copy of the model holding the same tree in f32) → stage{i}_{Module}_features.png / .npy
        under the run directory (`utils.plotting.feature_visualization`); the head's and int8 outputs
        are skipped, as in the JAX package."""
        from yolo_tpu_torch.utils.plotting import feature_visualization

        if self.save_dir is None:
            self.save_dir = get_save_dir(self.args)
            self.save_dir.mkdir(parents=True, exist_ok=True)
            self._vid_writers = {}
        model = copy.deepcopy(self.model)
        params_from_jax(model, self.model.held[0], torch.float32)
        x = torch.from_numpy(np.ascontiguousarray(imgs[..., ::-1]).astype(np.float32) / 255.0).to(self.device)
        with torch.no_grad():
            _, col = model._walk(x, plain=self.args.plain, neck_opt=False, collect=set(range(len(model.layers))))
        for i, m in enumerate(model.layers):
            out = col.get(i)
            if isinstance(out, torch.Tensor):
                feature_visualization(out.float().cpu().numpy(), type(m).__name__, i, save_dir=self.save_dir)

    def _plot_kwargs(self) -> dict:
        a = self.args
        return {"line_width": a.line_width, "labels": a.show_labels, "conf": a.show_conf, "boxes": a.show_boxes}

    def _write_results(self, results, metas) -> None:
        """What `save`, `save_txt` and `save_crop` ask for, under the run directory (made at the
        first write): <stem>.jpg (a video's frames into <stem>.mp4 at its fps over `vid_stride`,
        and <stem>_frames/<i>.jpg with `save_frames`), labels/<stem>[_<frame>].txt, and
        crops/<class>/<stem>_<frame>_<j>.jpg (the box squared, x1.02 + 10 px, clipped)."""
        import cv2

        if self.save_dir is None:
            self.save_dir = get_save_dir(self.args)
            self.save_dir.mkdir(parents=True, exist_ok=True)
            self._vid_writers = {}
        for r, (path, frame_idx) in zip(results, metas):
            stem = Path(str(path)).stem or "image"
            is_vid = Path(str(path)).suffix.lower().lstrip(".") in VID_FORMATS
            if self.args.save_txt:
                txt_stem = f"{stem}_{frame_idx}" if is_vid else stem
                r.save_txt(self.save_dir / "labels" / f"{txt_stem}.txt", save_conf=self.args.save_conf)
            if self.args.save_crop:
                H, W = r.orig_img.shape[:2]
                for j, b in enumerate(np.asarray(r.boxes.xyxy)):
                    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
                    side = max(b[2] - b[0], b[3] - b[1]) * 1.02 / 2 + 10
                    x1, y1 = max(int(cx - side), 0), max(int(cy - side), 0)
                    x2, y2 = min(int(cx + side), W), min(int(cy + side), H)
                    if x2 <= x1 or y2 <= y1:
                        continue
                    cname = self.names.get(int(r.boxes.cls[j]), str(int(r.boxes.cls[j])))
                    d = self.save_dir / "crops" / str(cname)
                    d.mkdir(parents=True, exist_ok=True)
                    imwrite(str(d / f"{stem}_{frame_idx}_{j}.jpg"), r.orig_img[y1:y2, x1:x2])
            if self.args.save:
                annotated = r.plot(**self._plot_kwargs())
                if is_vid and self.args.save_frames:
                    d = self.save_dir / f"{stem}_frames"
                    d.mkdir(parents=True, exist_ok=True)
                    imwrite(str(d / f"{frame_idx}.jpg"), annotated)
                if is_vid:
                    if path not in self._vid_writers:
                        h, w = annotated.shape[:2]
                        cap = cv2.VideoCapture(str(path))
                        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                        cap.release()
                        fps = max(fps / max(1, int(self.args.vid_stride or 1)), 1.0)
                        self._vid_writers[path] = cv2.VideoWriter(
                            str(self.save_dir / f"{stem}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h))
                    self._vid_writers[path].write(annotated)
                else:
                    imwrite(str(self.save_dir / f"{stem}.jpg"), annotated)

    def close(self) -> None:
        """Finish the videos `save` is writing."""
        for w in self._vid_writers.values():
            w.release()
        self._vid_writers = {}


def _drain_loader(loader):
    """(bgr_image, path, frame_idx) from any loader of data/loaders.py."""
    from yolo_tpu_torch.data.loaders import LoadStreams

    if isinstance(loader, LoadStreams):  # one (sources, frames, infos) a tick
        idx = 0
        try:
            for srcs, frames_, _ in loader:
                for j, im in enumerate(frames_):
                    yield im, str(srcs[j]), idx
                idx += 1
        finally:
            loader.close()
    else:
        for path, frame, idx in loader:
            yield frame, path, idx


def _iter_source(source, vid_stride: int = 1, stream_buffer: bool = False):
    """Yield (bgr_image, path, frame_idx) from any source: a single ndarray frame ("array") or
    PIL image ("pil") here, a list item by item ("array<i>" for its frames; a list of stream
    URLs or webcam indices as one multi-stream loader), and everything else (4-D arrays and
    tensors, files, directories, globs, videos, streams, "screen") through
    `data.loaders.load_inference_source`."""
    from yolo_tpu_torch.data.loaders import _is_stream, load_inference_source

    if isinstance(source, np.ndarray) and source.ndim != 4:
        yield source, "array", 0
        return
    try:
        from PIL import Image

        if isinstance(source, Image.Image):
            yield np.asarray(source.convert("RGB"))[..., ::-1], "pil", 0
            return
    except ImportError:
        pass
    if isinstance(source, (list, tuple)):
        if source and all(_is_stream(s) for s in source):
            yield from _drain_loader(load_inference_source(list(source), vid_stride=vid_stride, stream_buffer=stream_buffer))
            return
        for i, s in enumerate(source):
            if isinstance(s, np.ndarray) and s.ndim != 4:
                yield s, f"array{i}", 0
            else:
                yield from _iter_source(s, vid_stride, stream_buffer)
        return
    yield from _drain_loader(load_inference_source(source, vid_stride=vid_stride, stream_buffer=stream_buffer))
