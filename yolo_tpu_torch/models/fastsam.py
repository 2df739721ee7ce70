"""FastSAM: segment everything with a one-class yolov8-seg pass, then filter by prompts (counterpart of
yolo_tpu/models/fastsam.py).

The device side is the port's segment predictor (kernels 1, 2 and 3 in the forward, kernel 5 in its
NMS); the prompt filters (bbox, point, text) are host numpy over the decoded masks, JAX's rules.
Text prompts score each crop against the text with the CLIP towers (`nn/text_model.py::CLIPModel`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT
from yolo_tpu_torch.engine.model import YOLO
from yolo_tpu_torch.engine.segment_predictor import SegmentationPredictor
from yolo_tpu_torch.ops.boxes import box_iou
from yolo_tpu_torch.utils import LOGGER

_UNSET = object()  # a cache miss (clip_ckpt=None is a key)


def adjust_bboxes_to_image_border(boxes: np.ndarray, image_shape, threshold: int = 20) -> np.ndarray:
    """Boxes within `threshold` px of the image's border snapped onto it."""
    h, w = image_shape
    boxes = boxes.copy()
    boxes[boxes[:, 0] < threshold, 0] = 0
    boxes[boxes[:, 1] < threshold, 1] = 0
    boxes[boxes[:, 2] > w - threshold, 2] = w
    boxes[boxes[:, 3] > h - threshold, 3] = h
    return boxes


class FastSAMPredictor(SegmentationPredictor):
    """The segment predictor, a box near the whole image snapped to it (IoU > 0.9), then the prompts' selection."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prompts = {}

    def set_prompts(self, prompts: dict) -> None:
        """Prompts applied to the next batch."""
        self.prompts = dict(prompts or {})

    def _run_batch(self, imgs: list, metas: list) -> list:
        """The parent's batch with save / show / verbose held back, the snap and the prompts, then those."""
        emit = {k: getattr(self.args, k) for k in ("save", "save_txt", "save_crop", "show", "verbose")}
        for k in emit:
            setattr(self.args, k, False)
        try:
            results = super()._run_batch(imgs, metas)
        finally:
            for k, v in emit.items():
                setattr(self.args, k, v)
        p = self.prompts
        bboxes, points, labels, texts = (p.pop(k, None) for k in ("bboxes", "points", "labels", "texts"))
        for r in results:
            if r.boxes is None or len(r.boxes) == 0:
                continue
            h, w = r.orig_shape
            snapped = adjust_bboxes_to_image_border(np.asarray(r.boxes.xyxy), (h, w))
            full = np.array([[0, 0, w, h]], np.float32)
            iou = np.asarray(box_iou(full, snapped))[0]
            data = np.asarray(r.boxes.data).copy()
            data[iou > 0.9, :4] = full[0]
            r.update(boxes=data)
        out = self.prompt(results, bboxes=bboxes, points=points, labels=labels, texts=texts)
        if emit["verbose"]:
            for r, (path, _) in zip(out, metas):
                print(f"{path}: {r.verbose()}{r.speed['inference']:.1f}ms")
        if emit["show"]:
            self._show_results(out)
        if emit["save"] or emit["save_txt"] or emit["save_crop"]:
            self._write_results(out, metas)
        return out

    def _clip(self):
        """The prompts' `clip_model`, else one built once per `clip_ckpt` (seeded, with a warning, without one)."""
        from yolo_tpu_torch.nn.text_model import CLIPModel

        clip = self.prompts.pop("clip_model", None)
        ckpt = self.prompts.pop("clip_ckpt", None)
        if clip is None and getattr(self, "_clip_ckpt", _UNSET) == ckpt:
            return self._clip_model
        if clip is None:
            clip = CLIPModel(device=self.device)
            if ckpt:
                clip.load_torch(ckpt)
            else:
                LOGGER.warning("FastSAM text prompt: no clip_model/clip_ckpt supplied — scoring with a "
                               "RANDOMLY-initialized CLIP; pass clip_ckpt=... for meaningful selection.")
            self._clip_model, self._clip_ckpt = clip, ckpt
        return clip

    def prompt(self, results, bboxes=None, points=None, labels=None, texts=None) -> list:
        """The everything-results filtered by prompts: per box the mask of the best IoU with it, per text the crop
        most like it (masks of 100 px or less skipped), the masks under the clicks (a background click takes a mask
        out; with only background clicks every mask starts in)."""
        if bboxes is None and points is None and texts is None:
            return results
        clip = self._clip() if texts is not None else None
        out = []
        for r in results if isinstance(results, list) else [results]:
            if r.masks is None or len(r.masks) == 0:
                out.append(r)
                continue
            masks = np.asarray(r.masks.data).astype(np.float32)  # (n, H, W) at the original size
            n = masks.shape[0]
            idx = np.zeros(n, bool)
            if bboxes is not None:
                bb = np.atleast_2d(np.asarray(bboxes, np.int32))
                bbox_areas = (bb[:, 3] - bb[:, 1]) * (bb[:, 2] - bb[:, 0])
                mask_areas = np.stack([masks[:, b[1] : b[3], b[0] : b[2]].sum((1, 2)) for b in bb])
                union = bbox_areas[:, None] + masks.sum((1, 2))[None] - mask_areas
                idx[np.argmax(mask_areas / np.maximum(union, 1e-7), axis=1)] = True
            if clip is not None:
                keep_i, crops = [], []
                for i, (x1, y1, x2, y2) in enumerate(np.asarray(r.boxes.xyxy, np.int32)):
                    if masks[i].sum() > 100 and x2 > x1 and y2 > y1:
                        keep_i.append(i)
                        crops.append(r.orig_img[y1:y2, x1:x2, ::-1])
                if crops:
                    im_e = clip.encode_image(crops).float().cpu().numpy()
                    tx_e = clip.encode_text([texts] if isinstance(texts, str) else list(texts)).float().cpu().numpy()
                    idx[[keep_i[j] for j in np.argmax(im_e @ tx_e.T, axis=0)]] = True
            if points is not None:
                pts = np.atleast_2d(np.asarray(points, np.int32))
                lbl = np.ones(len(pts), np.int32) if labels is None else np.asarray(labels, np.int32)
                if len(lbl) != len(pts):
                    raise ValueError(f"labels size {len(lbl)} != points size {len(pts)}")
                point_idx = np.ones(n, bool) if lbl.sum() == 0 else np.zeros(n, bool)
                for (px, py), lab in zip(pts, lbl):
                    point_idx[masks[:, py, px] > 0] = bool(lab)
                idx |= point_idx
            out.append(r[idx])
        return out


class FastSAM(YOLO):
    """FastSAM: `FastSAM-s.yaml` / `FastSAM-x.yaml` build yolov8s-seg / yolov8x-seg with nc 1 and names
    {0: "object"} (the released checkpoints' graph, JAX's init(0) weights); a `.pt` must exist (its file is
    loaded as a segment YOLO); another name is a segment YOLO source."""

    def __init__(self, model="FastSAM-s.yaml", device=None):
        name = str(model)
        if name.lower().endswith(".pt"):
            if not Path(name).exists():
                raise FileNotFoundError(f"checkpoint '{name}' not found — pass the downloaded released checkpoint's "
                                        "path, or 'FastSAM-s.yaml' for a randomly-initialized graph")
            super().__init__(name, task="segment", device=device)
            self.model.names = {0: "object"}
        elif name.lower().startswith("fastsam"):
            from yolo_tpu_torch.device import resolve_device
            from yolo_tpu_torch.nn.tasks import SegmentationModel

            scale = "s" if "-s" in name.lower() else "x"
            self.predictor, self.ckpt_path, self.remote, self.task = None, None, None, "segment"
            self.device = resolve_device(device)
            self.model = SegmentationModel(f"yolov8{scale}-seg.yaml", nc=1, device=self.device)
            self.model.names = {0: "object"}
            self.params = self.model.init(0)
            self.overrides = {"model": name, "task": "segment"}
        else:
            super().__init__(model, task="segment", device=device)

    def predict(self, source=None, stream: bool = False, bboxes=None, points=None, labels=None, texts=None,
                clip_model=None, clip_ckpt=None, **kwargs):
        """Segment everything (conf 0.4 unless set), then filter by the prompts. Text prompts need `clip_model` (a
        `CLIPModel`) or `clip_ckpt` (an OpenAI clip state dict) for real weights; without either a seeded CLIP
        scores, with a warning."""
        kwargs.setdefault("conf", 0.4)
        if not isinstance(self.predictor, FastSAMPredictor):
            args = {**self.overrides, "batch": 1, "save": False, "mode": "predict", **kwargs}
            self.predictor = FastSAMPredictor(
                self.model, self.params, overrides={"device": str(self.device), **{k: v for k, v in args.items()
                                                                                   if k in DEFAULT_CFG_DICT}},
                names=self.model.names)
        self.predictor.set_prompts(dict(bboxes=bboxes, points=points, labels=labels, texts=texts,
                                        clip_model=clip_model, clip_ckpt=clip_ckpt))
        return super().predict(source, stream, **kwargs)
