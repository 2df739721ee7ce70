"""Detection validator (counterpart of yolo_tpu/engine/validator.py DetectionValidator):
P, R, mAP50, mAP50-95 and fitness of a detect model on a dataset split.

Per batch: the loader's threads read, letterbox and collate the images (RGB
uint8); the device pass uploads the batch from pinned memory, scales it to
[0, 1] in the compute dtype (f32, bf16 with `half=True`), runs
`DetectionModel.predict` (the C2f and head kernels) and the fixed-shape NMS
(the NMS kernel) at `conf` (0.001 unless set), `iou` and `max_det`, and packs
the outputs into one tensor that is copied back once; the host then matches
each image's detections to its labels at ten IoU thresholds and updates the
metrics and the confusion matrix. With `save_json` the kept detections go to
<run>/predictions.json as COCO rows, and where the dataset has
annotations/instances_val2017.json the port's copy of the COCOeval protocol
(utils/coco_eval.py) scores them against it: `coco/<key>` entries join the
results. `SegmentationValidator` adds the mask metrics (`mask_`-prefixed keys; fitness
the sum of both): each kept detection's mask at prototype resolution against the
ground-truth masks of the collate, their IoUs computed on the device and copied back
with the detections. `PoseValidator` adds the keypoint metrics (`pose_`-prefixed keys; fitness
the sum of both): each kept detection's decoded keypoints ride back as extra columns of the
packed detections and are matched on the host by object keypoint similarity, each gt box's
area × 0.53 its scale. `OBBValidator` scores oriented boxes: the rotated NMS (probiou, plain
torch) on the model's xywhr predictions, then probiou matching against the labels' xywhr
scaled to the letterboxed image (no confusion matrix, no json rows, as in the JAX package).
The classify task's validator is engine/classify.py.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from yolo_tpu_torch.data.dataset import check_det_dataset
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn.tasks import install_params
from yolo_tpu_torch.ops.boxes import scale_boxes, xywhn2xyxy, xyxy2xywh
from yolo_tpu_torch.ops.masks import process_mask
from yolo_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_rotated
from yolo_tpu_torch.utils import LOGGER
from yolo_tpu_torch.utils.metrics import (
    OKS_SIGMA,
    ConfusionMatrix,
    DetMetrics,
    kpt_iou,
    match_predictions,
    match_predictions_iou,
)


def validator_for(model):
    """The validator class of a model's task: detect's, segment's, pose's, obb's or classify's; the other
    tasks raise NotImplementedError."""
    task = "rtdetr" if getattr(model, "is_rtdetr", False) else getattr(model, "task", "detect")
    if task == "classify":
        from yolo_tpu_torch.engine.classify import ClassificationValidator

        return ClassificationValidator
    if task == "segment":
        return SegmentationValidator
    if task == "pose":
        return PoseValidator
    if task == "obb":
        return OBBValidator
    if task != "detect":
        raise NotImplementedError(f"validation of the {task} task is not ported (only detect, segment, pose, obb and classify)")
    return DetectionValidator


class DetectionValidator:
    """Evaluate a detection model on a dataset split. `args` are cfg settings (other keys
    are ignored, as in the JAX package) and `plain`, which runs the kernels' plain twins."""

    def __init__(self, args: dict | None = None, data: dict | None = None):
        args = dict(args or {})
        self.plain = bool(args.pop("plain", False))
        self.args = get_cfg(overrides={k: v for k, v in args.items() if k in DEFAULT_CFG_DICT})
        if self.args.conf is None:
            self.args.conf = 0.001
        self.data = data
        self.iou_thresholds = np.linspace(0.5, 0.95, 10)
        # per batch, ms: the wait for the loader, the host's time to issue the device pass, the device
        # pass (CUDA events from the upload to the packed outputs; on the CPU the host's), the wait
        # for the copy back, the host matching
        self.timings: list[dict] = []

    @staticmethod
    def _images(imgs: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """A uint8 RGB batch on the device (uploaded from pinned memory to a card) in [0, 1] in `dtype`."""
        x = torch.from_numpy(imgs)
        if device.type == "cuda":
            x = x.pin_memory()
        return x.to(device, non_blocking=True).to(dtype) / 255.0

    @torch.no_grad()
    def _device_pass(self, model, imgs: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """One uint8 RGB batch → (B, max_det, 7) f32 on the device: xyxy box, score, class, valid."""
        a = self.args
        x = self._images(imgs, device, dtype)
        out = non_max_suppression(model.predict(x, plain=self.plain), conf_thres=float(a.conf), iou_thres=float(a.iou),
                                  max_det=int(a.max_det), plain=self.plain)
        cols = [out["boxes"], out["scores"][..., None], out["cls"][..., None], out["valid"][..., None]]
        return torch.cat([c.to(torch.float32) for c in cols], -1)

    def __call__(self, model, params) -> dict:
        a = self.args
        data = self.data or check_det_dataset(a.data)
        split = data.get(a.split) or data.get("val") or data.get("train")
        dataset = build_yolo_dataset(a, split, data, stride=int(max(model.stride)))
        batch_size = min(int(a.batch) if a.batch and a.batch > 0 else 16, len(dataset))
        loader = build_dataloader(dataset, batch_size, workers=a.workers, overlap_mask=bool(a.overlap_mask))
        device, dtype = resolve_device(a.device), torch.bfloat16 if a.half else torch.float32
        install_params(model, params, device, dtype)
        names = getattr(model, "names", {})
        # COCO-91 category ids in the json rows of a COCO dataset
        cat_map = None
        if data.get("nc", 0) == 80 and "coco" in str(data.get("path", "")).lower():
            from yolo_tpu_torch.utils.coco_eval import coco80_to_coco91_class

            cat_map = coco80_to_coco91_class()

        metrics, cm = DetMetrics(names=names), ConfusionMatrix(nc=model.nc)
        self._json_dets, self.timings = [], []
        n_img, t_start = 0, time.time()
        with contextlib.closing(iter(loader)) as batches:  # closing stops the loader's threads on any exit
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                t1 = time.perf_counter()
                if device.type == "cuda":
                    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    ev[0].record()
                out = self._batch_pass(model, batch, device, dtype)
                if device.type == "cuda":
                    ev[1].record()
                t2 = time.perf_counter()
                out = out.cpu().numpy()  # the batch's one wait for the device
                t3 = time.perf_counter()
                n_img += self._update(batch, out, metrics, cm, cat_map)
                t4 = time.perf_counter()
                self.timings.append({
                    "loader": (t1 - t0) * 1e3,
                    "enqueue": (t2 - t1) * 1e3,
                    "device": ev[0].elapsed_time(ev[1]) if device.type == "cuda" else (t2 - t1) * 1e3,
                    "copy": (t3 - t2) * 1e3,
                    "host": (t4 - t3) * 1e3,
                })
        results = self._results(metrics)
        LOGGER.info(f"val: {n_img} images in {time.time() - t_start:.1f}s — P {results['precision']:.4f} R {results['recall']:.4f} "
                    f"mAP50 {results['mAP50']:.4f} mAP50-95 {results['mAP50-95']:.4f}")
        self.confusion_matrix, self.metrics = cm, metrics
        save_dir = None  # resolved once: a second get_save_dir would number another directory
        if a.save_json and self._json_dets:
            save_dir = get_save_dir(a, name="val")
            save_dir.mkdir(parents=True, exist_ok=True)
            (save_dir / "predictions.json").write_text(json.dumps(self._json_dets))
            LOGGER.info(f"saved {save_dir / 'predictions.json'}")
            anno = Path(data.get("path", ".")) / "annotations" / "instances_val2017.json"
            if anno.exists():  # the COCOeval protocol's numbers beside the validator's
                from yolo_tpu_torch.utils.coco_eval import coco_evaluate

                stats = coco_evaluate(str(anno), self._json_dets)
                LOGGER.info("COCOeval cross-check: " + " ".join(f"{k} {v:.4f}" for k, v in stats.items()))
                results.update({f"coco/{k}": v for k, v in stats.items()})
        if a.plots:
            try:  # a failed PNG is a warning: the metrics stand
                from yolo_tpu_torch.utils.plotting import plot_confusion_matrix

                save_dir = save_dir or get_save_dir(a, name="val")
                save_dir.mkdir(parents=True, exist_ok=True)
                plot_confusion_matrix(cm.matrix, names=names, save_path=save_dir / "confusion_matrix.png")
            except Exception as e:
                LOGGER.warning(f"plotting failed: {e}")
        return results

    def _batch_pass(self, model, batch: dict, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        return self._device_pass(model, batch["img"], device, dtype)

    def _results(self, metrics: DetMetrics) -> dict:
        return metrics.process()

    def _update(self, batch: dict, out: np.ndarray, metrics: DetMetrics, cm: ConfusionMatrix, cat_map) -> int:
        """Match each image's detections to its labels; update the metrics, the matrix and
        the json rows → the number of images."""
        H, W = batch["img"].shape[1:3]
        for i, meta in enumerate(batch["meta"]):
            valid = out[i, :, 6] > 0
            pboxes, pconf, pcls = out[i, valid, :4], out[i, valid, 4], out[i, valid, 5]
            m = batch["mask_gt"][i] > 0
            gt_boxes = np.asarray(xywhn2xyxy(batch["bboxes"][i][m], w=W, h=H))  # normalized on the canvas → pixels
            gt_cls = batch["cls"][i][m]
            metrics.update(match_predictions(pboxes, pcls, gt_boxes, gt_cls, self.iou_thresholds), pconf, pcls, gt_cls)
            cm.process_batch(pboxes, pconf, pcls, gt_boxes, gt_cls)
            if self.args.save_json:
                self._json_rows(pboxes, pconf, pcls, meta, (H, W), cat_map)
        return len(batch["meta"])

    def _json_rows(self, pboxes, pconf, pcls, meta: dict, hw, cat_map) -> None:
        """COCO-style rows of one image: a numeric file stem as the image id, boxes in the
        original image's pixels as (x, y, w, h), COCO-91 ids for a COCO dataset."""
        stem = Path(meta["im_file"]).stem
        image_id = int(stem) if stem.isnumeric() else stem
        jb = np.asarray(scale_boxes(hw, np.array(pboxes, np.float64), meta["shape"], meta["ratio_pad"]))
        for b, s, c in zip(np.asarray(xyxy2xywh(jb)), pconf, pcls):
            self._json_dets.append({
                "image_id": image_id,
                "category_id": cat_map[int(c)] if cat_map else int(c),
                "bbox": [round(float(v), 3) for v in [b[0] - b[2] / 2, b[1] - b[3] / 2, b[2], b[3]]],
                "score": round(float(s), 5),
            })


class SegmentationValidator(DetectionValidator):
    """Box mAP and mask mAP of a segment model (JAX SegmentationValidator). Each kept detection's mask is
    its coefficients times the prototypes, sigmoid > 0.5, cropped to its box at prototype scale; each
    ground truth's is its instance in the collate's overlap-index map (or its per-instance mask with
    `overlap_mask=False`), nearest-downsampled by stride to prototype resolution. Their IoUs are
    computed on the device and ride back as extra columns of the packed detections."""

    def __call__(self, model, params) -> dict:
        self.mask_metrics = DetMetrics(names=getattr(model, "names", {}))
        return super().__call__(model, params)

    @torch.no_grad()
    def _batch_pass(self, model, batch: dict, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """→ (B, max_det, 7 + N): the detect columns, then the mask IoU of each slot with each of the
        batch's N ground-truth rows (zero without polygon labels)."""
        a = self.args
        x = self._images(batch["img"], device, dtype)
        preds, protos = model.predict(x, plain=self.plain)
        out = non_max_suppression(preds, conf_thres=float(a.conf), iou_thres=float(a.iou), max_det=int(a.max_det),
                                  nc=model.nc, plain=self.plain)
        B, N = batch["cls"].shape
        mh, mw = protos.shape[1:3]
        miou = torch.zeros((B, out["boxes"].shape[1], N), dtype=torch.float32, device=device)
        if "masks" in batch:
            pm = (process_mask(protos, out["extra"], out["boxes"], x.shape[1:3], upsample=False) > 0.5).float()
            gmap = torch.from_numpy(batch["masks"]).to(device)
            if gmap.ndim == 4:  # per-instance (B, N, h, w)
                sy, sx = max(gmap.shape[2] // mh, 1), max(gmap.shape[3] // mw, 1)
                gm = (gmap[:, :, ::sy, ::sx][:, :, :mh, :mw] > 0).float()
            else:  # overlap-index map (B, h, w): instance j drawn as j + 1
                sy, sx = max(gmap.shape[1] // mh, 1), max(gmap.shape[2] // mw, 1)
                g = gmap[:, ::sy, ::sx][:, :mh, :mw].float()
                gm = (g[:, None] == torch.arange(1, N + 1, dtype=torch.float32, device=device)[None, :, None, None]).float()
            pm, gm = pm.reshape(B, pm.shape[1], -1), gm.reshape(B, N, -1)
            inter = (pm @ gm.transpose(1, 2)).clamp(min=0)  # (B, max_det, N)
            miou = inter / (pm.sum(-1)[..., None] + gm.sum(-1)[:, None] - inter + 1e-7)
        cols = [out["boxes"], out["scores"][..., None], out["cls"][..., None], out["valid"][..., None], miou]
        return torch.cat([c.to(torch.float32) for c in cols], -1)

    def _update(self, batch: dict, out: np.ndarray, metrics: DetMetrics, cm: ConfusionMatrix, cat_map) -> int:
        n = super()._update(batch, out[..., :7], metrics, cm, cat_map)
        for i in range(n):
            valid = out[i, :, 6] > 0
            m = batch["mask_gt"][i] > 0
            pcls, gt_cls = out[i, valid, 5], batch["cls"][i][m]
            iou = out[i][valid][:, 7:][:, m].T  # (n_gt, n_pred)
            tp = match_predictions_iou(pcls, gt_cls, iou, self.iou_thresholds) if "masks" in batch else \
                np.zeros((len(pcls), len(self.iou_thresholds)), bool)
            self.mask_metrics.update(tp, out[i, valid, 4], pcls, gt_cls)
        return n

    def _results(self, metrics: DetMetrics) -> dict:
        rb, rm = metrics.process(), self.mask_metrics.process()
        LOGGER.info(f"val(seg): mask mAP50 {rm['mAP50']:.4f} mAP50-95 {rm['mAP50-95']:.4f}")
        results = dict(rb)
        results.update({f"mask_{k}": v for k, v in rm.items()})
        results["fitness"] = rb.get("fitness", 0.0) + rm.get("fitness", 0.0)
        return results


class PoseValidator(DetectionValidator):
    """Box mAP and keypoint (OKS) mAP of a pose model (JAX PoseValidator). NMS gets the model's nc, so each kept
    detection's decoded keypoints (x, y in the letterboxed image's pixels, the visibility) ride back as extra
    columns; on the host each image's OKS against its gt keypoints (x and y in pixels), with each gt box's area
    × 0.53 and COCO's sigmas for (17, 3) keypoints (else 1 / K), is matched at the ten thresholds."""

    def __call__(self, model, params) -> dict:
        self.kpt_shape = tuple(model.head.kpt_shape)
        K = self.kpt_shape[0]
        self.sigma = OKS_SIGMA if self.kpt_shape == (17, 3) else np.ones(K) / K
        self.pose_metrics = DetMetrics(names=getattr(model, "names", {}))
        return super().__call__(model, params)

    @torch.no_grad()
    def _device_pass(self, model, imgs: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """→ (B, max_det, 7 + K · ndim): the detect columns, then each slot's keypoints."""
        a = self.args
        x = self._images(imgs, device, dtype)
        out = non_max_suppression(model.predict(x, plain=self.plain), conf_thres=float(a.conf), iou_thres=float(a.iou),
                                  max_det=int(a.max_det), nc=model.nc, plain=self.plain)
        cols = [out["boxes"], out["scores"][..., None], out["cls"][..., None], out["valid"][..., None], out["extra"]]
        return torch.cat([c.to(torch.float32) for c in cols], -1)

    def _update(self, batch: dict, out: np.ndarray, metrics: DetMetrics, cm: ConfusionMatrix, cat_map) -> int:
        n = super()._update(batch, out[..., :7], metrics, cm, cat_map)
        K, ndim = self.kpt_shape
        H, W = batch["img"].shape[1:3]
        gk = batch.get("keypoints")  # a batch of background images collates without keypoints
        if gk is None:
            gk = np.zeros((*batch["cls"].shape, K, ndim), np.float32)
        for i in range(n):
            valid = out[i, :, 6] > 0
            m = batch["mask_gt"][i] > 0
            pcls, gt_cls = out[i, valid, 5], batch["cls"][i][m]
            gt_boxes = np.asarray(xywhn2xyxy(batch["bboxes"][i][m], w=W, h=H))
            gt_kpts = gk[i][m] * np.array([W, H] + [1.0] * (ndim - 2), np.float32)
            area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]) * 0.53
            oks = kpt_iou(gt_kpts, out[i, valid, 7:].reshape(-1, K, ndim), area, self.sigma)
            self.pose_metrics.update(match_predictions_iou(pcls, gt_cls, oks, self.iou_thresholds), out[i, valid, 4], pcls, gt_cls)
        return n

    def _results(self, metrics: DetMetrics) -> dict:
        rb, rp = metrics.process(), self.pose_metrics.process()
        LOGGER.info(f"val(pose): pose mAP50 {rp['mAP50']:.4f} mAP50-95 {rp['mAP50-95']:.4f}")
        results = dict(rb)
        results.update({f"pose_{k}": v for k, v in rp.items()})
        results["fitness"] = rb.get("fitness", 0.0) + rp.get("fitness", 0.0)
        return results


class OBBValidator(DetectionValidator):
    """Box mAP of an obb model on probiou (JAX OBBValidator): the dataset reads DOTA rows, the device pass runs the
    rotated NMS at `conf`, `iou` and `max_det` (no `classes`, not agnostic), and on the host each image's kept xywhr
    boxes are matched by probiou to its labels' xywhr, scaled by (W, H, W, H, 1) to the letterboxed image (a batch of
    background images collates as (N, 4), padded with a zero angle)."""

    def __init__(self, args: dict | None = None, data: dict | None = None):
        super().__init__(args, data)
        self.args.task = "obb"

    @torch.no_grad()
    def _device_pass(self, model, imgs: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """→ (B, max_det, 8): xywhr box, score, class, valid."""
        a = self.args
        x = self._images(imgs, device, dtype)
        out = non_max_suppression_rotated(model.predict(x, plain=self.plain), conf_thres=float(a.conf), iou_thres=float(a.iou),
                                          max_det=int(a.max_det))
        cols = [out["boxes"], out["scores"][..., None], out["cls"][..., None], out["valid"][..., None]]
        return torch.cat([c.to(torch.float32) for c in cols], -1)

    def _update(self, batch: dict, out: np.ndarray, metrics: DetMetrics, cm: ConfusionMatrix, cat_map) -> int:
        H, W = batch["img"].shape[1:3]
        for i in range(len(batch["meta"])):
            valid = out[i, :, 7] > 0
            m = batch["mask_gt"][i] > 0
            gt = batch["bboxes"][i][m]
            if gt.shape[-1] == 4:
                gt = np.concatenate([gt, np.zeros((len(gt), 1), np.float32)], -1)
            gt_cls = batch["cls"][i][m]
            pcls = out[i, valid, 6]
            tp = match_predictions(out[i, valid, :5], pcls, gt * np.array([W, H, W, H, 1.0], np.float32), gt_cls, self.iou_thresholds)
            metrics.update(tp, out[i, valid, 5], pcls, gt_cls)
        return len(batch["meta"])
