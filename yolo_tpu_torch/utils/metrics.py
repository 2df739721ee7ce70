"""Detection metrics on the host: AP, mAP50 / mAP50-95, precision and recall, the
confusion matrix (counterpart of yolo_tpu/utils/metrics.py; numpy, once per batch
and once per run). 101-point interpolated AP, the F1-max operating point of the
smoothed mean F1 curve, fitness = 0.1 * mAP50 + 0.9 * mAP50-95.

Box, mask and keypoint matching (`mask_iou`, the segment task; `kpt_iou`, the object keypoint
similarity of the pose task, with COCO's `OKS_SIGMA`) and the obb task's rotated boxes, matched by
probiou.
"""

from __future__ import annotations

import numpy as np

from yolo_tpu_torch.ops.boxes import box_iou, probiou

# COCO's 17 keypoints' OKS sigmas
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing of a curve (the F1 curve whose argmax picks the operating point)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP of one class at one IoU threshold → (ap, envelope precision, recall)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)  # numpy >= 2.0
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray, eps: float = 1e-16):
    """Per-class AP over T IoU thresholds: tp (N, T) bool, conf (N,), pred_cls (N,), target_cls (M,)
    → dict of p, r, f1 at the operating point, ap (nc, T), unique_classes and the curves."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l, n_p = nt[ci], i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[i], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax() if nc else 0
    return {
        "p": p_curve[:, i],
        "r": r_curve[:, i],
        "f1": f1_curve[:, i],
        "ap": ap,
        "unique_classes": unique_classes.astype(int),
        "p_curve": p_curve,
        "r_curve": r_curve,
        "f1_curve": f1_curve,
        "x": x,
    }


def match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls, iou_thresholds=None):
    """TP matrix (n_pred, T) of one image: greedy matching of the highest-IoU same-class pairs per threshold; 5-column
    (xywhr) boxes are matched by probiou."""
    if iou_thresholds is None:
        iou_thresholds = np.linspace(0.5, 0.95, 10)
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(pred_boxes), len(iou_thresholds)), dtype=bool)
    if pred_boxes.shape[-1] == 5:  # rotated xywhr boxes (the obb task): probiou
        iou = np.asarray(probiou(gt_boxes[:, None, :], pred_boxes[None, :, :]))[..., 0]
    else:
        iou = np.asarray(box_iou(gt_boxes, pred_boxes))
    return match_predictions_iou(pred_cls, gt_cls, iou, iou_thresholds)


def match_predictions_iou(pred_cls, gt_cls, iou, iou_thresholds=None):
    """TP matrix (n_pred, T) from a precomputed (n_gt, n_pred) similarity matrix."""
    if iou_thresholds is None:
        iou_thresholds = np.linspace(0.5, 0.95, 10)
    tp = np.zeros((len(pred_cls), len(iou_thresholds)), dtype=bool)
    if len(pred_cls) == 0 or len(gt_cls) == 0:
        return tp
    iou = np.asarray(iou) * (gt_cls[:, None] == pred_cls[None, :])
    for t, thr in enumerate(iou_thresholds):
        matches = np.argwhere(iou >= thr)
        if matches.size:
            matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
            # one match per prediction, then per ground truth (highest IoU first)
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            tp[matches[:, 1], t] = True
    return tp


def mask_iou(mask1, mask2, eps: float = 1e-7) -> np.ndarray:
    """IoU of flattened binary masks (JAX `mask_iou`): mask1 (N, n) ground truths, mask2 (M, n)
    predictions → (N, M), in f32."""
    mask1 = np.asarray(mask1, np.float32)
    mask2 = np.asarray(mask2, np.float32)
    intersection = np.clip(mask1 @ mask2.T, 0, None)
    union = mask1.sum(1)[:, None] + mask2.sum(1)[None] - intersection
    return intersection / (union + eps)


def kpt_iou(gt_kpts, pred_kpts, area, sigma, eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity (N, M) of gt keypoints (N, K, 3) in pixels against predicted ones (M, K, >= 2),
    with the gt areas (N,) and per-keypoint sigmas (K,): exp(-d² / ((2σ)² · 2 · area)) averaged over each gt's
    labelled keypoints (visibility ≠ 0), the cocoeval form."""
    gt_kpts = np.asarray(gt_kpts, np.float32)
    pred_kpts = np.asarray(pred_kpts, np.float32)
    sigma = np.asarray(sigma, np.float32)
    d = (gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 + (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2
    kpt_mask = gt_kpts[..., 2] != 0
    e = d / ((2 * sigma) ** 2 * (area[:, None, None] + eps) * 2)
    return (np.exp(-e) * kpt_mask[:, None]).sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


class ConfusionMatrix:
    """Detection confusion matrix (nc + 1 square, the last row and column background) at fixed conf and IoU."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls):
        """Count one image: rows are predicted classes, columns true classes."""
        keep = pred_conf > self.conf
        pred_boxes, pred_cls = pred_boxes[keep], pred_cls[keep].astype(int)
        gt_cls = gt_cls.astype(int)
        if len(gt_boxes) == 0:
            for c in pred_cls:
                self.matrix[c, self.nc] += 1  # false positive
            return
        if len(pred_boxes) == 0:
            for c in gt_cls:
                self.matrix[self.nc, c] += 1  # false negative
            return
        iou = np.asarray(box_iou(gt_boxes, pred_boxes))
        matches = np.argwhere(iou > self.iou_thres)
        if matches.size:
            # by IoU, one per prediction, sorted again, one per ground truth: without
            # the second sort a ground truth under several predictions keeps the first
            matches = np.concatenate([matches, iou[matches[:, 0], matches[:, 1]][:, None]], axis=1)
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            matches = matches[:, :2].astype(int)
        pairs = matches.tolist() if matches.size else []
        matched_gt = {g for g, _ in pairs}
        matched_pred = {p for _, p in pairs}
        for g, p in pairs:
            self.matrix[pred_cls[p], gt_cls[g]] += 1
        for g in range(len(gt_boxes)):
            if g not in matched_gt:
                self.matrix[self.nc, gt_cls[g]] += 1
        for p in range(len(pred_boxes)):
            if p not in matched_pred:
                self.matrix[pred_cls[p], self.nc] += 1


class DetMetrics:
    """Detection metrics over a run: `update` per image, `process` once → precision, recall, mAP50, mAP50-95, fitness."""

    def __init__(self, names: dict | None = None):
        self.names = names or {}
        self.stats: dict = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        self.results = {}

    def update(self, tp, conf, pred_cls, target_cls):
        self.stats["tp"].append(tp)
        self.stats["conf"].append(conf)
        self.stats["pred_cls"].append(pred_cls)
        self.stats["target_cls"].append(target_cls)

    def process(self) -> dict:
        s = self.stats
        tp = np.concatenate(s["tp"]) if s["tp"] else np.zeros((0, 10), bool)
        conf = np.concatenate(s["conf"]) if s["conf"] else np.zeros(0)
        pred_cls = np.concatenate(s["pred_cls"]) if s["pred_cls"] else np.zeros(0)
        target_cls = np.concatenate(s["target_cls"]) if s["target_cls"] else np.zeros(0)
        if len(target_cls) == 0:
            self.results = {k: 0.0 for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness")}
            return self.results
        r = ap_per_class(tp, conf, pred_cls, target_cls)
        ap50 = r["ap"][:, 0]
        ap = r["ap"].mean(1)
        self.results = {
            "precision": float(r["p"].mean()) if len(r["p"]) else 0.0,
            "recall": float(r["r"].mean()) if len(r["r"]) else 0.0,
            "mAP50": float(ap50.mean()) if len(ap50) else 0.0,
            "mAP50-95": float(ap.mean()) if len(ap) else 0.0,
        }
        self.results["fitness"] = 0.1 * self.results["mAP50"] + 0.9 * self.results["mAP50-95"]
        self.per_class = {int(c): {"ap50": float(ap50[i]), "ap": float(ap[i])} for i, c in enumerate(r["unique_classes"])}
        return self.results

    @property
    def fitness(self):
        return self.results.get("fitness", 0.0)

    def keys(self):
        return ["precision", "recall", "mAP50", "mAP50-95"]
