"""COCO detection evaluation and category ids (counterpart of yolo_tpu/utils/coco_eval.py),
pure numpy: the validator's `save_json` cross-check, since pycocotools is not a dependency.

It reimplements the COCOeval bbox protocol as the JAX package's copy does:

  - greedy per-(image, category) matching by descending score,
    IoU thresholds 0.50:0.95:0.05;
  - crowd GTs are legal optional matches and never count as FPs/FNs;
  - already-matched GTs are skipped unless the candidate is a crowd;
  - area ranges all/small/medium/large, maxDets=100;
  - 101-point interpolated precision envelope, averaged over recall grid.

Inputs are plain COCO dicts/files: GT {"images", "annotations", "categories"},
DT [{"image_id", "category_id", "bbox" ltwh, "score"}].
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_ltwh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU for ltwh boxes; crowd GTs use IoF (pycocotools maskUtils.iou)."""
    d = dt[:, None]
    g = gt[None, :]
    ix = np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2]) - np.maximum(d[..., 0], g[..., 0])
    iy = np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3]) - np.maximum(d[..., 1], g[..., 1])
    inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
    area_d = d[..., 2] * d[..., 3]
    area_g = g[..., 2] * g[..., 3]
    union = np.where(iscrowd[None, :], area_d, area_d + area_g - inter)
    return np.where(union > 0, inter / union, 0.0)


def coco80_to_coco91_class() -> list[int]:
    """Contiguous 80-class index → the original COCO-91 category id (the 91-id space skips 11 ids)."""
    unused = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    return [i for i in range(1, 92) if i not in unused]


def _prep_img(dts, gts, max_det):
    """Area-independent per-(image, category) work, done ONCE: score-sort +
    truncate dts, and the (D, G) IoU matrix in ORIGINAL gt order (pycocotools
    computes self.ious once and reuses them across area ranges)."""
    if not dts and not gts:
        return None
    dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
    iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], bool)
    D, G = len(dts), len(gts)
    ious = (
        _iou_ltwh(np.array([d["bbox"] for d in dts], np.float64).reshape(D, 4),
                  np.array([g["bbox"] for g in gts], np.float64).reshape(G, 4), iscrowd)
        if D and G
        else np.zeros((D, G))
    )
    return dts, gts, iscrowd, ious


def _evaluate_img(prep, area_rng):
    """pycocotools COCOeval.evaluateImg for one (image, category, area range)."""
    if prep is None:
        return None
    dts, gts, iscrowd0, ious0 = prep
    g_ignore = np.array(
        [g["_ignore"] or not (area_rng[0] <= g["area"] <= area_rng[1]) for g in gts], bool
    )
    # sort gts: non-ignored first (pycocotools gtind ordering)
    g_order = np.argsort(g_ignore, kind="stable")
    g_ignore = g_ignore[g_order]
    iscrowd = iscrowd0[g_order]
    ious = ious0[:, g_order]

    D, G = len(dts), len(gts)
    T = len(IOU_THRS)
    dt_m = np.zeros((T, D), np.int64) - 1  # matched gt index (local), -1 = none
    gt_m = np.zeros((T, G), np.int64) - 1
    dt_ig = np.zeros((T, D), bool)
    for t, thr in enumerate(IOU_THRS):
        for di in range(D):
            best, bi = min(thr, 1 - 1e-10), -1
            for gi in range(G):
                if gt_m[t, gi] >= 0 and not iscrowd[gi]:
                    continue  # gt already claimed (crowds stay available)
                if bi >= 0 and not g_ignore[bi] and g_ignore[gi]:
                    break  # past all non-ignored gts; current best is real — stop
                if ious[di, gi] < best:
                    continue
                best, bi = ious[di, gi], gi
            if bi == -1:
                continue
            dt_ig[t, di] = g_ignore[bi]
            dt_m[t, di] = bi
            gt_m[t, bi] = di
    # detections outside the area range that matched nothing are ignored
    a = np.array([not (area_rng[0] <= d["bbox"][2] * d["bbox"][3] <= area_rng[1]) for d in dts])
    dt_ig = dt_ig | ((dt_m == -1) & a[None, :])
    return {
        "scores": np.array([d["score"] for d in dts]),
        "dt_matches": dt_m,
        "dt_ignore": dt_ig,
        "num_gt": int((~g_ignore).sum()),
    }


def coco_evaluate(gt, dt, max_det: int = 100):
    """COCO bbox metrics → dict with mAP50-95/mAP50/mAP75 + per-area APs.

    gt: COCO annotations dict or json path; dt: detections list or json path.
    """
    if isinstance(gt, (str, Path)):
        gt = json.loads(Path(gt).read_text())
    if isinstance(dt, (str, Path)):
        dt = json.loads(Path(dt).read_text())
    cat_ids = sorted({c["id"] for c in gt.get("categories", [])} or {a["category_id"] for a in gt["annotations"]})
    img_ids = sorted({im["id"] for im in gt["images"]}) if gt.get("images") else sorted({a["image_id"] for a in gt["annotations"]})

    gts_by = {}
    for a in gt["annotations"]:
        a = dict(a)
        a.setdefault("area", a["bbox"][2] * a["bbox"][3])
        a["_ignore"] = bool(a.get("ignore", 0)) or bool(a.get("iscrowd", 0))
        gts_by.setdefault((a["image_id"], a["category_id"]), []).append(a)
    dts_by = {}
    for d in dt:
        dts_by.setdefault((d["image_id"], d["category_id"]), []).append(d)

    # IoUs + score-sorted dts once per (image, category); area ranges reuse them
    preps = {
        (i, cid): _prep_img(dts_by.get((i, cid), []), gts_by.get((i, cid), []), max_det)
        for cid in cat_ids
        for i in img_ids
    }

    results = {}
    T, R = len(IOU_THRS), len(REC_THRS)
    for area_name, rng in AREA_RNG.items():
        ap = np.full((T, R, len(cat_ids)), -1.0)
        for k, cid in enumerate(cat_ids):
            evals = [_evaluate_img(preps[(i, cid)], rng) for i in img_ids]
            evals = [e for e in evals if e is not None]
            if not evals:
                continue
            scores = np.concatenate([e["scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            matches = np.concatenate([e["dt_matches"] for e in evals], axis=1)[:, order]
            ignore = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
            n_gt = sum(e["num_gt"] for e in evals)
            if n_gt == 0:
                continue
            tps = (matches >= 0) & ~ignore
            fps = (matches == -1) & ~ignore
            tp_c = np.cumsum(tps, axis=1).astype(np.float64)
            fp_c = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(T):
                tp, fp = tp_c[t], fp_c[t]
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                # precision envelope (monotone from the right), then sample at
                # the 101 recall points via searchsorted (pycocotools accumulate)
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(R)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                ap[t, :, k] = q
        valid = ap > -1
        mean = lambda x: float(np.mean(x)) if x.size else 0.0  # noqa: E731
        results[area_name] = {
            "mAP50-95": mean(ap[valid]),
            "mAP50": mean(ap[0][valid[0]]),
            "mAP75": mean(ap[5][valid[5]]),
        }
    out = dict(results["all"])
    out.update({f"mAP50-95_{k}": v["mAP50-95"] for k, v in results.items() if k != "all"})
    return out
