"""Host-side (numpy, cv2) transforms of the detect dataset (counterpart of
yolo_tpu/data/augment.py): the validation letterbox and the training
augmentations, in the JAX package's order: mosaic → copy-paste → random
perspective → mixup → photometric → HSV → flips → the channel swap.

The code is the JAX package's, kept call for call, so the same
`random.Random` gives the same pixels and labels. Labels travel as dicts:
{'img': HWC uint8 BGR, 'cls': (n,), 'bboxes': (n, 4) pixel xyxy, 'shape':
the original (h, w)}, and 'segments' (a pixel polygon per box, None for a box
row) where the label files hold polygons: the geometric transforms move them
along, and the random perspective takes a polygon's box from its warped points;
'keypoints' (n, K, ndim) in pixels where they hold keypoints: every transform moves
them with their boxes, a keypoint the perspective throws off the canvas loses its
visibility, a horizontal flip swaps left and right by the dataset's `flip_idx`, and
rows that a paste or cutmix adds get invisible keypoints.
`TrainTransforms.mosaic_n = 9` takes the 3x3 mosaic (`mosaic9`) instead of mosaic4, and
the cfg's `cutmix` probability pastes a region of another augmented sample (`cutmix`),
each drawing from the same `random` instance in the JAX package's order. mosaic9 carries
the keypoints too, which the JAX package's mosaic9 drops (its output has no keypoints, so a
pose batch loses them); the draws and every other label are the same. `rand_augment` is the
classify task's RandAugment (engine/classify.py), on the RNG it is given. The rotated boxes
of the obb task are not ported.
"""

from __future__ import annotations

import math
import random

import numpy as np

from yolo_tpu_torch.ops.letterbox import LetterBox


def _clip_bboxes(bboxes, w, h):
    bboxes[:, [0, 2]] = bboxes[:, [0, 2]].clip(0, w)
    bboxes[:, [1, 3]] = bboxes[:, [1, 3]].clip(0, h)
    return bboxes


def _filter_boxes(bboxes, cls, wh_thr=2, ar_thr=100, area_thr=0.0, orig_boxes=None, eps=1e-16):
    """Drop boxes a geometric transform left degenerate: width or height ≤ wh_thr, aspect ≥ ar_thr,
    or (with orig_boxes) an area ratio ≤ area_thr."""
    w = bboxes[:, 2] - bboxes[:, 0]
    h = bboxes[:, 3] - bboxes[:, 1]
    ar = np.maximum(w / (h + eps), h / (w + eps))
    keep = (w > wh_thr) & (h > wh_thr) & (ar < ar_thr)
    if orig_boxes is not None and area_thr > 0:
        ow = orig_boxes[:, 2] - orig_boxes[:, 0]
        oh = orig_boxes[:, 3] - orig_boxes[:, 1]
        keep &= (w * h) / (ow * oh + eps) > area_thr
    return bboxes[keep], cls[keep]


def random_hsv(img, hgain=0.5, sgain=0.5, vgain=0.5, rng=None):
    """HSV jitter through lookup tables (the IR recipe: hgain = sgain = 0, vgain 0.3)."""
    import cv2

    rng = rng or random
    if hgain or sgain or vgain:
        r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
        hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        dtype = img.dtype
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(dtype)
        img_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
        img = cv2.cvtColor(img_hsv, cv2.COLOR_HSV2BGR)
    return img


def _flip_kpts(kp, axis: int, size: int):
    """Keypoints mirrored along x (axis 0) or y (axis 1) in an image `size` wide or tall; the labelled
    ones only (visibility ≠ 0, or all without a visibility column)."""
    kp = kp.copy()
    vis = kp[..., 2] != 0 if kp.shape[-1] == 3 else np.ones(kp.shape[:-1], bool)
    kp[..., axis] = np.where(vis, size - kp[..., axis], kp[..., axis])
    return kp


def random_flip(labels, lr_p=0.5, ud_p=0.0, rng=None, flip_idx=None):
    """Vertical (with probability ud_p, drawn first) and horizontal (lr_p) flips, boxes, polygons and
    keypoints moved along; a horizontal flip reorders the keypoints by `flip_idx` (left and right swap).
    Keypoints without `flip_idx` are never flipped horizontally: lr_p turns to 0 (no draw) with a
    warning, once, as in the JAX package, since mirrored unswapped keypoints train the wrong side."""
    rng = rng or random
    img = labels["img"]
    h, w = img.shape[:2]
    b = labels["bboxes"]
    kp = labels.get("keypoints")
    segs = labels.get("segments")
    if lr_p and kp is not None and flip_idx is None:
        if not getattr(random_flip, "_warned_flip_idx", False):
            random_flip._warned_flip_idx = True
            from yolo_tpu_torch.utils import LOGGER

            LOGGER.warning("no 'flip_idx' in the dataset yaml: disabling fliplr for keypoints")
        lr_p = 0.0
    if ud_p and rng.random() < ud_p:
        img = np.flipud(img)
        b = b.copy()
        b[:, [1, 3]] = h - b[:, [3, 1]]
        if kp is not None and len(kp):
            kp = _flip_kpts(kp, 1, h)
        if segs:
            segs = [np.stack([sg[:, 0], h - sg[:, 1]], 1) if sg is not None else None for sg in segs]
    if lr_p and rng.random() < lr_p:
        img = np.fliplr(img)
        b = b.copy()
        b[:, [0, 2]] = w - b[:, [2, 0]]
        if kp is not None and len(kp):
            kp = _flip_kpts(kp, 0, w)[:, list(flip_idx)]
        if segs:
            segs = [np.stack([w - sg[:, 0], sg[:, 1]], 1) if sg is not None else None for sg in segs]
    labels["img"] = np.ascontiguousarray(img)
    labels["bboxes"] = b
    if kp is not None:
        labels["keypoints"] = kp
    if segs is not None:
        labels["segments"] = segs
    return labels


def random_perspective(labels, degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0, border=(0, 0), rng=None):
    """Affine (or perspective) warp onto a canvas grown by `border`, 114 outside; boxes
    warped by their corners, clipped, and kept when wider and taller than 2 px with more
    than a tenth of their scaled area left; keypoints warped with their boxes, those that
    land outside the canvas made invisible (unclipped)."""
    import cv2

    rng = rng or random
    img = labels["img"]
    h, w = img.shape[:2]
    height = h + border[0] * 2
    width = w + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -w / 2
    C[1, 2] = -h / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height), borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height), borderValue=(114, 114, 114))

    bboxes, cls = labels["bboxes"], labels["cls"]
    kpts = labels.get("keypoints")
    segments = labels.get("segments")
    n = len(bboxes)
    if n and segments:  # each polygon warped; its box is that of its warped points
        warped = []
        for sg in segments:
            if sg is None or len(sg) == 0:
                warped.append(None)
                continue
            pts = np.ones((len(sg), 3))
            pts[:, :2] = sg
            pts = pts @ M.T
            pts = pts[:, :2] / pts[:, 2:3] if perspective else pts[:, :2]
            pts[:, 0] = pts[:, 0].clip(0, width)
            pts[:, 1] = pts[:, 1].clip(0, height)
            warped.append(pts.astype(np.float32))
        new_boxes = np.array(
            [[w_.min(0)[0], w_.min(0)[1], w_.max(0)[0], w_.max(0)[1]] if w_ is not None and len(w_) else [0, 0, 0, 0]
             for w_ in warped],
            np.float32,
        )
        keep = ((new_boxes[:, 2] - new_boxes[:, 0]) > 2) & ((new_boxes[:, 3] - new_boxes[:, 1]) > 2)
        labels["img"] = img
        labels["bboxes"] = new_boxes[keep]
        labels["cls"] = cls[keep]
        labels["segments"] = [w_ for w_, k in zip(warped, keep) if k]
        return labels
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
        new = _clip_bboxes(new, width, height)
        orig_scaled = bboxes * s
        keep = ((new[:, 2] - new[:, 0]) > 2) & ((new[:, 3] - new[:, 1]) > 2)
        ow = (orig_scaled[:, 2] - orig_scaled[:, 0]) + 1e-16
        oh = (orig_scaled[:, 3] - orig_scaled[:, 1]) + 1e-16
        keep &= ((new[:, 2] - new[:, 0]) * (new[:, 3] - new[:, 1]) / (ow * oh)) > 0.1
        bboxes, cls = new[keep], cls[keep]
        if kpts is not None and len(kpts):
            nk = kpts.shape[1]
            kxy = np.ones((n * nk, 3))
            kxy[:, :2] = kpts[..., :2].reshape(n * nk, 2)
            kxy = kxy @ M.T
            kxy = (kxy[:, :2] / kxy[:, 2:3] if perspective else kxy[:, :2]).reshape(n, nk, 2)
            out_of = (kxy[..., 0] < 0) | (kxy[..., 0] > width) | (kxy[..., 1] < 0) | (kxy[..., 1] > height)
            kpts = kpts.copy()
            kpts[..., :2] = kxy
            if kpts.shape[-1] == 3:
                kpts[..., 2] = np.where(out_of, 0.0, kpts[..., 2])
            kpts = kpts[keep]
    labels["img"] = img
    labels["bboxes"] = bboxes
    labels["cls"] = cls
    if kpts is not None:
        labels["keypoints"] = kpts
    return labels


def mosaic4(items, imgsz: int, rng=None):
    """Four images around a random centre of a 2·imgsz canvas (114 elsewhere), each first
    resized so its long side is imgsz; boxes (polygons, keypoints) shifted along, boxes clipped
    to the canvas; a tile without keypoints gets invisible ones where another tile has them."""
    rng = rng or random
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, items[0]["img"].shape[-1]), 114, dtype=np.uint8)
    has_segs = any(it.get("segments") for it in items)
    kpt_dims = next((it["keypoints"].shape[1:] for it in items if it.get("keypoints") is not None), None)
    all_boxes, all_cls, all_segs, all_kpts = [], [], [], []
    for i, it in enumerate(items):
        img = it["img"]
        r = s / max(img.shape[:2])
        if r != 1:
            import cv2

            img = cv2.resize(img, (int(img.shape[1] * r), int(img.shape[0] * r)))
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(it["bboxes"]):
            b = it["bboxes"] * r
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_cls.append(it["cls"])
            if kpt_dims is not None:
                all_kpts.append(_shift_kpts(it.get("keypoints"), len(b), kpt_dims, r, padw, padh))
            if has_segs:
                segs = it.get("segments") or [None] * len(b)
                all_segs.extend(sg * r + np.array([padw, padh], np.float32) if sg is not None else None for sg in segs)
    bboxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls) if all_cls else np.zeros((0,), np.float32)
    bboxes = _clip_bboxes(bboxes, 2 * s, 2 * s)
    out = {"img": canvas, "bboxes": bboxes, "cls": cls, "shape": (2 * s, 2 * s)}
    if all_kpts:
        out["keypoints"] = np.concatenate(all_kpts)
    if has_segs:
        out["segments"] = all_segs
    return out


def _shift_kpts(kp, n: int, kpt_dims, r: float, padw: float, padh: float):
    """A mosaic tile's keypoints scaled by r and shifted by the pads (invisible zeros for a tile without any)."""
    kp = np.zeros((n, *kpt_dims), np.float32) if kp is None else kp.copy()
    kp[..., :2] *= r
    kp[..., 0] += padw
    kp[..., 1] += padh
    return kp


def copy_paste(labels, donor, p=0.5, rng=None):
    """Box-level copy-paste: each donor box, with probability p, is blitted at a random
    place of this image unless it covers more than 30% of an existing box there; a pasted
    box gets invisible keypoints where the image has keypoints."""
    rng = rng or random
    if p <= 0 or len(donor["bboxes"]) == 0:
        return labels
    img = labels["img"]
    h, w = img.shape[:2]
    new_boxes, new_cls = [labels["bboxes"]], [labels["cls"]]
    for box, c in zip(donor["bboxes"], donor["cls"]):
        if rng.random() > p:
            continue
        x1, y1, x2, y2 = map(int, box)
        dh, dw = donor["img"].shape[:2]
        x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, dw), min(y2, dh)
        bw, bh = x2 - x1, y2 - y1
        if bw < 2 or bh < 2 or bw >= w or bh >= h:
            continue
        patch = donor["img"][y1:y2, x1:x2]
        nx = int(rng.uniform(0, w - bw))
        ny = int(rng.uniform(0, h - bh))
        cand = np.array([nx, ny, nx + bw, ny + bh], np.float32)
        ex = np.concatenate(new_boxes) if new_boxes else np.zeros((0, 4))
        if len(ex):
            ix1 = np.maximum(cand[0], ex[:, 0])
            iy1 = np.maximum(cand[1], ex[:, 1])
            ix2 = np.minimum(cand[2], ex[:, 2])
            iy2 = np.minimum(cand[3], ex[:, 3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            if (inter / (bw * bh + 1e-9) > 0.30).any():
                continue
        img[ny : ny + bh, nx : nx + bw] = patch
        new_boxes.append(cand[None])
        new_cls.append(np.array([c], np.float32))
    labels["img"] = img
    n_new = sum(len(b) for b in new_boxes) - len(labels["bboxes"])
    labels["bboxes"] = np.concatenate(new_boxes).astype(np.float32)
    labels["cls"] = np.concatenate(new_cls).astype(np.float32)
    if labels.get("keypoints") is not None and n_new:
        labels["keypoints"] = np.concatenate([labels["keypoints"], np.zeros((n_new, *labels["keypoints"].shape[1:]), np.float32)])
    if labels.get("segments") is not None and n_new:  # a pasted patch's polygon: its box's corners
        bb = labels["bboxes"][-n_new:]
        labels["segments"] = list(labels["segments"]) + [
            np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]], np.float32) for b in bb
        ]
    return labels


def mixup(labels, other, rng=None):
    """Blend with another sample at a Beta(32, 32) ratio; the labels concatenated."""
    rng = rng or random
    r = rng.betavariate(32.0, 32.0) if hasattr(rng, "betavariate") else np.random.beta(32.0, 32.0)
    labels["img"] = (labels["img"].astype(np.float32) * r + other["img"].astype(np.float32) * (1 - r)).astype(np.uint8)
    labels["bboxes"] = np.concatenate([labels["bboxes"], other["bboxes"]])
    labels["cls"] = np.concatenate([labels["cls"], other["cls"]])
    if labels.get("keypoints") is not None:
        ok = other.get("keypoints")
        if ok is None:
            ok = np.zeros((len(other["bboxes"]), *labels["keypoints"].shape[1:]), np.float32)
        labels["keypoints"] = np.concatenate([labels["keypoints"], ok])
    if labels.get("segments") is not None:
        labels["segments"] = list(labels["segments"]) + list(other.get("segments") or [None] * len(other["bboxes"]))
    return labels


def random_photometric(img, p: float = 0.01, rng=None):
    """Blur, median blur, gray and CLAHE on the L channel, each with probability p, in that order."""
    import cv2

    rng = rng or random
    if rng.random() < p:
        k = rng.choice([3, 5, 7])
        img = cv2.blur(img, (k, k))
    if rng.random() < p:
        k = rng.choice([3, 5, 7])
        img = cv2.medianBlur(img, k)
    if rng.random() < p:  # gray, three channels kept
        g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        img = cv2.merge([g, g, g])
    if rng.random() < p:
        lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
        clahe = cv2.createCLAHE(clipLimit=rng.uniform(1.0, 4.0), tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)
    return img


def _bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2 area; box1 (n,4), box2 (m,4) → (n, m)."""
    ix1 = np.maximum(box1[:, None, 0], box2[None, :, 0])
    iy1 = np.maximum(box1[:, None, 1], box2[None, :, 1])
    ix2 = np.minimum(box1[:, None, 2], box2[None, :, 2])
    iy2 = np.minimum(box1[:, None, 3], box2[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area2[None] + eps)


def mosaic9(items, imgsz: int, rng=None):
    """Nine images around a centre tile on a 3·imgsz canvas (114 elsewhere), each first resized so
    its long side is imgsz, then the centre 2·imgsz crop, as mosaic4's canvas; boxes (and polygons and
    keypoints) shifted along, boxes clipped to it."""
    import cv2

    rng = rng or random
    s = imgsz
    canvas = np.full((s * 3, s * 3, items[0]["img"].shape[-1]), 114, dtype=np.uint8)
    all_boxes, all_cls = [], []
    all_segs = [] if any(it.get("segments") for it in items) else None
    kpt_dims = next((it["keypoints"].shape[1:] for it in items[:9] if it.get("keypoints") is not None), None)
    all_kpts = []
    hp = wp = h0 = w0 = 0
    for i, it in enumerate(items[:9]):
        img = it["img"]
        r = s / max(img.shape[:2])
        if r != 1:
            img = cv2.resize(img, (int(img.shape[1] * r), int(img.shape[0] * r)))
        h, w = img.shape[:2]
        if i == 0:  # center
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:  # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padw, padh = c[:2]
        x1, y1, x2, y2 = (max(x, 0) for x in c)
        canvas[y1:y2, x1:x2] = img[y1 - padh :, x1 - padw :]
        hp, wp = h, w
        if len(it["bboxes"]):
            # labels live on the eventual 2s canvas: shift by pad − s/2 crop
            off = np.array([padw - s // 2, padh - s // 2] * 2, np.float32)
            all_boxes.append(it["bboxes"] * r + off)
            all_cls.append(it["cls"])
            if kpt_dims is not None:
                all_kpts.append(_shift_kpts(it.get("keypoints"), len(it["bboxes"]), kpt_dims, r, off[0], off[1]))
            if all_segs is not None:
                segs = it.get("segments") or [None] * len(it["bboxes"])
                all_segs.extend(sg * r + off[:2] if sg is not None else None for sg in segs)
    bboxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls) if all_cls else np.zeros((0,), np.float32)
    bboxes = _clip_bboxes(bboxes, 2 * s, 2 * s)
    out = {
        "img": canvas[s // 2 : s // 2 + 2 * s, s // 2 : s // 2 + 2 * s],
        "bboxes": bboxes,
        "cls": cls,
        "shape": (2 * s, 2 * s),
    }
    if all_kpts:
        out["keypoints"] = np.concatenate(all_kpts)
    if all_segs is not None:
        out["segments"] = all_segs
    return out


def cutmix(labels, other, p: float = 1.0, beta: float = 1.0, num_areas: int = 3, rng=None):
    """Paste a region of `other` into the image: of `num_areas` random regions (sides √(1 − λ),
    λ ~ Beta(beta, beta)), one that covers no box of the image; the donor boxes it covers by at
    least a tenth come along, clipped to it, with invisible keypoints where the image has keypoints."""
    rng = rng or random
    img = labels["img"]
    h, w = img.shape[:2]
    areas = []
    for _ in range(num_areas):
        lam = rng.betavariate(beta, beta) if hasattr(rng, "betavariate") else np.random.beta(beta, beta)
        cut_ratio = math.sqrt(1.0 - lam)
        cw, chh = int(w * cut_ratio), int(h * cut_ratio)
        cx, cy = rng.randrange(w), rng.randrange(h)
        areas.append([
            np.clip(cx - cw // 2, 0, w), np.clip(cy - chh // 2, 0, h),
            np.clip(cx + cw // 2, 0, w), np.clip(cy + chh // 2, 0, h),
        ])
    areas = np.asarray(areas, np.float32)
    if len(labels["bboxes"]):
        ioa1 = _bbox_ioa(areas, labels["bboxes"])
        ok = np.nonzero(ioa1.sum(1) <= 0)[0]
    else:
        ok = np.arange(num_areas)
    if len(ok) == 0:
        return labels
    area = areas[ok[rng.randrange(len(ok))]]
    if len(other["bboxes"]) == 0:
        return labels
    ioa2 = _bbox_ioa(area[None], other["bboxes"])[0]
    take = np.nonzero(ioa2 >= 0.1)[0]
    if len(take) == 0:
        return labels
    x1, y1, x2, y2 = area.astype(np.int32)
    labels["img"][y1:y2, x1:x2] = other["img"][y1:y2, x1:x2]
    nb = other["bboxes"][take].copy()
    nb[:, [0, 2]] = nb[:, [0, 2]].clip(x1, x2)  # restrain to the pasted window
    nb[:, [1, 3]] = nb[:, [1, 3]].clip(y1, y2)
    labels["bboxes"] = np.concatenate([labels["bboxes"], nb])
    labels["cls"] = np.concatenate([labels["cls"], other["cls"][take]])
    if labels.get("keypoints") is not None:
        labels["keypoints"] = np.concatenate([labels["keypoints"], np.zeros((len(take), *labels["keypoints"].shape[1:]), np.float32)])
    if labels.get("segments") is not None:
        donor_segs = other.get("segments")
        labels["segments"] = list(labels["segments"]) + [
            donor_segs[t] if donor_segs is not None and t < len(donor_segs) else None for t in take
        ]
    return labels


def rand_augment(img, rng=None, n_ops: int = 2, magnitude: float = 9.0):
    """RandAugment of a uint8 BGR (or gray) image for classification (JAX `rand_augment`): `n_ops`
    ops drawn from twelve photometric and affine ones, each at magnitude `magnitude` / 30 and a
    random sign, every draw from `rng` (default numpy's global RNG: `np.random.seed(k)` fixes the
    result) in the JAX package's order, so the same seed gives the same image."""
    import cv2

    rng = rng or np.random
    m = magnitude / 30.0  # normalized magnitude in [0, 1]

    def _blend(a, b, alpha):
        return np.clip(a.astype(np.float32) * (1 - alpha) + b.astype(np.float32) * alpha, 0, 255).astype(np.uint8)

    def autocontrast(x, _):
        lo, hi = np.percentile(x, 0.5), np.percentile(x, 99.5)
        if hi <= lo:
            return x
        return np.clip((x.astype(np.float32) - lo) * 255.0 / (hi - lo), 0, 255).astype(np.uint8)

    def equalize(x, _):
        if x.ndim == 2:
            return cv2.equalizeHist(x)
        ycc = cv2.cvtColor(x, cv2.COLOR_BGR2YCrCb)
        ycc[..., 0] = cv2.equalizeHist(ycc[..., 0])
        return cv2.cvtColor(ycc, cv2.COLOR_YCrCb2BGR)

    def posterize(x, v):  # keep 8..4 bits
        bits = max(4, 8 - int(round(v * 4)))
        return (x >> (8 - bits)) << (8 - bits)

    def solarize(x, v):
        thr = int(255 - v * 110)
        return np.where(x >= thr, 255 - x, x).astype(np.uint8)

    def brightness(x, v):
        return _blend(np.zeros_like(x), x, 1.0 + (v if rng.random() < 0.5 else -v) * 0.9)

    def contrast(x, v):
        mean = np.full_like(x, int(x.mean()))
        return _blend(mean, x, 1.0 + (v if rng.random() < 0.5 else -v) * 0.9)

    def sharpness(x, v):
        blur = cv2.GaussianBlur(x, (3, 3), 0)
        return _blend(blur, x, 1.0 + (v if rng.random() < 0.5 else -v) * 0.9)

    def _warp(x, M):
        return cv2.warpAffine(x, M, (x.shape[1], x.shape[0]), borderValue=(128, 128, 128))

    def rotate(x, v):
        a = (v if rng.random() < 0.5 else -v) * 30.0
        return _warp(x, cv2.getRotationMatrix2D((x.shape[1] / 2, x.shape[0] / 2), a, 1.0))

    def shear_x(x, v):
        s = (v if rng.random() < 0.5 else -v) * 0.3
        return _warp(x, np.float32([[1, s, 0], [0, 1, 0]]))

    def shear_y(x, v):
        s = (v if rng.random() < 0.5 else -v) * 0.3
        return _warp(x, np.float32([[1, 0, 0], [s, 1, 0]]))

    def translate_x(x, v):
        t = (v if rng.random() < 0.5 else -v) * 0.45 * x.shape[1]
        return _warp(x, np.float32([[1, 0, t], [0, 1, 0]]))

    def translate_y(x, v):
        t = (v if rng.random() < 0.5 else -v) * 0.45 * x.shape[0]
        return _warp(x, np.float32([[1, 0, 0], [0, 1, t]]))

    ops = [autocontrast, equalize, posterize, solarize, brightness, contrast,
           sharpness, rotate, shear_x, shear_y, translate_x, translate_y]
    for _ in range(n_ops):
        img = ops[rng.randint(len(ops))](np.ascontiguousarray(img), m)
    return img


class TrainTransforms:
    """The training pipeline of one sample: mosaic (4 images, or 9 with `mosaic_n = 9`; else a
    letterbox to imgsz that may enlarge), copy-paste, random perspective, mixup, cutmix,
    photometric, HSV, flips, the channel swap. `close_mosaic()` on the dataset turns off mosaic,
    copy-paste, mixup and cutmix."""

    mosaic_n = 4

    def __init__(self, dataset, imgsz: int, hyp):
        # mixup and cutmix augment their donor through this same pipeline: at p >= 1 every sample
        # draws another without end (the JAX package recurses until RecursionError)
        if getattr(hyp, "cutmix", 0.0) >= 1:
            raise ValueError(f"cutmix={hyp.cutmix}: a probability below 1 (each cutmix donor is itself augmented)")
        if hyp.mixup >= 1 and hyp.mosaic >= 1:
            raise ValueError(f"mixup={hyp.mixup} with mosaic={hyp.mosaic}: a probability below 1 for either "
                             "(each mixup donor is itself augmented)")
        self.dataset = dataset
        self.imgsz = imgsz
        self.hyp = hyp
        self.mosaic_enabled = True

    def __call__(self, labels, rng=None):
        rng = rng or random
        h = self.hyp
        use_mosaic = self.mosaic_enabled and rng.random() < h.mosaic
        if use_mosaic:
            others = [self.dataset.load_raw(rng.randrange(len(self.dataset))) for _ in range(self.mosaic_n - 1)]
            labels = (mosaic9 if self.mosaic_n == 9 else mosaic4)([labels, *others], self.imgsz, rng)
            border = (-self.imgsz // 2, -self.imgsz // 2)
        else:
            lb = LetterBox((self.imgsz, self.imgsz), scaleup=True)
            img, (ratio, pad) = lb(labels["img"], return_meta=True)
            b = labels["bboxes"] * ratio[0]
            b[:, [0, 2]] += pad[0]
            b[:, [1, 3]] += pad[1]
            labels = {**labels, "img": img, "bboxes": b}
            if labels.get("keypoints") is not None:
                kp = labels["keypoints"].copy()
                kp[..., :2] = kp[..., :2] * ratio[0] + np.array([pad[0], pad[1]], np.float32)
                labels["keypoints"] = kp
            if labels.get("segments"):
                labels["segments"] = [sg * ratio[0] + np.array([pad[0], pad[1]], np.float32) if sg is not None else None
                                      for sg in labels["segments"]]
            border = (0, 0)

        if self.mosaic_enabled and h.copy_paste > 0:
            if getattr(h, "copy_paste_mode", "flip") == "mixup":  # patches of a random other image
                if rng.random() < 0.5:
                    donor = self.dataset.load_raw(rng.randrange(len(self.dataset)))
                    labels = copy_paste(labels, donor, p=h.copy_paste, rng=rng)
            elif len(labels["bboxes"]):  # "flip": the image's own instances, mirrored
                img = labels["img"]
                w = img.shape[1]
                fb = np.asarray(labels["bboxes"], np.float32).copy()
                fb[:, [0, 2]] = w - fb[:, [2, 0]]
                donor = {"img": np.ascontiguousarray(img[:, ::-1]), "bboxes": fb, "cls": labels["cls"]}
                labels = copy_paste(labels, donor, p=h.copy_paste, rng=rng)

        labels = random_perspective(
            labels, degrees=h.degrees, translate=h.translate, scale=h.scale, shear=h.shear,
            perspective=h.perspective, border=border, rng=rng,
        )
        if use_mosaic and rng.random() < h.mixup:
            other = self(self.dataset.load_raw(rng.randrange(len(self.dataset))), rng)
            labels = mixup(labels, other, rng)
        if self.mosaic_enabled and getattr(h, "cutmix", 0.0) and rng.random() < h.cutmix:
            other = self(self.dataset.load_raw(rng.randrange(len(self.dataset))), rng)
            labels = cutmix(labels, other, rng=rng)

        labels["img"] = random_photometric(labels["img"], p=getattr(h, "augment_photometric", 0.01), rng=rng)
        labels["img"] = random_hsv(labels["img"], h.hsv_h, h.hsv_s, h.hsv_v, rng)
        labels = random_flip(labels, lr_p=h.fliplr, ud_p=h.flipud, rng=rng, flip_idx=getattr(self.dataset, "flip_idx", None))
        # with probability `bgr` the image keeps its BGR order through the collate's swap to RGB
        if getattr(h, "bgr", 0.0) and labels["img"].ndim == 3 and labels["img"].shape[-1] == 3 and rng.random() < h.bgr:
            labels["img"] = np.ascontiguousarray(labels["img"][..., ::-1])
        return labels


class ValTransforms:
    """Letterbox to (imgsz, imgsz) without upscaling; pixel xyxy boxes (and polygons and keypoints) scaled
    and shifted; `ratio_pad` kept."""

    def __init__(self, imgsz: int, stride: int = 32):
        self.lb = LetterBox((imgsz, imgsz), scaleup=False, stride=stride)

    def __call__(self, labels: dict) -> dict:
        img, (ratio, pad) = self.lb(labels["img"], return_meta=True)
        b = labels["bboxes"] * ratio[0]
        if len(b):
            b[:, [0, 2]] += pad[0]
            b[:, [1, 3]] += pad[1]
        out = {**labels, "img": img, "bboxes": b, "ratio_pad": (ratio, pad)}
        if labels.get("segments"):
            out["segments"] = [sg * ratio[0] + np.array([pad[0], pad[1]], np.float32) if sg is not None else None
                               for sg in labels["segments"]]
        if labels.get("keypoints") is not None:
            kp = labels["keypoints"].copy()
            kp[..., :2] = kp[..., :2] * ratio[0] + np.array([pad[0], pad[1]], np.float32)
            out["keypoints"] = kp
        return out
