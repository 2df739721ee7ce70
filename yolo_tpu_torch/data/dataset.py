"""YOLO-format detection dataset (images/ + labels/*.txt) (counterpart of
yolo_tpu/data/dataset.py): the dataset yaml, the label files and their JSON
cache, image loading, the validation letterbox or the training augmentations
(`augment=True` with the settings as `hyp`), and the collate into fixed-shape
batches.

Box rows (`cls cx cy w h`, normalized), polygon rows (`cls x1 y1 x2 y2 ...`,
turned into their boxes; the training augmentations warp the polygons) and, where the
dataset yaml names a `kpt_shape` (K, ndim), pose rows (`cls cx cy w h` then K keypoints
of `x y [v]`, normalized) are read; where a batch has polygons the collate draws their
masks (the segment task), where it has keypoints it pads them to (B, N, K, ndim) (the
pose task). For the obb task (`task='obb'`) DOTA rows (`cls x1 y1 x2 y2 x3 y3 x4 y4`, the
normalized corners) are read as their corners ('obb', the envelope their box), and the collate
gives each box as normalized xywhr through cv2's `minAreaRect`.
`cache='ram'` (or True) keeps each decoded image in memory after its first read
and hands out copies (the augmentations write into the image).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import yaml

from yolo_tpu_torch.utils import LOGGER

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
DATASETS_DIR = Path(__file__).resolve().parents[1] / "cfg" / "datasets"


def check_det_dataset(data) -> dict:
    """A dataset dict, or the path of its yaml (a bare name is looked up among the
    shipped yamls) → the dict with `train` / `val` / `test` resolved against
    `path` (or the yaml's folder), `names` as {id: name} and `nc`."""
    if isinstance(data, dict):
        d = dict(data)
    else:
        p = Path(data)
        if not p.exists() and p.suffix in (".yaml", ".yml") and len(p.parts) == 1 and (DATASETS_DIR / p.name).exists():
            data = DATASETS_DIR / p.name
        d = yaml.safe_load(Path(data).read_text(encoding="utf-8", errors="ignore")) or {}
        d.setdefault("yaml_file", str(data))
    root = Path(d.get("path") or Path(d.get("yaml_file", ".")).parent)
    for split in ("train", "val", "test"):
        if d.get(split) and not Path(d[split]).is_absolute():
            d[split] = str(root / d[split])
    names = d.get("names") or {0: "object"}
    if isinstance(names, list):
        names = dict(enumerate(names))
    d["names"] = {int(k): v for k, v in names.items()}
    d["nc"] = len(d["names"])
    return d


def img2label_path(img_path: str) -> str:
    """.../images/.../x.jpg → .../labels/.../x.txt (the last `images` part), else x.txt beside the image."""
    p = Path(img_path)
    if "images" in p.parent.parts:
        parts = list(p.parts)
        parts[len(parts) - 1 - parts[::-1].index("images")] = "labels"
        return str(Path(*parts).with_suffix(".txt"))
    return str(p.with_suffix(".txt"))


def _parse_label_file(path: str, single_cls: bool, kpt_shape=None, obb: bool = False):
    """→ (cls (n,), bboxes (n, 4) normalized xywh, segments, keypoints, corners) of one label file, or None
    when it is missing. `segments` lists each row's normalized polygon (None for a box row), or is None when
    the file has no polygon row; the training augmentations warp polygons, not their boxes. With
    `kpt_shape` (K, ndim) a row of 5 + K · ndim numbers is a pose row: `keypoints` (n, K, ndim)
    normalized, zero for the file's other rows, or None when it has no pose row. With `obb` a row of 9
    numbers is a DOTA row: its box is its corners' envelope, and `corners` (m, 4, 2) stacks the DOTA
    rows' normalized corners (None when there is none)."""
    if not Path(path).exists():
        return None
    nk = kpt_shape[0] * kpt_shape[1] if kpt_shape else 0
    cls, boxes, segments, kpts, obbs = [], [], [], [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        kp = None
        if obb and len(parts) == 9:  # cls, then the four corners
            corners = np.array([float(x) for x in parts[1:]], np.float32).reshape(4, 2)
            (x1, y1), (x2, y2) = corners.min(0), corners.max(0)
            boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
            segments.append(None)
            obbs.append(corners)
        elif nk and len(parts) == 5 + nk:  # cls cx cy w h, then K keypoints of x y [v]
            boxes.append([float(x) for x in parts[1:5]])
            segments.append(None)
            kp = np.array([float(x) for x in parts[5:]], np.float32).reshape(kpt_shape)
        elif len(parts) >= 7 and len(parts) % 2 == 1:  # a polygon of three points or more → its box
            poly = np.array([float(x) for x in parts[1:]], np.float32).reshape(-1, 2)
            (x1, y1), (x2, y2) = poly.min(0), poly.max(0)
            boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
            segments.append(poly)
        elif len(parts) >= 5:
            boxes.append([float(x) for x in parts[1:5]])
            segments.append(None)
        else:
            continue
        cls.append(0.0 if single_cls else float(parts[0]))
        kpts.append(kp)
    segments = segments if any(sg is not None for sg in segments) else None
    keypoints = None
    if any(k is not None for k in kpts):
        keypoints = np.stack([np.zeros(kpt_shape, np.float32) if k is None else k for k in kpts])
    corners = np.stack(obbs) if obbs else None
    return np.array(cls, np.float32), np.array(boxes, np.float32).reshape(-1, 4), segments, keypoints, corners


class YOLODataset:
    """Detection dataset over a directory, a glob or a list file of images: letterboxed for
    validation, or augmented for training when `augment` is set and `hyp` holds the settings.
    `kpt_shape` reads pose rows; `flip_idx` (the dataset yaml's) swaps left and right keypoints
    on a horizontal flip; `task='obb'` reads DOTA rows."""

    def __init__(self, img_path, imgsz: int = 640, augment: bool = False, hyp=None, stride: int = 32,
                 single_cls: bool = False, fraction: float = 1.0, names=None, cache=None, kpt_shape=None, flip_idx=None,
                 task: str = "detect"):
        from yolo_tpu_torch.data.augment import TrainTransforms, ValTransforms

        self.img_path = img_path
        self.imgsz = imgsz
        self.stride = stride
        self.single_cls = single_cls
        self.names = names or {}
        self.kpt_shape = tuple(kpt_shape) if kpt_shape else None
        self.flip_idx = list(flip_idx) if flip_idx else None
        self.task = task
        self.im_files = self._list_images(img_path, fraction)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {img_path}")
        # the label cache is on unless `cache` is False; 'ram' / True also keep the decoded images
        self.labels = self._load_labels(cache is not False)
        self._im_cache = {} if cache in ("ram", True) else None
        self.transforms = TrainTransforms(self, imgsz, hyp) if augment and hyp is not None else ValTransforms(imgsz, stride)

    @staticmethod
    def _list_images(img_path, fraction: float) -> list:
        p = Path(img_path)
        if p.is_file() and p.suffix == ".txt":  # a list file: relative entries resolve against its folder
            lines = (line.strip() for line in p.read_text().splitlines())
            files = [t if Path(t).is_absolute() else str((p.parent / t).resolve()) for t in lines if t]
        elif p.is_dir():
            files = sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_EXTS)
        else:
            files = sorted(str(f) for f in Path(p.parent).glob(p.name) if f.suffix.lower() in IMG_EXTS)
        return files[: max(1, int(len(files) * fraction))] if files else []

    def _load_labels(self, cache: bool = True) -> list[dict]:
        """Parse the label files, or read them from the JSON cache beside the first
        image, keyed by the file lists, the label files' sizes and times, `single_cls`, `kpt_shape`,
        the task and the format (it holds the polygons since the training augmentations need them, the
        keypoints and the corners). The file is the port's own, written and read by the port alone."""
        label_files = [img2label_path(f) for f in self.im_files]

        def sig(p):
            try:
                st = Path(p).stat()
                return f"{st.st_size}:{st.st_mtime_ns}"
            except OSError:
                return "missing"

        kpt = self.kpt_shape
        key = hashlib.sha1(("".join(self.im_files + label_files) + ";".join(map(sig, label_files))
                            + f":sc{self.single_cls}:polygons:kpt{kpt}:{self.task}").encode())
        cache_path = Path(self.im_files[0]).parent / f".labels_{key.hexdigest()[:16]}.torch.cache.json"
        if cache and cache_path.exists():
            try:
                return [{"cls": np.array(r["cls"], np.float32), "bboxes": np.array(r["bboxes"], np.float32).reshape(-1, 4),
                         "segments": [None if sg is None else np.array(sg, np.float32).reshape(-1, 2) for sg in r["segments"]]
                         if r.get("segments") else None,
                         "keypoints": np.array(r["keypoints"], np.float32).reshape(-1, *kpt)
                         if kpt and r.get("keypoints") is not None else None,
                         "obb": np.array(r["obb"], np.float32).reshape(-1, 4, 2) if r.get("obb") is not None else None}
                        for r in json.loads(cache_path.read_text())]
            except (ValueError, KeyError, TypeError):
                pass  # an unreadable cache is parsed again and rewritten
        labels, n_missing = [], 0
        for lf in label_files:
            parsed = _parse_label_file(lf, self.single_cls, kpt, self.task == "obb")
            if parsed is None:
                n_missing += 1
                parsed = np.zeros(0, np.float32), np.zeros((0, 4), np.float32), None, None, None
            labels.append(dict(zip(("cls", "bboxes", "segments", "keypoints", "obb"), parsed)))
        if n_missing:
            LOGGER.warning(f"{n_missing}/{len(label_files)} label files missing (treated as background)")
        if cache:
            try:
                cache_path.write_text(json.dumps([
                    {"cls": lb["cls"].tolist(), "bboxes": lb["bboxes"].tolist(),
                     "segments": [None if sg is None else sg.tolist() for sg in lb["segments"]] if lb["segments"] else None,
                     "keypoints": None if lb["keypoints"] is None else lb["keypoints"].tolist(),
                     "obb": None if lb["obb"] is None else lb["obb"].tolist()}
                    for lb in labels]))
            except OSError:
                pass  # a read-only dataset: no cache
        return labels

    def __len__(self):
        return len(self.im_files)

    def load_raw(self, i: int) -> dict:
        """Image i (BGR, as decoded) with its labels as pixel xyxy boxes (and polygons, keypoints and
        corners, where the label file has them, in pixels), before any transform."""
        from yolo_tpu_torch.ops.boxes import xywhn2xyxy
        from yolo_tpu_torch.utils.files import imread

        if self._im_cache is not None and i in self._im_cache:
            img = self._im_cache[i].copy()  # the augmentations write into the image
        else:
            img = imread(self.im_files[i])
            if img is None:
                raise FileNotFoundError(self.im_files[i])
            if self._im_cache is not None:
                self._im_cache[i] = img.copy()
        h, w = img.shape[:2]
        lb = self.labels[i]
        bboxes = xywhn2xyxy(lb["bboxes"], w=w, h=h) if len(lb["bboxes"]) else np.zeros((0, 4), np.float32)
        out = {"img": img, "cls": lb["cls"].copy(), "bboxes": np.asarray(bboxes, np.float32), "shape": (h, w),
               "im_file": self.im_files[i]}
        if lb.get("segments"):
            out["segments"] = [None if sg is None else sg * np.array([w, h], np.float32) for sg in lb["segments"]]
        if lb.get("keypoints") is not None:
            kp = lb["keypoints"].copy()
            kp[..., 0] *= w
            kp[..., 1] *= h
            out["keypoints"] = kp
        if lb.get("obb") is not None:
            out["obb"] = lb["obb"] * np.array([w, h], np.float32)
        return out

    def __getitem__(self, i: int) -> dict:
        return self.transforms(self.load_raw(i))

    def close_mosaic(self) -> None:
        """Turn off mosaic, copy-paste and mixup for the last epochs."""
        if hasattr(self.transforms, "mosaic_enabled"):
            self.transforms.mosaic_enabled = False


def collate_batch(samples: list[dict], max_boxes: int = 64, overlap: bool = True, mask_ratio: int = 4) -> dict:
    """Stack letterboxed samples into fixed-shape arrays: img (B, H, W, 3) uint8 RGB,
    cls (B, N), bboxes (B, N, 4) normalized xywh, mask_gt (B, N), and `meta`, a list
    of {im_file, shape, ratio_pad}. Labels beyond `max_boxes` are dropped, with a warning.
    Where a sample has corners (the obb task), bboxes is (B, N, 5) instead: normalized xywhr from
    `xyxyxyxy2xywhr`, the angle in radians (a batch of background images only stays (B, N, 4)).

    Where a sample has keypoints, `keypoints` too: (B, N, K, ndim) f32, x and y normalized by the image's
    size like the boxes, the visibility as it is, zero on the padded rows and on samples without any.

    Where a sample has polygons, `masks` too, at (H / r, W / r) for r = `mask_ratio`, each polygon
    drawn with cv2.fillPoly at its points rounded by np.round (half to even) from pixels / r:
    `overlap=True` gives one f32 index map (B, h, w) a batch, instance j drawn as j + 1, the largest
    contour area first (a stable sort, so ties keep the label order) so a smaller instance keeps its
    pixels where it overlaps a larger one; `overlap=False` gives per-instance uint8 masks (B, N, h, w)."""
    from yolo_tpu_torch.ops.boxes import xyxy2xywhn, xyxyxyxy2xywhr

    B = len(samples)
    H, W = samples[0]["img"].shape[:2]
    worst = max(len(s["cls"]) for s in samples)
    if worst > max_boxes:
        LOGGER.warning(f"collate: an image carries {worst} labels but the static capacity is {max_boxes}: "
                       f"extra labels are dropped (raise max_boxes in build_dataloader to keep them)")
    is_obb = any(s.get("obb") is not None for s in samples)
    imgs = np.zeros((B, H, W, 3), np.uint8)
    cls = np.zeros((B, max_boxes), np.float32)
    bboxes = np.zeros((B, max_boxes, 5 if is_obb else 4), np.float32)
    mask = np.zeros((B, max_boxes), np.float32)
    meta = []
    for i, s in enumerate(samples):
        im = s["img"]
        # decoded BGR → RGB here, once, so the device pass never flips a dataset batch
        imgs[i] = im[..., ::-1] if im.ndim == 3 else im[..., None].repeat(3, -1)
        n = min(len(s["cls"]), max_boxes)
        if n:
            cls[i, :n] = s["cls"][:n]
            if is_obb:
                xywhr = xyxyxyxy2xywhr(s["obb"][:n])
                xywhr[:, [0, 2]] /= W
                xywhr[:, [1, 3]] /= H
                bboxes[i, :n] = xywhr
            else:
                bboxes[i, :n] = np.asarray(xyxy2xywhn(s["bboxes"][:n], w=W, h=H), np.float32)
            mask[i, :n] = 1.0
        meta.append({"im_file": s.get("im_file"), "shape": s.get("shape"), "ratio_pad": s.get("ratio_pad")})
    batch = {"img": imgs, "cls": cls, "bboxes": bboxes, "mask_gt": mask, "meta": meta}
    if any(s.get("keypoints") is not None for s in samples):
        ks = next(s["keypoints"].shape[1:] for s in samples if s.get("keypoints") is not None)
        kpts = np.zeros((B, max_boxes, *ks), np.float32)
        for i, s in enumerate(samples):
            kp = s.get("keypoints")
            if kp is not None and len(kp):
                k = kp[:max_boxes].copy()
                k[..., 0] /= W
                k[..., 1] /= H
                kpts[i, : len(k)] = k
        batch["keypoints"] = kpts
    if any(s.get("segments") for s in samples):
        batch["masks"] = _draw_masks(samples, max_boxes, overlap, max(int(mask_ratio), 1), (H, W))
    return batch


def _draw_masks(samples: list[dict], max_boxes: int, overlap: bool, r: int, hw) -> np.ndarray:
    """The `masks` of `collate_batch`: polygons (pixels) drawn at 1 / r of the image's size."""
    import cv2

    mh, mw = hw[0] // r, hw[1] // r
    maps = np.zeros((len(samples), mh, mw), np.float32) if overlap else np.zeros((len(samples), max_boxes, mh, mw), np.uint8)
    for i, s in enumerate(samples):
        polys = [(j, np.round(sg / r).astype(np.int32)) for j, sg in enumerate((s.get("segments") or [])[:max_boxes])
                 if sg is not None and len(sg) >= 3]
        if overlap:
            polys.sort(key=lambda t: -cv2.contourArea(t[1].reshape(-1, 1, 2).astype(np.float32)))
            for j, pts in polys:
                cv2.fillPoly(maps[i], [pts], float(j + 1))
        else:
            for j, pts in polys:
                cv2.fillPoly(maps[i, j], [pts], 1)
    return maps
