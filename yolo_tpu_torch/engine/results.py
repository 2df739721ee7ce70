"""Inference result containers of the detect, segment, pose and classify tasks (counterpart of
yolo_tpu/engine/results.py).

Host-side and numpy-backed: the predictor hands over the valid rows of the
fixed-shape NMS output, and these classes expose the `.boxes.xyxy/conf/cls`
views the Kalman clip loop consumes, and the track id column `YOLO.track` adds;
a classify result carries `probs` (`Probs`: top1, top5 and their confidences)
and no boxes; a segment result carries `masks` (`Masks`: one boolean map a box at
the original image's size, its contour polygons `xy` / `xyn`); a pose result carries
`keypoints` (`Keypoints`: (N, K, 2 or 3) x, y and visibility at the original image's size).
`Results` draws its boxes, masks, keypoints with their skeleton or top-5 block (`plot`,
`save`), writes YOLO label lines or top-5 lines (`save_txt`) and summarises itself
(`summary`, `to_json`, with each mask's contour as `segments` and each instance's
`keypoints`) as the JAX package's does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from yolo_tpu_torch.ops.boxes import xyxy2xywh, xyxy2xywhn


class Boxes:
    """Detection boxes with xyxy / conf / cls (+ optional track id) views."""

    def __init__(self, data: np.ndarray, orig_shape):
        # data: (N, 6) [x1, y1, x2, y2, conf, cls] or (N, 7) [x1, y1, x2, y2, track_id, conf, cls]
        data = np.asarray(data, dtype=np.float32)
        data = data.reshape(-1, data.shape[-1] if data.ndim > 1 else 6)
        if data.shape[-1] not in (6, 7):
            raise ValueError(f"boxes have 6 or 7 columns, got {data.shape[-1]}")
        self.data = data
        self.orig_shape = orig_shape
        self.is_track = data.shape[-1] == 7

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        return self.data[:, 4] if self.is_track else None

    @property
    def xywh(self):
        return xyxy2xywh(self.xyxy)

    def _normalised(self, b):
        b[:, [0, 2]] /= self.orig_shape[1]
        b[:, [1, 3]] /= self.orig_shape[0]
        return b

    @property
    def xyxyn(self):
        return self._normalised(self.xyxy.copy())

    @property
    def xywhn(self):
        return self._normalised(xyxy2xywh(self.xyxy))

    def cpu(self):
        """The boxes themselves: they already live on the host (the `.cpu().numpy()` idiom)."""
        return self

    def numpy(self):
        return self


class Probs:
    """Classification probabilities of one image (JAX Probs)."""

    def __init__(self, probs: np.ndarray):
        self.data = np.asarray(probs, np.float32)

    @property
    def top1(self) -> int:
        return int(np.argmax(self.data))

    @property
    def top5(self) -> list:
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data[self.top1])

    @property
    def top5conf(self) -> np.ndarray:
        return self.data[self.top5]

    def cpu(self):
        """The probabilities themselves: they already live on the host."""
        return self

    def numpy(self):
        return self


class Masks:
    """Instance masks of one image (JAX Masks): `data` (N, H, W) at the original image's size."""

    def __init__(self, masks: np.ndarray, orig_shape):
        self.data = np.asarray(masks)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Masks(self.data[idx], self.orig_shape)

    @property
    def xy(self) -> list:
        """Each mask's largest external contour as (K, 2) f32 pixel points (cv2, CHAIN_APPROX_SIMPLE;
        (0, 2) for an empty mask)."""
        import cv2

        polys = []
        for m in self.data:
            cnts, _ = cv2.findContours((m > 0.5).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            polys.append(max(cnts, key=cv2.contourArea).reshape(-1, 2).astype(np.float32) if cnts else np.zeros((0, 2), np.float32))
        return polys

    @property
    def xyn(self) -> list:
        h, w = self.orig_shape
        return [p / np.array([w, h], np.float32) for p in self.xy]

    def cpu(self):
        """The masks themselves: they already live on the host."""
        return self

    def numpy(self):
        return self


class Keypoints:
    """The keypoints of one image (JAX Keypoints): `data` (N, K, 2 or 3), x and y in the original image's
    pixels, then the visibility where the model predicts one."""

    def __init__(self, keypoints: np.ndarray, orig_shape):
        self.data = np.asarray(keypoints, np.float32)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Keypoints(self.data[idx], self.orig_shape)

    @property
    def xy(self) -> np.ndarray:
        return self.data[..., :2]

    @property
    def xyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xy / np.array([w, h], np.float32)

    @property
    def conf(self):
        """The visibility (N, K), or None for keypoints without one."""
        return self.data[..., 2] if self.data.shape[-1] == 3 else None

    def cpu(self):
        """The keypoints themselves: they already live on the host."""
        return self

    def numpy(self):
        return self


class Results:
    """Single-image inference result: boxes (detect; with `masks`, segment; with `keypoints`, pose) or
    class probabilities (`probs`, classify)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict, boxes: np.ndarray | None = None, speed: dict | None = None,
                 probs: np.ndarray | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        has = boxes is not None and len(boxes)
        self.boxes = Boxes(boxes if has else np.zeros((0, 6), np.float32), self.orig_shape)
        self.probs = Probs(probs) if probs is not None else None
        self.masks = None
        self.keypoints = None
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}
        self.save_dir = None

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, idx):
        """One row, a slice, or a list / array of row indices (the tracker's subset), with their masks
        and keypoints."""
        sel = idx if isinstance(idx, (slice, list, np.ndarray)) else [idx]
        r = Results(self.orig_img, self.path, self.names, boxes=self.boxes.data[sel], speed=self.speed)
        if self.masks is not None:
            r.masks = Masks(np.asarray(self.masks.data)[sel], self.orig_shape)
        if self.keypoints is not None:
            r.keypoints = Keypoints(np.asarray(self.keypoints.data)[sel], self.orig_shape)
        return r

    def new(self, boxes: np.ndarray | None = None):
        """A Results of the same image, path, names and speed with other boxes (none by default) and no
        masks or keypoints, as the JAX package's."""
        return Results(self.orig_img, self.path, self.names, boxes=boxes, speed=self.speed)

    def update(self, boxes: np.ndarray | None = None):
        """Replace the boxes: (n, 6) [x1, y1, x2, y2, conf, cls] or, tracked, (n, 7) with the id before conf."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)

    def verbose(self) -> str:
        """Per-image log fragment: '512x640 2 aircrafts, ' or '512x640 (no detections), '; a classify
        result's top-1 class and confidence."""
        if self.probs is not None:
            return f"{self.names.get(self.probs.top1, self.probs.top1)} {self.probs.top1conf:.2f}, "
        h, w = self.orig_shape
        if not len(self.boxes):
            return f"{h}x{w} (no detections), "
        cls = self.boxes.cls.astype(int)
        parts = []
        for c in sorted(set(cls.tolist())):
            n = int((cls == c).sum())
            parts.append(f"{n} {self.names.get(c, str(c))}{'s' if n > 1 else ''}")
        return f"{h}x{w} " + ", ".join(parts) + ", "

    def plot(self, conf: bool = True, line_width: int | None = None, labels: bool = True, boxes: bool = True,
             img: np.ndarray | None = None, probs: bool = True, masks: bool = True, kpt_radius: int = 5,
             kpt_line: bool = True) -> np.ndarray:
        """A copy of the image (BGR; a gray one made BGR) with each mask blended in its box's class colour
        (`masks`), then each box in its class's colour and its label: 'name conf', with 'id:N ' before it
        for a tracked box, then each instance's keypoints (`kpt_radius`) and, for 17 of them, the COCO
        skeleton (`kpt_line`); a classify result's top five 'name p' lines in its top-left corner instead."""
        import cv2

        from yolo_tpu_torch.utils.plotting import Annotator, color_for

        im = (img if img is not None else self.orig_img).copy()
        if im.ndim == 2:
            im = cv2.cvtColor(im, cv2.COLOR_GRAY2BGR)
        ann = Annotator(im, line_width=line_width)
        if self.probs is not None and probs:
            for k, j in enumerate(self.probs.top5):
                ann.text((8, 8 + k * (ann.lw * 12)), f"{self.names.get(j, j)} {self.probs.data[j]:.2f}", box_color=(64, 64, 64))
            return ann.result()
        if self.masks is not None and masks and len(self.masks.data):
            cols = [color_for(int(c)) for c in self.boxes.cls] if len(self.boxes) else [color_for(j) for j in range(len(self.masks.data))]
            ann.masks(self.masks.data, cols)
        if boxes:
            for row in self.boxes.data:
                c = int(row[-1])
                name = self.names.get(c, str(c))
                if self.boxes.is_track:
                    name = f"id:{int(row[4])} {name}"
                label = (f"{name} {float(row[-2]):.2f}" if conf else name) if labels else ""
                ann.box_label(row[:4], label, color=color_for(c))
        if self.keypoints is not None:
            for k in np.asarray(self.keypoints.data):
                ann.kpts(k, radius=kpt_radius, kpt_line=kpt_line)
        return ann.result()

    def save(self, filename: str | None = None) -> str:
        """Write `plot()` to `filename` (default 'results_<the source's name>') → the name."""
        from yolo_tpu_torch.utils.files import imwrite

        filename = filename or f"results_{Path(self.path).name or 'image.jpg'}"
        imwrite(str(filename), self.plot())
        return filename

    def save_txt(self, txt_file, save_conf: bool = False) -> None:
        """Append one YOLO label line a box to `txt_file`: 'cls cx cy w h' normalised by the image
        (`%.6g`), the confidence after them with `save_conf`; a classify result's top five as
        'p name' lines."""
        lines = [f"{self.probs.data[j]:.2f} {self.names.get(j, j)}" for j in self.probs.top5] if self.probs is not None else []
        for row in self.boxes.data:
            xywhn = xyxy2xywhn(row[None, :4], w=self.orig_shape[1], h=self.orig_shape[0])[0]
            vals = [int(row[-1]), *xywhn.tolist()] + ([float(row[-2])] if save_conf else [])
            lines.append(" ".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in vals))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        with open(txt_file, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))

    def summary(self, normalize: bool = False, decimals: int = 5) -> list:
        """One dict a box: name, class, confidence, box {x1, y1, x2, y2} (divided by the image's
        size with `normalize`), track_id for a tracked box, `segments` {x, y} (the mask's contour)
        for a segment result and `keypoints` {x, y, visible} for a pose one; rounded to `decimals`. A
        classify result: one dict, its top-1 class."""
        if self.probs is not None:
            top1 = self.probs.top1
            return [{"name": self.names.get(top1, str(top1)), "class": top1, "confidence": round(self.probs.top1conf, decimals)}]
        h, w = self.orig_shape if normalize else (1, 1)
        out = []
        for i in range(len(self.boxes)):
            xy = {}
            for j, (bx, by) in enumerate(np.asarray(self.boxes.xyxy[i]).reshape(-1, 2)):
                xy[f"x{j + 1}"] = round(float(bx) / w, decimals)
                xy[f"y{j + 1}"] = round(float(by) / h, decimals)
            c = int(self.boxes.cls[i])
            res = {"name": self.names.get(c, str(c)), "class": c, "confidence": round(float(self.boxes.conf[i]), decimals), "box": xy}
            if self.boxes.is_track:
                res["track_id"] = int(self.boxes.id[i])
            if self.masks is not None and i < len(self.masks.data):
                poly = self.masks[i : i + 1].xy[0]
                res["segments"] = {"x": (poly[:, 0] / w).round(decimals).tolist(), "y": (poly[:, 1] / h).round(decimals).tolist()}
            if self.keypoints is not None and i < len(self.keypoints.data):
                k = np.asarray(self.keypoints.data[i], np.float64)
                res["keypoints"] = {"x": (k[:, 0] / w).round(decimals).tolist(), "y": (k[:, 1] / h).round(decimals).tolist(),
                                    "visible": k[:, 2].round(decimals).tolist() if k.shape[-1] == 3 else [1.0] * len(k)}
            out.append(res)
        return out

    def to_json(self, normalize: bool = False) -> str:
        import json

        return json.dumps(self.summary(normalize=normalize), indent=2)
