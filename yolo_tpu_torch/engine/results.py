"""Inference result containers of the detect task (counterpart of yolo_tpu/engine/results.py).

Host-side and numpy-backed: the predictor hands over the valid rows of the
fixed-shape NMS output, and these classes expose the `.boxes.xyxy/conf/cls`
views the Kalman clip loop consumes, and the track id column `YOLO.track` adds.
Plotting and saving are not ported.
"""

from __future__ import annotations

import numpy as np

from yolo_tpu_torch.ops.boxes import xyxy2xywh


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


class Results:
    """Single-image inference result (boxes only)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict, boxes: np.ndarray | None = None, speed: dict | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        has = boxes is not None and len(boxes)
        self.boxes = Boxes(boxes if has else np.zeros((0, 6), np.float32), self.orig_shape)
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, idx):
        """One row, a slice, or a list / array of row indices (the tracker's subset)."""
        sel = idx if isinstance(idx, (slice, list, np.ndarray)) else [idx]
        return Results(self.orig_img, self.path, self.names, boxes=self.boxes.data[sel], speed=self.speed)

    def update(self, boxes: np.ndarray | None = None):
        """Replace the boxes: (n, 6) [x1, y1, x2, y2, conf, cls] or, tracked, (n, 7) with the id before conf."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)

    def verbose(self) -> str:
        """Per-image log fragment: '512x640 2 aircrafts, ' or '512x640 (no detections), '."""
        h, w = self.orig_shape
        if not len(self.boxes):
            return f"{h}x{w} (no detections), "
        cls = self.boxes.cls.astype(int)
        parts = []
        for c in sorted(set(cls.tolist())):
            n = int((cls == c).sum())
            parts.append(f"{n} {self.names.get(c, str(c))}{'s' if n > 1 else ''}")
        return f"{h}x{w} " + ", ".join(parts) + ", "
