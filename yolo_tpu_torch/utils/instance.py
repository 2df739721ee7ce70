"""Label containers for the augmentations (counterpart of yolo_tpu/utils/instance.py): `Bboxes`, boxes
in one of the xyxy / xywh / ltwh formats with their conversions, and `Instances`, boxes with their
segments and keypoints, moved together by scaling, padding, flips and clipping. numpy, on the host."""

from __future__ import annotations

import numpy as np

from yolo_tpu_torch.ops.boxes import ltwh2xyxy, xywh2xyxy, xyxy2ltwh, xyxy2xywh

_FORMATS = ("xyxy", "xywh", "ltwh")


class Bboxes:
    """(n, 4) f32 boxes in `format` (xyxy, xywh or ltwh); a single (4,) box becomes (1, 4)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        if format not in _FORMATS:
            raise ValueError(f"format must be one of {_FORMATS}, got {format!r}")
        bboxes = bboxes[None, :] if bboxes.ndim == 1 else bboxes
        if bboxes.ndim != 2 or bboxes.shape[1] != 4:
            raise ValueError(f"boxes are (n, 4), got {bboxes.shape}")
        self.bboxes = bboxes.astype(np.float32)
        self.format = format

    def convert(self, format: str) -> None:
        """Convert in place to `format`: directly from and to xyxy, through xyxy between the others."""
        if format not in _FORMATS:
            raise ValueError(f"format must be one of {_FORMATS}, got {format!r}")
        if self.format == format:
            return
        via = {"xyxy": {"xywh": xyxy2xywh, "ltwh": xyxy2ltwh}, "xywh": {"xyxy": xywh2xyxy}, "ltwh": {"xyxy": ltwh2xyxy}}
        if format in via.get(self.format, {}):
            self.bboxes = np.asarray(via[self.format][format](self.bboxes), np.float32)
            self.format = format
        else:
            self.convert("xyxy")
            self.convert(format)

    def areas(self) -> np.ndarray:
        fmt = self.format
        self.convert("xyxy")
        a = (self.bboxes[:, 2] - self.bboxes[:, 0]) * (self.bboxes[:, 3] - self.bboxes[:, 1])
        self.convert(fmt)
        return a

    def mul(self, scale) -> None:
        """Scale by (sx, sy, sx2, sy2) or one number."""
        scale = (scale,) * 4 if isinstance(scale, (int, float)) else scale
        self.bboxes = self.bboxes * np.asarray(scale, np.float32)

    def add(self, offset) -> None:
        offset = (offset,) * 4 if isinstance(offset, (int, float)) else offset
        self.bboxes = self.bboxes + np.asarray(offset, np.float32)

    def __len__(self):
        return len(self.bboxes)

    def __getitem__(self, idx):
        return Bboxes(self.bboxes[idx].reshape(-1, 4), self.format)

    @classmethod
    def concatenate(cls, boxes_list, axis: int = 0) -> Bboxes:
        """One Bboxes of several, in the first one's format (the others are converted in place)."""
        if not boxes_list:
            raise ValueError("nothing to concatenate")
        fmt = boxes_list[0].format
        for b in boxes_list:
            b.convert(fmt)
        return cls(np.concatenate([b.bboxes for b in boxes_list], axis=axis), fmt)


class Instances:
    """Boxes with their segments (n, m, 2) and keypoints (n, K, 2 or 3), normalized or in pixels."""

    def __init__(self, bboxes, segments=None, keypoints=None, bbox_format: str = "xywh", normalized: bool = True):
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.segments = segments if segments is not None else np.zeros((len(self._bboxes), 0, 2), np.float32)
        self.keypoints = keypoints
        self.normalized = normalized

    @property
    def bboxes(self) -> np.ndarray:
        return self._bboxes.bboxes

    def convert_bbox(self, format: str) -> None:
        self._bboxes.convert(format)

    @property
    def bbox_areas(self) -> np.ndarray:
        return self._bboxes.areas()

    def scale(self, sx: float, sy: float, bbox_only: bool = False) -> None:
        self._bboxes.mul((sx, sy, sx, sy))
        if not bbox_only:
            if len(self.segments):
                self.segments[..., 0] *= sx
                self.segments[..., 1] *= sy
            if self.keypoints is not None:
                self.keypoints[..., 0] *= sx
                self.keypoints[..., 1] *= sy

    def denormalize(self, w: int, h: int) -> None:
        if not self.normalized:
            return
        self.scale(w, h)
        self.normalized = False

    def normalize(self, w: int, h: int) -> None:
        if self.normalized:
            return
        self.scale(1 / w, 1 / h)
        self.normalized = True

    def add_padding(self, padw: float, padh: float) -> None:
        """Shift everything by the pads; pixel coordinates only."""
        if self.normalized:
            raise ValueError("add_padding works in pixels: denormalize first")
        self._bboxes.add((padw, padh, padw, padh))
        if len(self.segments):
            self.segments[..., 0] += padw
            self.segments[..., 1] += padh
        if self.keypoints is not None:
            self.keypoints[..., 0] += padw
            self.keypoints[..., 1] += padh

    def flipud(self, h: int) -> None:
        """Flip boxes, segments and keypoints upside down in an image of height h."""
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        y1, y2 = self.bboxes[:, 1].copy(), self.bboxes[:, 3].copy()
        self._bboxes.bboxes[:, 1] = h - y2
        self._bboxes.bboxes[:, 3] = h - y1
        self.convert_bbox(fmt)
        if len(self.segments):
            self.segments[..., 1] = h - self.segments[..., 1]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]

    def fliplr(self, w: int) -> None:
        """Flip boxes, segments and keypoints left to right in an image of width w."""
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        x1, x2 = self.bboxes[:, 0].copy(), self.bboxes[:, 2].copy()
        self._bboxes.bboxes[:, 0] = w - x2
        self._bboxes.bboxes[:, 2] = w - x1
        self.convert_bbox(fmt)
        if len(self.segments):
            self.segments[..., 0] = w - self.segments[..., 0]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]

    def clip(self, w: int, h: int) -> None:
        """Clip boxes, segments and keypoints into the image; a keypoint outside it loses its visibility."""
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        self._bboxes.bboxes[:, [0, 2]] = self.bboxes[:, [0, 2]].clip(0, w)
        self._bboxes.bboxes[:, [1, 3]] = self.bboxes[:, [1, 3]].clip(0, h)
        self.convert_bbox(fmt)
        if len(self.segments):
            self.segments[..., 0] = self.segments[..., 0].clip(0, w)
            self.segments[..., 1] = self.segments[..., 1].clip(0, h)
        if self.keypoints is not None:
            k = self.keypoints
            out = (k[..., 0] < 0) | (k[..., 0] > w) | (k[..., 1] < 0) | (k[..., 1] > h)
            if k.shape[-1] == 3:
                k[..., 2] = np.where(out, 0.0, k[..., 2])
            k[..., 0] = k[..., 0].clip(0, w)
            k[..., 1] = k[..., 1].clip(0, h)

    def remove_zero_area_boxes(self) -> np.ndarray:
        """Drop the instances whose box has no area → the kept mask."""
        good = self.bbox_areas > 0
        if not good.all():
            self._bboxes = self._bboxes[good]
            if len(self.segments):
                self.segments = self.segments[good]
            if self.keypoints is not None:
                self.keypoints = self.keypoints[good]
        return good

    def __len__(self):
        return len(self._bboxes)

    def __getitem__(self, idx) -> Instances:
        return Instances(
            self.bboxes[idx].reshape(-1, 4),
            self.segments[idx] if len(self.segments) else None,
            self.keypoints[idx] if self.keypoints is not None else None,
            bbox_format=self._bboxes.format,
            normalized=self.normalized,
        )
