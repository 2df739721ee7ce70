"""SAHI-style tiled (sliced) inference for small targets (counterpart of yolo_tpu/ops/tiling.py).

The tile grid is fixed for a given (H, W, tile, overlap), so every frame gives
the device one batch shape; all tiles of a frame run as one batch through
`YOLO.predict` (padded to a power of two: 9 tiles of a 640x512 frame at tile
256, overlap 0.25, make a batch of 16); the merge shifts each tile's boxes to
frame coordinates and runs a greedy NMS on the host over the candidates the
per-tile NMS left. Tiling keeps <32 px targets at native resolution instead of
shrinking them through a full-frame resize.
"""

from __future__ import annotations

import numpy as np

CLASS_OFFSET = 7680.0  # per-class box shift of the class-aware merge: classes never overlap


def tile_grid(h: int, w: int, tile: int = 256, overlap: float = 0.25):
    """Tile origins [(y0, x0), ...] covering (h, w); the last row and column snap to
    the border, so every pixel is covered without ragged tiles."""
    tile = int(min(tile, h, w))
    step = max(1, int(round(tile * (1.0 - overlap))))

    def starts(extent):
        s = list(range(0, max(extent - tile, 0) + 1, step))
        if s[-1] + tile < extent:
            s.append(extent - tile)
        return s

    return [(y, x) for y in starts(h) for x in starts(w)]


def slice_tiles(img: np.ndarray, grid, tile: int) -> np.ndarray:
    """The tiles of `img` (H, W, C) as one (T, tile, tile, C) batch."""
    return np.stack([img[y : y + tile, x : x + tile] for y, x in grid])


def _greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float) -> list[int]:
    """Greedy NMS on the host over the merged (small) candidate set → kept indices, by score."""
    order = np.argsort(-scores)
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-9)
        suppressed |= iou > iou_thres
    return keep


def merge_tile_detections(per_tile, grid, iou_thres: float = 0.5, class_aware: bool = True):
    """Per-tile detections → frame coordinates, duplicates across overlapping tiles suppressed.

    `per_tile`: one (boxes_xyxy (N, 4), scores (N,), cls (N,)) triplet per grid entry, in
    tile coordinates; `class_aware` suppresses only within a class (the predictor's default).
    Returns (boxes_xyxy (M, 4), scores (M,), cls (M,)) f32 in frame coordinates."""
    all_b, all_s, all_c = [], [], []
    for (y0, x0), (b, s, c) in zip(grid, per_tile):
        if len(b) == 0:
            continue
        b = np.asarray(b, np.float32).copy()
        b[:, [0, 2]] += x0
        b[:, [1, 3]] += y0
        all_b.append(b)
        all_s.append(np.asarray(s, np.float32))
        all_c.append(np.asarray(c, np.float32))
    if not all_b:
        z = np.zeros((0,), np.float32)
        return np.zeros((0, 4), np.float32), z, z
    boxes = np.concatenate(all_b)
    scores = np.concatenate(all_s)
    cls = np.concatenate(all_c)
    off = cls * CLASS_OFFSET if class_aware else np.zeros_like(cls)
    keep = _greedy_nms(boxes + off[:, None], scores, iou_thres)
    return boxes[keep], scores[keep], cls[keep]


def tiled_predict(model, img: np.ndarray, tile: int = 256, overlap: float = 0.25,
                  conf: float = 0.25, iou: float = 0.45, merge_iou: float = 0.5, **kwargs):
    """Detect on a tile grid of `img` with a YOLO and merge → (boxes_xyxy, scores, cls) in frame
    coordinates. The tiles go through `model.predict` as one batch (`batch` defaults to the
    tile count); `kwargs` are further predict settings (compute_dtype, plain, ...). A segment or
    pose model gives its boxes: the masks and keypoints are dropped, as the JAX package reads only
    `Results.boxes`. An obb model raises NotImplementedError: its Results carry no axis-aligned
    boxes, so the JAX package returns none."""
    if getattr(model, "task", "detect") == "obb":
        raise NotImplementedError("tiled inference with an obb model is not ported (its Results hold no axis-aligned boxes)")
    grid = tile_grid(img.shape[0], img.shape[1], tile, overlap)
    tiles = slice_tiles(img, grid, tile)
    kwargs.setdefault("batch", len(tiles))
    results = model.predict(list(tiles), conf=conf, iou=iou, imgsz=tile, verbose=False, **kwargs)
    per_tile = [(r.boxes.xyxy, r.boxes.conf, r.boxes.cls) for r in results]
    return merge_tile_detections(per_tile, grid, iou_thres=merge_iou)
