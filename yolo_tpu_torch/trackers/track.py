"""The glue between the predictor and the MOT trackers (counterpart of yolo_tpu/trackers/track.py).

`attach_tracker` feeds each Results of a predict run through one tracker and
rewrites it with tracked boxes, rows [x1, y1, x2, y2, id, conf, cls]: the Results
is subset to the tracked rows, so a segment result's masks and a pose result's
keypoints follow their boxes, in the tracker's order. An obb result tracks on its
xywhr (probiou association), its rows [cx, cy, w, h, angle, id, conf, cls].
"""

from __future__ import annotations

import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from yolo_tpu_torch.ops.boxes import xyxy2xywh
from yolo_tpu_torch.trackers.batched import BatchedBYTETracker
from yolo_tpu_torch.trackers.bot_sort import BOTSORT
from yolo_tpu_torch.trackers.byte_tracker import BYTETracker

CFG_DIR = Path(__file__).resolve().parents[1] / "cfg" / "trackers"


def load_tracker_cfg(tracker: str | None) -> SimpleNamespace:
    """A tracker YAML by path, else by name from the package's cfg/trackers (default botsort.yaml)."""
    import yaml

    path = Path(tracker or "botsort.yaml")
    if not path.exists():
        path = CFG_DIR / path.name
    cfg = SimpleNamespace(**(yaml.safe_load(path.read_text(encoding="utf-8")) or {}))
    if cfg.tracker_type not in ("bytetrack", "botsort"):
        raise ValueError(f"unsupported tracker type {cfg.tracker_type}")
    return cfg


def create_tracker(tracker: str | None, frame_rate: int = 30, device=None):
    """The tracker a tracker YAML names. ByteTrack runs on the host unless
    YOLO_TPU_DEVICE_TRACKER=1 asks for the batched twin on `device` (None: the
    card), sized by YOLO_TPU_DEVICE_TRACKER_DMAX / _NMAX (320 / 512: the
    predictor's max_det 300 fits). The JAX package picks the twin by default
    only on a TPU backend; on the port's backends the default is the host
    tracker. BoT-SORT always runs on the host; its ReID encoder's model, where the yaml
    names one, on `device`."""
    cfg = load_tracker_cfg(tracker)
    if cfg.tracker_type == "botsort":
        return BOTSORT(args=cfg, frame_rate=frame_rate, device=device)
    if os.getenv("YOLO_TPU_DEVICE_TRACKER") == "1":
        d_max = int(os.getenv("YOLO_TPU_DEVICE_TRACKER_DMAX", "320"))
        n_max = int(os.getenv("YOLO_TPU_DEVICE_TRACKER_NMAX", "512"))
        return BatchedBYTETracker(args=cfg, frame_rate=frame_rate, n_max=n_max, d_max=d_max, device=device)
    return BYTETracker(args=cfg, frame_rate=frame_rate)


def attach_tracker(model, results, persist: bool = False, stream: bool = False, tracker_cfg=None):
    """Track over an iterable of Results → the same kind of iterable (a generator with `stream`).
    A new tracker is made unless `persist` and the model already holds one."""
    if not persist or getattr(model, "_tracker", None) is None:
        predictor = getattr(model, "predictor", None)  # the device the results were computed on
        device = getattr(predictor, "device", None) if predictor is not None else None
        model._tracker = create_tracker(tracker_cfg, device=device if device is not None else getattr(model, "device", None))
    tracker = model._tracker

    def process(r):
        is_obb = r.obb is not None and len(r.boxes) == 0
        det = r.obb if is_obb else r.boxes
        if len(det) == 0:
            return r
        # the frame goes along: BoT-SORT's camera-motion estimate reads its pixels
        tracks = tracker.update(det.xywhr if is_obb else xyxy2xywh(det.xyxy), det.conf, det.cls, img=r.orig_img)
        if len(tracks) == 0:
            kept = r[[]]
            kept.update(**({"obb": np.zeros((0, 8), np.float32)} if is_obb else {"boxes": np.zeros((0, 7), np.float32)}))
            return kept
        kept = r[tracks[:, -1].astype(int).tolist()]
        if is_obb:  # rows [cx, cy, w, h, angle, id, score, cls, det_idx] → [xywhr, id, conf, cls]
            obb = np.concatenate([tracks[:, :5], tracks[:, 5:6], kept.obb.conf[:, None], kept.obb.cls[:, None]], axis=-1)
            kept.update(obb=obb.astype(np.float32))
            return kept
        boxes = np.concatenate([tracks[:, :4], tracks[:, 4:5], kept.boxes.conf[:, None], kept.boxes.cls[:, None]], axis=-1)
        kept.update(boxes=boxes.astype(np.float32))
        return kept

    if stream:
        return (process(r) for r in results)
    return [process(r) for r in results]
