"""Device ops: box math, anchors, letterbox, NMS, tiling, and the hand-written kernels' wrappers
(counterpart of yolo_tpu/ops/)."""

from yolo_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from yolo_tpu_torch.ops.boxes import (
    bbox_iou,
    box_iou,
    clip_boxes,
    ltwh2xyxy,
    scale_boxes,
    xywh2xyxy,
    xywhn2xyxy,
    xyxy2ltwh,
    xyxy2xywh,
    xyxy2xywhn,
)
from yolo_tpu_torch.ops.letterbox import LetterBox, letterbox_params
from yolo_tpu_torch.ops.nms import nms_fixed, non_max_suppression

__all__ = [
    "bbox_iou", "box_iou", "clip_boxes", "scale_boxes",
    "xywh2xyxy", "xyxy2xywh", "xywhn2xyxy", "xyxy2xywhn", "ltwh2xyxy", "xyxy2ltwh",
    "make_anchors", "dist2bbox", "bbox2dist",
    "LetterBox", "letterbox_params",
    "non_max_suppression", "nms_fixed",
]
