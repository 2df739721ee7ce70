"""COCO category ids (counterpart of `coco80_to_coco91_class` in yolo_tpu/utils/coco_eval.py).
The COCOeval cross-check of that module, `coco_evaluate`, is not ported."""

from __future__ import annotations


def coco80_to_coco91_class() -> list[int]:
    """Contiguous 80-class index → the original COCO-91 category id (the 91-id space skips 11 ids)."""
    unused = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    return [i for i in range(1, 92) if i not in unused]
