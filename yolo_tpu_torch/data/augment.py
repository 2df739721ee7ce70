"""The validation transform (counterpart of `ValTransforms` in yolo_tpu/data/augment.py):
a letterbox to a square canvas that never enlarges, with the labels moved along.
The training augmentations are not ported."""

from __future__ import annotations

from yolo_tpu_torch.ops.letterbox import LetterBox


class ValTransforms:
    """Letterbox to (imgsz, imgsz) without upscaling; pixel xyxy boxes scaled and shifted; `ratio_pad` kept."""

    def __init__(self, imgsz: int, stride: int = 32):
        self.lb = LetterBox((imgsz, imgsz), scaleup=False, stride=stride)

    def __call__(self, labels: dict) -> dict:
        img, (ratio, pad) = self.lb(labels["img"], return_meta=True)
        b = labels["bboxes"] * ratio[0]
        if len(b):
            b[:, [0, 2]] += pad[0]
            b[:, [1, 3]] += pad[1]
        return {**labels, "img": img, "bboxes": b, "ratio_pad": (ratio, pad)}
