"""yolo_tpu_torch: the PyTorch/CUDA port of yolo_tpu for NVIDIA Hopper: the fused detect+track
pipeline, the `YOLO(...).predict` facade with the per-object Kalman clip loop,
`YOLO(...).track` with the ByteTrack / BoT-SORT trackers, `SAM` / `FastSAM` (models/), `YOLO(...).val`, the
detect validator (`DetectionValidator`: P, R, mAP50, mAP50-95), `YOLO(...).train`,
the detect trainer (`engine/trainer.py`), and the detection server
(`python -m yolo_tpu_torch.serve`) with its client, `YOLO("tcp://host:port/<id>")`.

The JAX package `yolo_tpu` is the reference; this package imports nothing of
it (nor JAX). Entry points run on the CUDA card unless the caller passes
`device="cpu"`, where the hand-written kernels' plain PyTorch twins run.
"""

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.engine.exporter import load_npz
from yolo_tpu_torch.engine.model import NAS, RTDETR, YOLO, YOLOE, YOLOWorld
from yolo_tpu_torch.engine.validator import DetectionValidator
from yolo_tpu_torch.models import SAM, FastSAM
from yolo_tpu_torch.nn.tasks import DetectionModel, fuse, params_from_jax
from yolo_tpu_torch.pipeline.fused import FusedDetectTrack

__all__ = ["YOLO", "NAS", "RTDETR", "SAM", "FastSAM", "YOLOE", "YOLOWorld", "DetectionModel", "DetectionValidator",
           "FusedDetectTrack", "fuse", "load_npz", "params_from_jax", "resolve_device"]
