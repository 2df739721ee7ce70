"""yolo_tpu_torch: the PyTorch/CUDA port of yolo_tpu's fused detect+track path for NVIDIA Hopper.

The JAX package `yolo_tpu` is the reference; this package imports nothing of
it (nor JAX). Entry points run on the CUDA card unless the caller passes
`device="cpu"`, where the hand-written kernels' plain PyTorch twins run.
"""

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.engine.exporter import load_npz
from yolo_tpu_torch.nn.tasks import DetectionModel, fuse, params_from_jax
from yolo_tpu_torch.pipeline.fused import FusedDetectTrack

__all__ = ["DetectionModel", "FusedDetectTrack", "fuse", "load_npz", "params_from_jax", "resolve_device"]
