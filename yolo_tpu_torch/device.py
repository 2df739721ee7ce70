"""Device resolution for the port's entry points.

Every entry point (`FusedDetectTrack`, `DetectionModel`, the loaders) takes
`device=None` and runs on the CUDA card by default. The CPU is used only when
the caller asks for it (`device="cpu"`, as the tests do): a missing card is an
error, never a silent fall-back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → the first CUDA card (raises when there is none); else `torch.device(device)`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "yolo_tpu_torch runs on a CUDA card by default and none was found; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
