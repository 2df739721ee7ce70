"""The trainer's mixed-precision check (counterpart of `check_amp` in yolo_tpu/utils/checks.py;
nothing else of it is ported)."""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.utils import LOGGER


@torch.no_grad()
def check_amp(model, params) -> bool:
    """bf16 against f32 `DetectionModel.predict` (the C2f and head kernels on the card) on a
    seeded 64x64 input: boxes within 2 px and scores within 0.05 → True; a segment model's mask
    coefficients and prototypes are not compared (the JAX check skips a segment model, whose
    predict returns a pair); a pose model's keypoints are held as the boxes are, x and y within
    2 px, and the visibilities within 0.05 (the JAX check holds their pixels to 0.05 and so
    turns bf16 off for every pose model). The model keeps the bf16 inference weights afterwards."""
    from yolo_tpu_torch.nn.tasks import install_params

    device = model.device
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)).to(device)
    ys = []
    for dtype in (torch.float32, torch.bfloat16):
        install_params(model, params, device, dtype)
        y = model.predict(x.to(dtype))
        y = y[0][:, : 4 + model.nc] if isinstance(y, tuple) else y
        ys.append(y.float().cpu().numpy())
    y32, y16 = ys
    px = np.zeros(y32.shape[1], bool)
    px[:4] = True
    kpt_shape = getattr(getattr(model, "head", None), "kpt_shape", None)
    if kpt_shape:  # the x and y rows of each keypoint after the scores
        K, ndim = kpt_shape
        rows = 4 + model.nc + np.arange(K)[:, None] * ndim + np.arange(2)[None]
        px[rows.ravel()] = True
    ok = np.allclose(y32[:, px], y16[:, px], atol=2.0) and np.allclose(y32[:, ~px], y16[:, ~px], atol=0.05)
    if not ok:
        LOGGER.warning("bf16 check failed — training will fall back to float32")
    return bool(ok)
