"""The native (C++) letterbox of the host pipeline, loaded with ctypes (counterpart of
yolo_tpu/native/__init__.py). `preprocess.cpp` is a copy of the JAX package's source
with one addition, bit for bit the same output: a frame that needs no resize is
copied row by row instead of resampled at a scale of 1.

At first use `g++ -O3 -shared -fPIC` builds `preprocess.cpp` into
`yolo_tpu_torch/_build/libyolo_preprocess-<hash of the source>.so`. Without a
compiler, or when the build fails, `available()` is False and the predictor
letterboxes with cv2, as the JAX package does. ctypes releases the interpreter
lock for the duration of each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from yolo_tpu_torch.utils import LOGGER

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"

_LIB = None
_TRIED = False
_LOCK = threading.Lock()
_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = BUILD / f"libyolo_preprocess-{hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]}.so"
            if not so.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
                LOGGER.info(f"built native preprocess library {so.name}")
            lib = ctypes.CDLL(str(so))
            lib.letterbox_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint8, _F32P, _F32P]
            lib.letterbox_u8.restype = None
            lib.batch_letterbox_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_uint8, _F32P, _F32P]
            lib.batch_letterbox_u8.restype = None
            _LIB = lib
        except (OSError, subprocess.SubprocessError) as e:  # no compiler, or the build failed → the cv2 route
            LOGGER.info(f"native preprocess unavailable ({e}); using the cv2 letterbox")
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def _checked(a: np.ndarray, ndim: int) -> np.ndarray:
    if a.dtype != np.uint8 or a.ndim != ndim or min(a.shape) <= 0:
        raise ValueError(f"the native letterbox takes non-empty uint8 arrays of {ndim} dimensions, got {a.shape} {a.dtype}")
    return np.ascontiguousarray(a)


def letterbox(img: np.ndarray, dst_hw, pad_value: int = 114):
    """One (h, w[, c]) uint8 image → ((dh, dw, c) uint8, ((r, r), (dw_pad, dh_pad))): a bilinear
    resize by the f32 ratio r and a centred pad, the meta as the JAX package's library returns it."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    img = _checked(img if img.ndim == 3 else img[..., None], 3)
    h, w, c = img.shape
    dh, dw = dst_hw
    out = np.empty((dh, dw, c), np.uint8)
    ratio, pad = np.zeros(2, np.float32), np.zeros(2, np.float32)
    lib.letterbox_u8(img.ctypes.data_as(_U8P), h, w, c, out.ctypes.data_as(_U8P), dh, dw, pad_value,
                     ratio.ctypes.data_as(_F32P), pad.ctypes.data_as(_F32P))
    return out, ((float(ratio[0]), float(ratio[1])), (float(pad[0]), float(pad[1])))


def letterbox_batch(frames: np.ndarray, dst_hw, pad_value: int = 114):
    """(n, h, w, c) uint8 frames of one size → ((n, dh, dw, c) uint8, the meta of `letterbox`)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    frames = _checked(frames, 4)
    n, h, w, c = frames.shape
    dh, dw = dst_hw
    out = np.empty((n, dh, dw, c), np.uint8)
    ratio, pad = np.zeros(2, np.float32), np.zeros(2, np.float32)
    lib.batch_letterbox_u8(frames.ctypes.data_as(_U8P), n, h, w, c, out.ctypes.data_as(_U8P), dh, dw, pad_value,
                           ratio.ctypes.data_as(_F32P), pad.ctypes.data_as(_F32P))
    return out, ((float(ratio[0]), float(ratio[1])), (float(pad[0]), float(pad[1])))
