"""Image reading and writing that take any path, and run-directory numbering (counterpart
of `imread`, `imwrite` and `increment_path` in yolo_tpu/utils/files.py; nothing else of
it is ported). cv2 is imported only to decode and encode."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def imread(filename, flags=None):
    """cv2.imread for any path, non-ASCII ones included: the bytes are read by numpy
    and decoded by cv2 → the BGR image, or None when the file is missing, empty or undecodable."""
    import cv2

    flags = cv2.IMREAD_COLOR if flags is None else flags
    try:
        buf = np.fromfile(str(filename), np.uint8)
    except OSError:
        return None
    if buf.size == 0:
        return None
    return cv2.imdecode(buf, flags)


def imwrite(filename, img, params=None) -> bool:
    """cv2.imwrite for any path, non-ASCII ones included: cv2 encodes by the suffix (PNG without
    one) and numpy writes the bytes → whether the file was written."""
    import cv2

    try:
        ok, buf = cv2.imencode(Path(str(filename)).suffix or ".png", img, params or [])
        if not ok:
            return False
        buf.tofile(str(filename))
        return True
    except (cv2.error, OSError):
        return False


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/val → runs/val2, runs/val3, ... (the first that does not exist), unless `exist_ok`."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 10_000):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path
