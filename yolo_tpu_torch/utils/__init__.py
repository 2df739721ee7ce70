"""The port's logger and `yaml_save` (counterpart of `LOGGER` and `yaml_save` in
yolo_tpu/utils/__init__.py): INFO and above to stdout as plain messages, as the JAX
package's logger writes them. Nothing else of that module is ported."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import numpy as np

LOGGER = logging.getLogger("yolo_tpu_torch")
if not LOGGER.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_handler)
LOGGER.setLevel(logging.INFO)
LOGGER.propagate = False


def yaml_save(file, data: dict | None = None, header: str = "") -> None:
    """Write a dict as YAML, paths and numpy scalars converted and other objects as strings."""
    import yaml

    clean = {}
    for k, v in (data or {}).items():
        if isinstance(v, Path):
            v = str(v)
        elif isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif v is not None and not isinstance(v, (bool, int, float, str, list, dict, tuple)):
            v = str(v)
        clean[k] = v
    path = Path(file)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", errors="ignore", encoding="utf-8") as f:
        if header:
            f.write(header)
        yaml.safe_dump(clean, f, sort_keys=False, allow_unicode=True)
