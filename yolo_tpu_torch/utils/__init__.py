"""The port's logger (counterpart of `LOGGER` in yolo_tpu/utils/__init__.py): INFO and above
to stdout as plain messages, as the JAX package's logger writes them. Nothing else of that
module is ported."""

from __future__ import annotations

import logging
import sys

LOGGER = logging.getLogger("yolo_tpu_torch")
if not LOGGER.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_handler)
LOGGER.setLevel(logging.INFO)
LOGGER.propagate = False
