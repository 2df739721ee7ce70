"""TensorBoard callbacks (counterpart of yolo_tpu/utils/tb_logger.py): each epoch's validation
metrics as scalars `metrics/<name>` at step `epoch` under save_dir/tb, through
torch.utils.tensorboard's SummaryWriter where it imports, else an events.jsonl writer."""

from __future__ import annotations

import json
import time
from pathlib import Path

_writers: dict = {}  # one writer per log directory


class JsonlWriter:
    """One JSON line per scalar: {"t", "tag", "value", "step"}."""

    def __init__(self, log_dir):
        self.path = Path(log_dir) / "events.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def add_scalar(self, tag, value, step):
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def flush(self):
        pass


def _get_writer(log_dir):
    key = str(log_dir)
    if key not in _writers:
        try:
            from torch.utils.tensorboard import SummaryWriter

            _writers[key] = SummaryWriter(key)
        except Exception:  # no tensorboard package: the JSONL log
            _writers[key] = JsonlWriter(log_dir)
    return _writers[key]


def on_fit_epoch_end(trainer):
    w = _get_writer(trainer.save_dir / "tb")
    for k, v in (trainer.metrics or {}).items():
        w.add_scalar(f"metrics/{k}", v, trainer.epoch)
    w.flush()


def on_train_end(trainer):
    _get_writer(trainer.save_dir / "tb").flush()


callbacks = {"on_fit_epoch_end": on_fit_epoch_end, "on_train_end": on_train_end}
