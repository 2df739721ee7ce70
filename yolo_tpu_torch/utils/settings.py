"""Persisted user settings (counterpart of yolo_tpu/utils/settings.py): the same versioned JSON
dict at ``$YOLO_TPU_CONFIG_DIR/settings.json`` (default ``~/.config/yolo_tpu``) with the same
defaults, so one file drives both packages. A schema-version mismatch or a corrupt file resets
it to the defaults. The port reads the integration flags from it (utils/integrations.py);
`datasets_dir` and `runs_dir` are not read by the port yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from pathlib import Path

from yolo_tpu_torch.utils import LOGGER

SETTINGS_VERSION = "0.0.6"


def settings_file() -> Path:
    return Path(os.getenv("YOLO_TPU_CONFIG_DIR", Path.home() / ".config" / "yolo_tpu")) / "settings.json"


def _defaults() -> dict:
    return {
        "settings_version": SETTINGS_VERSION,
        "datasets_dir": "datasets",
        "weights_dir": "weights",
        "runs_dir": "runs",
        "uuid": hashlib.sha256(str(uuid.getnode()).encode()).hexdigest(),
        "sync": True,
        "api_key": "",
        "clearml": True,
        "comet": True,
        "dvc": True,
        "hub": True,
        "mlflow": True,
        "neptune": True,
        "raytune": True,
        "tensorboard": False,
        "wandb": False,
    }


class SettingsManager(dict):
    """Dict-backed settings, saved on every update and checked against the schema."""

    def __init__(self, file: Path | None = None, version: str = SETTINGS_VERSION):
        super().__init__()
        self.file = Path(file if file is not None else settings_file())
        self.version = version
        self.defaults = _defaults()
        super().update(self.defaults)
        try:
            if self.file.is_file():
                stored = json.loads(self.file.read_text())
                if not isinstance(stored, dict):
                    raise ValueError("settings root is not an object")
                self.update({k: v for k, v in stored.items() if k in self.defaults})
            else:
                self.save()
        except Exception as e:  # a corrupt file is reset
            LOGGER.warning(f"settings file unreadable ({e}); resetting to defaults")
            self.reset()
        self._validate()

    def _validate(self) -> None:
        if self.get("settings_version") != self.version or set(self) != set(self.defaults):
            LOGGER.warning("settings schema changed — resetting to defaults")
            keep = {k: self[k] for k in ("datasets_dir", "weights_dir", "runs_dir") if k in self}
            self.reset()
            self.update(keep)
            self.save()

    def save(self) -> None:
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(json.dumps(dict(self), indent=2))

    def update(self, *args, **kwargs) -> None:
        """Update known keys and save (KeyError for an unknown one)."""
        new = dict(*args, **kwargs)
        unknown = {k for k in new if k not in self.defaults} if self.defaults else set()
        if unknown:
            raise KeyError(f"unknown settings key(s) {sorted(unknown)}; valid: {sorted(self.defaults)}")
        super().update(new)
        if self.defaults and new:
            self.save()

    def reset(self) -> None:
        self.clear()
        super().update(self.defaults)
        self.save()


_SETTINGS: SettingsManager | None = None


def get_settings() -> SettingsManager:
    """The process's settings, read (or written with the defaults) at the first call."""
    global _SETTINGS
    if _SETTINGS is None:
        _SETTINGS = SettingsManager()
    return _SETTINGS
