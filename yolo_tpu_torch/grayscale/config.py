"""INI config for the grayscale tracking system (counterpart of
yolo_tpu/grayscale/config.py; ref: Grayscale-Tracking/config.ini:1-77).

Same sections/keys; values overlay the GrayscaleTracker defaults.
"""

from __future__ import annotations

import configparser
from pathlib import Path

DEFAULTS = {
    "TRACKING_PARAMETERS": {
        "max_lost_frames": 5,
        "roi_size": 40,
        "search_radius": 50,
        "similarity_threshold": 0.3,
        "distance_threshold": 100,
    },
    "MODEL_SETTINGS": {
        "model_path": "yolov8-small.yaml",
        "use_gpu": True,  # the reference's switch; the port runs on the CUDA card unless `device` names the CPU
        "detection_threshold": 0.25,
    },
    "VIDEO_SETTINGS": {
        "output_codec": "mp4v",
        "keep_original_fps": True,
        "progress_interval": 30,
    },
    "VISUALIZATION": {
        "show_confidence": True,
        "show_lost_frames": True,
    },
}


def load_config(path=None) -> dict:
    """Parse an INI config into a typed nested dict (defaults filled in)."""
    cfg = {k: dict(v) for k, v in DEFAULTS.items()}
    if path and Path(path).exists():
        parser = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        parser.read(path, encoding="utf-8")
        for section in parser.sections():
            for key, raw in parser[section].items():
                default = cfg.get(section, {}).get(key)
                if isinstance(default, bool):
                    val = raw.strip().lower() in ("1", "true", "yes", "on")
                elif isinstance(default, int):
                    val = int(float(raw))
                elif isinstance(default, float):
                    val = float(raw)
                else:
                    try:
                        val = float(raw) if "." in raw else int(raw)
                    except ValueError:
                        val = raw.strip()
                cfg.setdefault(section, {})[key] = val
    return cfg


def tracker_from_config(path=None, detector=None, device=None):
    """Build a GrayscaleTracker from an INI file; `device` reaches the YOLO facade
    (the CUDA card by default, "cpu" on request)."""
    from yolo_tpu_torch.grayscale.tracker import GrayscaleTracker

    cfg = load_config(path)
    t = GrayscaleTracker(
        model_path=cfg["MODEL_SETTINGS"]["model_path"],
        conf=float(cfg["MODEL_SETTINGS"]["detection_threshold"]),
        detector=detector,
        device=device,
    )
    t.roi_size = int(cfg["TRACKING_PARAMETERS"]["roi_size"])
    t.search_radius = int(cfg["TRACKING_PARAMETERS"]["search_radius"])
    t.min_prediction_confidence = float(cfg["TRACKING_PARAMETERS"]["similarity_threshold"])
    t.dist_threshold = float(cfg["TRACKING_PARAMETERS"]["distance_threshold"])
    # max_lost_frames is listed in the reference config.ini but read by NO
    # reference code — the tracker never deletes tracks (unbounded coasting);
    # kept unwired on purpose for parity
    return t
