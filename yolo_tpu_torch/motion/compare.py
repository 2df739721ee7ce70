"""Motion-compensation method comparison (counterpart of yolo_tpu/motion/compare.py).

Runs the motion-compensated tracker with each motion-detection method over the
same video, records frames/s and resets, and writes the reference's
comparison report (ref: camera_motion_compensation/test_motion_compensation.py
:20-313). The detector is any callable frame → [[x1, y1, x2, y2, conf], ...],
for example `kalman/pipeline.py::yolo_detector` over the port's YOLO on the card.
"""

from __future__ import annotations

import contextlib
import io
import time
from pathlib import Path

from yolo_tpu_torch.motion.motion_compensated_tracker import MotionCompensatedMultiTracker
from yolo_tpu_torch.utils import LOGGER

METHODS = ("optical_flow", "feature_matching", "hybrid")


def compare_motion_methods(video_path, detector, methods=METHODS, max_frames: int | None = None, report_path=None) -> dict:
    """Run each motion method over the clip; returns per-method stats + recommendation.

    Args:
        detector: callable frame → [[x1,y1,x2,y2,conf], ...].
    """
    import cv2

    results = {}
    for method in methods:
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open {video_path}")
        tracker = MotionCompensatedMultiTracker(
            max_lost_frames=150, min_hits=1, iou_threshold=0.1, motion_detection_method=method
        )
        frames = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            while True:
                ok, frame = cap.read()
                if not ok or (max_frames and frames >= max_frames):
                    break
                tracker.update(detector(frame), frame)
                frames += 1
        dt = time.perf_counter() - t0
        cap.release()
        stats = tracker.get_comprehensive_stats()
        results[method] = {
            "frames": frames,
            "fps": frames / dt if dt > 0 else 0.0,
            "ms_per_frame": dt / max(frames, 1) * 1e3,
            "global_motion_events": stats["basic"]["global_motion_events"],
            "global_resets": stats["basic"]["global_resets"],
            "individual_resets": stats["basic"]["individual_resets"],
            "motion_detection": stats["motion_detection"],
        }
        LOGGER.info(f"{method}: {results[method]['fps']:.1f} FPS ({results[method]['ms_per_frame']:.2f} ms/frame)")

    recommended = max(results, key=lambda m: results[m]["fps"])
    report = _format_report(results, recommended)
    if report_path:
        Path(report_path).parent.mkdir(parents=True, exist_ok=True)
        Path(report_path).write_text(report)
        LOGGER.info(f"wrote {report_path}")
    return {"results": results, "recommended": recommended, "report": report}


def _format_report(results: dict, recommended: str) -> str:
    lines = ["Motion compensation method comparison", "=" * 45, ""]
    for method, r in results.items():
        lines += [
            f"[{method}]",
            f"  frames processed : {r['frames']}",
            f"  throughput       : {r['fps']:.1f} FPS ({r['ms_per_frame']:.2f} ms/frame)",
            f"  motion events    : {r['global_motion_events']}",
            f"  global resets    : {r['global_resets']}",
            f"  individual resets: {r['individual_resets']}",
            "",
        ]
    lines += [f"Recommended method: {recommended} (highest throughput)", ""]
    return "\n".join(lines)
