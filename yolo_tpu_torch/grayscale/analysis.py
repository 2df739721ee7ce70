"""ROI-center estimation method comparison + loss-event capture tools
(counterpart of yolo_tpu/grayscale/analysis.py; host numpy and cv2).

Re-implements the reference analysis utilities (ref:
Grayscale-Tracking/roi_analysis_comparison.py:16-30 — 8 ROI-center methods
A/B-tested; target_loss_gradient_analyzer.py; basic_yolo_target_loss_test.py
— save 25×25 patches after N lost frames).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def center_max_value(roi):
    """Method 1: position of the max gray value."""
    y, x = np.unravel_index(int(np.argmax(roi)), roi.shape)
    return (int(x), int(y))


def center_mean_window(roi, win: int = 5):
    """Method 2: center of the win×win window with max mean gray."""
    w = np.lib.stride_tricks.sliding_window_view(roi.astype(np.float32), (win, win))
    means = w.mean(axis=(-2, -1))
    iy, ix = np.unravel_index(int(np.argmax(means)), means.shape)
    return (int(ix + win // 2), int(iy + win // 2))


def center_weighted_centroid(roi):
    """Method 3: intensity-weighted centroid."""
    r = roi.astype(np.float64)
    total = r.sum() + 1e-9
    ys, xs = np.mgrid[0 : roi.shape[0], 0 : roi.shape[1]]
    return (int((xs * r).sum() / total), int((ys * r).sum() / total))


def center_gradient_magnitude(roi):
    """Method 4: max of Sobel gradient magnitude."""
    import cv2

    gx = cv2.Sobel(roi.astype(np.float32), cv2.CV_64F, 1, 0, ksize=3)
    gy = cv2.Sobel(roi.astype(np.float32), cv2.CV_64F, 0, 1, ksize=3)
    mag = np.sqrt(gx**2 + gy**2)
    y, x = np.unravel_index(int(np.argmax(mag)), mag.shape)
    return (int(x), int(y))


def center_local_contrast(roi, win: int = 7):
    """Method 5: max local contrast (value − neighborhood mean)."""
    import cv2

    blur = cv2.blur(roi.astype(np.float32), (win, win))
    contrast = roi.astype(np.float32) - blur
    y, x = np.unravel_index(int(np.argmax(contrast)), contrast.shape)
    return (int(x), int(y))


def center_variance(roi, win: int = 5):
    """Method 6: center of max local variance window."""
    w = np.lib.stride_tricks.sliding_window_view(roi.astype(np.float32), (win, win))
    var = w.var(axis=(-2, -1))
    iy, ix = np.unravel_index(int(np.argmax(var)), var.shape)
    return (int(ix + win // 2), int(iy + win // 2))


def center_temperature_cluster(roi, percentile: float = 95):
    """Method 7: centroid of the hottest-percentile pixel cluster."""
    thr = np.percentile(roi, percentile)
    mask = roi >= thr
    if not mask.any():
        return center_max_value(roi)
    ys, xs = np.nonzero(mask)
    return (int(xs.mean()), int(ys.mean()))


def center_edge_density(roi, win: int = 5):
    """Method 8: center of max Canny-edge density window."""
    import cv2

    edges = cv2.Canny(roi.astype(np.uint8), 50, 150).astype(np.float32)
    w = np.lib.stride_tricks.sliding_window_view(edges, (win, win))
    dens = w.mean(axis=(-2, -1))
    if dens.max() == 0:
        return center_max_value(roi)
    iy, ix = np.unravel_index(int(np.argmax(dens)), dens.shape)
    return (int(ix + win // 2), int(iy + win // 2))


ROI_METHODS = {
    "max_value": center_max_value,
    "mean_window": center_mean_window,
    "weighted_centroid": center_weighted_centroid,
    "gradient_magnitude": center_gradient_magnitude,
    "local_contrast": center_local_contrast,
    "variance": center_variance,
    "temperature_cluster": center_temperature_cluster,
    "edge_density": center_edge_density,
}


def roi_analysis_comparison(rois: list[np.ndarray], true_centers: list | None = None, report_path=None) -> dict:
    """A/B-compare all 8 center estimators over a set of ROIs.

    Returns {method: {'centers': [...], 'mean_error': float|None}} and writes an
    optional text report (the reference's roi_analysis_results.txt pattern).
    """
    results = {}
    for name, fn in ROI_METHODS.items():
        centers = [fn(roi) for roi in rois]
        err = None
        if true_centers is not None:
            errs = [float(np.hypot(c[0] - t[0], c[1] - t[1])) for c, t in zip(centers, true_centers)]
            err = float(np.mean(errs))
        results[name] = {"centers": centers, "mean_error": err}
    if report_path:
        lines = ["ROI center-estimation comparison", "=" * 40]
        ranked = sorted(results.items(), key=lambda kv: kv[1]["mean_error"] if kv[1]["mean_error"] is not None else 1e9)
        for name, r in ranked:
            lines.append(f"{name:>22}: mean error {r['mean_error'] if r['mean_error'] is not None else 'n/a'}")
        Path(report_path).parent.mkdir(parents=True, exist_ok=True)
        Path(report_path).write_text("\n".join(lines) + "\n")
    return results


class LossEventCapturer:
    """Save patches around the last known center after N consecutive lost frames
    (ref: basic_yolo_target_loss_test.py — 25×25 patches after 5 lost frames)."""

    def __init__(self, out_dir, patch: int = 25, lost_threshold: int = 5):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.patch = patch
        self.lost_threshold = lost_threshold
        self.lost_streak = 0
        self.last_center = None
        self.captured = []

    def step(self, frame_gray: np.ndarray, detections, frame_id: int):
        """detections: list of (cx, cy) or [] — call per frame."""
        import cv2

        if detections:
            self.last_center = detections[0]
            self.lost_streak = 0
            return None
        self.lost_streak += 1
        if self.lost_streak >= self.lost_threshold and self.last_center is not None:
            cx, cy = int(self.last_center[0]), int(self.last_center[1])
            half = self.patch // 2
            h, w = frame_gray.shape[:2]
            x1, y1 = max(0, cx - half), max(0, cy - half)
            x2, y2 = min(w, cx + half + 1), min(h, cy + half + 1)
            patch = frame_gray[y1:y2, x1:x2]
            path = self.out_dir / f"loss_f{frame_id}_s{self.lost_streak}.png"
            cv2.imwrite(str(path), patch)
            self.captured.append(str(path))
            return patch
        return None
