"""Single-target IR tracker: a 4-state constant-velocity Kalman filter, a direction prior and
the classical fallback detector (counterpart of yolo_tpu/otherplan/single_target.py).

KalmanCV2D: Δt from the fps, Q = diag([1, 1, 5, 5]²), R = diag([3, 3]²), P0 = 100·I, initial
velocity (-5, 0). IRSmallTargetTracker.step: 50 px gating, a detection taken anyway after 3
misses, the right→left direction prior (gain 0.6), a predict after each update for the drawn
position, a stop after 30 coasted frames; one CSV row a frame. Numpy and cv2 on the host.
"""

from __future__ import annotations

import csv
import math
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from yolo_tpu_torch.otherplan.classical import ASPECT_TOL, MAX_AREA_RATIO, MIN_AREA_RATIO, classical_detect

YOLO_CONF_THR = 0.15
YOLO_IOU_THR = 0.45
MAX_COAST = 30
PROC_NOISE_POS = 1.0
PROC_NOISE_VEL = 5.0
MEAS_NOISE_POS = 3.0
GATE_DIST_PX = 50.0
DIR_PRIOR_GAIN = 0.6
TRACE_LEN = 100


@dataclass
class Detection:
    x1: int
    y1: int
    x2: int
    y2: int
    conf: float
    source: str  # 'yolo' | 'classical'

    @property
    def cx(self):
        return 0.5 * (self.x1 + self.x2)

    @property
    def cy(self):
        return 0.5 * (self.y1 + self.y2)


class KalmanCV2D:
    """Constant-velocity 2D Kalman: state [cx, cy, vx, vy]."""

    def __init__(self, dt: float, proc_pos=PROC_NOISE_POS, proc_vel=PROC_NOISE_VEL, meas_pos=MEAS_NOISE_POS):
        self.dt = dt
        self.F = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        q = np.array([proc_pos, proc_pos, proc_vel, proc_vel], np.float32)
        self.Q = np.diag(q * q)
        r = np.array([meas_pos, meas_pos], np.float32)
        self.R = np.diag(r * r)
        self.H = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
        self.x = None
        self.P = None

    def init(self, cx, cy, init_vel=(-5.0, 0.0)):
        # a small leftward prior velocity (targets fly right→left in the IR clips)
        self.x = np.array([cx, cy, init_vel[0], init_vel[1]], np.float32)
        self.P = np.eye(4, dtype=np.float32) * 100.0

    def predict(self):
        if self.x is None:
            return None
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.x.copy()

    def update(self, zcx, zcy):
        if self.x is None:
            self.init(zcx, zcy)
        z = np.array([zcx, zcy], np.float32)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(4, dtype=np.float32) - K @ self.H) @ self.P
        return self.x.copy()

    @property
    def state(self):
        return None if self.x is None else self.x.copy()


class IRSmallTargetTracker:
    """Single-target detect→gate→Kalman loop with classical fallback."""

    def __init__(self, fps: float = 25.0, detector=None, csv_path=None):
        """
        Args:
            detector: callable frame_bgr → [[x1,y1,x2,y2,conf], ...] (or None for
                classical-only).
            csv_path: optional trajectory CSV output.
        """
        self.detector = detector
        self.kf: KalmanCV2D | None = None
        self.last_det: Detection | None = None
        self.miss_cnt = 0
        self.trace = deque(maxlen=TRACE_LEN)
        self.fps = fps or 25.0
        self.dt = 1.0 / max(1e-6, self.fps)
        self.frame_idx = 0
        self.csv_writer = None
        self._csv_file = None
        if csv_path:
            Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
            self._csv_file = open(csv_path, "w", newline="")
            self.csv_writer = csv.writer(self._csv_file)
            self.csv_writer.writerow(["frame", "t", "mode", "conf", "source", "det_cx", "det_cy", "kf_cx", "kf_cy", "miss"])

    def direction_score(self, prev_cx, new_cx) -> float:
        """Right→left prior: moving left scores >1, right <1."""
        if prev_cx is None:
            return 1.0
        dx = new_cx - prev_cx
        return 1.0 + (0.3 if dx < 0 else -0.3) * DIR_PRIOR_GAIN

    def pick_detection(self, frame_bgr, gray, prev_cx) -> Detection | None:
        H, W = gray.shape
        cands = []
        if self.detector is not None:
            for d in self.detector(frame_bgr):
                x1, y1, x2, y2, conf = d[:5]
                w, h = x2 - x1, y2 - y1
                if w <= 0 or h <= 0:
                    continue
                if min(w, h) / max(w, h) < ASPECT_TOL:
                    continue
                area = w * h
                if area < MIN_AREA_RATIO * W * H or area > MAX_AREA_RATIO * W * H:
                    continue
                ds = self.direction_score(prev_cx, 0.5 * (x1 + x2))
                cands.append(Detection(int(x1), int(y1), int(x2), int(y2), conf * ds, "yolo"))
        if len(cands) == 0:
            for x1, y1, x2, y2, score in classical_detect(gray, gray.shape):
                ds = self.direction_score(prev_cx, 0.5 * (x1 + x2))
                cands.append(Detection(x1, y1, x2, y2, float(score / 255.0) * ds, "classical"))
        if not cands:
            return None
        cands.sort(key=lambda d: d.conf, reverse=True)
        return cands[0]

    def step(self, frame_bgr, vis: np.ndarray | None = None) -> bool:
        """One frame. Returns False when the coast limit is exceeded (stop)."""
        import cv2

        gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY) if frame_bgr.ndim == 3 else frame_bgr
        prev_cx = self.last_det.cx if self.last_det is not None else None
        det = self.pick_detection(frame_bgr, gray, prev_cx)

        mode, used_det = "predict", False
        if det is not None:
            if self.kf is not None and self.kf.state is not None:
                px, py, _, _ = self.kf.state
                dist = math.hypot(det.cx - px, det.cy - py)
                if dist <= GATE_DIST_PX or self.miss_cnt >= 3:
                    self.kf.update(det.cx, det.cy)
                    mode, used_det = "detect", True
                    self.miss_cnt = 0
                else:
                    self.kf.predict()
                    self.miss_cnt += 1
            else:
                self.kf = KalmanCV2D(self.dt)
                self.kf.init(det.cx, det.cy)
                mode, used_det = "detect", True
                self.miss_cnt = 0
        else:
            if self.kf is not None:
                self.kf.predict()
            self.miss_cnt += 1

        if self.kf is not None and used_det:
            self.kf.predict()  # post-update predict for a smoother drawn position

        draw_cx = draw_cy = None
        if self.kf is not None and self.kf.state is not None:
            cx, cy, _, _ = self.kf.state
            draw_cx, draw_cy = int(cx), int(cy)
            self.trace.append((draw_cx, draw_cy))

        if vis is not None and det is not None:
            color = (0, 255, 0) if used_det else (0, 180, 255)
            cv2.rectangle(vis, (det.x1, det.y1), (det.x2, det.y2), color, 2)
        if vis is not None and draw_cx is not None:
            cv2.circle(vis, (draw_cx, draw_cy), 4, (0, 0, 255), -1)

        if self.csv_writer is not None:
            t = self.frame_idx / max(1e-6, self.fps)
            self.csv_writer.writerow(
                [
                    self.frame_idx, f"{t:.3f}", mode, f"{det.conf:.3f}" if det else "0.000",
                    det.source if det else "none",
                    int(det.cx) if det else -1, int(det.cy) if det else -1,
                    draw_cx if draw_cx is not None else -1, draw_cy if draw_cy is not None else -1,
                    self.miss_cnt,
                ]
            )

        if self.miss_cnt > MAX_COAST:
            return False
        self.last_det = det if used_det else self.last_det
        self.frame_idx += 1
        return True

    def close(self):
        if self._csv_file:
            self._csv_file.close()


def run_single_target_tracking(video_path, detector=None, output_video=None, csv_path=None, max_frames=None) -> dict:
    """The tracker over a video (cv2 decode; `output_video` gets the drawn frames, `csv_path`
    the trajectory rows) → {frames, stopped_early, miss_cnt, trace_len}."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = None
    if output_video:
        Path(output_video).parent.mkdir(parents=True, exist_ok=True)
        writer = cv2.VideoWriter(str(output_video), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    tracker = IRSmallTargetTracker(fps=fps, detector=detector, csv_path=csv_path)
    frames = 0
    stopped_early = False
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and frames >= max_frames):
            break
        vis = frame.copy() if writer is not None else None
        alive = tracker.step(frame, vis)
        if writer is not None:
            writer.write(vis)
        frames += 1
        if not alive:
            stopped_early = True
            break
    cap.release()
    if writer is not None:
        writer.release()
    tracker.close()
    return {"frames": frames, "stopped_early": stopped_early, "miss_cnt": tracker.miss_cnt, "trace_len": len(tracker.trace)}
