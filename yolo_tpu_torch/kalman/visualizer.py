"""Trajectory visualizer: thin-line state-coded overlay for small IR targets.

The port's own copy of yolo_tpu/kalman/visualizer.py: green boxes for
detected tracks, flashing orange for predicted ones, a fading 20-point yellow
trail, a magenta velocity arrow, a HUD and a legend. Host side; cv2 is
imported when an object is made, so the module imports without it.
"""

from __future__ import annotations

import numpy as np


class TrajectoryVisualizer:
    """Draw detected (green) vs predicted (flashing orange) tracks + trails."""

    def __init__(self, colors: dict | None = None):
        self.colors = colors or {
            "detected": (0, 255, 0),  # green: live detection
            "predicted": (0, 165, 255),  # orange: Kalman prediction
            "lost": (0, 100, 255),  # deep orange: long-term loss
            "trajectory": (255, 255, 0),  # yellow trail
            "velocity": (255, 0, 255),  # magenta velocity arrow
            "text": (255, 255, 255),
            "background": (0, 0, 0),
        }
        self.trajectory_length = 20
        self.velocity_scale = 5.0
        import cv2

        self.font = cv2.FONT_HERSHEY_SIMPLEX
        self.font_scale = 0.4  # small fonts so tiny targets stay visible
        self.font_thickness = 1
        self.frame_counter = 0

    def draw_tracks(self, image, tracks, detections=None, frame_info=None):
        """Render all tracks (and optional raw detections / HUD) onto a copy."""
        vis = image.copy()
        self.frame_counter += 1
        if detections:
            self._draw_detections(vis, detections)
        for track in tracks:
            self._draw_single_track(vis, track)
        if frame_info:
            self._draw_frame_info(vis, frame_info, tracks, detections)
        self._draw_legend(vis)
        return vis

    def _draw_detections(self, image, detections):
        import cv2

        for det in detections:
            if len(det) >= 5:
                x1, y1, x2, y2 = map(int, det[:4])
                cv2.rectangle(image, (x1, y1), (x2, y2), self.colors["detected"], 1)
                cv2.putText(image, f"Det: {det[4]:.2f}", (x1, y1 - 5), self.font, 0.3, self.colors["detected"], 1)

    def _draw_single_track(self, image, track):
        import cv2

        bbox = track["bbox"]
        track_id = str(track["track_id"])
        status = track.get("status", "detected")
        tsu = int(track.get("time_since_update", 0))
        confidence = float(track.get("confidence", 1.0))
        trajectory = track.get("trajectory", [])
        velocity = track.get("velocity", (0, 0))
        x1, y1, x2, y2 = [int(float(c)) for c in bbox[:4]]

        if status == "predicted":
            # flash between bright/base orange every 6 frames
            if (self.frame_counter // 6) % 2 == 0:
                color, thickness = (0, 220, 255), 2
            else:
                color, thickness = self.colors["predicted"], 1
            cv2.rectangle(image, (x1, y1), (x2, y2), color, thickness)
            overlay = image.copy()
            cv2.rectangle(overlay, (x1, y1), (x2, y2), color, -1)
            cv2.addWeighted(overlay, 0.3, image, 0.7, 0, image)
            self._draw_label(image, f"ID:{track_id} PRED({tsu})", x1, y1, x2, y2, color)
            self._draw_status_text(image, "AI PREDICTION", x2, y1, color)
        else:
            color = self.colors["detected"]
            cv2.rectangle(image, (x1, y1), (x2, y2), color, 1)
            self._draw_label(image, f"ID:{track_id} TRACKING", x1, y1, x2, y2, color)
            self._draw_status_text(image, "DETECTED", x2, y1, color)

        cv2.putText(image, f"Conf: {confidence:.2f}", (x2 + 10, y2 + 10), self.font, 0.3, self.colors["text"], 1)

        trail_color = self.colors["predicted"] if status == "predicted" else self.colors["detected"]
        self._draw_trajectory(image, trajectory, trail_color)
        vx, vy = velocity
        if float(np.hypot(vx, vy)) > 1.0:
            self._draw_velocity_vector(image, bbox, velocity)

    def _draw_label(self, image, label, x1, y1, x2, y2, color):
        import cv2

        size = cv2.getTextSize(label, self.font, self.font_scale, self.font_thickness)[0]
        lx, ly = x2 + 15, y1 - 5  # offset right of the box so tiny targets stay clear
        cv2.rectangle(image, (lx - 2, ly - size[1] - 2), (lx + size[0] + 2, ly + 2), color, -1)
        cv2.putText(image, label, (lx, ly), self.font, self.font_scale, self.colors["text"], self.font_thickness)

    def _draw_status_text(self, image, text, x2, y1, color):
        import cv2

        scale, thick = 0.35, 1
        size = cv2.getTextSize(text, self.font, scale, thick)[0]
        tx, ty = x2 + 20, y1 + 15
        h, w = image.shape[:2]
        if tx + size[0] > w:
            tx = x2 - size[0] - 20
        if ty > h:
            ty = y1 - 10
        cv2.rectangle(image, (tx - 2, ty - size[1] - 2), (tx + size[0] + 2, ty + 2), color, -1)
        cv2.putText(image, text, (tx, ty), self.font, scale, (255, 255, 255), thick)

    def _draw_trajectory(self, image, trajectory, color):
        import cv2

        if len(trajectory) < 2:
            return
        pts = np.asarray(trajectory[-self.trajectory_length :], dtype=np.int32)
        for i in range(1, len(pts)):
            alpha = i / len(pts)
            cv2.line(image, tuple(pts[i - 1]), tuple(pts[i]), self.colors["trajectory"], max(1, int(3 * alpha)))

    def _draw_velocity_vector(self, image, bbox, velocity):
        import cv2

        cx = int((bbox[0] + bbox[2]) / 2)
        cy = int((bbox[1] + bbox[3]) / 2)
        ex = int(cx + velocity[0] * self.velocity_scale)
        ey = int(cy + velocity[1] * self.velocity_scale)
        cv2.arrowedLine(image, (cx, cy), (ex, ey), self.colors["velocity"], 2, tipLength=0.3)

    def _draw_frame_info(self, image, frame_info, tracks, detections):
        import cv2

        detected = sum(1 for t in tracks if t.get("status") == "detected")
        predicted = sum(1 for t in tracks if t.get("status") == "predicted")
        lines = [
            f"Frame: {frame_info.get('frame_number', 0)}",
            f"Detections: {len(detections) if detections else 0}",
            f"Tracking (Green): {detected}",
            f"Predicting (Orange): {predicted}",
        ]
        if "state_changes" in frame_info:
            lines.append(f"State Changes: {frame_info['state_changes']}")
        for i, text in enumerate(lines):
            cv2.putText(image, text, (10, 30 + i * 25), self.font, 0.6, self.colors["text"], 2)

    def _draw_legend(self, image):
        import cv2

        h, w = image.shape[:2]
        lx, ly = w - 220, h - 100
        cv2.rectangle(image, (lx - 10, ly - 10), (w - 10, h - 10), self.colors["background"], -1)
        cv2.rectangle(image, (lx - 10, ly - 10), (w - 10, h - 10), self.colors["text"], 2)
        cv2.putText(image, "Status Legend", (lx, ly - 5), self.font, 0.6, self.colors["text"], 2)
        for i, (label, color) in enumerate(
            [
                ("Green = Detection", self.colors["detected"]),
                ("Orange = Prediction", self.colors["predicted"]),
                ("Yellow = Trail", self.colors["trajectory"]),
            ]
        ):
            y = ly + 15 + i * 20
            cv2.rectangle(image, (lx, y), (lx + 15, y + 15), color, -1)
            cv2.putText(image, label, (lx + 25, y + 12), self.font, 0.45, self.colors["text"], 1)
