"""Grayscale fallback tracking system (counterpart of yolo_tpu/grayscale/tracker.py).

The detector is the port's `YOLO(model_path, device=device).predict` (the
CUDA card by default, "cpu" on request) unless a `detector` callable is given.
Behavioral parity with the reference system (ref:
Grayscale-Tracking/grayscale_tracking_system.py GrayscaleTracker:72 —
nearest-center (<100 px) association :716-745, *unbounded* lost-target
prediction via the 40×40/5×5 grayscale+gradient scorer :785-890 (never deletes),
bbox size carried from last detection :835-850, optional template matching
(the reference suggests 25×25, which its own NCC search rejects as odd-sided —
see __init__), forced-loss fault-injection test mode :341-346, run dirs
runs/<video>_<ts>/{output-video,process} :120-169, green detected / red
predicted overlay :893).
"""

from __future__ import annotations

import datetime
from collections import defaultdict
from pathlib import Path

import numpy as np

from yolo_tpu_torch.grayscale.scoring import grayscale_similarity_search, predict_center, template_match  # noqa: F401 — template_match kept as API (ref defines it at :381 but never calls it)
from yolo_tpu_torch.utils import LOGGER


class GrayscaleTracker:
    """Detector + grayscale-recovery tracker over a video."""

    def __init__(self, model_path=None, local_grayscale_template=None, save_process: bool = False, detector=None, conf: float = 0.25,
                 device=None):
        """
        Args:
            model_path: model source for the YOLO facade (or pass `detector`).
            local_grayscale_template: optional grayscale template array. Must be
                even-sided to contribute: the reference's stride-2 NCC search
                (ref :644-714) extracts (2*(ts//2))²-sized ROIs, so an odd-sided
                template (e.g. the 25×25 the reference mentions) never matches
                and always scores -1.0 — kept for parity, warned at construction.
            save_process: dump ROI patches / grayscale matrices per prediction.
            detector: callable frame → [[x1,y1,x2,y2,conf,cls], ...] (overrides model).
            device: where the YOLO facade runs: the CUDA card by default (the
                first detection raises without one), or "cpu".
        """
        self._detector = detector
        self._yolo = None
        self.device = device
        self.model_path = model_path
        self.conf = conf
        self.local_grayscale_template = local_grayscale_template
        if local_grayscale_template is not None and (
            np.asarray(local_grayscale_template).shape[0] % 2
            or np.asarray(local_grayscale_template).shape[1] % 2
        ):
            LOGGER.warning(
                "grayscale template has odd side(s): the reference's stride-2 NCC search "
                "skips every candidate for odd templates (scores -1.0), so template "
                "matching will never contribute; use an even-sided template."
            )
        self.save_process = save_process

        self.roi_size = 40
        self.search_radius = 50
        self.min_prediction_confidence = 0.1
        self.dist_threshold = 100.0  # association gate, px (config.ini distance_threshold)

        self.tracks: dict = defaultdict(dict)
        self.track_id_counter = 0
        self.video_fps = 30
        self.test_mode_range = None  # (start, end) forced-empty-detection frames

        self.process_dir = None
        self.roi_patches_dir = None
        self.grayscale_data_dir = None
        LOGGER.info(
            f"grayscale tracking system ready: roi {self.roi_size}x{self.roi_size}, "
            f"min prediction confidence {self.min_prediction_confidence}, unbounded coasting"
        )

    # --- detection -----------------------------------------------------------------

    def yolo_detect(self, frame, frame_id: int):
        """Run the detector; forced-loss test mode returns empty in-range (ref :341-346)."""
        if self.test_mode_range is not None:
            start, end = self.test_mode_range
            if start <= frame_id <= end:
                return []
        if self._detector is not None:
            return self._detector(frame)
        if self._yolo is None:
            from yolo_tpu_torch import YOLO

            self._yolo = YOLO(self.model_path, device=self.device)
            self._yolo.fuse()
        results = self._yolo.predict(frame, conf=self.conf, verbose=False)
        dets = []
        if len(results) and results[0].boxes is not None:
            for row in results[0].boxes.data:
                dets.append([row[0], row[1], row[2], row[3], row[4], row[5]])
        return dets

    @staticmethod
    def calculate_center(x1, y1, x2, y2):
        return (int((x1 + x2) / 2), int((y1 + y2) / 2))

    def extract_roi(self, gray_frame, cx, cy):
        h, w = gray_frame.shape[:2]
        half = self.roi_size // 2
        x1, y1 = max(0, cx - half), max(0, cy - half)
        x2, y2 = min(w, cx + half), min(h, cy + half)
        return gray_frame[y1:y2, x1:x2], (x1, y1, x2, y2)

    # --- association ----------------------------------------------------------------

    def associate_detections(self, detections, frame, frame_id: int, gray=None) -> dict:
        """Nearest-center association (<dist_threshold px) or new-track creation."""
        import cv2

        current = {}
        # one grayscale conversion per frame, not per detection (the reference
        # converts only the ROI crop; full-frame-per-detection was pure waste);
        # process_video passes the shared per-frame conversion in
        if gray is None:
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
        for detection in detections:
            x1, y1, x2, y2, conf, cls = detection
            center = self.calculate_center(x1, y1, x2, y2)
            best_track_id, min_distance = None, float("inf")
            for track_id, info in self.tracks.items():
                if "last_center" in info:
                    lc = info["last_center"]
                    d = float(np.hypot(center[0] - lc[0], center[1] - lc[1]))
                    if d < min_distance and d < self.dist_threshold:
                        min_distance = d
                        best_track_id = track_id
            if best_track_id is None:
                best_track_id = self.track_id_counter
                self.track_id_counter += 1

            roi, _ = self.extract_roi(gray, center[0], center[1])
            self.tracks[best_track_id] = {
                "last_center": center,
                "last_bbox": (x1, y1, x2, y2),
                "last_detection_frame": frame_id,
                "lost_frames": 0,
                "confidence": conf,
                "class_id": cls,
                "status": "detected",
                "last_detection_roi": roi.copy(),
                "last_detection_info": {"center": center, "roi": roi.copy(), "frame_id": frame_id, "confidence": conf},
            }
            current[best_track_id] = self.tracks[best_track_id]
        return current

    # --- lost-target recovery -------------------------------------------------------

    def predict_lost_targets(self, frame, frame_id: int, gray=None) -> dict:
        """Coast lost tracks by grayscale scoring; never deletes (ref :785-890)."""
        import cv2

        predicted = {}
        if gray is None:
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
        for track_id, info in list(self.tracks.items()):
            if info["last_detection_frame"] >= frame_id:
                continue
            lost_frames = frame_id - info["last_detection_frame"]
            current_center = info["last_center"]

            center, score = predict_center(gray, current_center, self.roi_size)
            prediction_type = "gradient"
            if self.local_grayscale_template is not None:
                # the reference's chooser (ref :824-830) overrides the gradient
                # pick with the stride-2 NCC grid search when it scores higher
                t_center, t_score = grayscale_similarity_search(
                    gray, self.local_grayscale_template, current_center, self.search_radius
                )
                if t_score > score:
                    center, score, prediction_type = t_center, t_score, "template"

            if score > self.min_prediction_confidence:
                if "last_bbox" in info:
                    lx1, ly1, lx2, ly2 = info["last_bbox"]
                    w, h = lx2 - lx1, ly2 - ly1
                else:
                    w = h = self.roi_size
                bbox = (center[0] - w // 2, center[1] - h // 2, center[0] + w // 2, center[1] + h // 2)
                if self.save_process and self.process_dir is not None:
                    roi, _ = self.extract_roi(gray, center[0], center[1])
                    self._save_process(frame, track_id, frame_id, center, roi, prediction_type, info.get("last_detection_info"))
                self.tracks[track_id].update(
                    {"last_center": center, "last_bbox": bbox, "lost_frames": lost_frames, "confidence": score, "status": "predicted"}
                )
                predicted[track_id] = self.tracks[track_id]
            else:
                # keep the track alive and retry next frame (unbounded coasting)
                self.tracks[track_id]["lost_frames"] = lost_frames
                self.tracks[track_id]["status"] = "lost_low_confidence"
        return predicted

    def _save_process(self, frame, track_id, frame_id, center, roi, prediction_type, last_detection_info):
        import cv2

        if self.roi_patches_dir:
            cv2.imwrite(str(self.roi_patches_dir / f"t{track_id}_f{frame_id}_{prediction_type}.png"), roi)
        if self.grayscale_data_dir is not None and roi.size:
            np.savetxt(self.grayscale_data_dir / f"t{track_id}_f{frame_id}.txt", roi, fmt="%3d")

    # --- rendering ----------------------------------------------------------------------

    def draw_tracks(self, frame, detected_tracks: dict, predicted_tracks: dict):
        """Green detected / red predicted boxes + labels (ref :893)."""
        import cv2

        vis = frame.copy()
        for track_id, info in detected_tracks.items():
            x1, y1, x2, y2 = [int(v) for v in info["last_bbox"]]
            cv2.rectangle(vis, (x1, y1), (x2, y2), (0, 255, 0), 2)
            cv2.putText(vis, f"T{track_id} {info['confidence']:.2f}", (x1, y1 - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 255, 0), 1)
        for track_id, info in predicted_tracks.items():
            x1, y1, x2, y2 = [int(v) for v in info["last_bbox"]]
            cv2.rectangle(vis, (x1, y1), (x2, y2), (0, 0, 255), 2)
            cv2.putText(
                vis, f"T{track_id} PRED({info['lost_frames']}) {info['confidence']:.2f}", (x1, y1 - 5),
                cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 255), 1,
            )
        return vis

    def create_results_directory(self, video_path):
        """runs/<video>_<timestamp>/{output-video, process} (ref :120-169)."""
        video_name = Path(video_path).stem
        timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        runs_dir = Path("runs") / "grayscale"
        results_dir = runs_dir / f"{video_name}_{timestamp}"
        output_video_dir = results_dir / "output-video"
        process_dir = results_dir / "process"
        output_video_dir.mkdir(parents=True, exist_ok=True)
        process_dir.mkdir(parents=True, exist_ok=True)
        if self.save_process:
            self.process_dir = process_dir
            self.roi_patches_dir = process_dir / "roi_patches"
            self.grayscale_data_dir = process_dir / "grayscale_data"
            self.roi_patches_dir.mkdir(exist_ok=True)
            self.grayscale_data_dir.mkdir(exist_ok=True)
        return results_dir, output_video_dir, process_dir

    # --- main loop ------------------------------------------------------------------------

    def process_video(self, video_path, output_path=None, test_range=None, max_frames=None, write_video: bool = True) -> dict:
        """Full detect→associate→recover loop over a video.

        Args:
            test_range: optional (start, end) frames with forced-empty detections.
        """
        import cv2

        if test_range is not None:
            self.test_mode_range = tuple(test_range)
            LOGGER.info(f"forced-loss test mode: detections suppressed in frames {self.test_mode_range}")

        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open video {video_path}")
        self.video_fps = int(cap.get(cv2.CAP_PROP_FPS)) or 30
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

        out = None
        # the results tree is needed when the output video is unnamed AND for
        # save_process artifacts regardless of output_path (ref:
        # grayscale_tracking_system.py:973 creates it unconditionally)
        results_tree = None
        if (self.save_process and self.process_dir is None) or (write_video and output_path is None):
            results_tree = self.create_results_directory(video_path)
        if write_video:
            if output_path is None:
                _, output_video_dir, _ = results_tree
                output_path = output_video_dir / f"{Path(str(video_path)).stem}_tracked.mp4"
            Path(output_path).parent.mkdir(parents=True, exist_ok=True)
            out = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), self.video_fps, (width, height))

        frame_id = 0
        stats = {"frames": 0, "detected_frames": 0, "predicted_frames": 0, "low_confidence_frames": 0}
        while True:
            ok, frame = cap.read()
            if not ok or (max_frames and frame_id >= max_frames):
                break
            detections = self.yolo_detect(frame, frame_id)
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
            detected = self.associate_detections(detections, frame, frame_id, gray=gray)
            predicted = self.predict_lost_targets(frame, frame_id, gray=gray)
            stats["frames"] += 1
            if detected:
                stats["detected_frames"] += 1
            if predicted:
                stats["predicted_frames"] += 1
            if any(t.get("status") == "lost_low_confidence" for t in self.tracks.values()):
                stats["low_confidence_frames"] += 1
            if out is not None:
                out.write(self.draw_tracks(frame, detected, predicted))
            frame_id += 1

        cap.release()
        if out is not None:
            out.release()
            LOGGER.info(f"wrote {output_path}")
        stats["tracks"] = {k: {kk: v[kk] for kk in ("last_center", "lost_frames", "status")} for k, v in self.tracks.items()}
        return stats


def main(argv=None):
    """CLI: python -m yolo_tpu_torch.grayscale.tracker VIDEO --model M [--test start,end] [--device cpu] (ref :1108)."""
    import argparse

    p = argparse.ArgumentParser(description="grayscale fallback tracking")
    p.add_argument("video")
    p.add_argument("--model", default="yolov8-small.yaml")
    p.add_argument("--test", default=None, help="start,end frames with forced-empty detections")
    p.add_argument("--save-process", action="store_true")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="the CUDA card by default; cpu runs the kernels' plain twins")
    args = p.parse_args(argv)
    test_range = tuple(int(x) for x in args.test.split(",")) if args.test else None
    tracker = GrayscaleTracker(args.model, save_process=args.save_process, conf=args.conf, device=args.device)
    stats = tracker.process_video(args.video, output_path=args.output, test_range=test_range)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
