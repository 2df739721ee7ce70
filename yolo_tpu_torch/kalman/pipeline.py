"""Detect + track clip pipeline: YOLO detector → multi-target Kalman → overlay.

Counterpart of yolo_tpu/kalman/pipeline.py: the tracker settings of the
original demo (max_lost_frames=150, min_hits=1, iou_threshold=0.1), the
conf > 0.1 detection filter, the state-switch accounting and the title
overlay. Returns the run statistics (the contract: detection / prediction
frame counts + state switches).

`track_clip` is the frame loop over any iterator of frames;
`aircraft_detection_tracking` opens a video file with cv2 (imported there
only) and feeds the loop.
"""

from __future__ import annotations

import os
from pathlib import Path

from yolo_tpu_torch.kalman.multi_tracker import EnhancedMultiTargetTracker


def yolo_detector(yolo, conf_threshold: float, **predict_kwargs):
    """frame → [[x1, y1, x2, y2, conf], ...] through `yolo.predict`, scores above the threshold only."""

    def detector(frame):
        results = yolo.predict(frame, conf=conf_threshold, verbose=False, **predict_kwargs)
        dets = []
        if len(results) > 0 and results[0].boxes is not None:
            for box, score in zip(results[0].boxes.xyxy, results[0].boxes.conf):
                if score > conf_threshold:
                    dets.append([box[0], box[1], box[2], box[3], score])
        return dets

    return detector


def track_clip(frames, detector, tracker, max_frames: int | None = None, total_frames: int = 0, on_frame=None) -> dict:
    """The frame loop: detect, update the tracker, account the state switches.

    frames: an iterator of frames; detector: frame → [[x1, y1, x2, y2, conf], ...];
    tracker: an object with `update(detections) → track dicts` and
    `get_statistics()`. `on_frame(frame, tracks, detections, frame_info)` is
    called after each frame (the video writer hooks in here). → the stats dict."""
    frame_count = detection_frames = prediction_frames = state_changes = 0
    last_states: dict = {}
    for frame in frames:
        if max_frames and frame_count >= max_frames:
            break
        frame_count += 1

        detections = detector(frame)
        tracks = tracker.update(detections)

        current_states = {}
        for track in tracks:
            tid, status = track["track_id"], track["status"]
            current_states[tid] = status
            if tid in last_states and last_states[tid] != status:
                state_changes += 1
                print(f"frame {frame_count}: target {tid} {last_states[tid]} -> {status}")
            if status == "detected":
                detection_frames += 1
            elif status == "predicted":
                prediction_frames += 1
        last_states = current_states

        if on_frame is not None:
            on_frame(frame, tracks, detections, {
                "frame_number": frame_count,
                "detections": len(detections),
                "tracks": len(tracks),
                "detection_frames": detection_frames,
                "prediction_frames": prediction_frames,
                "state_changes": state_changes,
            })

        if frame_count % 50 == 0:
            pct = frame_count / max(total_frames, 1) * 100
            print(f"progress: {pct:.1f}% ({frame_count}/{total_frames})")
            print(f"  detection frames: {detection_frames}, prediction frames: {prediction_frames}")
            print(f"  state changes: {state_changes}")

    stats = {
        "frames": frame_count,
        "detection_frames": detection_frames,
        "prediction_frames": prediction_frames,
        "state_changes": state_changes,
        "tracker": tracker.get_statistics(),
    }
    total_states = detection_frames + prediction_frames
    if total_states:
        print(
            f"done: {frame_count} frames; detected {detection_frames} "
            f"({100 * detection_frames / total_states:.1f}%) / predicted {prediction_frames} "
            f"({100 * prediction_frames / total_states:.1f}%); {state_changes} state switches"
        )
    return stats


def aircraft_detection_tracking(
    video_path,
    model="yolov8-small.yaml",
    output_path=None,
    conf_threshold: float = 0.1,
    max_lost_frames: int = 150,
    min_hits: int = 1,
    iou_threshold: float = 0.1,
    max_frames: int | None = None,
    write_video: bool = True,
    detector=None,
    device=None,
) -> dict:
    """Run the IR small-target detect+track loop over a video.

    Args:
        video_path: input video file.
        model: model source for the YOLO facade (yaml / .npz), or pass
            ``detector``, a callable frame → [[x1, y1, x2, y2, conf], ...], directly.
        output_path: annotated video output (default: tracking_results/<name>_tracked.mp4).
        conf_threshold: detection filter (0.1: small targets score low).
        max_lost_frames / min_hits / iou_threshold: tracker settings (the original demo's values).
        max_frames: optional cap for tests.
        write_video: set False to skip the VideoWriter (benchmarking).
        device: where the YOLO facade runs when no ``detector`` is given: the
            CUDA card by default (raises without one), or "cpu".

    Returns:
        stats dict: frames, detection_frames, prediction_frames, state_changes,
        tracker statistics.
    """
    video_path = str(video_path)
    if not os.path.exists(video_path):
        raise FileNotFoundError(f"video not found: {video_path}")
    import cv2

    if detector is None:
        from yolo_tpu_torch.engine.model import YOLO

        detector = yolo_detector(YOLO(model, device=device).fuse(), conf_threshold)

    tracker = EnhancedMultiTargetTracker(
        max_lost_frames=max_lost_frames, min_hits=min_hits, iou_threshold=iou_threshold
    )

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video: {video_path}")
    out = None
    try:
        fps = int(cap.get(cv2.CAP_PROP_FPS)) or 30
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        print(f"video: {width}x{height}, {fps}fps, {total_frames} frames")

        on_frame = None
        if write_video:
            from yolo_tpu_torch.kalman.visualizer import TrajectoryVisualizer

            visualizer = TrajectoryVisualizer()
            if output_path is None:
                output_path = Path("tracking_results") / f"{Path(video_path).stem}_tracked.mp4"
            Path(output_path).parent.mkdir(parents=True, exist_ok=True)
            out = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))

            def on_frame(frame, tracks, detections, frame_info):
                vis = visualizer.draw_tracks(frame, tracks, detections, frame_info)
                if any(t["status"] == "predicted" for t in tracks):
                    title, color = "AI PREDICTION MODE - Orange Boxes", (0, 165, 255)
                elif any(t["status"] == "detected" for t in tracks):
                    title, color = "DETECTION MODE - Green Boxes", (0, 255, 0)
                else:
                    title, color = "NO TARGETS", (255, 255, 255)
                cv2.putText(vis, title, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1.0, color, 3)
                out.write(vis)

        def frames():
            while True:
                ret, frame = cap.read()
                if not ret:
                    return
                yield frame

        stats = track_clip(frames(), detector, tracker, max_frames, total_frames, on_frame)
    finally:
        cap.release()
        if out is not None:
            out.release()
    if out is not None:
        print(f"wrote {output_path}")
    return stats
