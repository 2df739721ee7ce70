"""Detector-only video loop (counterpart of yolo_tpu/otherplan/detect_only.py): detect each
frame, draw, write, count."""

from __future__ import annotations

from pathlib import Path

from yolo_tpu_torch.utils import LOGGER


def detect_only(video_path, model="yolov8-small.yaml", conf: float = 0.15, imgsz: int = 640, output_video=None,
                max_frames=None, detector=None, fast: bool = False, device=None) -> dict:
    """Detect over a video → {frames, frames_with_detections, total_detections}.

    The default detector is the port's `YOLO(model)`, fused, on `device` (the card unless
    "cpu"), predicting in the default bf16; `fast` halves imgsz. `detector` (frame → rows
    [x1, y1, x2, y2, conf, ...]) replaces it."""
    import cv2

    if detector is None:
        from yolo_tpu_torch.engine.model import YOLO

        yolo = YOLO(model, device=device)
        yolo.fuse()
        eff_imgsz = imgsz // 2 if fast else imgsz

        def detector(frame):
            res = yolo.predict(frame, conf=conf, imgsz=eff_imgsz, verbose=False)
            return res[0].boxes.data if len(res) else []

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video_path}")
    fps = int(cap.get(cv2.CAP_PROP_FPS)) or 30
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = None
    if output_video:
        Path(output_video).parent.mkdir(parents=True, exist_ok=True)
        writer = cv2.VideoWriter(str(output_video), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))

    stats = {"frames": 0, "frames_with_detections": 0, "total_detections": 0}
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and stats["frames"] >= max_frames):
            break
        dets = detector(frame)
        stats["frames"] += 1
        if len(dets):
            stats["frames_with_detections"] += 1
            stats["total_detections"] += len(dets)
        if writer is not None:
            vis = frame.copy()
            for d in dets:
                x1, y1, x2, y2 = map(int, d[:4])
                cv2.rectangle(vis, (x1, y1), (x2, y2), (0, 255, 0), 1)
                cv2.putText(vis, f"{float(d[4]):.2f}", (x1, y1 - 4), cv2.FONT_HERSHEY_SIMPLEX, 0.35, (0, 255, 0), 1)
            writer.write(vis)
    cap.release()
    if writer is not None:
        writer.release()
    LOGGER.info(
        f"detect_only: {stats['frames']} frames, {stats['frames_with_detections']} with detections, "
        f"{stats['total_detections']} total"
    )
    return stats
