"""Inference sources of the predictor (counterpart of yolo_tpu/data/loaders.py).

`load_inference_source` routes a source to its loader: image files, directories
and globs, video files (`vid_stride`), streams (URLs, webcam indices, a list of
them, one reader thread each, `stream_buffer`), screenshots (`mss`, imported
when asked for) and in-memory batches (numpy arrays or torch tensors). Files and
videos are decoded with cv2, imported where they are read.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np

from yolo_tpu_torch.utils import LOGGER
from yolo_tpu_torch.utils.files import imread

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}
VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}


class LoadStreams:
    """N video sources, one daemon reader thread each; iteration yields (sources, one frame
    per source, infos), waiting for a frame of every source. `buffer=True` keeps every frame
    (at most 30 queued a source), `False` only the newest."""

    def __init__(self, sources, vid_stride: int = 1, buffer: bool = False):
        import cv2

        self.buffer = buffer
        self.vid_stride = vid_stride
        sources = [sources] if isinstance(sources, (str, int)) else list(sources)
        self.sources = sources
        n = len(sources)
        self.caps = []
        self.imgs: list[list] = [[] for _ in range(n)]
        self.fps = [30.0] * n
        self.frames = [0] * n
        self.threads = []
        self.running = True
        self.shape = [None] * n
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(int(s) if str(s).isdigit() else str(s))
            if not cap.isOpened():
                raise ConnectionError(f"failed to open stream {s}")
            self.caps.append(cap)
            self.fps[i] = cap.get(cv2.CAP_PROP_FPS) or 30.0
            self.frames[i] = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or float("inf")
            ok, im = cap.read()
            if not ok:
                raise ConnectionError(f"failed to read from {s}")
            self.imgs[i].append(im)
            self.shape[i] = im.shape
            t = threading.Thread(target=self._update, args=(i, cap), daemon=True)
            self.threads.append(t)
            t.start()
        LOGGER.info(f"LoadStreams: {n} stream(s) at {[int(f) for f in self.fps]} fps")

    def _update(self, i: int, cap):
        n = 0
        while self.running and cap.isOpened() and n < self.frames[i]:
            if len(self.imgs[i]) < 30:
                n += 1
                cap.grab()
                if n % self.vid_stride == 0:
                    ok, im = cap.retrieve()
                    if not ok:
                        break
                    if self.buffer:
                        self.imgs[i].append(im)
                    else:
                        self.imgs[i] = [im]
            else:
                time.sleep(0.01)
        # `running` stays set: it is every other stream's loop condition too; iteration ends
        # in __next__ once this stream's buffer is empty and its thread has ended

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        self.count += 1
        images = []
        for i in range(len(self.sources)):
            waited = 0.0
            while not self.imgs[i]:
                if not self.running or not self.threads[i].is_alive():
                    raise StopIteration
                time.sleep(0.005)
                waited += 0.005
                if waited > 5.0:
                    raise StopIteration
            images.append(self.imgs[i].pop(0) if self.buffer else self.imgs[i].pop())
            if not self.buffer:
                self.imgs[i].clear()
        return self.sources, images, [""] * len(images)

    def close(self):
        self.running = False
        for t in self.threads:
            t.join(timeout=1.0)
        for cap in self.caps:
            cap.release()

    def __len__(self):
        return len(self.sources)


class LoadImagesAndVideos:
    """Image and video files in order: a file, every such file under a directory (sorted), or
    the files a glob matches; yields (path, BGR frame, frame index), every `vid_stride`-th
    frame of a video."""

    def __init__(self, path, vid_stride: int = 1):
        p = Path(path)
        if p.is_dir():
            files = sorted(f for f in p.rglob("*") if f.suffix.lower().lstrip(".") in IMG_FORMATS | VID_FORMATS)
        elif p.exists():
            files = [p]
        else:
            files = sorted(Path(p.parent).glob(p.name))
            if not files:
                raise FileNotFoundError(f"source not found: {path}")
        self.files = files
        self.vid_stride = vid_stride

    def __iter__(self):
        import cv2

        for f in self.files:
            if f.suffix.lower().lstrip(".") in VID_FORMATS:
                cap = cv2.VideoCapture(str(f))
                try:
                    idx = 0
                    while True:
                        ok, frame = cap.read()
                        if not ok:
                            break
                        if idx % self.vid_stride == 0:
                            yield str(f), frame, idx
                        idx += 1
                finally:
                    cap.release()
            else:
                im = imread(str(f))
                if im is None:
                    LOGGER.warning(f"unreadable image {f}")
                    continue
                yield str(f), im, 0

    def __len__(self):
        return len(self.files)


class LoadScreenshots:
    """Screen capture with `mss`: "screen [N] [left top width height]"; raises ImportError without it."""

    def __init__(self, source: str = "screen"):
        try:
            import mss
        except ImportError as e:
            raise ImportError("screen capture needs the 'mss' package (pip install mss)") from e
        parts = str(source).split()[1:]
        self.screen = 0
        left = top = width = height = None
        if len(parts) == 1:
            self.screen = int(parts[0])
        elif len(parts) == 4:
            left, top, width, height = (int(x) for x in parts)
        elif len(parts) == 5:
            self.screen, left, top, width, height = (int(x) for x in parts)
        self.sct = mss.mss()
        mon = self.sct.monitors[self.screen]
        self.monitor = {
            "left": mon["left"] + (left or 0),
            "top": mon["top"] + (top or 0),
            "width": width or mon["width"],
            "height": height or mon["height"],
        }
        self.mode = "stream"
        self.frame = 0

    def __iter__(self):
        while True:
            im = np.asarray(self.sct.grab(self.monitor))[..., :3]  # BGRA → BGR
            self.frame += 1
            yield f"screen{self.screen}", im, self.frame


class LoadTensor:
    """An in-memory batch, a numpy array or a torch tensor: (B, H, W, 3) uint8 BGR, or
    (B, 3, H, W) floats in [0, 1] (ValueError above 1), converted to the first form; a 3-D
    input is one image, one channel is repeated to three."""

    def __init__(self, im0):
        im = im0.detach().cpu().numpy() if hasattr(im0, "detach") else np.asarray(im0)
        if im.ndim == 3:
            im = im[None]
        if im.ndim != 4:
            raise ValueError(f"LoadTensor expects 3/4-D input, got shape {im.shape}")
        if im.shape[1] in (1, 3) and im.shape[-1] not in (1, 3):  # NCHW → NHWC
            im = im.transpose(0, 2, 3, 1)
        if im.dtype != np.uint8:
            if im.max() > 1.0 + 1e-3:
                raise ValueError("float inputs must be normalized to [0, 1]")
            im = (im * 255).round().astype(np.uint8)
        if im.shape[-1] == 1:
            im = im.repeat(3, -1)
        self.im0 = im
        self.bs = im.shape[0]
        self.mode = "image"

    def __iter__(self):
        for i, im in enumerate(self.im0):
            yield f"image{i}.jpg", im, 0

    def __len__(self):
        return self.bs


def _is_stream(s) -> bool:
    return isinstance(s, str) and ("://" in s or s.isdigit())


def load_inference_source(source, vid_stride: int = 1, stream_buffer: bool = False):
    """The loader of `source`: "screen ..." → LoadScreenshots; a 4-D numpy array or torch
    tensor → LoadTensor; a webcam index, a URL or a list of them → LoadStreams; anything
    else (a file, a directory, a glob) → LoadImagesAndVideos."""
    if isinstance(source, str) and (source == "screen" or source.startswith("screen ")):
        return LoadScreenshots(source)
    if isinstance(source, np.ndarray) and source.ndim == 4:
        return LoadTensor(source)
    if type(source).__module__.startswith("torch") and getattr(source, "ndim", 0) == 4:
        return LoadTensor(source)
    if isinstance(source, int):
        return LoadStreams(str(source), vid_stride=vid_stride, buffer=stream_buffer)
    if isinstance(source, (list, tuple)) and all(_is_stream(s) for s in source):
        return LoadStreams(source, vid_stride=vid_stride, buffer=stream_buffer)
    if _is_stream(source):
        return LoadStreams(source, vid_stride=vid_stride, buffer=stream_buffer)
    return LoadImagesAndVideos(source, vid_stride=vid_stride)
