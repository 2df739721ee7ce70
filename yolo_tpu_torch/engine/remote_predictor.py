"""Predictor over a detection server's lane (counterpart of yolo_tpu/engine/remote_predictor.py).

`YOLO("tcp://host:port/<id>")` builds it: the same sources as the local
predictor (`data/loaders.py`) and the same Results, one request a frame, while
the model runs in the server's process. The server applies its own conf, iou
and letterbox; a client-side `conf` only filters its detections further.
"""

from __future__ import annotations

import time

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from yolo_tpu_torch.engine.predictor import _iter_source
from yolo_tpu_torch.engine.results import Results


class RemotePredictor:
    """Streams frames to a `RemoteModel` and wraps its detections as Results."""

    def __init__(self, client, overrides: dict | None = None, names: dict | None = None):
        self.client = client
        self.args = get_cfg(overrides={k: v for k, v in (overrides or {}).items() if k in DEFAULT_CFG_DICT})
        self.names = names or {}

    def __call__(self, source, stream: bool = False, **kwargs):
        gen = self.stream_inference(source, **kwargs)
        return gen if stream else list(gen)

    def stream_inference(self, source, **kwargs):
        for k, v in kwargs.items():
            if k in DEFAULT_CFG_DICT:
                setattr(self.args, k, v)
        conf = self.args.conf if self.args.conf is not None else 0.0
        for img, path, _ in _iter_source(source, vid_stride=self.args.vid_stride, stream_buffer=bool(self.args.stream_buffer)):
            t0 = time.perf_counter()
            dets = self.client(img)
            dt = time.perf_counter() - t0
            if conf:
                dets = dets[dets[:, 4] >= conf]
            r = Results(img, path, self.names, boxes=dets if len(dets) else None)
            r.speed = {"preprocess": 0.0, "inference": dt * 1e3, "postprocess": 0.0}
            if self.args.verbose:
                print(f"{path}: {r.verbose()}{r.speed['inference']:.1f}ms (remote)")
            yield r

    def close(self):
        self.client.close()
