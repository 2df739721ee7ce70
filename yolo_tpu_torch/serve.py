"""Detection server: frames in over TCP, detections out (counterpart of yolo_tpu/serve.py).

    python -m yolo_tpu_torch.serve best.npz --port 8777            # lane 0 on the card
    python -m yolo_tpu_torch.serve 0=best.npz 1=best.pt --device cpu

One process owns the models on its device; any client (utils/remote.py,
`YOLO("tcp://host:port/<id>")`, examples/cpp_client, another host) streams
frames over a length-prefixed binary protocol, the JAX package's:

Protocol v2 (little-endian):
  request:  magic 'YTP2' | u16 version (=2) | u16 model_id
            | u32 height | u32 width | u32 channels | u8[h*w*c] BGR frame
  response: magic 'YTPR' | u16 version | u16 status (0 = ok)
            | u32 n | n x (f32 x1, y1, x2, y2, conf, cls)
            status != 0 → u32 msg_len | UTF-8 message instead of detections
            (1 unknown model, 2 bad request, 3 internal error)
Protocol v1 ('YTPU' | u32 h | u32 w | u32 c | frame → 'YTPR' | u32 n | dets) is
still accepted; its errors come back as zero detections.

Each model id is a lane: its own YOLO, predictor and queue. A lane that fails
to load or build is out of service (its requests get status 3); the others
answer. One worker thread owns every device call: frames that arrive within
`batch_window_ms` of each other coalesce into one predictor call per lane
(batches of up to the predictor's 16, padded to a power of two).
"""

from __future__ import annotations

import argparse
import socket
import struct
import threading
import time

import numpy as np

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.utils import LOGGER

MAGIC_REQ_V1 = b"YTPU"
MAGIC_REQ_V2 = b"YTP2"
MAGIC_RES = b"YTPR"
PROTOCOL_VERSION = 2

STATUS_OK = 0
STATUS_BAD_MODEL = 1
STATUS_BAD_REQUEST = 2
STATUS_INTERNAL = 3


class _ModelLane:
    """One model's YOLO, predictor and coalescing queue."""

    def __init__(self, source: str, conf, iou, imgsz, max_det, device, predict_args: dict):
        self.conf, self.iou, self.imgsz, self.max_det = conf, iou, imgsz, max_det
        self.device, self.predict_args = device, predict_args
        self.queue: list = []
        self.predictor = None
        self.yolo = None
        self.error: str | None = None  # set when loading, building or warming up failed: the lane is out of service
        try:  # a bad source takes this lane out, not the server
            from yolo_tpu_torch.engine.model import YOLO
            from yolo_tpu_torch.nn.tasks import EXTRA_OUTPUT_TASKS

            self.yolo = YOLO(source, device=str(device))
            if self.yolo.task in EXTRA_OUTPUT_TASKS:
                raise NotImplementedError(f"serving a {self.yolo.task} model is not ported (ROADMAP item 2)")
            self.yolo.fuse()
        except Exception as e:
            self.yolo = None
            self.error = f"model '{source}' failed to load: {e}"
            LOGGER.warning(self.error)

    def build(self):
        """The lane's predictor, warmed up on one zero frame (on a card: the kernels built)."""
        if self.yolo is None:
            raise RuntimeError(self.error or "model not loaded")
        from yolo_tpu_torch.engine.predictor import BasePredictor

        self.predictor = BasePredictor(
            self.yolo.model, self.yolo.params,
            overrides={"conf": self.conf, "iou": self.iou, "imgsz": self.imgsz, "max_det": self.max_det, "verbose": False,
                       "device": str(self.device), **self.predict_args},
            names=self.yolo.names,
        )
        self.predictor.warmup((1, self.imgsz, self.imgsz, 3))


class DetectionServer:
    """`models`: a source, or {model_id: source} (.npz, .pt or model YAML). `device` None is the
    card (RuntimeError without one); `predict_args` are further settings of every lane's
    predictor (for example compute_dtype='float32'; bf16 by default, as the JAX lanes)."""

    def __init__(self, models, host: str = "127.0.0.1", port: int = 8777, conf: float = 0.25,
                 iou: float = 0.7, imgsz: int = 640, max_det: int = 300, batch_window_ms: float = 4.0,
                 device=None, predict_args: dict | None = None):
        self.device = resolve_device(device)
        if isinstance(models, str):
            models = {0: models}
        self.lanes = {int(k): _ModelLane(v, conf, iou, imgsz, max_det, self.device, dict(predict_args or {}))
                      for k, v in models.items()}
        self.host, self.port = host, port
        self.batch_window = batch_window_ms / 1e3
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = False

    # --- device worker ----------------------------------------------------------

    def _worker(self):
        LOGGER.info("warming up the model lanes...")
        for mid, lane in self.lanes.items():
            try:
                lane.build()
                LOGGER.info(f"model {mid} ready ({lane.yolo.overrides.get('model')})")
            except Exception as e:  # one broken lane must not take the server down
                lane.error = f"model {mid} failed to build: {e}"
                LOGGER.warning(lane.error)
        LOGGER.info("server ready")
        while not self._stop:
            self._event.wait(timeout=0.1)
            time.sleep(self.batch_window)  # coalesce
            with self._lock:
                grabbed = {mid: lane.queue for mid, lane in self.lanes.items() if lane.queue}
                for mid in grabbed:
                    self.lanes[mid].queue = []
                self._event.clear()
            for mid, jobs in grabbed.items():
                lane = self.lanes[mid]
                try:
                    results = lane.predictor([j[0] for j in jobs], verbose=False)
                    for (_, done, out), r in zip(jobs, results):
                        out.append((STATUS_OK, r.boxes.data[:, :6] if len(r.boxes) else np.zeros((0, 6), np.float32)))
                        done.set()
                except Exception as e:  # the protocol's error semantics: a failed batch answers status 3, the worker goes on
                    LOGGER.warning(f"inference failed for model {mid}: {e}")
                    for _, done, out in jobs:
                        out.append((STATUS_INTERNAL, str(e)))
                        done.set()

    # --- socket handling ------------------------------------------------------------

    @staticmethod
    def _recv_exact(conn, n: int) -> bytearray:
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = conn.recv_into(view[got:], n - got)
            if not k:
                raise ConnectionError("client closed")
            got += k
        return buf

    def _send_error(self, conn, status: int, msg: str, version: int = PROTOCOL_VERSION):
        """An error in the client's framing: v1 has no status field, so a v1 client gets a valid
        frame of zero detections (a v2 error frame would be read as a count and desync it)."""
        if version == 1:
            LOGGER.warning(f"v1 client error (reported as empty result): {msg}")
            conn.sendall(MAGIC_RES + struct.pack("<I", 0))
            return
        data = msg.encode()
        conn.sendall(MAGIC_RES + struct.pack("<HHI", PROTOCOL_VERSION, status, len(data)) + data)

    def _drain_payload(self, conn, h: int, w: int, c: int):
        """Read and drop a rejected request's frame so the stream stays in step; a geometry past
        8192 x 8192 x 4 bytes closes the connection instead."""
        n = h * w * c
        if n > 8192 * 8192 * 4:
            raise ValueError(f"unrecoverable geometry {h}x{w}x{c}")
        self._recv_exact(conn, n)

    def _handle_client(self, conn, addr):
        LOGGER.info(f"client {addr} connected")
        try:
            while True:
                magic = bytes(self._recv_exact(conn, 4))
                if magic == MAGIC_REQ_V1:
                    version, mid = 1, 0
                elif magic == MAGIC_REQ_V2:
                    version, mid = struct.unpack("<HH", self._recv_exact(conn, 4))
                    if version != PROTOCOL_VERSION:
                        h, w, c = struct.unpack("<III", self._recv_exact(conn, 12))
                        self._drain_payload(conn, h, w, c)
                        self._send_error(conn, STATUS_BAD_REQUEST, f"unsupported protocol version {version}")
                        continue
                else:
                    raise ValueError(f"bad magic {magic!r}")
                h, w, c = struct.unpack("<III", self._recv_exact(conn, 12))
                if not (0 < h <= 8192 and 0 < w <= 8192 and c in (1, 3)):
                    self._drain_payload(conn, h, w, c)
                    self._send_error(conn, STATUS_BAD_REQUEST, f"bad frame geometry {h}x{w}x{c}", version)
                    continue
                raw = self._recv_exact(conn, h * w * c)
                if mid not in self.lanes:
                    self._send_error(conn, STATUS_BAD_MODEL, f"unknown model id {mid} (have {sorted(self.lanes)})", version)
                    continue
                if self.lanes[mid].error:
                    self._send_error(conn, STATUS_INTERNAL, self.lanes[mid].error, version)
                    continue
                frame = np.frombuffer(raw, np.uint8).reshape(h, w, c)
                if c == 1:
                    frame = np.repeat(frame, 3, axis=-1)
                done, out = threading.Event(), []
                with self._lock:
                    self.lanes[mid].queue.append((frame, done, out))
                    self._event.set()
                if not done.wait(timeout=300.0):  # the worker is stuck: fail the request, keep the stream
                    self._send_error(conn, STATUS_INTERNAL, "inference timed out", version)
                    continue
                status, payload = out[0]
                if status != STATUS_OK:
                    self._send_error(conn, status, str(payload), version)
                    continue
                dets = payload.astype(np.float32)
                if version == 1:
                    conn.sendall(MAGIC_RES + struct.pack("<I", len(dets)) + dets.tobytes())
                else:
                    conn.sendall(MAGIC_RES + struct.pack("<HHI", PROTOCOL_VERSION, STATUS_OK, len(dets)) + dets.tobytes())
        except (ConnectionError, ValueError) as e:
            LOGGER.info(f"client {addr} gone: {e}")
        finally:
            conn.close()

    def serve_forever(self, ready_event: threading.Event | None = None):
        """Start the worker, listen (port 0: any free port, then in `self.port`), set `ready_event`
        once listening (the lanes may still be building), and serve until `shutdown()`."""
        worker = threading.Thread(target=self._worker, daemon=True)
        worker.start()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.host, self.port))
            srv.listen(16)
            self.port = srv.getsockname()[1]
            LOGGER.info(f"listening on {self.host}:{self.port}")
            if ready_event is not None:
                ready_event.set()
            srv.settimeout(0.5)
            while not self._stop:
                try:
                    conn, addr = srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(None)
                threading.Thread(target=self._handle_client, args=(conn, addr), daemon=True).start()
        finally:
            srv.close()
            self._stop = True
            worker.join(timeout=10.0)

    def shutdown(self):
        self._stop = True


def main(argv=None):
    p = argparse.ArgumentParser(description="yolo_tpu_torch detection server")
    p.add_argument("models", nargs="*", default=["yolov8-small.yaml"],
                   help="model sources; 'id=source' pairs for multi-model, bare source = id 0")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--device", default=None, help="'cpu', 'cuda' or 'cuda:N'; default the card")
    args = p.parse_args(argv)
    models = {}
    for i, spec in enumerate(args.models):
        if "=" in spec:
            k, v = spec.split("=", 1)
            models[int(k)] = v
        else:
            models[i] = spec
    DetectionServer(models, args.host, args.port, args.conf, args.iou, args.imgsz, device=args.device).serve_forever()


if __name__ == "__main__":
    main()
