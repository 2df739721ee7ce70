"""Client of a detection server's model lane (counterpart of yolo_tpu/utils/remote.py).

`YOLO("tcp://host:port/<model_id>")` predicts through it: one server process
(`serve.py`, either package's) owns the model on its device, and any number of
clients stream frames over protocol v2 and get detections back. Standard
library only, so it can be copied into thin edge processes.

Protocol v2 (little-endian): request 'YTP2' | u16 version (2) | u16 model_id |
u32 h | u32 w | u32 c | u8[h*w*c] BGR; response 'YTPR' | u16 version | u16
status (0 ok) | u32 n | n x (f32 x1, y1, x2, y2, conf, cls), or for a status
other than 0, u32 length | a UTF-8 message.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

MAGIC_REQ = b"YTP2"
MAGIC_RES = b"YTPR"
PROTOCOL_VERSION = 2


class RemoteInferenceError(RuntimeError):
    """A failure the server reported in an error frame."""

    def __init__(self, status: int, message: str):
        super().__init__(f"remote inference failed (status {status}): {message}")
        self.status = status


class RemoteModel:
    """One model lane of a detection server.

    >>> rm = RemoteModel("tcp://127.0.0.1:8777/0")
    >>> dets = rm(frame_bgr)        # (n, 6) float32: x1, y1, x2, y2, conf, cls
    Boxes are in the frame's own pixels (the server letterboxes and inverts it).
    """

    def __init__(self, url: str, timeout: float = 300.0):
        self.url = url
        self.host, self.port, self.model_id = self._parse(url)
        self.timeout = timeout
        self._conn: socket.socket | None = None

    @staticmethod
    def _parse(url: str) -> tuple[str, int, int]:
        if not url.startswith("tcp://"):
            raise ValueError(f"remote model url must be tcp://host:port[/model_id], got {url!r}")
        addr, _, mid = url[len("tcp://"):].partition("/")
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"remote model url must be tcp://host:port[/model_id], got {url!r}")
        return host, int(port), int(mid) if mid else 0

    def _connect(self) -> socket.socket:
        if self._conn is None:
            self._conn = socket.create_connection((self.host, self.port), timeout=self.timeout)
            self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._conn

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _recv_exact(self, conn: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return buf

    def _roundtrip(self, frame: np.ndarray) -> np.ndarray:
        conn = self._connect()
        h, w, c = frame.shape
        conn.sendall(MAGIC_REQ + struct.pack("<HHIII", PROTOCOL_VERSION, self.model_id, h, w, c) + frame.tobytes())
        if self._recv_exact(conn, 4) != MAGIC_RES:
            raise ConnectionError("bad response magic — protocol desync")
        _ver, status, n = struct.unpack("<HHI", self._recv_exact(conn, 8))
        if status != 0:
            raise RemoteInferenceError(status, self._recv_exact(conn, n).decode("utf-8", "replace"))
        raw = self._recv_exact(conn, n * 24)
        return np.frombuffer(raw, np.float32).reshape(n, 6).copy() if n else np.zeros((0, 6), np.float32)

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        """One BGR (or single-channel) uint8 HWC frame → its (n, 6) detections."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim == 2:
            frame = frame[..., None]
        if frame.ndim != 3 or frame.shape[-1] not in (1, 3):
            raise ValueError(f"frame must be HxW[x1|x3] uint8, got shape {frame.shape}")
        try:
            return self._roundtrip(frame)
        except (ConnectionError, socket.timeout):
            self.close()  # one reconnect: servers restart, TCP streams break
            return self._roundtrip(frame)
