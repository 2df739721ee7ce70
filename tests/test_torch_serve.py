"""The port's detection server (`yolo_tpu_torch/serve.py`) and remote client
(`utils/remote.py`, `YOLO("tcp://...")`) against the JAX package's, on the CPU.

One module-scoped server per package, `best.npz` at imgsz 64, bf16 (the lanes'
default in both packages). The port's server has a second lane from the same
file and a third whose source is missing. Frames are seeded IR frames with two
bright targets; the protocol cases follow tests/test_serving.py. Tolerances:
the port's server against its own `YOLO.predict` exactly (B = 1, the same
path); against the JAX server at the bf16 gates of tests/test_torch_predict.py.
"""

import re
import shutil
import socket
import struct
import subprocess
import threading

import numpy as np
import pytest
import torch

from tests.conftest import ROOT
from tests.test_torch_predict import BF16_BOX_PX, BF16_CONF
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

WEIGHTS = str(ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz")
IMGSZ = 64


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        assert chunk, "server closed"
        buf += chunk
    return buf


def _serve(srv):
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever, args=(ready,), daemon=True)
    t.start()
    assert ready.wait(60)
    return t


@pytest.fixture(scope="module")
def port_server():
    from yolo_tpu_torch.serve import DetectionServer

    srv = DetectionServer({0: WEIGHTS, 1: WEIGHTS, 2: str(ROOT / "no_such_model.npz")}, port=0, imgsz=IMGSZ,
                          batch_window_ms=1.0, device="cpu")
    t = _serve(srv)
    yield srv
    srv.shutdown()
    t.join(30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def jax_server():
    from yolo_tpu.serve import DetectionServer

    srv = DetectionServer({0: WEIGHTS}, port=0, imgsz=IMGSZ, batch_window_ms=1.0)
    t = _serve(srv)
    yield srv
    srv.shutdown()
    t.join(5)


def _frame(seed=0, h=48, w=64, c=3):
    """Two bright 4-px-sigma targets on a dim noisy background; (h, w) = (48, 64) only pads into 64."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 30 + rng.normal(0, 2, (h, w))
    for fx, fy in ((0.3, 0.4), (0.7, 0.6)):
        img = img + 170 * np.exp(-((xx - fx * w) ** 2 + (yy - fy * h) ** 2) / (2 * 4.0**2))
    img = np.clip(img, 0, 255).astype(np.uint8)[..., None]
    return np.repeat(img, c, -1) if c == 3 else img


def _v2(conn, f, mid=0, version=2):
    conn.sendall(b"YTP2" + struct.pack("<HHIII", version, mid, *f.shape) + f.tobytes())
    assert _recv_exact(conn, 4) == b"YTPR"
    ver, status, n = struct.unpack("<HHI", _recv_exact(conn, 8))
    assert ver == 2
    if status:
        return status, _recv_exact(conn, n).decode()
    return status, np.frombuffer(_recv_exact(conn, n * 24), np.float32).reshape(n, 6)


def test_v2_request_roundtrip(port_server):
    with socket.create_connection(("127.0.0.1", port_server.port), timeout=120) as conn:
        status, dets = _v2(conn, _frame())
    assert status == 0 and dets.shape == (2, 6)


def test_v1_legacy_framing(port_server):
    f = _frame()
    with socket.create_connection(("127.0.0.1", port_server.port), timeout=120) as conn:
        conn.sendall(b"YTPU" + struct.pack("<III", *f.shape) + f.tobytes())
        assert _recv_exact(conn, 4) == b"YTPR"
        (n,) = struct.unpack("<I", _recv_exact(conn, 4))
        v1 = np.frombuffer(_recv_exact(conn, n * 24), np.float32).reshape(n, 6)
        _, v2 = _v2(conn, f)
    np.testing.assert_array_equal(v1, v2)


def test_recoverable_errors_keep_the_stream(port_server):
    """Unknown model (status 1), bad geometry and bad version (status 2, the payload drained), a lane
    whose model failed to load (status 3): each gets its error frame and the connection still answers."""
    f = _frame()
    with socket.create_connection(("127.0.0.1", port_server.port), timeout=120) as conn:
        assert _v2(conn, f, mid=7)[0] == 1 and "unknown model" in _v2(conn, f, mid=7)[1]
        conn.sendall(b"YTP2" + struct.pack("<HHIII", 2, 0, 0, 64, 3))
        assert _recv_exact(conn, 4) == b"YTPR"
        _, status, n = struct.unpack("<HHI", _recv_exact(conn, 8))
        assert status == 2 and "geometry" in _recv_exact(conn, n).decode()
        status, msg = _v2(conn, f, version=3)
        assert status == 2 and "protocol version 3" in msg
        status, msg = _v2(conn, f, mid=2)
        assert status == 3 and "no_such_model" in msg
        assert _v2(conn, f, mid=1)[0] == 0
    assert port_server.lanes[2].error and not port_server.lanes[0].error and not port_server.lanes[1].error


def test_server_equals_its_own_predict_at_b1(port_server):
    """One client, one frame at a time: every device call is B = 1, the path of `YOLO.predict`
    (bf16, conf 0.25, iou 0.7, imgsz 64), so the replies are equal, for 3- and 1-channel frames
    and a frame the letterbox resizes."""
    import yolo_tpu_torch

    y = yolo_tpu_torch.YOLO(WEIGHTS, device="cpu").fuse()
    from yolo_tpu_torch.utils.remote import RemoteModel

    frames = [_frame(1), _frame(2, c=1), _frame(3, h=64, w=80)]
    with RemoteModel(f"tcp://127.0.0.1:{port_server.port}/1") as rm:
        got = [rm(f) for f in frames]
    want = [r.boxes.data for r in y.predict([f if f.shape[-1] == 3 else f[..., 0] for f in frames], imgsz=IMGSZ, iou=0.7,
                                             verbose=False)]
    assert [len(g) for g in got] == [2, 2, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _sorted(d):
    return d[np.argsort(d[:, 0])]


def test_port_server_matches_jax_server(port_server, jax_server):
    """The same frames through both servers' lane 0, one request at a time: the same count and class,
    boxes and conf at the bf16 tolerance."""
    from yolo_tpu_torch.utils.remote import RemoteModel

    frames = [_frame(s, c=1 + 2 * (s % 2)) for s in range(4)]
    with RemoteModel(f"tcp://127.0.0.1:{port_server.port}/0") as p, RemoteModel(f"tcp://127.0.0.1:{jax_server.port}/0") as j:
        got, want = [p(f) for f in frames], [j(f) for f in frames]
    assert [len(g) for g in got] == [len(w) for w in want] == [2, 2, 2, 2]
    for g, w in zip(got, want):
        g, w = _sorted(g), _sorted(w)
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=BF16_BOX_PX)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=BF16_CONF)
        np.testing.assert_array_equal(g[:, 5], w[:, 5])


@pytest.mark.parametrize("client_pkg,server", [("yolo_tpu", "port_server"), ("yolo_tpu_torch", "jax_server")])
def test_clients_cross_packages(client_pkg, server, request):
    """Each package's RemoteModel and YOLO("tcp://...") against the other package's server: the same
    replies as a raw v2 request, error frames as RemoteInferenceError, the stream kept after one."""
    import importlib

    srv = request.getfixturevalue(server)
    remote = importlib.import_module(f"{client_pkg}.utils.remote")
    f = _frame(5)
    with socket.create_connection(("127.0.0.1", srv.port), timeout=120) as conn:
        raw = _v2(conn, f)[1]
    with remote.RemoteModel(f"tcp://127.0.0.1:{srv.port}/42") as rm:
        with pytest.raises(remote.RemoteInferenceError, match="unknown model"):
            rm(f)
        rm.model_id = 0
        np.testing.assert_array_equal(rm(f), raw)
    m = importlib.import_module(client_pkg).YOLO(f"tcp://127.0.0.1:{srv.port}/0")
    r = m.predict(f, conf=0.0, verbose=False)
    np.testing.assert_array_equal(r[0].boxes.data, raw)
    assert sum(1 for _ in m.predict([f, f], conf=0.0, stream=True, verbose=False)) == 2
    tracked = m.track(f, conf=0.0, verbose=False)
    assert len(tracked) == 1 and tracked[0].boxes.is_track
    m.predictor.close()


def test_remote_model_url_and_local_modes(port_server):
    import yolo_tpu_torch
    from yolo_tpu_torch.utils.remote import RemoteModel

    rm = RemoteModel("tcp://10.0.0.5:8777/3")
    assert (rm.host, rm.port, rm.model_id) == ("10.0.0.5", 8777, 3)
    rm = RemoteModel("tcp://localhost:99")
    assert (rm.host, rm.port, rm.model_id) == ("localhost", 99, 0)
    for bad in ("http://host:1/0", "tcp://hostonly/0"):
        with pytest.raises(ValueError):
            RemoteModel(bad)
    m = yolo_tpu_torch.YOLO(f"tcp://127.0.0.1:{port_server.port}/0")
    assert m.overrides == {"model": f"tcp://127.0.0.1:{port_server.port}/0", "task": "detect"}
    for call in (lambda: m.train(data="nonexistent.yaml"), lambda: m.val(data="nonexistent.yaml"), m.export):
        with pytest.raises(RuntimeError, match="predict/track"):
            call()
    # a client-side conf only filters the server's detections further
    f = _frame(6)
    all_dets = m.predict(f, conf=0.0, verbose=False)[0].boxes.conf
    high = m.predict(f, conf=float(all_dets.max()), verbose=False)[0].boxes.conf
    assert len(all_dets) == 2 and list(high) == [all_dets.max()]


def test_jax_example_remote_client_against_port_server(port_server, tmp_path):
    """examples/remote_client.py (the JAX package's client) over a video, tracking, against the port's server."""
    import importlib.util

    import cv2

    vid = tmp_path / "clip.mp4"
    vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for s in range(4):
        vw.write(_frame(s))
    vw.release()
    spec = importlib.util.spec_from_file_location("remote_ex", ROOT / "examples" / "remote_client.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n = mod.main(["--url", f"tcp://127.0.0.1:{port_server.port}/0", "--source", str(vid), "--conf", "0.0", "--track",
                  "--save", str(tmp_path / "out.mp4"), "--max-frames", "3"])
    assert n == 3 and (tmp_path / "out.mp4").exists()


def _cpp_client_frame(t, h=512, w=640):
    """examples/cpp_client/client.cpp::make_frame: LCG noise and a 10x8 block of 235 moving right."""
    img = np.empty(h * w, np.uint8)
    s = (12345 + t) & 0xFFFFFFFF
    for i in range(h * w):
        s = (s * 1664525 + 1013904223) & 0xFFFFFFFF
        img[i] = 20 + (s >> 28)
    img = np.repeat(img.reshape(h, w, 1), 3, -1)
    cx, cy = (40 + 4 * t) % w, 250
    img[cy - 4:cy + 4, max(cx - 5, 0):cx + 5] = 235
    return img


def test_cpp_client_against_port_server(port_server, tmp_path):
    """examples/cpp_client built with cmake in a temporary directory sends 4 frames of 640x512 (the
    letterbox shrinks them into 64) to lane 1; its printed detections equal RemoteModel's for the
    same frames, to the 6 digits it prints."""
    if shutil.which("cmake") is None or shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("needs cmake and a C++ compiler")
    from yolo_tpu_torch.utils.remote import RemoteModel

    build = tmp_path / "build"
    subprocess.run(["cmake", "-S", str(ROOT / "examples" / "cpp_client"), "-B", str(build)], check=True, capture_output=True, timeout=120)
    subprocess.run(["cmake", "--build", str(build)], check=True, capture_output=True, timeout=300)
    out = subprocess.run([str(build / "yolo_client"), "127.0.0.1", str(port_server.port), "4", "1"], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    lines = out.strip().splitlines()
    assert len(lines) == 5 and lines[-1].startswith("4 frames in")
    with RemoteModel(f"tcp://127.0.0.1:{port_server.port}/1") as rm:
        for t, line in enumerate(lines[:4]):
            want = rm(_cpp_client_frame(t))
            assert line.startswith(f"frame {t}: {len(want)} detections")
            got = np.array(re.findall(r"\[([^,]+),([^,]+),([^,]+),(\S+) conf=(\S+) cls=([^\]]+)\]", line), np.float32).reshape(-1, 6)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_server_needs_a_device(monkeypatch):
    from yolo_tpu_torch.serve import DetectionServer, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionServer(WEIGHTS, port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([WEIGHTS, "--port", "0"])
