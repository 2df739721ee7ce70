"""The port's alternative IR pipelines (`yolo_tpu_torch.otherplan`) against the JAX package's
(`yolo_tpu.otherplan`), on the same seeded inputs, mirroring tests/test_otherplan.py: the
host enhancement, `normalize_u8` and `classical_detect` exactly; `enhance_small_targets_torch`
against `enhance_small_targets_jax` within 1e-3 on the 0-255 scale (measured: 0 on the CPU)
with equal `classical_detect` boxes from either; `KalmanCV2D` states and covariances within
1e-5; `IRSmallTargetTracker` on a scripted detector and classical-only, CSV files byte for
byte; `run_single_target_tracking` and `detect_only` over a short cv2-written video with
detectors built from each package's f32 predict (equal stats and CSV), and `detect_only`'s
default detector once."""

import jax.numpy as jnp
import numpy as np
import pytest

import yolo_tpu
import yolo_tpu.otherplan as J
import yolo_tpu_torch
import yolo_tpu_torch.otherplan as P
from yolo_tpu_torch.otherplan import classical as PC

from tests.conftest import ROOT
from tests.test_otherplan import ir_frame_with_blob
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

cv2 = pytest.importorskip("cv2")
WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


def _frames():
    """Four 512x640 frames: two blobs on a cloud-like sky, uniform noise, a flat frame."""
    rng = np.random.default_rng(3)
    return np.stack([
        ir_frame_with_blob(150, 100, seed=1),
        ir_frame_with_blob(480, 300, r=1.4, seed=2),
        rng.integers(0, 255, (512, 640), np.uint8),
        np.full((512, 640), 17, np.uint8),
    ])


def test_otherplan_exports_match_jax():
    assert P.__all__ == [n.replace("_jax", "_torch") for n in J.__all__]
    for name in P.__all__:
        assert callable(getattr(P, name))


def test_host_enhancement_and_detection_match_jax():
    frames = _frames()
    for f in frames:
        np.testing.assert_array_equal(P.classical.normalize_u8(f.astype(np.float32) * 3 - 7),
                                      J.classical.normalize_u8(f.astype(np.float32) * 3 - 7))
        np.testing.assert_array_equal(P.enhance_small_targets(f), J.enhance_small_targets(f))
        assert P.classical_detect(f, f.shape) == J.classical_detect(f, f.shape)
    np.testing.assert_array_equal(PC._gauss_kernel_1d(5.0), J.classical._gauss_kernel_1d(5.0))
    assert len(PC._gauss_kernel_1d(1.2)) == 9 and len(PC._gauss_kernel_1d(5.0)) == 31
    # the blob frames have their target on top (tests/test_otherplan.py's case)
    x1, y1, x2, y2, _ = P.classical_detect(frames[0])[0]
    assert abs((x1 + x2) / 2 - 150) < 6 and abs((y1 + y2) / 2 - 100) < 6


@pytest.mark.parametrize("as_numpy", [False, True])
def test_torch_enhancement_matches_jax(as_numpy):
    """Batched, flat frame included (its parts normalise to 0): within 1e-3 of JAX on the 0-255
    scale, and classical_detect on either enhancement (as uint8) gives the same boxes."""
    import torch

    frames = _frames()
    want = np.asarray(J.enhance_small_targets_jax(jnp.asarray(frames.astype(np.float32))))
    got = P.enhance_small_targets_torch(frames if as_numpy else torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == frames.shape
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert float(got.min()) >= 0 and float(got.max()) <= 255 and not got[3].any()
    for f, g, w in zip(frames, got, want):
        assert P.classical_detect(f, enhanced=g.astype(np.uint8)) == J.classical_detect(f, enhanced=w.astype(np.uint8))


def test_kalman_cv2d_matches_jax():
    rng = np.random.default_rng(4)
    kp, kj = P.KalmanCV2D(dt=1 / 25), J.KalmanCV2D(dt=1 / 25)
    assert kp.predict() is None and kp.state is None
    for k in (kp, kj):
        k.init(100, 100, init_vel=(-5.0, 0.0))
    for i in range(1, 40):
        zx, zy = 100 - 3.0 * i + rng.normal(0, 1), 100 + 1.0 * i + rng.normal(0, 1)
        for k in (kp, kj):
            k.predict()
            if i % 7:
                k.update(zx, zy)
        np.testing.assert_allclose(kp.state, kj.state, rtol=0, atol=1e-5)
        np.testing.assert_allclose(kp.P, kj.P, rtol=1e-6, atol=1e-5)
    assert kp.state.dtype == kj.state.dtype == np.float32
    assert abs(kp.state[2] + 75.0) < 10  # ~ -3 px a frame at 25 frames/s


def _scripted(n):
    calls = {"n": 0}

    def det(frame_bgr):
        f = calls["n"]
        calls["n"] += 1
        if 20 <= f < 28:  # dropout → classical fallback / coast
            return []
        cx = 280 - 4 * f
        return [[cx - 4, 116, cx + 4, 124, 0.8], [500, 400, 560, 402, 0.9]]  # the second fails the aspect filter

    return det


@pytest.mark.parametrize("scripted", [True, False], ids=["scripted", "classical"])
def test_single_target_tracker_matches_jax(tmp_path, scripted):
    n = 50 if scripted else 16
    frames = [cv2.cvtColor(ir_frame_with_blob(280 - 4 * f, 120, seed=f), cv2.COLOR_GRAY2BGR) for f in range(n)]
    paths = tmp_path / "port.csv", tmp_path / "jax.csv"
    tp = P.IRSmallTargetTracker(fps=25, detector=_scripted(n) if scripted else None, csv_path=paths[0])
    tj = J.IRSmallTargetTracker(fps=25, detector=_scripted(n) if scripted else None, csv_path=paths[1])
    for fr in frames:
        vp, vj = fr.copy(), fr.copy()
        assert tp.step(fr, vp) == tj.step(fr, vj)
        np.testing.assert_array_equal(vp, vj)
    tp.close(), tj.close()
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert len(paths[0].read_text().splitlines()) == n + 1
    np.testing.assert_allclose(tp.kf.state, tj.kf.state, rtol=0, atol=1e-5)
    assert (tp.miss_cnt, list(tp.trace)) == (tj.miss_cnt, list(tj.trace))
    if scripted:
        assert tp.kf.state[2] < -2.0  # the leftward velocity learned through the dropout


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 12-frame 128x160 mp4v video: three targets moving over the cloud-like sky."""
    path = tmp_path_factory.mktemp("otherplan") / "clip.mp4"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (160, 128))
    for f in range(12):
        g = ir_frame_with_blob(140 - 6 * f, 40 + f, h=128, w=160, r=1.5, seed=f)
        g = np.maximum(g, ir_frame_with_blob(30 + 3 * f, 90, h=128, w=160, r=2.0, seed=f))
        vw.write(cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))
    vw.release()
    return path


def _detector(yolo, point: bool = False):
    """frame → [[x1, y1, x2, y2, conf], ...] from an f32 predict at imgsz 160, conf 0.05; `point`
    shrinks each box to 2x2 px about its centre, which the single-target tracker's area filter
    (at most 2e-4 of a 128x160 frame, 4 px²) lets through."""

    def detect(frame):
        r = yolo.predict(frame, conf=0.05, iou=0.6, imgsz=160, compute_dtype="float32", verbose=False)[0]
        rows = [[*map(float, b), float(c)] for b, c in zip(r.boxes.xyxy, r.boxes.conf)]
        if point:
            rows = [[(x1 + x2) / 2 - 1, (y1 + y2) / 2 - 1, (x1 + x2) / 2 + 1, (y1 + y2) / 2 + 1, c] for x1, y1, x2, y2, c in rows]
        return rows

    return detect


@pytest.fixture(scope="module")
def yolos():
    """best.npz in each package."""
    return yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu"), yolo_tpu.YOLO(str(WEIGHTS))


def test_run_single_target_tracking_matches_jax(tmp_path, video, yolos):
    dp, dj = (_detector(y, point=True) for y in yolos)
    got = P.run_single_target_tracking(video, detector=dp, output_video=tmp_path / "p.mp4", csv_path=tmp_path / "p.csv")
    want = J.run_single_target_tracking(video, detector=dj, output_video=tmp_path / "j.mp4", csv_path=tmp_path / "j.csv")
    assert got == want and got["frames"] == 12 and got["trace_len"] > 0
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert "yolo" in (tmp_path / "p.csv").read_text() and (tmp_path / "p.mp4").stat().st_size > 0
    assert P.run_single_target_tracking(video, max_frames=5)["frames"] == 5  # classical only


def test_detect_only_matches_jax(tmp_path, video, yolos):
    dp, dj = (_detector(y) for y in yolos)
    got = P.detect_only(video, detector=dp, output_video=tmp_path / "p.mp4")
    want = J.detect_only(video, detector=dj, output_video=tmp_path / "j.mp4")
    assert got == want and got["frames"] == 12 and got["total_detections"] >= 12
    assert (tmp_path / "p.mp4").stat().st_size > 0
    # the default detector: the port's YOLO(model), fused, bf16, half imgsz with `fast`
    default = P.detect_only(video, model="yolov8-small.yaml", conf=0.001, imgsz=128, max_frames=3, fast=True, device="cpu")
    assert default["frames"] == 3 and default["total_detections"] >= default["frames_with_detections"] >= 0
    with pytest.raises(RuntimeError, match="cannot open"):
        P.detect_only(tmp_path / "missing.mp4", detector=dp)
