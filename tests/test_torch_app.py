"""The port's application layer against the JAX package's: the per-object
tracker (`AircraftKalmanTracker`), the manager (`EnhancedMultiTargetTracker`),
the batched tracker's host wrapper (`BatchedMultiTargetTracker`) and the clip
loop of `aircraft_detection_tracking`, on seeded detection sequences with
dropouts. The numpy trackers must agree to 1e-6 in their states (they run the
same f64 arithmetic); the batched wrapper agrees to 1e-4 (f32, another
summation order than XLA's). Statuses, ids and stats must be equal. Tracks
whose ids come from `uuid` are compared by order and content, not by id."""

import jax
import numpy as np
import pytest
import torch

import yolo_tpu_torch
from yolo_tpu.kalman import batched as JBt
from yolo_tpu.kalman import multi_tracker as JM
from yolo_tpu.kalman import pipeline as JP
from yolo_tpu.kalman import tracker as JT
from yolo_tpu_torch.kalman import batched as PBt
from yolo_tpu_torch.kalman import multi_tracker as PM
from yolo_tpu_torch.kalman import pipeline as PP
from yolo_tpu_torch.kalman import tracker as PT

from tests.conftest import ROOT
from tests.test_kalman import make_detection_script
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


def _same_info(a: dict, b: dict, compare_id: bool = True, tol: float = 1e-6):
    assert set(a) == set(b)
    for k in a:
        if k == "track_id":
            assert not compare_id or a[k] == b[k]
        elif k in ("bbox", "velocity"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)
        elif k == "trajectory":
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=0, atol=tol)
        elif isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], abs=tol), k
        else:
            assert a[k] == b[k], k


def test_single_tracker_matches_jax(capsys):
    """Update, coast, lose, long-term predict and recover: the same calls on both trackers."""
    rng = np.random.default_rng(0)
    got, want = PT.AircraftKalmanTracker([100, 100, 120, 116], max_lost_frames=60), JT.AircraftKalmanTracker([100, 100, 120, 116], max_lost_frames=60)
    assert len(got.track_id) == len(want.track_id) == 8  # uuid ids: not compared
    for f in range(1, 140):
        lost = 45 <= f < 110
        for t in (got, want):
            t.predict()
        if lost:
            for t in (got, want):
                t.mark_as_lost()
        else:
            z = np.r_[100 + 3.0 * f, 100 + 1.0 * f, 120 + 3.0 * f, 116 + 1.0 * f] + rng.normal(0, 0.4, 4)
            for t in (got, want):
                t.update(z)
        _same_info(got.get_track_info(), want.get_track_info(), compare_id=False)
        np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.P, want.P, rtol=0, atol=1e-6)
        assert got.should_delete(60) == want.should_delete(60)
        assert (got.is_lost, got.lost_frames, got.hit_streak) == (want.is_lost, want.lost_frames, want.hit_streak)
    assert got.motion_analysis["prediction_confidence"] == pytest.approx(want.motion_analysis["prediction_confidence"], abs=1e-9)
    assert got.motion_analysis["prediction_confidence"] > 0.3  # the high-confidence extrapolation branch ran
    np.testing.assert_array_equal(PT.bbox_to_cxcywh([0, 2, 10, 8]), JT.bbox_to_cxcywh([0, 2, 10, 8]))
    np.testing.assert_array_equal(PT.cxcywh_to_bbox([5, 5, 10, 6]), JT.cxcywh_to_bbox([5, 5, 10, 6]))
    for name in ("_make_F", "_make_H", "_make_Q", "_make_P0"):
        np.testing.assert_array_equal(getattr(PT, name)(), getattr(JT, name)())
    assert PT.EnhancedAircraftKalmanTracker is PT.AircraftKalmanTracker
    capsys.readouterr()


def _churn_script(n_frames=120, seed=7):
    """Six targets with random dropouts, exact duplicates and a burst: tracks open, coast, recover and are pruned."""
    rng = np.random.default_rng(seed)
    centers, vels = rng.uniform(50, 450, (6, 2)), rng.uniform(-3, 3, (6, 2))
    frames = []
    for f in range(n_frames):
        dets = []
        for t in range(6):
            if rng.uniform() < 0.3:
                continue
            c = centers[t] + vels[t] * f + rng.normal(0, 1, 2)
            dets.append([*(c - 8), *(c + 8), float(rng.uniform(0.3, 0.9))])
            if rng.uniform() < 0.2:
                dets.append(list(dets[-1]))  # an exact duplicate: tied IoUs
        frames.append(dets)
    return frames


@pytest.mark.parametrize("script,kw", [
    ("crossing", dict(max_lost_frames=150, min_hits=1, iou_threshold=0.1)),
    ("churn", dict(max_lost_frames=20, min_hits=3, iou_threshold=0.3)),
])
def test_multi_tracker_matches_jax(script, kw, capsys):
    frames = make_detection_script(n_frames=130, seed=3) if script == "crossing" else _churn_script()
    got, want = PM.EnhancedMultiTargetTracker(**kw), JM.EnhancedMultiTargetTracker(**kw)
    for dets in frames:
        tg, tw = got.update([list(d) for d in dets]), want.update([list(d) for d in dets])
        assert len(tg) == len(tw)
        for a, b in zip(tg, tw):
            _same_info(a, b)
    assert got.get_statistics() == want.get_statistics()
    assert got.stats["total_tracks_created"] >= 2 and got.stats["successful_recoveries"] >= 1
    if script == "churn":
        assert got.stats["total_tracks_terminated"] >= 1
    assert PM.iou_xyxy([0, 0, 10, 10], [5, 5, 15, 15]) == JM.iou_xyxy([0, 0, 10, 10], [5, 5, 15, 15]) == pytest.approx(25 / 175)
    assert PM.iou_xyxy([0, 0, 1, 1], [2, 2, 3, 3]) == 0.0
    capsys.readouterr()


def test_batched_wrapper_matches_jax():
    frames = make_detection_script(n_frames=100, seed=3)
    kw = dict(max_lost_frames=150, min_hits=1, iou_threshold=0.1, n_max=16, d_max=8)
    got, want = PBt.BatchedMultiTargetTracker(device="cpu", **kw), JBt.BatchedMultiTargetTracker(**kw)
    seen = set()
    for dets in frames[:60]:
        tg, tw = got.update(dets), want.update(dets)
        assert [t["track_id"] for t in tg] == [t["track_id"] for t in tw]
        for a, b in zip(tg, tw):
            _same_info(a, b, tol=1e-4)
            seen.add(a["status"])
    assert seen == {"detected", "predicted"}
    # the rest of the clip in one on-device scan, from the state the updates left
    D = kw["d_max"]
    boxes, masks = np.zeros((40, D, 4), np.float32), np.zeros((40, D), bool)
    for f, dets in enumerate(frames[60:]):
        for i, d in enumerate(dets):
            boxes[f, i], masks[f, i] = d[:4], True
    og, ow = got.scan_frames(boxes, masks), want.scan_frames(boxes, masks)
    assert set(og) == set(ow)
    for k in og:
        assert og[k].shape == np.asarray(ow[k]).shape == (40, 16) + og[k].shape[2:]
        if og[k].dtype.kind == "f":
            np.testing.assert_allclose(og[k], ow[k], rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(og[k], ow[k], err_msg=k)
    assert int(got.state["frame_count"]) == int(want.state["frame_count"]) == 100


def test_batched_wrapper_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PBt.BatchedMultiTargetTracker()


def _clip_and_detector(script):
    frames = [np.full((4, 4, 3), f % 256, np.uint8) for f in range(len(script))]  # frame f carries its index
    return frames, (lambda frame: [list(d) for d in script[int(frame[0, 0, 0])]])


def test_track_clip_matches_jax_video_loop(tmp_path, capsys):
    """The port's frame loop on an ndarray clip equals the JAX package's loop
    over the same frames read back from a video file (the detector is a
    script keyed by frame index, so the codec's pixel loss cannot matter)."""
    cv2 = pytest.importorskip("cv2")
    script = make_detection_script(n_frames=110, seed=5)
    vid = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    for f in range(len(script)):
        vw.write(np.full((48, 64, 3), 20, np.uint8))
    vw.release()

    def counting_detector():
        state = {"f": -1}

        def det(_frame):
            state["f"] += 1
            return [list(d) for d in script[state["f"]]]

        return det

    kw = dict(conf_threshold=0.1, max_lost_frames=150, min_hits=1, iou_threshold=0.1, write_video=False)
    want = JP.aircraft_detection_tracking(vid, detector=counting_detector(), **kw)
    got = PP.aircraft_detection_tracking(vid, detector=counting_detector(), **kw)
    assert got == want
    assert got["frames"] == 110 and got["prediction_frames"] >= 39 and got["state_changes"] >= 2

    tracker = PM.EnhancedMultiTargetTracker(max_lost_frames=150, min_hits=1, iou_threshold=0.1)
    seen = []
    clip = np.zeros((110, 48, 64, 3), np.uint8)
    loop = PP.track_clip(iter(clip), counting_detector(), tracker, on_frame=lambda fr, tr, de, info: seen.append(info))
    assert loop == want and len(seen) == 110 and seen[-1]["state_changes"] == want["state_changes"]
    capped = PP.track_clip(iter(clip), counting_detector(), PM.EnhancedMultiTargetTracker(150, 1, 0.1), max_frames=30)
    assert capped["frames"] == 30
    with pytest.raises(FileNotFoundError):
        PP.aircraft_detection_tracking(str(tmp_path / "missing.mp4"), detector=counting_detector())
    capsys.readouterr()


def test_written_video_has_every_frame(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    script = make_detection_script(n_frames=30, seed=5)
    vid, out = str(tmp_path / "clip.avi"), str(tmp_path / "out" / "tracked.mp4")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 30, (320, 240))
    for f in range(len(script)):
        vw.write(np.full((240, 320, 3), 20, np.uint8))
    vw.release()
    it = iter(script)
    stats = PP.aircraft_detection_tracking(vid, detector=lambda _f: [list(d) for d in next(it)], output_path=out)
    cap = cv2.VideoCapture(out)
    try:
        assert stats["frames"] == 30 and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 30
    finally:
        cap.release()
    capsys.readouterr()


def test_clip_loop_with_the_yolo_detector_matches_jax(capsys):
    """best.npz through both facades into both clip loops: a target that moves
    across twelve 96x128 frames and is hidden for four of them."""
    import yolo_tpu

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:96, 0:128]
    clip = []
    for f in range(12):
        img = 30 + rng.normal(0, 2, (96, 128))
        if not 5 <= f < 9:
            img = img + 170 * np.exp(-((xx - (20 + 6 * f)) ** 2 + (yy - (30 + 2 * f)) ** 2) / (2 * 4.0**2))
        clip.append(np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1))

    py = yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu").fuse()
    got = PP.track_clip(iter(clip), PP.yolo_detector(py, 0.1, imgsz=(96, 128), compute_dtype="float32"), PM.EnhancedMultiTargetTracker(150, 1, 0.1))

    jy = yolo_tpu.YOLO(str(WEIGHTS))
    jy.fuse()

    def jax_detector(frame):  # the detector closure of the JAX package's pipeline, at this frame size and in f32
        r = jy.predict(frame, conf=0.1, verbose=False, imgsz=(96, 128), compute_dtype="float32")[0]
        return [[b[0], b[1], b[2], b[3], s] for b, s in zip(r.boxes.xyxy, r.boxes.conf) if s > 0.1]

    want = PP.track_clip(iter(clip), jax_detector, JM.EnhancedMultiTargetTracker(150, 1, 0.1))
    assert {k: v for k, v in got.items() if k != "tracker"} == {k: v for k, v in want.items() if k != "tracker"}
    assert got["detection_frames"] == 8 and got["prediction_frames"] == 4 and got["state_changes"] == 2
    gt, wt = got["tracker"], want["tracker"]
    assert {k: v for k, v in gt.items() if k != "tracker_details"} == {k: v for k, v in wt.items() if k != "tracker_details"}
    for a, b in zip(gt["tracker_details"], wt["tracker_details"]):
        assert {k: v for k, v in a.items() if k != "confidence"} == {k: v for k, v in b.items() if k != "confidence"}
        assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-4)
    capsys.readouterr()
