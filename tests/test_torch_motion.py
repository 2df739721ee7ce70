"""The port's camera-motion compensation (`yolo_tpu_torch/motion/`) against the
JAX package's (`yolo_tpu/motion/`), on the CPU: the global motion detector
(LK flow, ORB matching and their hybrid, host cv2 in both), the reset tracker,
the motion-compensated multi-tracker and the method comparison. Both packages
run the same numpy and cv2 code in one process, so every value must be equal,
not close. Track ids are random uuids in both packages: the tests give both
tracker modules the same seeded sequence of uuids."""

import random
import types
import uuid

import cv2
import numpy as np
import pytest

from demos.motion_comp_bench import make_panning_clip
from yolo_tpu.kalman import tracker as JT
from yolo_tpu.motion import compare as JC
from yolo_tpu.motion import global_motion_detector as JG
from yolo_tpu.motion import motion_compensated_tracker as JMC
from yolo_tpu.motion import motion_reset_tracker as JR
from yolo_tpu_torch.kalman import tracker as PT
from yolo_tpu_torch.motion import compare as PC
from yolo_tpu_torch.motion import global_motion_detector as PG
from yolo_tpu_torch.motion import motion_compensated_tracker as PMC
from yolo_tpu_torch.motion import motion_reset_tracker as PR

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

METHODS = ("optical_flow", "feature_matching", "hybrid")


def assert_same(a, b, path="value"):
    """Exact equality through dicts, lists, tuples, deques and numpy arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) or type(a).__name__ == "deque":
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def seeded_uuids(monkeypatch):
    """Both packages' tracker modules draw track ids from the same seeded uuid sequence."""
    for mod in (JT, PT):
        rng = random.Random(0)
        monkeypatch.setattr(mod, "uuid", types.SimpleNamespace(uuid4=lambda rng=rng: uuid.UUID(int=rng.getrandbits(128))))


@pytest.fixture(scope="module")
def panning_clip():
    """The config-5 clip (camera pan plus two abrupt jumps, at frames 32 and 64) at 320x256, as BGR."""
    return np.repeat(make_panning_clip(96, w=320, h=256)[..., None], 3, -1)


@pytest.mark.parametrize("method", METHODS)
def test_global_motion_detector_matches_jax(panning_clip, method, capsys):
    got, want = PG.GlobalMotionDetector(method), JG.GlobalMotionDetector(method)
    resets = 0
    for frame in panning_clip:
        g, w = got.detect_motion(frame), want.detect_motion(frame)
        assert_same(g, w)
        resets += bool(g[3])
    assert_same(got.stats, want.stats)
    assert_same(got.get_stats(), want.get_stats())
    assert_same(list(got.motion_history), list(want.motion_history))
    assert resets >= 2 and got.stats["motion_events"] >= 2  # both camera jumps fire
    got.reset_stats()
    want.reset_stats()
    assert_same(got.stats, want.stats)
    assert PG.GlobalMotionDetector._calculate_motion_consistency([np.array([1.0, 0.0])]) == 0.0
    capsys.readouterr()


def _reset_script(kind, n=60, seed=0):
    """A bbox per frame (None: the frame is lost) for one target: smooth motion, or a
    position jump, a velocity change, a size change, or jumps inside and after the cooldown."""
    rng = np.random.default_rng(seed)
    boxes, x, y, vx, w, h = [], 100.0, 100.0, 3.0, 20.0, 16.0
    for f in range(1, n):
        if kind == "jump" and f == 30:
            x, y = x + 200.0, y + 150.0
        if kind == "velocity" and f == 30:
            vx = 75.0
        if kind == "size" and f == 30:
            w, h = 34.0, 26.0
        if kind == "cooldown" and f in (20, 24, 45):
            x, y = x + 180.0, y - 90.0
        x += vx
        j = rng.normal(0, 0.3, 2)
        lost = kind == "smooth" and 40 <= f < 46
        boxes.append(None if lost else [x + j[0], y + j[1], x + j[0] + w, y + j[1] + h])
    return boxes


@pytest.mark.parametrize("kind", ["smooth", "jump", "velocity", "size", "cooldown"])
def test_reset_tracker_matches_jax(kind, capsys):
    got = PR.MotionResetKalmanTracker([100, 100, 120, 116], track_id="T001")
    want = JR.MotionResetKalmanTracker([100, 100, 120, 116], track_id="T001")
    assert got.position_history.maxlen == 8
    for bbox in _reset_script(kind):
        assert_same(got.predict(), want.predict())
        for t in (got, want):
            if bbox is None:
                t.mark_as_lost()
            else:
                t.update(list(bbox))
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.P, want.P)
        assert got.reset_count == want.reset_count
        assert_same(got.reset_reasons, want.reset_reasons)
        assert_same(got.get_track_info(), want.get_track_info())
    assert_same(got.get_reset_statistics(), want.get_reset_statistics())
    # velocity: 75 px/frame resets at its first frame and again once the cooldown is over
    expected = {"smooth": 0, "jump": 1, "velocity": 2, "size": 1, "cooldown": 2}[kind]
    assert got.reset_count == expected
    capsys.readouterr()


def _detections(n, seed=3):
    """Seeded detections for the panning clip: three targets, dropouts, a duplicate box."""
    rng = np.random.default_rng(seed)
    dets = []
    for f in range(n):
        frame = []
        for i, (x0, y0, vx, vy) in enumerate(((40, 60, 1.5, 0.5), (250, 180, -1.2, -0.4), (150, 40, 0.2, 1.0))):
            if rng.random() < 0.15 or (i == 1 and 40 <= f < 55):
                continue
            cx, cy = x0 + vx * f + (25 if f >= 32 else 0) + rng.normal(0, 0.5), y0 + vy * f + rng.normal(0, 0.5)
            frame.append([cx - 6, cy - 6, cx + 6, cy + 6, float(rng.uniform(0.3, 0.9))])
        if f % 17 == 5 and frame:
            frame.append(list(frame[0]))
        dets.append(frame)
    return dets


@pytest.mark.parametrize("method", METHODS)
def test_motion_compensated_tracker_matches_jax(panning_clip, method, seeded_uuids, capsys):
    kw = dict(max_lost_frames=150, min_hits=1, iou_threshold=0.1, motion_detection_method=method)
    got, want = PMC.MotionCompensatedMultiTracker(**kw), JMC.MotionCompensatedMultiTracker(**kw)
    n_tracks = 0
    for frame, dets in zip(panning_clip, _detections(len(panning_clip))):
        g = got.update([list(d) for d in dets], frame)
        w = want.update([list(d) for d in dets], frame)
        assert_same(g, w)
        n_tracks += len(g)
    assert_same(got.get_comprehensive_stats(), want.get_comprehensive_stats())
    basic = got.get_comprehensive_stats()["basic"]
    assert n_tracks > 0 and basic["global_motion_events"] >= 1
    for t in (got, want):
        t.enable_adaptive_mode(False)
        t.set_global_motion_sensitivity(1.5)
        t.set_global_motion_sensitivity(3.0)  # out of range: a message, no change
        t.reset_all_statistics()
    assert_same(got.get_comprehensive_stats(), want.get_comprehensive_stats())
    assert got.motion_detector.reset_motion_threshold == want.motion_detector.reset_motion_threshold
    capsys.readouterr()


def test_greedy_association_ties_match_jax(capsys):
    """Equal IoUs go to the larger indices in both (Python's reverse sort of (iou, d, t) tuples)."""
    box = [10.0, 10.0, 30.0, 30.0, 0.9]
    dets = [list(box), list(box), [50.0, 50.0, 60.0, 60.0, 0.5], [200.0, 0.0, 210.0, 10.0, 0.4]]
    preds = [box[:4], box[:4], [52.0, 50.0, 62.0, 60.0]]
    got = PMC.MotionCompensatedMultiTracker().associate_detections_to_trackers(dets, preds, 0.1)
    want = JMC.MotionCompensatedMultiTracker().associate_detections_to_trackers(dets, preds, 0.1)
    assert_same(got, want)
    assert got[0][0] == [1, 1] and got[1] == [3] and got[2] == []
    assert_same(PMC.MotionCompensatedMultiTracker().associate_detections_to_trackers([], preds, 0.1), ([], [], [0, 1, 2]))
    capsys.readouterr()


def test_compare_motion_methods_matches_jax(panning_clip, tmp_path, capsys):
    """Both packages' comparison over one decoded mp4v file with a stub detector:
    equal frame counts, events, resets and motion stats per method."""
    vid = tmp_path / "pan.mp4"
    vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 256))
    for frame in panning_clip[:48]:
        vw.write(frame)
    vw.release()
    dets = _detections(48)

    def stub():
        it = iter(dets)
        return lambda frame: [list(d) for d in next(it)]

    got = PC.compare_motion_methods(vid, stub(), methods=("optical_flow",), report_path=tmp_path / "p.txt")
    want = JC.compare_motion_methods(vid, stub(), methods=("optical_flow",), report_path=tmp_path / "j.txt")
    for method in ("feature_matching", "hybrid"):
        got["results"].update(PC.compare_motion_methods(vid, stub(), methods=(method,), max_frames=40)["results"])
        want["results"].update(JC.compare_motion_methods(vid, stub(), methods=(method,), max_frames=40)["results"])
    assert set(got["results"]) == set(METHODS) and PC.METHODS == JC.METHODS
    for method in METHODS:
        g, w = got["results"][method], want["results"][method]
        assert g["frames"] == w["frames"] == (48 if method == "optical_flow" else 40)
        assert_same({k: v for k, v in g.items() if k not in ("fps", "ms_per_frame")},
                    {k: v for k, v in w.items() if k not in ("fps", "ms_per_frame")})
    assert got["results"]["optical_flow"]["global_motion_events"] >= 1
    strip = lambda text: [ln for ln in text.splitlines() if "FPS" not in ln and "Recommended" not in ln]  # noqa: E731
    assert strip((tmp_path / "p.txt").read_text()) == strip((tmp_path / "j.txt").read_text())
    with pytest.raises(RuntimeError, match="cannot open"):
        PC.compare_motion_methods(tmp_path / "missing.mp4", stub())
    capsys.readouterr()
