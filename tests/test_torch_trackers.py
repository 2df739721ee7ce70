"""The port's MOT trackers against the JAX package's, on the CPU: the Kalman
filters, the association costs, ByteTrack and BoT-SORT on synthetic detection
streams, the batched ByteTrack twin (torch on the CPU) and its scan, the
tracker routing, and `YOLO(best.npz).track` end to end. Inputs come from
seeded numpy generators; the JAX side runs as its own tests run it.

Tolerances: the Kalman filters rtol 1e-6 (the same float64 numpy code);
costs and assignments exact; host tracker rows 1e-5; the batched twin ids
exact and rows 1e-4 (its 4x4 inverse and products sum in another order than
XLA's); `YOLO.track` ids and row counts exact, boxes 1e-2 px, conf 1e-4 (f32)."""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.trackers import batched as JBT
from yolo_tpu.trackers import bot_sort as JBS
from yolo_tpu.trackers import byte_tracker as JBY
from yolo_tpu.trackers import kalman_filter as JKF
from yolo_tpu.trackers import matching as JM
from yolo_tpu.trackers import track as JT
from yolo_tpu.utils import IterableSimpleNamespace
from yolo_tpu_torch.engine.results import Results
from yolo_tpu_torch.trackers import batched as PBT
from yolo_tpu_torch.trackers import bot_sort as PBS
from yolo_tpu_torch.trackers import byte_tracker as PBY
from yolo_tpu_torch.trackers import kalman_filter as PKF
from yolo_tpu_torch.trackers import matching as PM
from yolo_tpu_torch.trackers import track as PT

from tests.conftest import ROOT
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


def synth_stream(n_frames=40, drop=(15, 22)):
    """Two targets moving linearly; target 0 drops out during `drop`."""
    frames = []
    for f in range(n_frames):
        dets = []
        if not (drop[0] <= f < drop[1]):
            dets.append(([100 + 4 * f, 200.0, 30.0, 20.0], 0.9, 0))
        dets.append(([400 - 3 * f + 0.01 * f * f, 300.0, 40.0, 24.0], 0.85, 0))
        frames.append(dets)
    return frames


def _rich_stream(n_frames=60, seed=3, n_targets=5):
    """Multi-target scene with dropouts, low-conf dips (second-stage rescue),
    late joiners and departures; targets well separated so greedy and optimal
    assignment agree (the batched twin's contract)."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform([60, 60], [560, 420], (n_targets, 2))
    vels = rng.uniform(-4, 4, (n_targets, 2))
    frames = []
    for f in range(n_frames):
        dets = []
        for t in range(n_targets):
            if t == 2 and 20 <= f < 28:
                continue  # full dropout → lost + re-acquire
            if t == 3 and f < 10:
                continue  # late joiner
            if t == 4 and f > 45:
                continue  # departure
            cx, cy = starts[t] + vels[t] * f
            if not (20 < cx < 620 and 20 < cy < 490):
                continue
            conf = 0.9 if not (t == 1 and 30 <= f < 36) else 0.18  # low-conf dip → stage-2 rescue
            w, h = 26 + 2 * t, 18 + t
            dets.append(([cx, cy, w, h], conf, t % 3))
        frames.append(dets)
    return frames


def _args(**over):
    base = dict(
        tracker_type="bytetrack", track_high_thresh=0.25, track_low_thresh=0.1,
        new_track_thresh=0.25, track_buffer=30, match_thresh=0.8, fuse_score=True,
        gmc_method="sparseOptFlow", proximity_thresh=0.5, appearance_thresh=0.8, with_reid=False, model="auto",
    )
    base.update(over)
    return IterableSimpleNamespace(**base), SimpleNamespace(**base)


def _frame_arrays(dets, rng=None, noise=0.25):
    boxes = np.array([d[0] for d in dets], np.float32).reshape(-1, 4)
    if rng is not None:
        boxes = boxes + rng.normal(0, noise, boxes.shape).astype(np.float32)
    return boxes, np.array([d[1] for d in dets], np.float32), np.array([d[2] for d in dets], np.float32)


def _by_id(rows):
    return rows[np.argsort(rows[:, 4], kind="stable")] if len(rows) else rows


# --- kalman_filter --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["KalmanFilterXYAH", "KalmanFilterXYWH"])
def test_kalman_filters_match_jax(name):
    rng = np.random.default_rng(0)
    got_kf, want_kf = getattr(PKF, name)(), getattr(JKF, name)()
    z0 = np.array([120.0, 200.0, 1.4 if name.endswith("XYAH") else 28.0, 20.0])
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)  # noqa: E731
    mg, cg = got_kf.initiate(z0)
    mw, cw = want_kf.initiate(z0)
    close(mg, mw), close(cg, cw)
    for i in range(6):
        mg, cg = got_kf.predict(mg, cg)
        mw, cw = want_kf.predict(mw, cw)
        close(mg, mw), close(cg, cw)
        close(got_kf.project(mg, cg)[1], want_kf.project(mw, cw)[1])
        z = z0 + rng.normal(0, 1.0, 4) * [3, 3, 0.05, 0.5]
        mg, cg = got_kf.update(mg, cg, z)
        mw, cw = want_kf.update(mw, cw, z)
        close(mg, mw), close(cg, cw)
    means = np.stack([mg, mg + 1, mg * 1.1])
    covs = np.stack([cg, cg * 1.1, cg * 0.9])
    for a, b in zip(got_kf.multi_predict(means.copy(), covs.copy()), want_kf.multi_predict(means.copy(), covs.copy())):
        close(a, b)
    meas = mg[:4] + rng.normal(0, 2.0, (7, 4))
    for only_position in (False, True):
        for metric in ("maha", "gaussian"):
            close(got_kf.gating_distance(mg, cg, meas.copy(), only_position, metric),
                  want_kf.gating_distance(mw, cw, meas.copy(), only_position, metric))


# --- matching -----------------------------------------------------------------------------------


@pytest.mark.parametrize("shape,thresh", [((0, 3), 0.8), ((4, 0), 0.8), ((5, 7), 0.8), ((9, 4), 0.5), ((6, 6), 0.3)])
def test_linear_assignment_matches_jax(shape, thresh):
    cost = np.random.default_rng(sum(shape)).uniform(0, 1, shape)
    got, want = PM.linear_assignment(cost, thresh), JM.linear_assignment(cost, thresh)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _boxes(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 80, (n, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("na,nb", [(0, 4), (3, 0), (6, 9)])
def test_iou_distance_fuse_score_and_embedding_distance_match_jax(na, nb):
    """Box lists and track lists alike; exact."""
    rng = np.random.default_rng(na * 10 + nb)
    a, b = _boxes(rng, na), _boxes(rng, nb)
    a[: min(na, nb) // 2] = b[: min(na, nb) // 2]  # some identical boxes: IoU 1
    got, want = PM.iou_distance(list(a), list(b)), JM.iou_distance(list(a), list(b))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    feats = rng.normal(0, 1, (na + nb, 8)).astype(np.float32)

    def tracks(boxes, scores, feats):
        return [SimpleNamespace(xyxy=x, score=s, curr_feat=f, smooth_feat=f) for x, s, f in zip(boxes, scores, feats)]

    scores = rng.uniform(0.1, 1, nb).astype(np.float32)
    ta, tb = tracks(a, np.ones(na), feats[:na]), tracks(b, scores, feats[na:])
    np.testing.assert_array_equal(PM.iou_distance(ta, tb), JM.iou_distance(ta, tb))
    np.testing.assert_array_equal(PM.fuse_score(got, tb), JM.fuse_score(want, tb))
    np.testing.assert_array_equal(PM.embedding_distance(ta, tb), JM.embedding_distance(ta, tb))


# --- BYTETracker / BOTSORT (host) -----------------------------------------------------------------


def _run_pair(got_trk, want_trk, stream, rng=None, imgs=None, feats=None):
    """Feed both trackers the same frames (copies: the trackers may write to their inputs) → frames compared."""
    n_rows = 0
    for f, dets in enumerate(stream):
        boxes, scores, cls = _frame_arrays(dets, rng)
        img = None if imgs is None else imgs[f]
        ft = None if feats is None else feats[f]
        a = got_trk.update(boxes.copy(), scores.copy(), cls.copy(), img=img, feats=ft)
        b = want_trk.update(boxes.copy(), scores.copy(), cls.copy(), img=img, feats=ft)
        assert a.shape == b.shape, (f, a, b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f"frame {f}")
        n_rows += len(a)
    return n_rows


@pytest.mark.parametrize("stream", ["synth", "rich"])
def test_bytetracker_matches_jax(stream):
    frames = synth_stream() if stream == "synth" else _rich_stream()
    ja, pa = _args()
    assert _run_pair(PBY.BYTETracker(pa), JBY.BYTETracker(ja), frames, np.random.default_rng(1)) > len(frames)


def test_bytetracker_zero_detections_and_reset_match_jax():
    ja, pa = _args()
    got, want = PBY.BYTETracker(pa), JBY.BYTETracker(ja)
    empty = [np.zeros((0, 4), np.float32), np.zeros((0,), np.float32), np.zeros((0,), np.float32)]
    assert got.update(*empty).shape[0] == want.update(*empty).shape[0] == 0
    stream = [[([50, 50, 10, 10], 0.9, 0)]] * 3 + [[]] + [[([52, 50, 10, 10], 0.9, 0)]] * 2
    _run_pair(got, want, stream)
    got.reset(), want.reset()
    assert got.frame_id == want.frame_id == 0
    _run_pair(got, want, synth_stream(n_frames=12))


def _panning_frames(n, seed=0, h=240, w=320, pan=(2.0, 1.0)):
    """Textured BGR frames of a camera panning over a seeded scene (sparse optical flow has points to follow)."""
    import cv2

    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.uniform(0, 255, (h + 80, w + 80)).astype(np.float32), (0, 0), 3)
    big = cv2.normalize(big, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    frames = []
    for f in range(n):
        x, y = int(round(pan[0] * f)), int(round(pan[1] * f))
        frames.append(np.repeat(big[y : y + h, x : x + w, None], 3, -1).copy())
    return frames


@pytest.mark.parametrize("gmc_method", ["none", "sparseOptFlow", "orb"])
def test_botsort_matches_jax(gmc_method):
    """BoT-SORT over seeded panning frames (the GMC warp moves the tracks), a
    zero-detection frame included."""
    frames = _rich_stream(n_frames=30, seed=5)
    frames[12] = []
    imgs = _panning_frames(len(frames))
    ja, pa = _args(tracker_type="botsort", gmc_method=gmc_method)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "not enough matching points" on a frame
        n = _run_pair(PBS.BOTSORT(pa), JBS.BOTSORT(ja), frames, np.random.default_rng(2), imgs=imgs)
    assert n > len(frames)


def test_botsort_appearance_features_match_jax():
    """with_reid and model 'auto': the detections' own features gate the costs;
    they follow the high / low confidence split."""
    frames = _rich_stream(n_frames=25, seed=9)
    rng = np.random.default_rng(3)
    protos = rng.normal(0, 1, (5, 16)).astype(np.float32)
    feats = [np.stack([protos[int(round(d[0][2] - 26)) // 2] + rng.normal(0, 0.1, 16) for d in dets]).astype(np.float32)
             if dets else np.zeros((0, 16), np.float32) for dets in frames]
    ja, pa = _args(tracker_type="botsort", gmc_method="none", with_reid=True)
    got, want = PBS.BOTSORT(pa), JBS.BOTSORT(ja)
    _run_pair(got, want, frames, np.random.default_rng(4), imgs=[np.zeros((8, 8, 3), np.uint8)] * len(frames), feats=feats)
    for g, w in zip(sorted(got.tracked_stracks, key=lambda t: t.track_id), sorted(want.tracked_stracks, key=lambda t: t.track_id)):
        np.testing.assert_allclose(g.smooth_feat, w.smooth_feat, rtol=0, atol=1e-6)


def _same_tracks(got, want, feat_tol=1e-4):
    """Tracked, lost and removed tracks alike: ids and states equal, features within feat_tol."""
    for kind in ("tracked_stracks", "lost_stracks", "removed_stracks"):
        g = sorted(getattr(got, kind), key=lambda t: t.track_id)
        w = sorted(getattr(want, kind), key=lambda t: t.track_id)
        assert [(t.track_id, t.state) for t in g] == [(t.track_id, t.state) for t in w], kind
        for a, b in zip(g, w):
            for f in ("curr_feat", "smooth_feat"):
                assert (getattr(a, f) is None) == (getattr(b, f) is None), (kind, f)
                if getattr(a, f) is not None:
                    np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=feat_tol, err_msg=f"{kind} {f}")


def test_botsort_reid_encoder_matches_jax(two_threads):
    """with_reid and a named model: the crop-and-embed encoder, `YOLO("yolov8n.yaml").embed` of each
    detection's crop at imgsz 128 (both packages draw the same initial tree), L2-normalised. JAX's
    `test_botsort_reid_encoder_path` scenario (a 128x160 seeded frame, three updates), then _rich_stream
    with a seeded 480x640 frame each: rows 1e-5, ids and states equal, features 1e-4 (the f32
    tolerance of `test_embed_matches_jax`). The namespace's `device` puts the port's encoder on the CPU."""
    ja, pa = _args(tracker_type="botsort", gmc_method="none", with_reid=True, model="yolov8n.yaml")
    pa.device = "cpu"
    got, want = PBS.BOTSORT(pa), JBS.BOTSORT(ja)
    assert isinstance(got.encoder, PBS.ReID) and got.encoder.model.device == torch.device("cpu")
    img = np.random.default_rng(0).integers(0, 255, (128, 160, 3), np.uint8)
    _run_pair(got, want, [[([40 + 2 * f, 60, 30, 24], 0.9, 0)] for f in range(3)], imgs=[img] * 3)
    assert len(got.tracked_stracks) == 1 and abs(float(np.linalg.norm(got.tracked_stracks[0].smooth_feat)) - 1) < 1e-3
    _same_tracks(got, want)

    frames = _rich_stream(n_frames=30, seed=7)
    frames[5].append(([700.0, 300.0, 30.0, 20.0], 0.9, 0))  # a box outside the frame: the 8x8 black crop
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 255, (480, 640, 3), np.uint8) for _ in frames]
    got, want = PBS.BOTSORT(pa), JBS.BOTSORT(ja)
    assert _run_pair(got, want, frames, np.random.default_rng(12), imgs=imgs) > len(frames)
    _same_tracks(got, want)


# --- the batched twin -----------------------------------------------------------------------------


@pytest.mark.parametrize("n_max,d_max", [(64, 16), (8, 4)])
def test_batched_byte_twin_matches_jax(n_max, d_max):
    """The torch slot-table step on the CPU against the JAX twin on _rich_stream
    (d_max 4 drops detections beyond the fourth, n_max 8 fills the table)."""
    ja, pa = _args()
    got = PBT.BatchedBYTETracker(pa, n_max=n_max, d_max=d_max, device="cpu")
    want = JBT.BatchedBYTETracker(ja, n_max=n_max, d_max=d_max)
    rng = np.random.default_rng(1)
    n_rows = 0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for f, dets in enumerate(_rich_stream()):
            boxes, scores, cls = _frame_arrays(dets, rng)
            a = got.update(boxes.copy(), scores.copy(), cls.copy())
            b = want.update(boxes.copy(), scores.copy(), cls.copy())
            assert a.shape == b.shape, (f, a, b)
            np.testing.assert_array_equal(a[:, 4], b[:, 4], err_msg=f"ids, frame {f}")
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=f"frame {f}")
            n_rows += len(a)
    assert n_rows > 100
    dropped = [w for w in seen if "d_max" in str(w.message)]
    assert len(dropped) == (1 if d_max < 5 else 0)
    for k in ("state", "track_id", "det_idx", "tracklet_len", "last_frame", "start_frame", "next_id", "frame"):
        np.testing.assert_array_equal(got.state[k].numpy(), np.asarray(want.state[k]), err_msg=k)
    assert got.state["track_id"].dtype == got.state["next_id"].dtype == torch.int32


def test_batched_byte_twin_matches_the_host_tracker():
    """The JAX package's contract: on _rich_stream the twin's rows equal the host BYTETracker's, ids exact."""
    _, pa = _args()
    host, dev = PBY.BYTETracker(pa), PBT.BatchedBYTETracker(pa, n_max=64, d_max=16, device="cpu")
    rng = np.random.default_rng(1)
    for f, dets in enumerate(_rich_stream()):
        boxes, scores, cls = _frame_arrays(dets, rng)
        a, b = _by_id(host.update(boxes.copy(), scores.copy(), cls.copy())), dev.update(boxes.copy(), scores.copy(), cls.copy())
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a[:, 4], b[:, 4])
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2, err_msg=f"frame {f}")


def _scan_inputs(frames, D):
    T = len(frames)
    xywh, sc, cl, mask = np.zeros((T, D, 4), np.float32), np.zeros((T, D), np.float32), np.zeros((T, D), np.float32), np.zeros((T, D), bool)
    for f, dets in enumerate(frames):
        for i, (b, s, c) in enumerate(dets[:D]):
            xywh[f, i], sc[f, i], cl[f, i], mask[f, i] = b, s, c, True
    return xywh, sc, cl, mask


def _scan_rows(outs, f):
    keep = np.flatnonzero(outs["emit"][f])
    keep = keep[np.argsort(outs["track_id"][f][keep])]
    cols = [outs["xyxy"][f][keep]] + [outs[k][f][keep, None] for k in ("track_id", "score", "cls", "det_idx")]
    return np.concatenate(cols, 1).astype(np.float32)


def test_batched_byte_scan_matches_stepwise_and_jax():
    """scan_frames (d_max rounds a stage, no host read) == update frame by frame (rounds from the
    host's counts), and == the JAX scan; then a second chunk continues from the first's state."""
    frames = _rich_stream(n_frames=40, seed=7)
    D = 16
    seq = _scan_inputs(frames, D)
    ja, pa = _args()
    step = PBT.BatchedBYTETracker(pa, n_max=64, d_max=D, device="cpu")
    stepwise = [step.update(seq[0][f][seq[3][f]], seq[1][f][seq[3][f]], seq[2][f][seq[3][f]]) for f in range(len(frames))]
    scan = PBT.BatchedBYTETracker(pa, n_max=64, d_max=D, device="cpu")
    outs = {}
    for lo, hi in ((0, 25), (25, 40)):  # two chunks: the state carries over
        part = scan.scan_frames(*(torch.from_numpy(a[lo:hi]) for a in seq))
        outs = {k: np.concatenate([outs[k], v]) if k in outs else v for k, v in part.items()}
    want = JBT.BatchedBYTETracker(ja, n_max=64, d_max=D).scan_frames(*seq)
    assert outs["track_id"].dtype == np.int32 and outs["emit"].any()
    for f in range(len(frames)):
        np.testing.assert_array_equal(stepwise[f], _scan_rows(outs, f), err_msg=f"frame {f}")
        np.testing.assert_array_equal(outs["emit"][f], want["emit"][f])
        np.testing.assert_array_equal(outs["track_id"][f], want["track_id"][f])
        np.testing.assert_allclose(_scan_rows(outs, f), _scan_rows(want, f), rtol=0, atol=1e-4, err_msg=f"frame {f}")


def test_greedy_assign_ties_take_the_first_flat_index():
    """Equal costs: the lowest flat index wins each round, as jnp.argmin picks it."""
    import jax.numpy as jnp

    cost = np.array([[0.2, 0.2, 0.5], [0.2, 0.2, 0.9], [1e9, 0.1, 0.1]], np.float32)
    got = PBT._greedy_assign(torch.from_numpy(cost), 0.8, 3).numpy()
    want = np.asarray(JBT._greedy_assign(jnp.asarray(cost), 0.8, 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 2, -1])


# --- track.py -----------------------------------------------------------------------------------------


def test_create_tracker_routing(monkeypatch):
    """The default is the host ByteTrack (the JAX rule picks the twin on TPU
    backends only); YOLO_TPU_DEVICE_TRACKER turns the twin on and off, with its
    capacities from the environment; BoT-SORT never routes to the twin."""
    monkeypatch.delenv("YOLO_TPU_DEVICE_TRACKER", raising=False)
    assert type(PT.create_tracker("bytetrack.yaml")) is PBY.BYTETracker
    assert type(PT.create_tracker(None)) is PBS.BOTSORT
    monkeypatch.setenv("YOLO_TPU_DEVICE_TRACKER", "1")
    monkeypatch.setenv("YOLO_TPU_DEVICE_TRACKER_DMAX", "24")
    dev = PT.create_tracker("bytetrack.yaml", device="cpu")
    assert isinstance(dev, PBT.BatchedBYTETracker) and (dev.n_max, dev.d_max) == (512, 24)
    assert type(PT.create_tracker("botsort.yaml")) is PBS.BOTSORT
    monkeypatch.setenv("YOLO_TPU_DEVICE_TRACKER", "0")
    assert type(PT.create_tracker("bytetrack.yaml")) is PBY.BYTETracker


@pytest.mark.parametrize("name", ["botsort.yaml", "bytetrack.yaml"])
def test_tracker_cfgs_match_jax(name, tmp_path):
    assert vars(PT.load_tracker_cfg(name)) == vars(JT.load_tracker_cfg(name))
    bad = tmp_path / "t.yaml"
    bad.write_text("tracker_type: deepsort\n")
    with pytest.raises(ValueError, match="unsupported tracker type"):
        PT.load_tracker_cfg(str(bad))


def test_attach_tracker_subsets_results_like_jax():
    """Results of moving boxes, one empty frame and one frame whose only box scores
    below every threshold: the rewritten Results equal JAX's."""
    from yolo_tpu.engine.results import Results as JResults

    img = np.zeros((480, 640, 3), np.uint8)
    data = [np.array([[100 + 5 * f, 200, 140 + 5 * f, 230, 0.9, 0], [300, 300 - 2 * f, 330, 320 - 2 * f, 0.6, 1]], np.float32)
            for f in range(6)]
    data[3] = np.zeros((0, 6), np.float32)
    data[4] = np.array([[300, 292, 330, 312, 0.05, 1]], np.float32)
    got_model, want_model = SimpleNamespace(device="cpu"), SimpleNamespace()
    got = PT.attach_tracker(got_model, [Results(img, f"f{f}", {0: "a", 1: "b"}, boxes=d) for f, d in enumerate(data)],
                            persist=True, tracker_cfg="bytetrack.yaml")
    want = JT.attach_tracker(want_model, [JResults(img, f"f{f}", {0: "a", 1: "b"}, boxes=d) for f, d in enumerate(data)],
                             persist=True, tracker_cfg="bytetrack.yaml")
    assert [len(r) for r in got] == [len(r) for r in want] == [2, 2, 2, 0, 0, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
        assert g.boxes.is_track == (w.boxes.data.shape[-1] == 7)
    stream = PT.attach_tracker(got_model, iter([Results(img, "x", {}, boxes=data[5])]), persist=True, stream=True)
    assert not isinstance(stream, list) and list(next(stream).boxes.id) == [1.0, 2.0]


def test_results_update_and_list_index():
    img = np.zeros((64, 64, 3), np.uint8)
    r = Results(img, "a", {0: "a"}, boxes=np.array([[1, 2, 3, 4, 0.9, 0], [5, 6, 7, 8, 0.8, 0], [9, 9, 12, 12, 0.7, 0]], np.float32))
    sub = r[np.array([2, 0])]
    np.testing.assert_array_equal(sub.boxes.data, r.boxes.data[[2, 0]])
    assert len(r[[]]) == 0
    sub.update(boxes=np.array([[9, 9, 12, 12, 5, 0.7, 0], [1, 2, 3, 4, 6, 0.9, 0]], np.float32))
    assert sub.boxes.is_track and list(sub.boxes.id) == [5, 6]
    np.testing.assert_array_equal(sub.boxes.conf, r.boxes.conf[[2, 0]])


# --- YOLO.track ------------------------------------------------------------------------------------------


def _ir_frames(n, seed=0, h=512, w=640):
    """640x512 BGR frames of a cloudy IR background with three bright targets on straight tracks."""
    import cv2

    rng = np.random.default_rng(seed)
    bg = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for f in range(n):
        img = bg + rng.normal(0, 2, (h, w))
        for x0, y0, vx, vy in ((100, 120, 6, 2), (400, 300, -5, 3), (300, 80, 1, 5)):
            img = img + 170 * np.exp(-((xx - x0 - vx * f) ** 2 + (yy - y0 - vy * f) ** 2) / (2 * 4.0**2))
        frames.append(np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1))
    return frames


@pytest.fixture(scope="module")
def yolos():
    return yolo_tpu.YOLO(str(WEIGHTS)), yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")


@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "botsort.yaml"])
def test_yolo_track_matches_jax(yolos, tracker):
    """Five 640x512 frames, one per call with persist=True, at the track defaults
    (conf 0.1, max_det 300, imgsz 640); the JAX side in f32."""
    jy, py = yolos
    jy._tracker = py._tracker = None
    n_ids = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the GMC on a frame with few corners
        for frame in _ir_frames(5):
            want = jy.track(frame, persist=True, tracker=tracker, compute_dtype="float32", verbose=False)
            got = py.track(frame, persist=True, tracker=tracker, compute_dtype="float32", verbose=False)
            assert len(got) == len(want) == 1
            g, w = got[0].boxes, want[0].boxes
            assert len(g) == len(w) and g.is_track == (w.data.shape[-1] == 7)
            if len(g):
                np.testing.assert_array_equal(g.id, w.id)
                np.testing.assert_array_equal(g.cls, w.cls)
                np.testing.assert_allclose(g.xyxy, w.xyxy, rtol=0, atol=1e-2)
                np.testing.assert_allclose(g.conf, w.conf, rtol=0, atol=1e-4)
                n_ids |= set(g.id.tolist())
    assert n_ids == {1.0, 2.0, 3.0}
    kind = PBY.BYTETracker if tracker == "bytetrack.yaml" else PBS.BOTSORT
    assert type(py._tracker) is kind
    assert py.predictor.args.conf == 0.1 and py.predictor.args.batch == 1
    # without persist every call starts a new tracker: the first frame's ids again
    again = py.track(_ir_frames(1)[0], tracker=tracker, verbose=False)
    assert sorted(again[0].boxes.id.tolist()) == [1.0, 2.0, 3.0]
