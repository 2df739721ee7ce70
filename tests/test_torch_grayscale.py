"""The port's grayscale fallback tracker (`yolo_tpu_torch/grayscale/`) against
the JAX package's (`yolo_tpu/grayscale/`), on the CPU: the numpy window scorer,
the NCC grid search and template matching (exact: the same numpy and cv2
code), the torch scorer against the JAX one (same index, score at rel 1e-5:
another summation order), the tracker with a stub detector (equal stats and
tracks), the tracker's own YOLO detector on best.npz (the port on
device="cpu"), the INI config and the analysis tools.

Detector tolerances: in f32 both packages give the same boxes (1e-2 px), so
the tracks are equal. At the default compute dtype, bf16 in both, the boxes
may differ by BF16_BOX_PX and the scores by BF16_CONF (a few bf16 steps of a
score near 1), so a track's integer center may differ by one pixel."""

import cv2
import jax
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from tests.conftest import ROOT
from tests.test_grayscale import make_frame
from yolo_tpu.grayscale import analysis as JA
from yolo_tpu.grayscale import config as JCfg
from yolo_tpu.grayscale import scoring as JS
from yolo_tpu.grayscale import tracker as JTr
from yolo_tpu_torch.grayscale import analysis as PA
from yolo_tpu_torch.grayscale import config as PCfg
from yolo_tpu_torch.grayscale import scoring as PS
from yolo_tpu_torch.grayscale import tracker as PTr
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"
BF16_BOX_PX, BF16_CONF = 0.25, 2e-2


@pytest.mark.parametrize("shape", [(40, 40), (40, 23), (17, 40), (5, 5), (3, 7), (0, 12)])
def test_gradient_window_scores_match_jax(shape):
    roi = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    got, want = PS.gradient_window_scores(roi), JS.gradient_window_scores(roi)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_predict_center_matches_jax():
    """Interior ROIs, ROIs clipped at the frame border, ROIs narrower than the window and empty ones."""
    frame = make_frame(83, 57, noise_seed=3)
    centers = [(70, 55), (90, 60), (10, 10), (155, 120), (0, 64), (159, 127), (-17, 60), (80, -18), (-40, 60), (400, 400)]
    for c in centers:
        assert PS.predict_center(frame, c) == JS.predict_center(frame, c), c
        assert PS.predict_center(frame, c, roi_size=24, win=3) == JS.predict_center(frame, c, roi_size=24, win=3), c


@pytest.mark.parametrize("side", [24, 25])
def test_similarity_search_and_template_match_match_jax(side):
    """Even templates are live in the NCC search, odd ones always score -1 (the reference's contract)."""
    template = np.random.default_rng(11).integers(0, 255, (side, side), np.uint8)
    for seed, last_center, radius in [(0, (80, 60), 50), (1, (15, 15), 50), (2, (150, 120), 30), (3, (80, 60), 7)]:
        frame = make_frame(83, 57, noise_seed=seed)
        frame[40 : 40 + side, 90 : 90 + side] = template
        got = PS.grayscale_similarity_search(frame, template, last_center, search_radius=radius)
        assert got == JS.grayscale_similarity_search(frame, template, last_center, search_radius=radius)
        assert (got[1] == -1.0) == (side % 2 == 1)
        assert PS.template_match(frame, template, last_center, radius) == JS.template_match(frame, template, last_center, radius)
    assert PS.grayscale_similarity_search(frame, None, (5, 6)) == JS.grayscale_similarity_search(frame, None, (5, 6)) == ((5, 6), 0.0)


def test_predict_center_torch_matches_jax():
    """Seeded 40x40 ROIs one by one and as a batch, and a constant ROI (an exact tie: index (0, 0))."""
    jit = jax.jit(JS.predict_center_jax)
    rng = np.random.default_rng(5)
    rois = np.concatenate([rng.uniform(0, 255, (6, 40, 40)), [make_frame(20, 17, h=40, w=40, noise_seed=9)]]).astype(np.float32)
    best, score = PS.predict_center_torch(torch.from_numpy(rois))
    assert best.shape == (7, 2) and score.shape == (7,) and best.device.type == "cpu"
    for i, roi in enumerate(rois):
        jb, js = jit(roi)
        one_b, one_s = PS.predict_center_torch(torch.from_numpy(roi))
        assert best[i].tolist() == one_b.tolist() == np.asarray(jb).tolist(), i
        assert float(score[i]) == pytest.approx(float(js), rel=1e-5)
        assert float(one_s) == pytest.approx(float(js), rel=1e-5)
        scores = JS.gradient_window_scores(roi)  # the numpy scorer's argmax too
        assert np.unravel_index(int(np.argmax(scores)), scores.shape) == tuple(best[i].tolist())
    grid = PS.predict_center_torch(torch.from_numpy(rois[:6].reshape(2, 3, 40, 40)))
    assert grid[0].reshape(6, 2).tolist() == best[:6].tolist()
    flat = np.full((40, 40), 77, np.uint8)
    b, s = PS.predict_center_torch(flat)
    jb, js = jit(flat)
    assert b.tolist() == np.asarray(jb).tolist() == [0, 0] and float(s) == float(js) == 77.0


def _blob_video(path, n, h=128, w=160, fps=30):
    """A moving bright blob on noise, written as a BGR mp4v file; both packages read the same decoded frames."""
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in range(n):
        vw.write(cv2.cvtColor(make_frame(20 + 3 * f, 64 + (f % 5), h=h, w=w, noise_seed=f), cv2.COLOR_GRAY2BGR))
    vw.release()
    return path


def _blob_detector(frame):
    """tests/test_grayscale.py's stub: the blob found in the frame itself."""
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
    blur = cv2.GaussianBlur(gray, (5, 5), 0)
    cy, cx = np.unravel_index(int(np.argmax(blur)), blur.shape)
    return [[cx - 6, cy - 6, cx + 6, cy + 6, 0.9, 0]]


def _tracks(tracker):
    return {k: {kk: v[kk] for kk in ("last_center", "last_bbox", "lost_frames", "status", "confidence")} for k, v in tracker.tracks.items()}


@pytest.mark.parametrize("template_side", [None, 24])
def test_process_video_with_a_stub_detector_matches_jax(tmp_path, template_side):
    vid = _blob_video(tmp_path / "clip.mp4", 40)
    template = None if template_side is None else np.random.default_rng(21).integers(100, 255, (template_side,) * 2, np.uint8)
    got = PTr.GrayscaleTracker(detector=_blob_detector, local_grayscale_template=template)
    want = JTr.GrayscaleTracker(detector=_blob_detector, local_grayscale_template=template)
    gs = got.process_video(vid, test_range=(10, 25), max_frames=40, write_video=False)
    ws = want.process_video(vid, test_range=(10, 25), max_frames=40, write_video=False)
    assert gs == ws and gs["predicted_frames"] >= 14 and len(gs["tracks"]) == 1
    assert _tracks(got) == _tracks(want)


def test_process_video_saves_the_same_artifacts_as_jax(tmp_path, monkeypatch):
    vid = _blob_video(tmp_path / "clip.mp4", 12, h=64, w=96)
    trees = []
    for name, pkg in (("p", PTr), ("j", JTr)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)  # the run directories are made under the working directory
        t = pkg.GrayscaleTracker(detector=_blob_detector, save_process=True)
        stats = t.process_video(vid, test_range=(4, 9))
        files = sorted(str(p.relative_to(t.process_dir)) for p in t.process_dir.rglob("*") if p.is_file())
        trees.append((stats, files, sorted(p.name for p in (tmp_path / name).rglob("*.mp4"))))
    assert trees[0] == trees[1] and trees[0][1] and trees[0][2] == ["clip_tracked.mp4"]


# --- the trackers' own detector: YOLO(best.npz) in both packages ------------------------------------------


def _ir_video(path, n=4):
    """640x512 frames (imgsz 640 only pads them) with two bright targets, the second hidden on
    frame 1; with IR_TEST_RANGE, frame 2 is a forced loss: detect, coast one, coast both, detect."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:640]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (640, 512))
    for f in range(n):
        img = 30 + rng.normal(0, 2, (512, 640))
        for i, (x0, y0, vx, vy) in enumerate(((100, 120, 6, 2), (400, 300, -5, 3))):
            if not (i == 1 and f == 1):
                img = img + 170 * np.exp(-((xx - x0 - vx * f) ** 2 + (yy - y0 - vy * f) ** 2) / (2 * 4.0**2))
        vw.write(np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1))
    vw.release()
    return path


IR_TEST_RANGE = (2, 2)


@pytest.fixture
def two_threads():
    """The port's CPU forward at 640 with two intra-op threads: when the suite runs in parallel
    workers, a thread per core in each of them makes every forward tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ir_video(tmp_path_factory):
    return _ir_video(tmp_path_factory.mktemp("gray") / "ir.mp4")


@pytest.fixture(scope="module")
def jax_default_run(ir_video):
    """The JAX tracker with its own YOLO at the defaults (bf16) → (stats, tracks): the reference
    of both the port's tracker and its CLI (the JAX CLI runs exactly this)."""
    t = JTr.GrayscaleTracker(str(WEIGHTS))
    return t.process_video(ir_video, test_range=IR_TEST_RANGE, write_video=False), _tracks(t)


def test_yolo_detect_f32_matches_jax(ir_video, two_threads):
    """Both trackers' own `yolo_detect` with their YOLO set to f32 (the JAX predictor fixes its
    dtype at its first call, from `overrides`): equal stats and tracks."""
    got, want = PTr.GrayscaleTracker(str(WEIGHTS), device="cpu"), JTr.GrayscaleTracker(str(WEIGHTS))
    got._yolo = yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu").fuse()
    want._yolo = yolo_tpu.YOLO(str(WEIGHTS))
    want._yolo.fuse()
    for t in (got, want):
        t._yolo.overrides["compute_dtype"] = "float32"
    gs = got.process_video(ir_video, test_range=IR_TEST_RANGE, write_video=False)
    ws = want.process_video(ir_video, test_range=IR_TEST_RANGE, write_video=False)
    assert got._yolo.predictor.dtype == torch.float32
    assert gs == ws and gs["frames"] == 4 and gs["detected_frames"] == 3 and gs["predicted_frames"] == 2
    assert len(gs["tracks"]) == 2
    g, w = _tracks(got), _tracks(want)
    for k in g:
        np.testing.assert_allclose(g[k].pop("last_bbox"), w[k].pop("last_bbox"), rtol=0, atol=1e-2)
        assert g[k].pop("confidence") == pytest.approx(w[k].pop("confidence"), abs=1e-4)
    assert g == w


def _same_at_bf16(gs, g, ws, w):
    """Equal counts, statuses and lost counts; centers within a pixel, boxes and scores at the bf16 tolerance."""
    assert {k: v for k, v in gs.items() if k != "tracks"} == {k: v for k, v in ws.items() if k != "tracks"}
    assert set(g) == set(w) == {0, 1}
    for k in g:
        assert (g[k]["status"], g[k]["lost_frames"]) == (w[k]["status"], w[k]["lost_frames"])
        assert np.abs(np.subtract(g[k]["last_center"], w[k]["last_center"])).max() <= 1
        np.testing.assert_allclose(g[k]["last_bbox"], w[k]["last_bbox"], rtol=0, atol=BF16_BOX_PX + 1)
        assert g[k]["confidence"] == pytest.approx(w[k]["confidence"], abs=BF16_CONF)


def test_yolo_detect_default_dtype_matches_jax(ir_video, jax_default_run, two_threads):
    """Both trackers build their own YOLO and predict at the defaults (bf16 in both)."""
    got = PTr.GrayscaleTracker(str(WEIGHTS), device="cpu")
    gs = got.process_video(ir_video, test_range=IR_TEST_RANGE, write_video=False)
    assert got._yolo.predictor.dtype == torch.bfloat16 and got._yolo.device == torch.device("cpu")
    assert gs["detected_frames"] == 3 and gs["predicted_frames"] == 2
    _same_at_bf16(gs, _tracks(got), *jax_default_run)


def test_main_matches_jax(ir_video, jax_default_run, tmp_path, two_threads, capsys):
    """`python -m yolo_tpu_torch.grayscale.tracker VIDEO --model M --test 2,2 --device cpu --output O`
    at the default dtype against the JAX tracker's run (the JAX CLI runs that tracker); it writes O."""
    out = tmp_path / "tracked.mp4"
    got = PTr.main([str(ir_video), "--model", str(WEIGHTS), "--test", "2,2", "--device", "cpu", "--output", str(out)])
    ws, w = jax_default_run
    assert {k: v for k, v in got.items() if k != "tracks"} == {k: v for k, v in ws.items() if k != "tracks"}
    assert set(got["tracks"]) == set(w)
    for k, info in got["tracks"].items():
        assert (info["status"], info["lost_frames"]) == (w[k]["status"], w[k]["lost_frames"])
        assert np.abs(np.subtract(info["last_center"], w[k]["last_center"])).max() <= 1
    assert out.stat().st_size > 0
    capsys.readouterr()


def test_yolo_detect_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = PTr.GrayscaleTracker(str(WEIGHTS))  # builds nothing yet
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t.yolo_detect(np.zeros((64, 64, 3), np.uint8), 0)
    t.test_mode_range = (0, 3)  # forced-loss frames never reach the detector
    assert t.yolo_detect(np.zeros((64, 64, 3), np.uint8), 1) == []


# --- config and analysis ---------------------------------------------------------------------------------


def test_config_matches_jax(tmp_path):
    ini = tmp_path / "cfg.ini"
    ini.write_text(
        "[TRACKING_PARAMETERS]\nroi_size = 24\nsearch_radius = 30\nsimilarity_threshold = 0.4\ndistance_threshold = 40\n"
        "max_lost_frames = 9\n[MODEL_SETTINGS]\ndetection_threshold = 0.5\nuse_gpu = no\nmodel_path = w.npz  # a comment\n"
        "[VIDEO_SETTINGS]\noutput_codec = XVID\nprogress_interval = 12.0\n[EXTRA]\nratio = 1.5\ncount = 3\nname = x\n"
    )
    for path in (None, ini, tmp_path / "missing.ini"):
        assert PCfg.load_config(path) == JCfg.load_config(path)
    assert PCfg.DEFAULTS == JCfg.DEFAULTS
    got = PCfg.tracker_from_config(ini, detector=lambda f: [], device="cpu")
    want = JCfg.tracker_from_config(ini, detector=lambda f: [])
    keys = ("roi_size", "search_radius", "min_prediction_confidence", "dist_threshold", "conf", "model_path")
    assert [getattr(got, k) for k in keys] == [getattr(want, k) for k in keys] == [24, 30, 0.4, 40.0, 0.5, "w.npz"]
    assert got.device == "cpu" and PCfg.tracker_from_config(None).device is None


def _blob_roi(cx, cy, size=40, seed=0):
    rng = np.random.default_rng(seed)
    roi = rng.normal(30, 3, (size, size)).clip(0, 255)
    yy, xx = np.mgrid[0:size, 0:size]
    roi += 180 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 2.0**2)))
    return roi.clip(0, 255).astype(np.uint8)


def test_roi_methods_and_comparison_match_jax(tmp_path):
    rois = [_blob_roi(25, 14), _blob_roi(8, 30, seed=1), np.full((40, 40), 9, np.uint8), _blob_roi(20, 20, size=41, seed=2)]
    assert list(PA.ROI_METHODS) == list(JA.ROI_METHODS)
    for name in PA.ROI_METHODS:
        assert [PA.ROI_METHODS[name](r) for r in rois] == [JA.ROI_METHODS[name](r) for r in rois], name
    truth = [(25, 14), (8, 30), (20, 20), (20, 20)]
    got = PA.roi_analysis_comparison(rois, truth, report_path=tmp_path / "p.txt")
    assert got == JA.roi_analysis_comparison(rois, truth, report_path=tmp_path / "j.txt")
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert PA.roi_analysis_comparison(rois[:1]) == JA.roi_analysis_comparison(rois[:1])


def test_loss_event_capturer_matches_jax(tmp_path):
    frame = _blob_roi(60, 60, size=120)
    caps = [mod.LossEventCapturer(tmp_path / name, patch=25, lost_threshold=3) for mod, name in ((PA, "p"), (JA, "j"))]
    for f in range(12):
        dets = [(60, 60)] if f < 4 or f == 8 else ([(118, 2)] if f == 9 else [])
        outs = [c.step(frame, dets, f) for c in caps]
        assert (outs[0] is None) == (outs[1] is None) and (outs[0] is None or np.array_equal(outs[0], outs[1]))
    got, want = caps
    assert [p.split("/")[-1] for p in got.captured] == [p.split("/")[-1] for p in want.captured] != []
    assert (got.lost_streak, got.last_center) == (want.lost_streak, want.last_center)
    for a, b in zip(got.captured, want.captured):
        np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_GRAYSCALE), cv2.imread(b, cv2.IMREAD_GRAYSCALE))
