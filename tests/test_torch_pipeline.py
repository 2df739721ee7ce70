"""The port's whole slice against the JAX package: FusedDetectTrack on a 16-frame
64x64 clip in chunks of 8 (as tests/test_fused_pipeline.py) gives the same
packed outputs (floats to 1e-3, the forward's summation order differs),
the same statuses, ids, emits and detection counts, and the same contract
stats. Also: the port imports no JAX and nothing of the JAX package, and its
entry points run on the card unless the CPU is asked for."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import DetectionModel, FusedDetectTrack
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.kalman.batched import init_state

from tests.conftest import ROOT
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)


@pytest.mark.parametrize("plain", [False, True])
def test_fused_detect_track_matches_jax(plain):
    jm = JaxDetectionModel("yolov8n.yaml")
    jp = jm.fuse(jm.init(0))
    clip = np.random.default_rng(2).integers(0, 255, (16, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255  # a bright square in every frame
    kw = dict(frame_hw=(64, 64), chunk=8, conf=1e-4, n_max=8, d_max=4)
    want_outs, want_stats = JaxFusedDetectTrack(jm, jp, dtype=jnp.float32, **kw).run_clip(clip)

    params = jax.tree_util.tree_map(np.asarray, jp)
    ft = FusedDetectTrack(DetectionModel("yolov8n.yaml", device="cpu"), params, dtype=torch.float32, device="cpu",
                          plain=plain, **kw)
    assert ft.max_nms == 64
    got_outs, got_stats = ft.run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    assert len(got_outs) == len(want_outs) == 2
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)
    assert int(ft.state["frame_count"]) == 16
    ft.reset()
    first = ft.process_chunk(clip[:8])  # one chunk from a fresh state = run_clip's first chunk
    for k in first:
        if first[k].dtype.kind == "f":
            np.testing.assert_allclose(first[k], got_outs[0][k], rtol=1e-5, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(first[k], got_outs[0][k], err_msg=k)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "import numpy as np, torch\n"
        "import yolo_tpu_torch, chip_smoke\n"
        "from yolo_tpu_torch import DetectionModel, FusedDetectTrack, load_npz\n"
        "from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_nms, nms, _cuda\n"
        "m, p, _ = load_npz(chip_smoke.WEIGHTS, device='cpu')\n"
        "ft = FusedDetectTrack(m, p, frame_hw=(64, 64), chunk=2, device='cpu')\n"
        "outs, stats = ft.run_clip(np.zeros((2, 64, 64, 1), np.uint8))\n"
        "assert stats['frames'] == 2, stats\n"
        "from yolo_tpu_torch.motion import GlobalMotionDetector, MotionCompensatedMultiTracker, compare_motion_methods\n"
        "from yolo_tpu_torch.grayscale import GrayscaleTracker, predict_center, predict_center_torch\n"
        "from yolo_tpu_torch.grayscale import analysis, config\n"
        "rng = np.random.default_rng(0)\n"
        "frames = rng.integers(0, 255, (2, 64, 80, 3), np.uint8)\n"
        "gmd = GlobalMotionDetector('hybrid')\n"
        "assert [gmd.detect_motion(f)[3] for f in frames] == [False, False]\n"
        "best, score = predict_center_torch(torch.from_numpy(frames[0, :40, :40, 0]))\n"
        "assert best.shape == (2,) and float(score) > 0\n"
        "import threading\n"
        "from yolo_tpu_torch import YOLO, native\n"
        "from yolo_tpu_torch.serve import DetectionServer\n"
        "from yolo_tpu_torch.data.loaders import load_inference_source\n"
        "from yolo_tpu_torch.nn import torch_export, torch_import\n"
        "srv = DetectionServer(str(chip_smoke.WEIGHTS), port=0, imgsz=64, batch_window_ms=1.0, device='cpu')\n"
        "ready = threading.Event(); t = threading.Thread(target=srv.serve_forever, args=(ready,), daemon=True); t.start()\n"
        "assert ready.wait(60)\n"
        "r = YOLO(f'tcp://127.0.0.1:{srv.port}/0').predict(frames, conf=0.0, verbose=False)\n"
        "assert len(r) == 2\n"
        "srv.shutdown(); t.join(30)\n"
        "from yolo_tpu_torch.otherplan import classical_detect, detect_only, enhance_small_targets_torch\n"
        "from yolo_tpu_torch.ops.tiling import tiled_predict\n"
        "from yolo_tpu_torch.nn import quantize\n"
        "from yolo_tpu_torch.utils import integrations, profilers, settings, tb_logger\n"
        "q = FusedDetectTrack(m, p, frame_hw=(64, 64), chunk=2, device='cpu', int8=True, int8_calib=np.zeros((2, 64, 64, 1), np.uint8))\n"
        "assert q.run_clip(np.zeros((2, 64, 64, 1), np.uint8))[1]['frames'] == 2\n"
        "assert enhance_small_targets_torch(frames[:, :, :, 0]).shape == (2, 64, 80)\n"
        "from yolo_tpu_torch.utils import benchmarks, coco_eval\n"
        "from yolo_tpu_torch.engine import classify, tuner\n"
        "cy = YOLO('yolov8n-cls.yaml', device='cpu')\n"
        "r = cy.predict(frames[0], imgsz=32, verbose=False)[0]\n"
        "assert cy.task == 'classify' and r.probs.data.shape == (1000,), r.probs.data.shape\n"
        "assert coco_eval.coco_evaluate({'images': [{'id': 0}], 'annotations': [{'image_id': 0, 'category_id': 1, 'bbox': [0, 0, 9, 9]}]},"
        " [{'image_id': 0, 'category_id': 1, 'bbox': [0, 0, 9, 9], 'score': 0.9}])['mAP50'] == 1.0\n"
        "assert tuner.Tuner({})._mutate({k: 0.5 for k in tuner.DEFAULT_SPACE})\n"
        "from yolo_tpu_torch.engine import obb_predictor\n"
        "oy = YOLO('yolov8n-obb.yaml', device='cpu')\n"
        "r = oy.predict(frames[0], imgsz=32, conf=0.0, max_det=3, verbose=False)[0]\n"
        "assert oy.task == 'obb' and r.obb.data.shape == (3, 7), r.obb.data.shape\n"
        "bad = sorted(k for k in sys.modules if k == 'yolo_tpu' or k.startswith('yolo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionModel("yolov8n.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(4)
    model = DetectionModel("yolov8n.yaml", device="cpu")
    jm = JaxDetectionModel("yolov8n.yaml")
    params = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedDetectTrack(model, params, frame_hw=(64, 64), chunk=8)
    assert FusedDetectTrack(model, params, frame_hw=(64, 64), chunk=8, device="cpu").device == torch.device("cpu")


@pytest.fixture(scope="module")
def pipelines():
    """One JAX and one port FusedDetectTrack (yolov8n init(0) fused, f32, 64x64, chunks of 8) and a
    16-frame clip with a bright square: each test resets them."""
    jm = JaxDetectionModel("yolov8n.yaml")
    jp = jm.fuse(jm.init(0))
    clip = np.random.default_rng(2).integers(0, 255, (16, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=(64, 64), chunk=8, conf=1e-4, n_max=8, d_max=4)
    jft = JaxFusedDetectTrack(jm, jp, dtype=jnp.float32, **kw)
    ft = FusedDetectTrack(DetectionModel("yolov8n.yaml", device="cpu"), jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu", **kw)
    return jft, ft, clip


@pytest.mark.parametrize("opts", [dict(collect_outputs=False), dict(collect_stats=False), dict(prefetch=1), dict(prefetch=4),
                                  dict(prefetch=0, collect_outputs=False, collect_stats=False)],
                         ids=["no-outputs", "no-stats", "prefetch1", "prefetch4", "none"])
def test_run_clip_options_match_jax(pipelines, opts):
    """`run_clip`'s collect_outputs, collect_stats and prefetch return what JAX's return: no outputs
    ([]), no stats ({}), and otherwise the outputs (floats 1e-3, the rest exactly) and stats of the
    default run; the stats accumulate on the device either way."""
    jft, ft, clip = pipelines
    jft.reset(), ft.reset()
    want_outs, want_stats = jft.run_clip(clip, **opts)
    got_outs, got_stats = ft.run_clip(clip, **opts)
    assert got_stats == want_stats and len(got_outs) == len(want_outs)
    assert (got_outs == []) == (opts.get("collect_outputs") is False) and (got_stats == {}) == (opts.get("collect_stats") is False)
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)
    assert int(ft.stats["frames"]) == int(np.asarray(jft.stats["frames"])) == 16


def test_put_frames_feeds_process_chunk_device(pipelines):
    """`put_frames` stages a chunk (here on the CPU: the frames as a uint8 tensor) that
    `process_chunk_device` takes; chunk by chunk it equals `run_clip` and JAX's chunks."""
    jft, ft, clip = pipelines
    jft.reset(), ft.reset()
    staged = ft.put_frames(clip[:8])
    assert staged.dtype == torch.uint8 and staged.device == ft.device and np.array_equal(staged.numpy(), clip[:8])
    first = ft.process_chunk_device(staged).numpy()
    second = ft.process_chunk_device(ft.put_frames(clip[8:])).numpy()
    want = [np.asarray(jft.process_chunk_device(clip[i : i + 8])) for i in (0, 8)]
    for got, w in zip((first, second), want):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-3)
    ft.reset()
    outs, _ = ft.run_clip(clip)
    np.testing.assert_array_equal(outs[1]["track_num"], second[..., 8].astype(np.int32))


@pytest.mark.parametrize("opts", [dict(neck_opt=False), dict(pallas_head2=True), dict(pallas_head=True, pallas_c2f=True, unroll=4)],
                         ids=["neck_opt-off", "pallas_head2", "kernel-flags"])
def test_signature_routes_match_jax(pipelines, opts):
    """The JAX signature's other settings: neck_opt=False (the neck's upsample and concat
    materialised), pallas_head2=True (the channel-major head kernel) and the kernel flags and
    `unroll`, which change nothing in the port's route: the outputs of JAX's default run (floats 1e-3,
    the rest exactly) and its stats."""
    jft, _, clip = pipelines
    jft.reset()
    want_outs, want_stats = jft.run_clip(clip)
    jm = JaxDetectionModel("yolov8n.yaml")
    jp = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(0)))
    ft = FusedDetectTrack(DetectionModel("yolov8n.yaml", device="cpu"), jp, dtype=torch.float32, device="cpu",
                          frame_hw=(64, 64), chunk=8, conf=1e-4, n_max=8, d_max=4, **opts)
    assert ft.neck_opt == opts.get("neck_opt", True) and ft.pallas_head2 == opts.get("pallas_head2", False)
    got_outs, got_stats = ft.run_clip(clip)
    assert got_stats == want_stats
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("unroll, env, error", [(0, None, None), (None, "x8", None), (None, "0", None),
                                                (None, "16", None), ("mesh", None, NotImplementedError)])
def test_unroll_and_mesh_settings_like_jax(monkeypatch, unroll, env, error):
    """`unroll` and YOLO_TPU_SCAN_UNROLL are taken and change nothing: the port's step loop runs frame
    by frame, so no value is refused (the JAX package refuses those that are not an integer >= 1).
    `mesh` raises NotImplementedError naming ROADMAP item 3."""
    if env is not None:
        monkeypatch.setenv("YOLO_TPU_SCAN_UNROLL", env)
    jm = JaxDetectionModel("yolov8n.yaml")
    jp = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(0)))
    kw = dict(frame_hw=(64, 64), chunk=8, device="cpu")
    kw.update({"mesh": object()} if unroll == "mesh" else {"unroll": unroll})
    model = DetectionModel("yolov8n.yaml", device="cpu")
    if error is None:
        ft = FusedDetectTrack(model, jp, **kw)
        assert not hasattr(ft, "unroll") and ft.run_clip(np.zeros((8, 64, 64, 1), np.uint8))[1]["frames"] == 8
        return
    with pytest.raises(error, match="ROADMAP item 3"):
        FusedDetectTrack(model, jp, **kw)
