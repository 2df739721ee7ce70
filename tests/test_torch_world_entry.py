"""The entry points of YOLO-World and YOLOE in the port against the JAX package's on the CPU, on yolov8n-world's awake
tree and yoloe-v8n's (tests/test_torch_world.py): the parts path and FusedDetectTrack, int8 and tiled predict, an
ensemble, a server lane and `benchmark`, which JAX runs on both; and those left out, as JAX fails on them: `YOLO(...)`
of a World or YOLOE yaml (JAX builds a model without prompts that fails at its first forward) and every predictor,
validator, trainer, ensemble and parts path of a YOLOE segment model (JAX's YOLOE fixes the task to detect and fails
on its (preds, protos) pair), where `YOLOEModel.predict` and `benchmark` run in both.

Tolerances, stated again at each test: parts 1e-3 px and 1e-5 in score; the pipeline's tracks, statuses and counts
exact, boxes 1e-3 px; rows paired by box, 1e-3 px and 1e-5 in score (int8: 5e-3 in score, the reason at its test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine.model import YOLOE as JaxYOLOE
from yolo_tpu.ops.tiling import tiled_predict as jax_tiled_predict
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import FusedDetectTrack
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.ops.tiling import tiled_predict

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures)
from tests.test_torch_world import PX, SCORE, _awake, _frames, world  # noqa: F401 (a fixture)
from tests.test_torch_yolo11_12 import _paired
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)

INT8_SCORE = 5e-3  # int8 scores against JAX's compiled int8 predictor (test_int8_tiled_ensemble_server_and_benchmark)


@pytest.fixture(scope="module")
def yoloe():
    """(JAX YOLOE, port YOLOE) of yoloe-v8n holding one awake tree (box branches as the World fixture's), with two
    random text prompts installed through each package's `get_tpe`."""
    jy, py = JaxYOLOE("yoloe-v8n.yaml"), yolo_tpu_torch.YOLOE("yoloe-v8n.yaml", device="cpu")
    tree = _awake(jax.tree_util.tree_map(np.asarray, jy.params), np.random.default_rng(8))
    for l in range(3):
        box = tree["model"]["22"]["cv2"][str(l)]["2"]
        box["weight"], box["bias"] = box["weight"] * 0.0, np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
    txt = np.random.default_rng(9).normal(0, 1, (1, 2, 512)).astype(np.float32)
    for y in (jy, py):
        y.params = tree
        y.set_text_features(txt, names=["a", "b"])
    return jy, py


def _same_rows(got, want, px=PX, conf=SCORE):
    wb = np.asarray(want.boxes.xyxy)
    assert len(wb) and len(got.boxes.xyxy) == len(wb)
    o = _paired(got.boxes.xyxy, wb, got.boxes.cls, np.asarray(want.boxes.cls))
    np.testing.assert_allclose(got.boxes.xyxy[o], wb, rtol=0, atol=px)
    np.testing.assert_allclose(got.boxes.conf[o], np.asarray(want.boxes.conf), rtol=0, atol=conf)
    np.testing.assert_array_equal(got.boxes.cls[o], np.asarray(want.boxes.cls))


@pytest.mark.parametrize("which", ["world", "yoloe"])
def test_parts_path_and_fused_pipeline_match_jax(which, world, yoloe, two_threads):
    """`predict_parts` (f32, two seeded 64² images) against JAX's: boxes 1e-3 px, scores 1e-5; `head_cm=True` raises
    ValueError (JAX asserts on its channel-major head); FusedDetectTrack (f32, 64x64 BGR, chunks of 4) over eight
    frames: JAX's tracks, statuses and counts exact, boxes 1e-3 px, velocities and confidences 1e-4 relative."""
    jy, py = world if which == "world" else yoloe
    jf = jax.tree_util.tree_map(np.asarray, jy.model.fuse(jy.params))
    x = np.random.default_rng(10).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    wb, ws = jax.jit(jy.model.predict_parts)(jf, jnp.asarray(x))
    PT.params_from_jax(py.model, jf)
    gb, gs = py.model.predict_parts(torch.from_numpy(x))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=PX)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=SCORE)
    with pytest.raises(ValueError, match="channel-major"):
        py.model.predict_parts(torch.from_numpy(x), head_cm=True)
    with pytest.raises(AssertionError):
        jy.model.predict_parts(jf, jnp.asarray(x), pallas_head2=True)
    clip = np.stack(_frames(8))
    kw = dict(frame_hw=(64, 64), channels=3, chunk=4, conf=0.3, n_max=8, d_max=4)
    want_outs, want_stats = JaxFusedDetectTrack(jy.model, jf, dtype=jnp.float32, **kw).run_clip(clip)
    ft = FusedDetectTrack(py.model, jf, dtype=torch.float32, device="cpu", **kw)
    got_outs, got_stats = ft.run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=PX, err_msg=k)


def test_int8_tiled_ensemble_server_and_benchmark(world, tmp_path, monkeypatch, two_threads):
    """On yolov8n-world's awake tree (f32, imgsz 64): `predict(int8=True)` (dynamic scales) against JAX's int8
    predictor, rows paired by box: boxes 1e-3 px, scores 5e-3, the same count (XLA's compiled CPU program multiplies by
    the f32 reciprocal of 127 where both sources divide, so activation codes on a rounding edge flip, and a flipped
    code moves the contrastive scores by up to 3.3e-3 here; JAX run op by op takes 53 s on this model);
    `tiled_predict` (64²
    tiles over a 96x128 frame) against JAX's: boxes 1e-3 px, scores 1e-5, classes exact; an ensemble of the .npz twice
    against JAX's; a server lane's rows (the .npz's placeholder prompts) JAX's predict's of that .npz, 1e-3 px and 1e-5; `benchmark(imgsz=32)` rows in JAX's keys and batches (each batch run once)."""
    from yolo_tpu.utils import benchmarks as JB
    from yolo_tpu_torch.serve import DetectionServer
    from yolo_tpu_torch.utils.remote import RemoteModel

    from tests.test_torch_serve import _serve

    jy, py = world
    frame = _frames(1)[0]
    F32 = dict(imgsz=64, conf=0.3, compute_dtype="float32", verbose=False)
    jy.predictor = py.predictor = None
    want = jy.predict(frame, int8=True, **F32)[0]
    got = py.predict(frame, int8=True, **F32)[0]
    assert py.model.int8
    _same_rows(got, want, conf=INT8_SCORE)
    jy.predictor = py.predictor = None
    big = np.random.default_rng(11).integers(0, 255, (96, 128, 3), np.uint8)
    tk = dict(tile=64, overlap=0.25, conf=0.3, iou=0.55, merge_iou=0.6, compute_dtype="float32", max_det=30)  # off the grid's exact overlaps
    wb, wsc, wc = jax_tiled_predict(jy, big, **tk)
    gb, gsc, gc = tiled_predict(py, big, **tk)
    assert len(wb) and len(gb) == len(wb)
    o = _paired(gb, np.asarray(wb), gc, np.asarray(wc))
    np.testing.assert_allclose(gb[o], np.asarray(wb), rtol=0, atol=PX)
    np.testing.assert_allclose(gsc[o], np.asarray(wsc), rtol=0, atol=SCORE)
    jy.predictor = py.predictor = None
    src = str(py.save(str(tmp_path / "world.npz")))
    jy_ens, py_ens = yolo_tpu.YOLO([src, src]), yolo_tpu_torch.YOLO([src, src], device="cpu")
    _same_rows(py_ens.predict(frame, **F32)[0], jy_ens.predict(frame, **F32)[0])
    srv = DetectionServer({0: src}, port=0, imgsz=64, batch_window_ms=1.0, device="cpu", predict_args={"compute_dtype": "float32"})
    t = _serve(srv)
    try:
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/0") as client:
            g = client(frame)
        w = np.asarray(yolo_tpu.YOLO(src).predict(frame, imgsz=64, conf=0.25, compute_dtype="float32", verbose=False)[0].boxes.data)[:, :6]
        assert len(w) and g.shape == w.shape
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=PX)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=SCORE)
    finally:
        srv.shutdown()
        t.join(30)
    from yolo_tpu_torch.utils import benchmarks as PB

    monkeypatch.setattr(JB, "_time_fn", lambda fn, args, **kw: (jax.block_until_ready(fn(*args)), (1e-3, 0.0))[1])
    monkeypatch.setattr(PB, "_time_fn", lambda fn, args, **kw: (PB._block(fn(*args)), (1e-3, 0.0))[1])
    want_rows, got_rows = jy.benchmark(imgsz=32), py.benchmark(imgsz=32)
    assert [(r["batch"], r["dtype"]) for r in got_rows] == [(r["batch"], r["dtype"]) for r in want_rows]
    assert all(r["latency_ms"] > 0 for r in got_rows)
    jy.predictor = py.predictor = None


def test_left_out_entry_points_pin_both_sides(tiny_dataset, tmp_path, monkeypatch, two_threads):
    """`YOLO(...)` of a World or YOLOE yaml: JAX builds a model without prompts whose predict fails (AttributeError);
    the port raises NotImplementedError naming ROADMAP item 5c when it builds. A YOLOE segment yaml through the YOLOE
    facade: JAX's predict fails (its task is detect: NMS on the (preds, protos) pair), and so do its parts path, its
    ensemble and its pipeline; the port's predict, track, val, train, parts path, ensemble and FusedDetectTrack raise
    NotImplementedError naming 5c, while `YOLOEModel.predict` and `benchmark` run in both (each batch run once)."""
    frame = _frames(1)[0]
    for name in ("yolov8n-world.yaml", "yoloe-v8n-seg.yaml"):
        with pytest.raises(AttributeError):
            yolo_tpu.YOLO(name).predict(frame, imgsz=64, verbose=False)
        with pytest.raises(NotImplementedError, match="5c"):
            yolo_tpu_torch.YOLO(name, device="cpu")
    jy, py = JaxYOLOE("yoloe-v8n-seg.yaml"), yolo_tpu_torch.YOLOE("yoloe-v8n-seg.yaml", device="cpu")
    with pytest.raises(AttributeError, match="tuple"):
        jy.predict(frame, imgsz=64, verbose=False)
    x = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(AssertionError, match="structured outputs"):
        jy.model.predict_parts(jy.params, jnp.asarray(x))
    for call in (lambda: py.predict(frame, imgsz=64), lambda: py.track(frame, imgsz=64),
                 lambda: py.val(data=tiny_dataset, imgsz=64, plots=False),
                 lambda: py.train(data=tiny_dataset, epochs=1, imgsz=64, project=str(tmp_path), amp=False, plots=False),
                 lambda: py.model.predict_parts(torch.from_numpy(x)),
                 lambda: PT.Ensemble([py.model, py.model]),
                 lambda: FusedDetectTrack(py.model, py.params, frame_hw=(64, 64), channels=3, chunk=2, device="cpu")):
        with pytest.raises(NotImplementedError, match="5c"):
            call()
    src = str(py.save(str(tmp_path / "seg.npz")))
    with pytest.raises(TypeError):
        yolo_tpu.YOLO([src, src]).predict(frame, imgsz=64, verbose=False)
    preds, protos = PT.params_from_jax(py.model, py.params).predict(torch.from_numpy(x))
    assert preds.shape == (1, 4 + 80 + 32, 84) and protos.shape == (1, 16, 16, 32)
    from yolo_tpu.utils import benchmarks as JB
    from yolo_tpu_torch.utils import benchmarks as PB

    monkeypatch.setattr(JB, "_time_fn", lambda fn, args, **kw: (jax.block_until_ready(fn(*args)), (1e-3, 0.0))[1])
    monkeypatch.setattr(PB, "_time_fn", lambda fn, args, **kw: (PB._block(fn(*args)), (1e-3, 0.0))[1])
    assert len(py.benchmark(imgsz=32, half=False)) == len(jy.benchmark(imgsz=32, half=False)) == 3
