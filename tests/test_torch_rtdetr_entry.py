"""RT-DETR's other entry points in the port against the JAX package's on the CPU, on yolov8n-rtdetr's awake tree (see
tests/test_torch_rtdetr.py): int8 predict, tiled predict, track, a server lane, benchmark and embed, which JAX's
RT-DETR runs; checkpoints both ways; and the entry points left out, as JAX fails on them (FusedDetectTrack, the parts
path, an ensemble).

Tolerances, stated again at each test: rows paired by class and box, 1e-3 px and 1e-5 in score, classes and counts
equal (int8 against JAX's int8 predictor run op by op); track ids equal, or swapped only among detections whose scores
lie within 1e-5 of each other; embeddings 1e-4; trees exact."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.nn import modules as JM
from yolo_tpu.ops.tiling import tiled_predict as jax_tiled_predict
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.ops.tiling import tiled_predict

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures)
from tests.test_torch_pose import _same_tree
from tests.test_torch_rtdetr import IMG, _frames, _piece_close, _same_results, pair  # noqa: F401 (a fixture)
from tests.test_torch_yolo11_12 import _paired

F32 = dict(imgsz=IMG, conf=0.22, compute_dtype="float32", verbose=False)  # the awake tree scores 0.15-0.24


def _int8_walk_op_by_op(jm):
    """JAX's `RTDETRDetectionModel.predict` with its walk through the int8 backbone and neck run op by op (under
    `jax.disable_jit`) and the float decoder compiled, on the decoder's dense input maps as `_apply_layer` hands them."""
    head = jm.layers[-1]

    def predict(params, x, dtype=jnp.float32):
        ctx = JM.Ctx(train=False, dtype=dtype)
        _, _, col = jm._walk(params, x, ctx, upto=len(jm.layers) - 1, collect=set(head.f))
        with jax.disable_jit(False):
            return jax.jit(lambda p, xs: head.module(p, xs, ctx))(params["model"][str(head.i)], [JM.deq(col[i], dtype) for i in head.f])
    return predict


def test_int8_and_tiled_predict(pair, two_threads):
    """`predict(int8=True)` (f32, conf 0.22; the backbone and neck convs quantized with dynamic per-tensor scales, the
    decoder float in both) against JAX's int8 predictor run op by op (`jax.disable_jit`): the same counts, rows paired
    by class and box within 1e-3 px and 1e-5 in score, classes equal, the model walking int8 (JAX's walk through the
    int8 backbone and neck op by op, its float decoder compiled: `_int8_walk_op_by_op`). Op by op, because XLA's
    compiled CPU program multiplies by the f32 reciprocal of 127 where JAX's source divides (the dynamic scale one ulp
    apart) and fuses the dequantizing epilogue: on these frames (largest value 254) half the stem's codes sit on a
    rounding edge (x / s = k / 2), and each per-tensor scale carries a flipped code into every later one, so the
    compiled program's rows differ from the op-by-op ones by the int8 noise itself (about 36 of the 300 selected
    queries move). Then `tiled_predict` (160² tiles, overlap 0.25, f32, conf 0.22) of a seeded 240x320 frame: JAX's
    merged boxes (1e-3 px), scores (1e-5) and classes, the same count."""
    jy, py = pair
    frames = _frames()
    jy.predictor = py.predictor = None
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jy.model, "predict", _int8_walk_op_by_op(jy.model))
        want = jy.predict(frames, int8=True, **F32)
    got = py.predict(frames, int8=True, **F32)
    assert py.model.int8
    _same_results(got, want)
    jy.predictor = py.predictor = None
    big = np.random.default_rng(6).integers(0, 255, (240, 320, 3), np.uint8)
    kw = dict(tile=IMG, overlap=0.25, conf=0.22, compute_dtype="float32")
    wb, ws, wc = jax_tiled_predict(jy, big, **kw)
    gb, gs, gc = tiled_predict(py, big, **kw)
    assert len(gb) == len(wb) > 0
    o = _paired(gb, wb, gc, wc)
    np.testing.assert_allclose(gb[o], wb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gs[o], ws, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gc[o], wc)
    jy.predictor = py.predictor = None


def test_server_benchmark_track_and_embed(pair, tmp_path, monkeypatch, two_threads):
    """A server lane (conf 0.22, f32) replies to each frame with the rows of JAX's predict (paired by class and box,
    1e-3 px, 1e-5, classes equal); `benchmark(imgsz=160)` gives JAX's rows' keys, batches and dtypes (timing stubbed,
    the batch-1 forward run); `track` (ByteTrack with its thresholds at 0.2, persist, f32) over the two frames and the
    first again against JAX's, frame by frame: the same rows (1e-3 px, 1e-5) and the same ids, except that ids may swap
    among detections whose JAX scores lie within 1e-5 of each other (the tracker starts its tracks in score order, and
    f32 rounding may order such near-ties either way), where the group's ids are the same set; `embed` against JAX's
    (1e-4 of the largest)."""
    from yolo_tpu.utils import benchmarks as JB
    from yolo_tpu_torch.serve import DetectionServer
    from yolo_tpu_torch.utils import benchmarks as PB
    from yolo_tpu_torch.utils.remote import RemoteModel

    from tests.test_torch_serve import _serve

    jy, py = pair
    frames = _frames()
    src = str(py.save(str(tmp_path / "rtdetr.npz")))
    srv = DetectionServer({0: src}, port=0, conf=0.22, imgsz=IMG, batch_window_ms=1.0, device="cpu",
                          predict_args={"compute_dtype": "float32"})
    t = _serve(srv)
    jy.predictor = None
    try:
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/0") as client:
            for f in frames:
                w, g = np.asarray(jy.predict(f, **F32)[0].boxes.data)[:, :6], client(f)
                assert len(w) and g.shape == w.shape
                o = _paired(g, w, g[:, 5], w[:, 5])
                np.testing.assert_allclose(g[o, :4], w[:, :4], rtol=0, atol=1e-3)
                np.testing.assert_allclose(g[o, 4], w[:, 4], rtol=0, atol=1e-5)
                np.testing.assert_array_equal(g[o, 5], w[:, 5])
    finally:
        srv.shutdown()
        t.join(30)
        jy.predictor = None
    monkeypatch.setattr(JB, "_time_fn", lambda fn, args, **kw: (1e-3, 0.0))
    monkeypatch.setattr(PB, "_time_fn", lambda fn, args, **kw: (len(args[0]) > 1 or fn(*args).shape and 1e-3, 0.0))
    want_rows, got_rows = jy.benchmark(imgsz=IMG), py.benchmark(imgsz=IMG)
    assert [(r["batch"], r["dtype"]) for r in got_rows] == [(r["batch"], r["dtype"]) for r in want_rows]
    assert [list(r) for r in got_rows] == [list(r) for r in want_rows]
    jy.predictor = py.predictor = None
    trk = tmp_path / "bytetrack_low.yaml"  # the awake tree scores 0.15-0.24: below ByteTrack's default thresholds
    trk.write_text(re.sub(r"(track_high_thresh|new_track_thresh): [0-9.]+", r"\1: 0.2",
                          (PT.CFG_DIR / "trackers" / "bytetrack.yaml").read_text()))
    for f in frames + frames[:1]:
        w, g = jy.track(f, persist=True, tracker=str(trk), **F32)[0], py.track(f, persist=True, tracker=str(trk), **F32)[0]
        _same_results([g], [w])
        o = _paired(g.boxes.xyxy, w.boxes.xyxy, g.boxes.cls, w.boxes.cls)
        gi, wi, wconf = np.asarray(g.boxes.id)[o], np.asarray(w.boxes.id), np.asarray(w.boxes.conf)
        for r in np.nonzero(gi != wi)[0]:
            tie = np.abs(wconf - wconf[r]) <= 1e-5
            assert tie.sum() > 1 and sorted(gi[tie]) == sorted(wi[tie]), (r, wconf[r], gi[r], wi[r])
    jy.predictor = py.predictor = None
    _piece_close(py.embed(frames[0], imgsz=IMG)[0], jy.embed(frames[0], imgsz=IMG)[0], 1e-4)


def test_checkpoints_and_left_out_entry_points(pair, tmp_path, two_threads):
    """A .npz that JAX writes loads in the port as an RTDETRDetectionModel with JAX's tree bit for bit, the port's
    .npz loads in JAX as one, and the port's .pt reads back to the same tree in both packages. Left out, as JAX fails
    on them: FusedDetectTrack and the parts path (NotImplementedError naming ROADMAP item 5b; JAX asserts), an ensemble
    (NotImplementedError; JAX's runs its NMS over the members' joined query rows, read as a (B, 4 + nc, A) map, and
    returns classes past nc)."""
    from yolo_tpu.pipeline.fused import FusedDetectTrack as JaxFused
    from yolo_tpu_torch import FusedDetectTrack

    jy, py = pair
    path = str(jy.save(str(tmp_path / "jax.npz")))
    loaded = yolo_tpu_torch.YOLO(path, device="cpu")
    assert type(loaded.model) is PT.RTDETRDetectionModel
    _same_tree(loaded.params, jax.tree_util.tree_map(np.asarray, jy.params))
    back = yolo_tpu.YOLO(str(loaded.save(str(tmp_path / "port.npz"))))
    assert type(back.model).__name__ == "RTDETRDetectionModel"
    _same_tree(back.params, loaded.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        pt = loaded.export(format="pt")
    for y in (yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu"), yolo_tpu.YOLO(str(tmp_path / pt))):
        assert type(y.model).__name__ == "RTDETRDetectionModel"
        _same_tree(y.params, loaded.params)
    with pytest.raises(NotImplementedError, match="5b"):
        FusedDetectTrack(py.model, py.params, frame_hw=(IMG, IMG), chunk=2, dtype=torch.float32, device="cpu")
    with pytest.raises(AssertionError, match="RTDETRDecoder"):
        JaxFused(jy.model, jy.params, frame_hw=(IMG, IMG), channels=3, chunk=2).run_clip(np.zeros((2, IMG, IMG, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="5b"):
        py.model.predict_parts(torch.zeros(1, IMG, IMG, 3))
    with pytest.raises(NotImplementedError, match="5b"):
        yolo_tpu_torch.YOLO([path, path], device="cpu")
    r = yolo_tpu.YOLO([path, path]).predict(_frames()[0], imgsz=IMG, conf=0.01, verbose=False)[0]
    assert len(r.boxes.conf) and (np.asarray(r.boxes.cls) >= 80).any()  # the joined rows read as 296 classes
