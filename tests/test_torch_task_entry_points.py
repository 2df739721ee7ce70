"""The entry points the port opened to segment, pose and obb models, against the JAX package's on the CPU:
`YOLO.benchmark`, `predict(int8=True)`, `YOLO.tune`, `ops.tiling.tiled_predict` and a server lane, each with
the tuned trees of tests/test_torch_{segment,pose,obb}.py (untrained models that find the drawn targets), and
what stays refused because the JAX package fails too.

Tolerances, stated again at each test: benchmark rows in keys, batches and dtype (timings are the CPU's and
only checked positive); int8 predictions at the same counts and classes, boxes within 0.05 px, conf within
1e-3, keypoints within 0.05 px and visibilities 1e-3, masks in at least 99% of their pixels, oriented boxes
within 0.05 px and 1e-3 rad (the dynamic int8 codes of an activation can flip by one against JAX's where an f32
SiLU lands on a rounding edge: torch's and XLA's logistic differ in the last bit); tune's hyperparameters
exact; tiled and served boxes in f32 within 1e-3 px and conf 1e-5."""

import csv
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine import tuner as JTN
from yolo_tpu.ops.tiling import tiled_predict as jax_tiled_predict
from yolo_tpu.utils import benchmarks as JB
from yolo_tpu_torch.engine import tuner as PTN
from yolo_tpu_torch.ops.tiling import tiled_predict

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_obb import _write_obb_split, obb_pair  # noqa: F401 (a fixture)
from tests.test_torch_pose import _write_pose_split, pose_pair  # noqa: F401 (a fixture)
from tests.test_torch_segment import _write_seg_split, seg_pair  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

TASKS = ("segment", "pose", "obb")
PAIR = {"segment": "seg_pair", "pose": "pose_pair", "obb": "obb_pair"}
YAML = {"segment": "yolov8n-seg.yaml", "pose": "yolov8n-pose.yaml", "obb": "yolov8n-obb.yaml"}
F32 = dict(imgsz=64, compute_dtype="float32", max_det=30, verbose=False, classes=None, agnostic_nms=False, retina_masks=False)
INT8_PX, INT8_CONF, INT8_RAD, INT8_MASK = 0.05, 1e-3, 1e-3, 0.99


def _untimed(fn, args, **kw):
    """JAX's `_time_fn` without its compile and runs: the rows' structure is what is compared."""
    return 1e-3, 0.0


@pytest.mark.parametrize("task", TASKS)
def test_task_benchmark_rows_match_jax(task, request, monkeypatch, two_threads):
    """YOLO(<task yaml>).benchmark(imgsz=32) with the tuned tree: JAX's rows (JAX's timing stubbed, its program
    not compiled) in keys, batches 1 / 8 / 32 and dtype bfloat16; the port times its model's `predict` (a segment
    model's (preds, protos) waited for), positive latencies and fps = batch / latency."""
    jy, py, _ = request.getfixturevalue(PAIR[task])
    monkeypatch.setattr(JB, "_time_fn", _untimed)
    want = jy.benchmark(imgsz=32)
    got = py.benchmark(imgsz=32)
    assert [list(r) for r in got] == [list(r) for r in want] == [["batch", "dtype", "latency_ms", "std_ms", "fps"]] * 3
    assert [(r["batch"], r["dtype"]) for r in got] == [(r["batch"], r["dtype"]) for r in want] == [(b, "bfloat16") for b in (1, 8, 32)]
    for r in got:
        assert r["latency_ms"] > 0 and r["std_ms"] >= 0 and abs(r["fps"] - r["batch"] / (r["latency_ms"] / 1e3)) <= 0.01 * r["fps"] + 0.1


def _paired(got, want):
    """Row order of `got` matched to `want`'s by the nearest box (equal scores may come out in either order)."""
    order = [int(np.argmin(np.abs(got[:, :4] - w[None, :4]).sum(-1))) for w in want]
    assert sorted(order) == list(range(len(got)))
    return order


@pytest.mark.parametrize("task", TASKS)
def test_task_int8_predict_matches_jax(task, request, two_threads):
    """predict(int8=True) (dynamic activation scales, f32, imgsz 64) on the fixture's two frames against JAX's: the
    same counts and classes, boxes within 0.05 px, conf 1e-3; segment masks equal in at least 99% of each mask's
    pixels; pose keypoints x, y 0.05 px and visibilities 1e-3; obb centres and sizes 0.05 px, angles 1e-3 rad (a
    dynamic int8 code may flip against JAX's where an f32 SiLU lands on a rounding edge). The model walks int8
    (`model.int8`), and a later float predict of the same YOLO goes back to the float route."""
    jy, py, frames = request.getfixturevalue(PAIR[task])
    kw = {**F32, "conf": 0.2} if task == "obb" else dict(F32)
    jy.predictor = py.predictor = None
    want, got = jy.predict(frames, int8=True, **kw), py.predict(frames, int8=True, **kw)
    assert py.model.int8
    n = 0
    for rj, rp in zip(want, got):
        assert len(rp) == len(rj)
        n += len(rp)
        if task == "obb":
            o = _paired(rp.obb.xywhr, rj.obb.xywhr)
            np.testing.assert_allclose(rp.obb.xywhr[o, :4], rj.obb.xywhr[:, :4], rtol=0, atol=INT8_PX)
            np.testing.assert_allclose(rp.obb.xywhr[o, 4], rj.obb.xywhr[:, 4], rtol=0, atol=INT8_RAD)
            np.testing.assert_allclose(rp.obb.conf[o], rj.obb.conf, rtol=0, atol=INT8_CONF)
            np.testing.assert_array_equal(rp.obb.cls[o], rj.obb.cls)
            continue
        o = _paired(rp.boxes.xyxy, rj.boxes.xyxy)
        np.testing.assert_allclose(rp.boxes.xyxy[o], rj.boxes.xyxy, rtol=0, atol=INT8_PX)
        np.testing.assert_allclose(rp.boxes.conf[o], rj.boxes.conf, rtol=0, atol=INT8_CONF)
        np.testing.assert_array_equal(rp.boxes.cls[o], rj.boxes.cls)
        if task == "segment":
            same = (rp.masks.data[o] == np.asarray(rj.masks.data)).mean((1, 2))
            assert same.min() >= INT8_MASK, same
        else:
            np.testing.assert_allclose(rp.keypoints.data[o][..., :2], rj.keypoints.data[..., :2], rtol=0, atol=INT8_PX)
            np.testing.assert_allclose(rp.keypoints.data[o][..., 2], rj.keypoints.data[..., 2], rtol=0, atol=INT8_CONF)
    assert n > 0
    py.predict(frames, int8=False, **kw)
    assert not py.model.int8
    jy.predictor = py.predictor = None  # a reused predictor keeps int8


def _split(task, root):
    """A seeded 4-image split of the task's labels, train and val the same images → the dataset yaml."""
    if task == "segment":
        yaml = _write_seg_split(root, 4, 5)
    elif task == "pose":
        yaml = _write_pose_split(root, 4, 5)
    else:
        yaml = _write_obb_split(root, 4, 5)
    text = open(yaml).read().replace("val: images/val", "train: images/val\nval: images/val")
    open(yaml, "w").write(text)
    return yaml


@pytest.mark.parametrize("task", TASKS)
def test_task_tune_matches_jax(task, tmp_path, monkeypatch, two_threads):
    """YOLO(<task yaml>).tune(iterations=2, epochs=1, imgsz=64) on a 4-image split of the task's labels under one
    clock: JAX's tune_results.csv columns, its iteration-0 and iteration-1 hyperparameters exactly (the same draws
    of the mutation), JAX's result keys; the port trains each iteration through the task's trainer and scores it
    with the task's validator (a finite fitness, the one `train` returned); best.npz is a checkpoint of the task.
    JAX's `train` returns fitness 0.25 (a real JAX training compiles for a minute per iteration)."""
    clock = SimpleNamespace(time=lambda: 1_700_000_123.456)
    monkeypatch.setattr(JTN, "time", clock)
    monkeypatch.setattr(PTN, "time", clock)
    monkeypatch.setattr(yolo_tpu.YOLO, "train", lambda self, **kw: {"fitness": 0.25})
    fits = []
    train = yolo_tpu_torch.YOLO.train

    def recorded(self, **kw):
        m = train(self, **kw)
        fits.append(m["fitness"])
        return m

    monkeypatch.setattr(yolo_tpu_torch.YOLO, "train", recorded)
    data = _split(task, tmp_path / "data")
    kw = dict(iterations=2, data=data, epochs=1, imgsz=64, batch=2, workers=0, plots=False, val=True, amp=False)
    want = yolo_tpu.YOLO(YAML[task]).tune(project=str(tmp_path / "jax"), **kw)
    got = yolo_tpu_torch.YOLO(YAML[task], device="cpu").tune(project=str(tmp_path / "torch"), **kw)
    read = lambda p: list(csv.DictReader(open(p)))  # noqa: E731
    jrows, prows = read(tmp_path / "jax/tune/tune_results.csv"), read(tmp_path / "torch/tune/tune_results.csv")
    assert list(prows[0]) == list(jrows[0]) == ["iteration", "fitness", *JTN.DEFAULT_SPACE]
    for p, j in zip(prows, jrows):
        assert {k: float(v) for k, v in p.items() if k in JTN.DEFAULT_SPACE} == {k: float(v) for k, v in j.items() if k in JTN.DEFAULT_SPACE}
    assert [float(r["fitness"]) for r in prows] == pytest.approx(fits) and len(fits) == 2 and np.isfinite(fits).all()
    assert set(got) == set(want) and got["best_fitness"] == max(fits)
    assert yolo_tpu_torch.YOLO(str(tmp_path / "torch/tune/best.npz"), device="cpu").task == task


def _big_frame(seed=4, h=128, w=160):
    """A 128x160 BGR frame with five bright filled ellipses: six 64² tiles at overlap 0.25."""
    rng = np.random.default_rng(seed)
    img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
    for _ in range(5):
        cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
        cv2.ellipse(img, (int(cx), int(cy)), (int(rng.uniform(4, 10)), int(rng.uniform(4, 10))), float(rng.uniform(0, 180)), 0, 360,
                    float(rng.uniform(150, 230)), -1)
    return cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR)


@pytest.mark.parametrize("task", ("segment", "pose"))
def test_task_tiled_predict_matches_jax(task, request, two_threads):
    """tiled_predict(tile=64, overlap=0.25, f32) of a 128x160 frame: the merged boxes, scores and classes of JAX's
    (boxes 1e-3 px, scores 1e-5), which reads only `Results.boxes`, so masks and keypoints are dropped."""
    jy, py, _ = request.getfixturevalue(PAIR[task])
    frame = _big_frame()
    kw = dict(tile=64, overlap=0.25, conf=0.25, compute_dtype="float32", max_det=30)
    jy.predictor = py.predictor = None
    wb, ws, wc = jax_tiled_predict(jy, frame, **kw)
    gb, gs, gc = tiled_predict(py, frame, **kw)
    assert len(gb) == len(wb) > 0
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gc, wc)
    jy.predictor = py.predictor = None


@pytest.fixture(scope="module")
def task_server(seg_pair, pose_pair, obb_pair, tmp_path_factory):
    """The port's server (f32 lanes, imgsz 64, conf 0.25) with a segment lane 0, a pose lane 1 and an obb lane 2
    from the tuned trees saved as .npz; yields (server, {lane: source})."""
    from tests.test_torch_serve import _serve
    from yolo_tpu_torch.serve import DetectionServer

    root = tmp_path_factory.mktemp("lanes")
    src = {i: str(pair[1].save(str(root / f"{t}.npz"))) for i, (t, pair) in enumerate(zip(TASKS, (seg_pair, pose_pair, obb_pair)))}
    srv = DetectionServer(src, port=0, imgsz=64, batch_window_ms=1.0, device="cpu", predict_args={"compute_dtype": "float32"})
    t = _serve(srv)
    yield srv, src
    srv.shutdown()
    t.join(30)


def test_task_server_lanes_match_jax(task_server, seg_pair):
    """A server with a segment, a pose and an obb lane, each request one frame: the pose lane replies as JAX's lane
    (its BasePredictor's pose route, f32) with `boxes.data[:, :6]`; the segment lane replies with the boxes of JAX's
    segment predict (JAX's own segment lane fails at its warm-up: its BasePredictor hands the (preds, protos) pair
    to NMS); the obb lane is out of service (status 3). f32: boxes 1e-3 px, conf 1e-5, classes equal."""
    from yolo_tpu.engine.predictor import BasePredictor as JaxBasePredictor
    from yolo_tpu.serve import _ModelLane as JaxLane
    from yolo_tpu_torch.utils.remote import RemoteInferenceError, RemoteModel

    srv, src = task_server
    frames = seg_pair[2]
    lane_kw = dict(conf=0.25, iou=0.7, imgsz=64, max_det=300, verbose=False, compute_dtype="float32")
    jseg = JaxLane(src[0], 0.25, 0.7, 64, 300)
    with pytest.raises(AttributeError):
        jseg.build()
    jseg_y = yolo_tpu.YOLO(src[0])
    jpose = yolo_tpu.YOLO(src[1])
    jpose.fuse()
    jpred = JaxBasePredictor(jpose.model, jpose.params, overrides=lane_kw, names=jpose.names)
    n = 0
    for lane, ref in ((0, lambda f: jseg_y.predict(f, **lane_kw)[0]), (1, lambda f: jpred([f], verbose=False)[0])):
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/{lane}") as client:
            for f in frames:
                got, r = client(f), ref(f)
                want = np.asarray(r.boxes.data)[:, :6] if len(r.boxes) else np.zeros((0, 6), np.float32)
                assert got.shape == want.shape
                n += len(got)
                np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)
                np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)
                np.testing.assert_array_equal(got[:, 5], want[:, 5])
    assert n > 0
    with RemoteModel(f"tcp://127.0.0.1:{srv.port}/2") as client, pytest.raises(RemoteInferenceError, match="obb"):
        client(frames[0])
    assert "obb" in srv.lanes[2].error
