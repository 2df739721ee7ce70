"""The yolov3, yolov6, YOLO-NAS and yolov9 families of the port against the JAX package's on the CPU, continued from
tests/test_torch_v3_v6_v9_nas.py (the modules, the trees, the checkpoints, the routes): one train step of yolov9t and
of yolo_nas_s, and the entry points (int8 predict, track, tiled predict, a server lane, FusedDetectTrack, benchmark,
tune), with the refusal where JAX fails (FusedDetectTrack on yolov9e, whose layer 0 has no conv).

Tolerances, the yolo11 / yolo12 file's (tests/test_torch_yolo11_12.py), stated again at each test: train-step losses
1e-4 relative, BN moments 1e-4 of their largest and gradients 1e-3 of their tensor's largest (at least 1e-6), both in
an f64 step on both sides, and the f32 step's gradient direction (cosine > 0.999; the test says why); int8 predictions at the same
counts and classes, boxes 0.05 px and conf 1e-3; FusedDetectTrack's tracks, ids and stats exact, floats 1e-3; served,
tiled and tracked boxes in f32 1e-3 px and conf 1e-5."""

import csv
import types
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine import tuner as JTN
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.ops.tiling import tiled_predict as jax_tiled_predict
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu.utils import benchmarks as JB
from yolo_tpu.utils.loss import v8DetectionLoss as JaxLoss
from yolo_tpu_torch import FusedDetectTrack
from yolo_tpu_torch.engine import tuner as PTN
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.ops.tiling import tiled_predict
from yolo_tpu_torch.utils.loss import v8DetectionLoss

from tests.test_loss import _random_case
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)
from tests.test_torch_yolo11_12 import _frames, _paired, _same_boxes, _tuned

HYP = type("Hyp", (), dict(box=7.5, cls=0.5, dfl=1.5))
F32 = dict(imgsz=64, compute_dtype="float32", max_det=30, verbose=False, conf=0.25)
INT8_PX, INT8_CONF = 0.05, 1e-3


# --- (a) one train step ---------------------------------------------------------------------------------------


class _WideJnp(types.ModuleType):
    """`jax.numpy` with `float32` read as `float64`: set as the `jnp` of JAX's modules, it widens the casts that pin
    f32 (BN moments, the loss, NASBottleneck's residual) for a true f64 step."""

    def __init__(self):
        super().__init__("jax.numpy")

    def __getattr__(self, key):
        return jnp.float64 if key == "float32" else getattr(jnp, key)


@pytest.mark.parametrize("name", ["yolov9t.yaml", "yolo_nas_s.yaml"])
def test_train_step_matches_jax(name, two_threads, monkeypatch):
    """One train step at nc = 3 from init(0) on two seeded 128² images with `_random_case`'s targets: JAX's
    value_and_grad of forward_features + v8DetectionLoss against the port's train forward and backward. In f64 on
    both sides: the loss and its items 1e-4 relative, every BN's batch moments 1e-4 of their largest (at least 1) with
    the same count, every gradient 1e-3 of its tensor's largest (at least 1e-6); both packages pin f32 at their
    casts (`.astype(jnp.float32)`, `.float()`), which the f64 step widens to f64 (JAX's modules read a `jnp` whose
    float32 is float64; the port's `.float()` leaves an f64 tensor as it is). In f32, where an untrained tree's step
    is ill-conditioned (train-mode BN of 4x4 maps, ReLU kinks, the assigner's near-ties): the loss and its items 1e-4
    relative, and the whole gradient's direction (cosine > 0.999). NASBottleneck's alpha is a 0-d leaf of both trees,
    in the optimizer's 'other' group (no decay); the frozen leaves get no gradient in either package."""
    from yolo_tpu.utils import loss as JL, tal as JTAL
    from yolo_tpu_torch.utils import optim

    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": cls, "bboxes": boxes * 2, "mask_gt": mask}
    jm = JT.DetectionModel(name, nc=3)
    jp = jm.init(0)

    def jax_step(dtype):
        def forward_loss(params):
            ctx = JM.Ctx(train=True, dtype=dtype)
            total, comps = JaxLoss(jm, HYP)(jm.forward_features(params, jnp.asarray(x, dtype), ctx), {k: jnp.asarray(v) for k, v in batch.items()})
            return total, (comps, ctx.stats)

        tree = jax.tree.map(lambda a: np.asarray(a, dtype), jp)
        (total, (comps, stats)), grads = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(tree)
        flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(grads)}
        return float(total), np.asarray(comps), jax.tree.map(np.asarray, stats), flat

    def port_step(dtype):
        pm = PT.DetectionModel(name, nc=3, device="cpu").to(dtype)
        PT.load_train_params(pm, pm.init(0))
        pm.train()
        total, comps = v8DetectionLoss(pm, HYP)(pm.forward_features(torch.from_numpy(x).to(dtype)), {k: torch.from_numpy(v) for k, v in batch.items()})
        total.backward()
        params = {k: t for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)}
        grads = {}
        for k, t in params.items():
            g = PT.tree_from_leaves(pm, {k: t.grad})
            for part in k.split("/"):
                g = g[part]
            grads[k] = np.asarray(g)
        return pm, float(total.detach()), comps.detach().numpy(), params, grads

    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (JM, JT, JL, JTAL):
            mp.setattr(mod, "jnp", _WideJnp())
        narrow = torch.Tensor.float
        mp.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64 else narrow(t, *a, **k))
        jt, jcomps, jstats, flat = jax_step(jnp.float64)
        pm, total, comps, params, grads = port_step(torch.float64)
    assert flat["model/0/conv/weight" if "nas" in name else "model/1/conv/weight"].dtype == np.float64
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    bns = {"/".join(["model", *n.split(".")[1:]]) + "/bn": m for n, m in pm.named_modules() if isinstance(m, PM.ConvBNAct)}
    assert len(bns) == len(jstats)
    for key, m in bns.items():
        mean, var, n = jstats[key]
        assert m.batch_stats[2] == n
        for got, want in zip(m.batch_stats[:2], (mean, var)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1.0), err_msg=key)
    assert set(params) < set(flat)
    alphas = [k for k in params if k.endswith("/alpha")]
    assert (len(alphas) > 0) == ("nas" in name) and all(params[k].ndim == 0 == flat[k].ndim for k in alphas)
    assert all(not optim.is_decay_param(k, params[k]) and not optim.is_bias_param(k) for k in alphas)
    for k, g in grads.items():
        np.testing.assert_allclose(g, flat[k], rtol=0, atol=max(1e-3 * np.abs(flat[k]).max(), 1e-6), err_msg=k)
    for k in set(flat) - set(params):
        assert not np.abs(flat[k]).any(), k

    jt, jcomps, _, flat = jax_step(jnp.float32)
    _, total, comps, _, grads = port_step(torch.float32)
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    scale = {k: max(np.abs(flat[k]).max(), 1e-6) for k in grads}
    g = np.concatenate([np.ravel(grads[k]) / scale[k] for k in grads])
    w = np.concatenate([np.ravel(flat[k]) / scale[k] for k in grads])
    assert float(g @ w / np.linalg.norm(g) / np.linalg.norm(w)) > 0.999


# --- (b) the entry points -------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """{yaml: (JAX YOLO, port YOLO)} of yolov9t (SiLU, the head kernel's route) and yolo_nas_s (ReLU, walked) holding
    the same tuned tree (nc 80: box bins raised, class logits near 0), and two BGR frames of other sizes than the
    input (the letterbox resizes and pads)."""
    out = {}
    for name in ("yolov9t.yaml", "yolo_nas_s.yaml"):
        jy, py = yolo_tpu.YOLO(name), yolo_tpu_torch.YOLO(name, device="cpu")
        tree = _tuned(PT.DetectionModel(name, device="cpu"))
        jy.params, py.params = tree, tree
        out[name] = (jy, py)
    return out, _frames()


@pytest.mark.parametrize("name", ["yolov9t.yaml", "yolo_nas_s.yaml"])
def test_int8_predict_and_track_match_jax(name, pairs, two_threads):
    """`predict(int8=True)` (f32, imgsz 64, conf 0.25; dynamic activation scales: RepConv's fused 3x3 and CBLinear-free
    trees quantize as JAX's `quantize_params` does) on the resized frames: the same counts and classes, boxes 0.05 px
    and conf 1e-3, with detections, the model walking int8; then `track` (ByteTrack, f32, persist) over the two frames
    and the first again: JAX's rows (boxes 1e-3 px, conf 1e-5, ids exact)."""
    (models, frames) = pairs
    jy, py = models[name]
    jy.predictor = py.predictor = None
    want, got = jy.predict(frames, int8=True, **F32), py.predict(frames, int8=True, **F32)
    assert py.model.int8 and sum(_same_boxes(g, w, INT8_PX, INT8_CONF) for g, w in zip(got, want)) > 0
    jy.predictor = py.predictor = None
    kw = dict(tracker="bytetrack.yaml", persist=True, **F32)
    n = 0
    for f in frames + frames[:1]:
        w, g = jy.track(f, **kw)[0], py.track(f, **kw)[0]
        n += _same_boxes(g, w, 1e-3, 1e-5)
        if len(w) and w.boxes.id is not None:
            o = _paired(g.boxes.xyxy, w.boxes.xyxy, g.boxes.cls, w.boxes.cls)
            np.testing.assert_array_equal(g.boxes.id[o], w.boxes.id)
    assert n > 0 and not py.model.int8
    jy.predictor = py.predictor = None


def test_tiled_predict_and_server_lane_match_jax(pairs, tmp_path, two_threads):
    """yolo_nas_s: tiled_predict(tile=64, overlap=0.25, f32) of a 128x160 frame, the merged boxes (1e-3 px), scores
    (1e-5) and classes of JAX's; a server lane of yolov9t's tuned tree (f32, imgsz 64) replies to each frame with the
    boxes of JAX's predict (1e-3 px, conf 1e-5, classes equal)."""
    from tests.test_torch_serve import _serve
    from yolo_tpu_torch.serve import DetectionServer
    from yolo_tpu_torch.utils.remote import RemoteModel

    (models, frames) = pairs
    jy, py = models["yolo_nas_s.yaml"]
    big = cv2.resize(frames[0], (160, 128))
    kw = dict(tile=64, overlap=0.25, conf=0.25, compute_dtype="float32", max_det=30)
    jy.predictor = py.predictor = None
    wb, ws, wc = jax_tiled_predict(jy, big, **kw)
    gb, gs, gc = tiled_predict(py, big, **kw)
    assert len(gb) == len(wb) > 0
    o = _paired(gb, wb, gc, wc)
    np.testing.assert_allclose(gb[o], wb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gs[o], ws, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gc[o], wc)
    jy.predictor = py.predictor = None
    jy, py = models["yolov9t.yaml"]
    src = str(py.save(str(tmp_path / "yolov9t.npz")))
    srv = DetectionServer({0: src}, port=0, imgsz=64, batch_window_ms=1.0, device="cpu", predict_args={"compute_dtype": "float32"})
    t = _serve(srv)
    try:
        jy.predictor = None
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/0") as client:
            n = 0
            for f in frames:
                r = jy.predict(f, conf=0.25, iou=0.7, imgsz=64, max_det=300, verbose=False, compute_dtype="float32")[0]
                w, g = np.asarray(r.boxes.data)[:, :6], client(f)
                assert g.shape == w.shape
                o = _paired(g, w, g[:, 5], w[:, 5])
                np.testing.assert_allclose(g[o, :4], w[:, :4], rtol=0, atol=1e-3)
                np.testing.assert_allclose(g[o, 4], w[:, 4], rtol=0, atol=1e-5)
                np.testing.assert_array_equal(g[o, 5], w[:, 5])
                n += len(w)
            assert n > 0
    finally:
        srv.shutdown()
        t.join(30)
        jy.predictor = None


def _jax_walk_parts(jm):
    """JAX's `predict_parts` replaced by its `predict` (the conv walk, then the transposed decode): what JAX's
    FusedDetectTrack computes without its merged-SiLU fault (ROADMAP §3)."""
    def parts(params, x, dtype=jnp.float32, **_):
        y = jm.predict(params, x, dtype=dtype)
        return y[:, :4].transpose(0, 2, 1), y[:, 4:].transpose(0, 2, 1)
    return parts


def test_fused_detect_track_matches_jax(pairs, monkeypatch):
    """FusedDetectTrack (f32, 8 gray 64² frames in chunks of 4, a bright square in each): with yolo_nas_s's tuned tree,
    JAX's pipeline on its `predict` (the conv walk: JAX's own `predict_parts` merges the ReLU head's first convs with
    SiLU, ROADMAP §3): its tracks, ids and stats exactly, boxes, confidences and velocities 1e-3 (1e-4 relative); with
    yolov9t's, `pallas_head2=True` (the channel-major head kernel's route, its twin here; JAX's runs only in its
    Pallas interpreter) gives the default route's tracks, with detections; yolov9e's layer 0 (nn.Identity) has no conv
    for the input folds: JAX fails with a KeyError, the port raises NotImplementedError."""
    (models, _) = pairs
    clip = np.random.default_rng(2).integers(0, 255, (8, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=(64, 64), chunk=4, conf=0.25, n_max=8, d_max=4)

    def same(got, want):
        (got_outs, got_stats), (want_outs, want_stats) = got, want
        assert got_stats == want_stats and got_stats["detection_frames"] > 0
        for g, w in zip(got_outs, want_outs):
            for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ("bbox", "confidence", "velocity"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-3, err_msg=k)

    jy, py = models["yolo_nas_s.yaml"]
    monkeypatch.setattr(jy.model, "predict_parts", _jax_walk_parts(jy.model))
    same(FusedDetectTrack(py.model, py.params, dtype=torch.float32, device="cpu", **kw).run_clip(clip),
         JaxFusedDetectTrack(jy.model, jy.params, dtype=jnp.float32, **kw).run_clip(clip))
    _, py = models["yolov9t.yaml"]
    same(FusedDetectTrack(py.model, py.params, dtype=torch.float32, device="cpu", pallas_head2=True, **kw).run_clip(clip),
         FusedDetectTrack(py.model, py.params, dtype=torch.float32, device="cpu", **kw).run_clip(clip))
    je, pe = JT.DetectionModel("yolov9e.yaml"), PT.DetectionModel("yolov9e.yaml", device="cpu")
    tree = {"model": {"0": {}, "1": {"conv": {"weight": np.zeros((3, 3, 3, 64), np.float32)}}}}
    with pytest.raises(KeyError, match="conv"):
        JaxFusedDetectTrack(je, tree, dtype=jnp.float32, **kw)
    with pytest.raises(NotImplementedError, match="Identity"):
        FusedDetectTrack(pe, tree, dtype=torch.float32, device="cpu", **kw)


def test_benchmark_rows_and_tune_match_jax(tiny_dataset, tmp_path, monkeypatch, two_threads):
    """yolov9c-seg's `benchmark(imgsz=32)`: JAX's rows (its timing stubbed) in keys, batches 1 / 8 / 32 and dtype, the
    port's latencies positive; yolov9t's `tune(iterations=2, epochs=1, imgsz=32)` on the tiny detect split under one
    clock: JAX's tune_results.csv columns and hyperparameters exactly (JAX's `train` stubbed to fitness 0.25); the port
    trains each iteration and scores it with its validator (finite fitness), and best.npz is a yolov9t checkpoint
    whose RepNCSPELAN4 trees JAX reads."""
    monkeypatch.setattr(JB, "_time_fn", lambda fn, args, **kw: (1e-3, 0.0))
    want = yolo_tpu.YOLO("yolov9c-seg.yaml").benchmark(imgsz=32)
    got = yolo_tpu_torch.YOLO("yolov9c-seg.yaml", device="cpu").benchmark(imgsz=32)
    assert [list(r) for r in got] == [list(r) for r in want] == [["batch", "dtype", "latency_ms", "std_ms", "fps"]] * 3
    assert [(r["batch"], r["dtype"]) for r in got] == [(r["batch"], r["dtype"]) for r in want]
    assert all(r["latency_ms"] > 0 for r in got)
    clock = SimpleNamespace(time=lambda: 1_700_000_123.456)
    monkeypatch.setattr(JTN, "time", clock)
    monkeypatch.setattr(PTN, "time", clock)
    monkeypatch.setattr(yolo_tpu.YOLO, "train", lambda self, **kw: {"fitness": 0.25})
    kw = dict(iterations=2, data=tiny_dataset, epochs=1, imgsz=32, batch=4, workers=0, plots=False, val=True, amp=False)
    want = yolo_tpu.YOLO("yolov9t.yaml").tune(project=str(tmp_path / "jax"), **kw)
    got = yolo_tpu_torch.YOLO("yolov9t.yaml", device="cpu").tune(project=str(tmp_path / "torch"), **kw)
    read = lambda p: list(csv.DictReader(open(p)))  # noqa: E731
    jrows, prows = read(tmp_path / "jax/tune/tune_results.csv"), read(tmp_path / "torch/tune/tune_results.csv")
    assert list(prows[0]) == list(jrows[0]) == ["iteration", "fitness", *JTN.DEFAULT_SPACE]
    for p, j in zip(prows, jrows):
        assert {k: float(v) for k, v in p.items() if k in JTN.DEFAULT_SPACE} == {k: float(v) for k, v in j.items() if k in JTN.DEFAULT_SPACE}
    assert np.isfinite([float(r["fitness"]) for r in prows]).all() and set(got) == set(want)
    best = yolo_tpu.YOLO(str(tmp_path / "torch/tune/best.npz"))
    assert best.task == "detect" and isinstance(best.model.layers[4].module, JM.RepNCSPELAN4)
