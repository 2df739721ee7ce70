"""The JAX package's sparse box head and lazy decode against the port, on the CPU in f32. The port
takes their settings (`sparse_head`, YOLO_TPU_SPARSE_HEAD, YOLO_TPU_LAZY_DECODE) and runs its default
route; these tests hold that route against JAX's `predict_sparse_det` and `predict_logits` +
`non_max_suppression_logits` (random maps, targets on the map borders, a 3-class model with `classes`
and `agnostic`), `FusedDetectTrack` with each setting (tracks, ids and stats exact, boxes 1e-4 px), the
predictor under YOLO_TPU_LAZY_DECODE=1, and the settings' combinations, taken where JAX takes them.
yolov8-small from init(0); inputs from seeded numpy generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.ops import nms as JN
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import DetectionModel, FusedDetectTrack, params_from_jax
from yolo_tpu_torch.ops import nms as PN

from tests.conftest import ROOT
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)


def _models(nc=1, ch=1):
    jm = JaxDetectionModel("yolov8-small.yaml", ch=ch, nc=nc)
    fused = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(0)))
    pm = DetectionModel("yolov8-small.yaml", ch=ch, nc=nc, device="cpu")
    params_from_jax(pm, fused, torch.float32)
    return jm, pm, fused


@pytest.fixture(scope="module")
def one_class():
    return _models()


def _jax_sparse(jm, fused, x, **kw):
    return jax.jit(lambda p, xx: jm.predict_sparse_det(p, xx, dtype=jnp.float32, neck_opt=True, **kw))(fused, jnp.asarray(x))


def _jax_lazy(jm, fused, x, **kw):
    fn = lambda p, xx: JN.non_max_suppression_logits(*jm.predict_logits(p, xx, dtype=jnp.float32, neck_opt=True), **kw)  # noqa: E731
    return jax.jit(fn)(fused, jnp.asarray(x))


def _same_dets(got, want, atol=1e-4):
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(want["cls"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=atol)


def _border_frames(rng):
    x = rng.uniform(0, 0.1, (2, 64, 96, 1)).astype(np.float32)
    for y0, x0 in ((0, 0), (0, 90), (58, 0), (58, 90), (30, 0), (0, 45)):
        x[:, y0 : y0 + 6, x0 : x0 + 6] = 1.0
    return x


@pytest.mark.parametrize("case", ["random", "border"])
def test_sparse_and_lazy_routes_match_jax(one_class, case):
    """The port's default route (`predict_parts` + `non_max_suppression_parts`) gives the detections of JAX's
    sparse head and of its lazy decode (the same valid slots and classes, scores within 1e-6, boxes within
    1e-4 px), on random maps and on targets at the map borders and corners (the 5x5 patches leave the map
    there), through the NMS kernel's route (plain=False, its twin on the CPU) and the select-max route."""
    jm, pm, fused = one_class
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 64, 96, 1)).astype(np.float32) if case == "random" else _border_frames(rng)
    kw = dict(conf_thres=0.001 if case == "random" else 0.01, iou_thres=0.6, max_det=16, max_nms=64)
    parts = pm.predict_parts(torch.from_numpy(x), plain=True)
    for want in (_jax_sparse(jm, fused, x, **kw), _jax_lazy(jm, fused, x, **kw)):
        for plain in (True, False):
            _same_dets(PN.non_max_suppression_parts(*parts, plain=plain, **kw), want)


def test_multiclass_filters_match_jax():
    """A 3-class model: `classes=[0, 2]` and `agnostic` through the port's default route equal JAX's sparse
    head and lazy decode."""
    jm, pm, fused = _models(nc=3)
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    parts = pm.predict_parts(torch.from_numpy(x), plain=True)
    for extra in (dict(classes=[0, 2]), dict(agnostic=True)):
        kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=16, max_nms=64)
        got = PN.non_max_suppression_parts(*parts, plain=True, classes=extra.get("classes"),
                                           agnostic=extra.get("agnostic", False), **kw)
        _same_dets(got, _jax_sparse(jm, fused, x, **kw, **extra))
        _same_dets(got, _jax_lazy(jm, fused, x, **kw, **extra))


@pytest.mark.parametrize("route", ["sparse", "lazy"])
def test_fused_routes_match_jax(one_class, route, monkeypatch):
    """FusedDetectTrack with sparse_head=True or YOLO_TPU_LAZY_DECODE=1 (the port's default route) on a
    16-frame 64x64 clip in chunks of 8: statuses, ids, emits, detection counts and stats equal to JAX's
    sparse or lazy pipeline, boxes within 1e-4 px."""
    jm, pm, fused = one_class
    kw = dict(frame_hw=(64, 64), chunk=8, conf=1e-4, n_max=8, d_max=4)
    if route == "lazy":
        monkeypatch.setenv("YOLO_TPU_LAZY_DECODE", "1")
    else:
        kw["sparse_head"] = True
    clip = np.random.default_rng(2).integers(0, 255, (16, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255
    jft = JaxFusedDetectTrack(jm, fused, dtype=jnp.float32, **kw)
    assert (bool(jft.sparse_head), jft.lazy_decode) == (route == "sparse", route == "lazy")
    want, wstats = jft.run_clip(clip)
    got, gstats = FusedDetectTrack(pm, fused, dtype=torch.float32, device="cpu", **kw).run_clip(clip)
    assert gstats == wstats and wstats["detection_frames"] > 0
    for g, w in zip(got, want):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("env, kw", [
    ({"YOLO_TPU_SPARSE_HEAD": "1"}, {}),
    ({"YOLO_TPU_SPARSE_HEAD": "1"}, {"pallas_c2f": True}),
    ({"YOLO_TPU_SPARSE_HEAD": "1"}, {"pallas_head2": True}),
    ({"YOLO_TPU_SPARSE_HEAD": "1", "YOLO_TPU_LAZY_DECODE": "1"}, {}),
    ({"YOLO_TPU_LAZY_DECODE": "1"}, {"pallas_head": True}),
    ({"YOLO_TPU_LAZY_DECODE": "1"}, {"s2d": 4}),
    ({"YOLO_TPU_LAZY_DECODE": "1"}, {"int8": True}),
    ({}, {"sparse_head": False}),
    ({}, {}),
])
def test_route_flags_resolve_like_jax(one_class, env, kw, monkeypatch):
    """Each combination of the environment switches and the kernel flags that the JAX pipeline takes, the
    port takes too, and its neck fold's auto rule resolves as JAX's (nothing runs)."""
    jm, pm, fused = one_class
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = dict(frame_hw=(64, 64), chunk=8)
    j = JaxFusedDetectTrack(jm, fused, **base, **kw)
    p = FusedDetectTrack(pm, fused, device="cpu", **base, **kw)
    assert p.neck_opt == j.neck_opt and p.int8 == kw.get("int8", False)


def test_predictor_lazy_decode_matches_jax(monkeypatch):
    """YOLO_TPU_LAZY_DECODE=1 in predict (a fused float tree, no augment): the port's Results equal JAX's lazy
    predictor's and the port's without the switch (boxes 1e-2 px, conf 1e-4)."""
    weights = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:96, 0:128]
    img = 30 + rng.normal(0, 2, (96, 128)) + 170 * np.exp(-((xx - 70) ** 2 + (yy - 40) ** 2) / 32.0)
    frame = np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)
    kw = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=1, compute_dtype="float32")
    py = yolo_tpu_torch.YOLO(str(weights), device="cpu")
    dense = py.predict(frame, **kw)
    monkeypatch.setenv("YOLO_TPU_LAZY_DECODE", "1")
    want = yolo_tpu.YOLO(str(weights)).predict(frame, **kw)
    got = py.predict(frame, **kw)
    assert len(got[0]) == len(want[0]) == 1
    for other in (want, dense):
        np.testing.assert_allclose(got[0].boxes.xyxy, other[0].boxes.xyxy, rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[0].boxes.conf, other[0].boxes.conf, rtol=0, atol=1e-4)
