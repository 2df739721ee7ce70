"""The port's int8 PTQ (yolo_tpu_torch/nn/quantize.py) against the JAX package's: the quantized
trees bit for bit, the calibrated activation scales, the int8 conv (exact, where an f32 conv of
integer-valued maps is not), `predict(int8=True)` with its re-quantization, and
`FusedDetectTrack(int8=True, int8_calib=...)`, the int8-resident flow, on the CPU. The demo's
trained weights (best.npz, yolov8-small P2); inputs from seeded numpy generators; tolerances
stated at each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.nn import quantize as JQ
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import FusedDetectTrack
from yolo_tpu_torch.engine.exporter import load_npz
from yolo_tpu_torch.nn import quantize as PQ

from tests.conftest import ROOT
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


@pytest.fixture(scope="module")
def trained():
    """best.npz in both packages: the port's model, the JAX model of the same yaml, the fused tree."""
    pm, params, _ = load_npz(WEIGHTS, device="cpu")
    jm = JaxDetectionModel(pm.yaml)
    return pm, jm, params, jax.tree_util.tree_map(np.asarray, jm.fuse(params))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "static"])
def test_quantized_trees_match_jax_bit_for_bit(trained, calibrated):
    """quantize_params of the fused tree equals JAX's leaf for leaf and dtype for dtype: w_int8, w_scale,
    bias, and with JAX's calibrated scales x_scale and y_scale (min_channels 16: the 16-output stem is
    quantized; the Detect 1x1s and the bias-less DFL stay float); the flow paths are JAX's."""
    pm, jm, _, fused = trained
    assert pm.int8_flow_paths() == jm.int8_flow_paths()
    scales = None
    if calibrated:
        x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        scales = JQ.calibrate_act_scales(jm, fused, jnp.asarray(x))
    want = JQ.quantize_params(fused, act_scales=scales, flow_paths=jm.int8_flow_paths())
    got = PQ.quantize_params(fused, act_scales=scales, flow_paths=pm.int8_flow_paths())
    _same_tree(got, want)
    head = got["model"][str(len(pm.layers) - 1)]
    assert got["model"]["0"]["conv"]["w_int8"].shape[-1] == 16 and "w_int8" in head["cv2"]["0"]["0"]["conv"]
    assert "w_int8" not in head["cv3"]["0"]["2"] and "w_int8" not in head["dfl"]["conv"]
    assert ("y_scale" in got["model"]["2"]["cv1"]["conv"]) is calibrated
    _same_tree(PQ.quantize_params(jm.init(0)), JQ.quantize_params(jm.init(0)))  # unfused: nothing quantized


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrated_scales_match_jax(trained, dtype):
    """calibrate_act_scales: the same 166 keys (every ConvBNAct's input and 'OUT::' output), each scale
    within 1e-5 relative of JAX's in f32, and within three bf16 ulps (3 · 2^-7) in bf16, where both
    forwards round every map (XLA and torch round at different places)."""
    pm, jm, _, fused = trained
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = JQ.calibrate_act_scales(jm, fused, jnp.asarray(x), dtype=getattr(jnp, dtype))
    got = PQ.calibrate_act_scales(pm, fused, x, dtype=getattr(torch, dtype))
    assert set(got) == set(want) and len(want) == 166
    tol = 1e-5 if dtype == "float32" else 3 * 2**-7
    for k in want:
        assert abs(got[k] - want[k]) <= tol * want[k], (k, got[k], want[k])


def test_calibration_capture_is_per_model(trained, monkeypatch):
    """While `capture` runs on one model, a second model (another thread's predictor, say) keeps its route:
    its C2f blocks go through the kernel entry (its twin on the CPU), nothing of its walk enters the
    calibration store, and its outputs equal those it gives outside the capture."""
    from yolo_tpu_torch.nn import modules as M
    from yolo_tpu_torch.nn.tasks import DetectionModel, params_from_jax

    pm, _, params, _ = trained
    a, b = DetectionModel(pm.yaml, device="cpu"), DetectionModel(pm.yaml, device="cpu")
    for m in (a, b):
        params_from_jax(m, params, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    want = b.predict(x, plain=True)
    calls = []
    real = M.C2f.forward_modules
    monkeypatch.setattr(M.C2f, "forward_modules", lambda self, y: (calls.append(self), real(self, y))[1])
    with PQ.capture(a, {}) as store:
        got = b.predict(x, plain=True)
        assert not store and not calls
        a._walk(x, plain=True, neck_opt=False)
    assert store and calls and all(any(c is m for m in a.modules()) for c in calls)
    assert all(m.calib is None for m in a.modules() if isinstance(m, M.ConvBNAct))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("k, s, cin, cout", [(3, 1, 192, 64), (3, 2, 3, 16), (1, 1, 48, 40), (3, 1, 1, 16)])
def test_int8_conv_is_exact(k, s, cin, cout):
    """The im2col + torch._int_mm conv equals an f64 conv of the same int8 codes exactly; at 3x3 over 192
    channels an f32 conv of those integer-valued maps does not (sums beyond 2^24)."""
    rng = np.random.default_rng(k * 100 + cin)
    x = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    if cin == 192:
        x[...] = 127
        w[...] = 127
    got = PQ.int8_conv(torch.from_numpy(x), PQ.weight_matrix(w, "cpu"), k, s, cout)

    def conv(dt):
        xt = torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2).to(dt)
        wt = torch.from_numpy(w.astype(np.float64).transpose(3, 2, 0, 1)).to(dt)
        return torch.nn.functional.conv2d(xt, wt, stride=s, padding=k // 2).permute(0, 2, 3, 1)

    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), conv(torch.float64).numpy().astype(np.int64))
    if cin == 192:
        assert not np.array_equal(conv(torch.float32).double().numpy(), conv(torch.float64).numpy())


def test_predict_int8_matches_jax(trained):
    """YOLO(best.npz).predict(int8=True) (dynamic scales) in f32: the same detections as JAX's, boxes
    within 1e-5 relative (+1e-4 px), conf within 1e-4. A reused predictor re-quantizes the tree it is
    given (the facade refreshes params each call) and int8=False goes back to the float route."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    frames = []
    for cx, cy in ((40, 30), (90, 60)):
        img = 30 + rng.normal(0, 2, (96, 128)) + 170 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 32.0)
        frames.append(np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1))
    kw = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=2, compute_dtype="float32")
    jy, py = yolo_tpu.YOLO(str(WEIGHTS)), yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")
    want, got = jy.predict(frames, int8=True, **kw), py.predict(frames, int8=True, **kw)
    assert [len(r) for r in got] == [len(r) for r in want] == [1, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=0, atol=1e-4)
    assert py.model.int8 and py.predictor._quantized[0] is py.params
    fresh = jax.tree_util.tree_map(np.copy, py.params)
    py.predictor.set_params(fresh)
    assert py.predictor._quantized[0] is fresh and py.model.held[0] is py.predictor._quantized[1]
    f32 = py.predict(frames, int8=False, **kw)
    assert not py.model.int8 and [len(r) for r in f32] == [1, 1]
    assert float(np.abs(f32[0].boxes.xyxy - got[0].boxes.xyxy).max()) < 2.0  # int8 is close to f32, not equal


def test_fused_int8_calibrated_matches_jax(trained, monkeypatch):
    """FusedDetectTrack(int8=True, int8_calib=first chunk) on a 16-frame 64x64 clip, in f32: static
    scales and the int8-resident flow (QTensors between the convs): every layer's int8 codes and
    scales equal to JAX's on the first chunk; tracks, ids, statuses and stats equal, boxes at the
    float route's tolerance (1e-4 relative + 1e-3 px: the head's float 1x1s and DFL sum in another
    order, test_torch_pipeline.py). The scales are JAX's calibration of the
    same frames and tree (the port's own bf16 calibration is held to JAX's in
    test_calibrated_scales_match_jax: a scale one bf16 ulp apart moves int8 codes, as any other
    calibration would). Without `int8_calib` the pipeline quantizes each conv input with its dynamic
    scale and keeps no int8 between the convs (the dynamic route is held against JAX on predict
    frames: its codes follow each f32 SiLU, whose last bit torch and XLA may round apart, so a
    code on a rounding edge can flip). int8 turns the neck fold off and refuses s2d, the sparse
    head and an explicit neck_opt. Both take the fused tree: the JAX
    pipeline does not fuse, and its quantize_params leaves an unfused tree float."""
    import yolo_tpu_torch.pipeline.fused as PF

    pm, jm, _, params = trained
    monkeypatch.setattr(PF, "calibrate_act_scales", lambda m, p, cal: JQ.calibrate_act_scales(jm, p, jnp.asarray(cal)))
    clip = np.random.default_rng(5).integers(0, 60, (16, 64, 64, 1), np.uint8)
    clip[:, 20:26, 30:36] = 230
    clip[8:, 40:44, 10:14] = 200
    kw = dict(frame_hw=(64, 64), chunk=8, conf=0.05, n_max=8, d_max=4)
    for calib in (clip[:8],):
        jft = JaxFusedDetectTrack(jm, params, dtype=jnp.float32, int8=True, int8_calib=calib, **kw)
        want, wstats = jft.run_clip(clip)
        ft = FusedDetectTrack(pm, params, dtype=torch.float32, device="cpu", int8=True, int8_calib=calib, **kw)
        got, gstats = ft.run_clip(clip)
        assert gstats == wstats and wstats["detection_frames"] > 0
        for g, w in zip(got, want):
            for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ("bbox", "confidence", "velocity"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-3, err_msg=k)
        assert ft.model.int8 and not ft.neck_opt
        if calib is not None:  # the codes layer by layer on the first chunk
            from yolo_tpu.nn.modules import Ctx

            x = clip[:8].astype(np.float32) / 255.0
            _, _, jcol = jm._walk(jft.params, jnp.asarray(x), Ctx(train=False, dtype=jnp.float32), collect=set(range(len(pm.layers) - 1)))
            _, pcol = ft.model._walk(torch.from_numpy(x), plain=True, neck_opt=False, collect=set(range(len(pm.layers) - 1)))
            qt = [i for i in pcol if isinstance(pcol[i], PQ.QTensor)]
            assert len(qt) == len(pm.layers) - 1  # every layer's output stays int8
            for i in qt:
                np.testing.assert_array_equal(pcol[i].q.numpy(), np.asarray(jcol[i].q), err_msg=f"layer {i}")
                assert float(pcol[i].s) == float(jcol[i].s)
    dyn = FusedDetectTrack(pm, params, dtype=torch.float32, device="cpu", int8=True, **kw)
    assert dyn.model.layers[2].cv1.q["x_scale"] is None and dyn.model.layers[2].cv1.q["y_scale"] is None
    assert dyn.run_clip(clip)[1]["frames"] == 16
    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedDetectTrack(pm, params, device="cpu", int8=True, s2d=4, **kw)
    with pytest.raises(ValueError, match="sparse"):
        FusedDetectTrack(pm, params, device="cpu", int8=True, sparse_head=True, **kw)
    with pytest.raises(ValueError, match="neck_opt"):
        FusedDetectTrack(pm, params, device="cpu", int8=True, neck_opt=True, **kw)
