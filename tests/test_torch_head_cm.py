"""The port's channel-major Detect level (ops/cuda_head_cm plain twin on the
CPU) against the JAX package's channel-major Pallas head kernel in interpret
mode, then `predict_parts(head_cm=True)` and `FusedDetectTrack(pallas_head2=True)`
against the JAX package's `pallas_head2` routes. f32 throughout; tolerances
stated at each comparison (summation order differs, nothing else)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import modules as M
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.ops.pallas_head2 import head_level_cm as jax_head_level_cm
from yolo_tpu.ops.pallas_head2 import pick_wt
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import DetectionModel, FusedDetectTrack, params_from_jax
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.ops import cuda_head, cuda_head_cm

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)


def _fused_level(chain):
    """ConvBNAct init params → fused {conv: {weight, bias}} (BN folded)."""
    out = {}
    for j in ("0", "1"):
        bn = chain[j]["bn"]
        g = bn["weight"] / np.sqrt(bn["running_var"] + 1e-3)
        out[j] = {"conv": {"weight": chain[j]["conv"]["weight"] * g, "bias": bn["bias"] - bn["running_mean"] * g}}
    out["2"] = chain["2"]
    return out


def _level(rng, C, nc):
    """One Detect level with random fused weights: (JAX head, its params, the port's HeadWeights)."""
    head = M.Detect(nc=nc, ch=(C,))
    p = head.init(rng)
    for branch in ("cv2", "cv3"):  # non-trivial BN statistics and 1x1 biases
        for j in ("0", "1"):
            bn = p[branch]["0"][j]["bn"]
            bn["running_mean"] = rng.normal(0, 0.1, bn["running_mean"].shape).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    hp = {"cv2": {"0": _fused_level(p["cv2"]["0"])}, "cv3": {"0": _fused_level(p["cv3"]["0"])}, "dfl": p["dfl"]}
    port = PM.Detect(nc=nc, ch=(C,))
    port.load_jax(jax.tree_util.tree_map(np.asarray, hp), "cpu", torch.float32)
    return head, hp, port.kernel_weights(0)


@pytest.mark.parametrize("H,W,C,nc", [(8, 20, 24, 1), (7, 16, 16, 3)])
def test_head_level_cm_matches_jax_kernel(H, W, C, nc):
    rng = np.random.default_rng(0)
    _, hp, kw = _level(rng, C, nc)
    x = rng.normal(0, 1, (2, H, W, C)).astype(np.float32)
    before = cuda_head_cm.head_level_cm.launches
    got_d, got_c = cuda_head_cm.head_level_cm(torch.from_numpy(x), kw)
    assert cuda_head_cm.head_level_cm.launches == before  # CPU tensors take the plain twin
    want_d, want_c = jax_head_level_cm(
        jnp.asarray(x), hp["cv2"]["0"], hp["cv3"]["0"], np.arange(16, dtype=np.float32), nc, interpret=True, dtype=jnp.float32
    )
    assert got_d.shape == (2, H * W, 4) and got_c.shape == (2, H * W, nc) and got_c.dtype == torch.float32
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-5)


def test_head_level_cm_takes_a_width_without_tpu_tile():
    """W = 11 has no tile the TPU kernel accepts (a prime above its widest
    tile: the JAX package falls back to the XLA walk); the port's level
    function takes it and equals that walk."""
    H, W, C, nc = 5, 11, 24, 2
    assert pick_wt(W) == 0
    rng = np.random.default_rng(1)
    head, hp, kw = _level(rng, C, nc)
    x = rng.normal(0, 1, (2, H, W, C)).astype(np.float32)
    got_d, got_c = cuda_head_cm.head_level_cm(torch.from_numpy(x), kw)
    bins, clss, _ = head._branch_walk(hp, [jnp.asarray(x)], M.Ctx(train=False, dtype=jnp.float32))
    want_d = M.dfl_project(bins[0].reshape(2, H * W, 4, 16), jnp.arange(16, dtype=jnp.float32))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(jax.nn.sigmoid(clss[0])), rtol=0, atol=1e-5)


def test_head_level_cm_plain_is_head_level_plain_plus_sigmoid_in_f32():
    """In f32 no rounding separates the two level functions: the channel-major
    one is the default one with the logistic folded in."""
    rng = np.random.default_rng(2)
    _, _, kw = _level(rng, 48, 3)
    x = torch.from_numpy(rng.normal(0, 1, (1, 6, 9, 48)).astype(np.float32))
    d0, c0 = cuda_head.head_level_plain(x, kw)
    d1, c1 = cuda_head_cm.head_level_cm_plain(x, kw)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), torch.sigmoid(c0).numpy(), rtol=0, atol=1e-7)


def test_head_weights_tensor_core_layout_of_the_cm_kernel():
    """The channel-major kernel streams the bf16 pack of the default one
    (ops/cuda_head.py::pack_core; tests/test_torch_head.py walks its layout):
    each conv's blocks padded as the kernel reads them, made once."""
    rng = np.random.default_rng(3)
    _, _, kw = _level(rng, 24, 1)
    core = kw.core()
    # merged first conv 9 x pad16(24) x pad48(64 + pad32(24)), reg 3x3 9 x 64 x 64, cls 3x3 9 x 32 x 32,
    # reg 1x1 64 x 64, cls 1x1 pad32(24) x pad16(1)
    assert core.shape == (9 * 32 * 96 + 9 * 64 * 64 + 9 * 32 * 32 + 64 * 64 + 32 * 16,)
    assert core.dtype == torch.bfloat16 and kw.core() is core  # cached


@pytest.fixture(scope="module")
def small_model():
    jm = JaxDetectionModel("yolov8-small.yaml", ch=1, nc=1)
    jp = jm.fuse(jm.init(0))
    pm = DetectionModel("yolov8-small.yaml", ch=1, nc=1, device="cpu")
    params_from_jax(pm, jax.tree_util.tree_map(np.asarray, jp), torch.float32)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 1)).astype(np.float32)
    # the JAX package's kernel, in interpret mode, on every level (all four widths have a tile)
    want = jm.predict_parts(jp, jnp.asarray(x), dtype=jnp.float32, pallas_head2=True, pallas_interpret=True)
    return pm, x, tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("plain", [False, True])
def test_predict_parts_head_cm_matches_jax(small_model, plain):
    """By default (a CPU tensor takes the twin) and with the twin asked for by name."""
    pm, x, (want_b, want_s) = small_model
    got_b, got_s = pm.predict_parts(torch.from_numpy(x), head_cm=True, plain=plain)
    assert got_b.shape == want_b.shape and got_s.shape == want_s.shape
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-4)
    # the head switch changes the route, not the result
    base_b, base_s = pm.predict_parts(torch.from_numpy(x))
    np.testing.assert_allclose(got_b.numpy(), base_b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), base_s.numpy(), rtol=0, atol=1e-6)


def test_decode_from_inputs_cm_routes_levels(monkeypatch):
    """`decode_from_inputs_cm` sends every level to the channel-major level function, `decode_from_inputs` none."""
    calls = []
    real_cm, real = cuda_head_cm.head_level_cm, cuda_head.fused_head_level
    monkeypatch.setattr(cuda_head_cm, "head_level_cm", lambda x, kw: (calls.append(("cm", x.shape[1])), real_cm(x, kw))[1])
    monkeypatch.setattr(cuda_head, "fused_head_level", lambda x, kw: (calls.append(("pm", x.shape[1])), real(x, kw))[1])
    head = PM.Detect(nc=2, ch=(16, 32, 64))
    xs = [torch.randn(1, h, h, c) for h, c in ((8, 16), (4, 32), (2, 64))]
    head.decode_from_inputs_cm(xs)
    assert calls == [("cm", 8), ("cm", 4), ("cm", 2)]
    calls.clear()
    head.decode_from_inputs(xs)
    assert calls == [("pm", 8), ("pm", 4), ("pm", 2)]


@pytest.mark.parametrize("channels", [1, 3])
def test_fused_detect_track_head_cm_matches_jax(channels):
    """Two 8-frame chunks of a 64x64 clip. The JAX side takes its default XLA
    head, not `pallas_head2=True`: its `FusedDetectTrack` has no interpret
    switch, so off the TPU the kernel cannot run inside the jitted pipeline.
    The kernel itself is held in interpret mode by the tests above."""
    jm = JaxDetectionModel("yolov8n.yaml")
    jp = jm.fuse(jm.init(0))
    clip = np.random.default_rng(2).integers(0, 255, (16, 64, 64, channels), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=(64, 64), channels=channels, chunk=8, conf=1e-4, n_max=8, d_max=4)
    want_outs, want_stats = JaxFusedDetectTrack(jm, jp, dtype=jnp.float32, **kw).run_clip(clip)

    params = jax.tree_util.tree_map(np.asarray, jp)
    ft = FusedDetectTrack(DetectionModel("yolov8n.yaml", device="cpu"), params, dtype=torch.float32, device="cpu",
                          pallas_head2=True, **kw)
    got_outs, got_stats = ft.run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match="chunk is"):
        ft.process_chunk(clip[:8, :, :, :1] if channels == 3 else np.repeat(clip[:8], 3, -1))
