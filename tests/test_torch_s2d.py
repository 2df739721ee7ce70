"""The JAX package's space-to-depth stem settings against the port, on the CPU in f32. The port takes
`FusedDetectTrack(s2d=4|8)` and YOLO_TPU_TRAIN_S2D=4 with the JAX package's checks and runs its
default route; these tests hold that route against JAX's s2d routes: `predict_s2d` (boxes 1e-4 px),
`FusedDetectTrack(s2d=r)` (tracks, ids and stats exact, boxes 1e-4 px), and the train-form stem with
its BN moments and gradients. yolov8-small (P2, one input channel) from init(0); inputs from seeded
numpy generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import s2d as JS
from yolo_tpu.nn.modules import Ctx
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import DetectionModel, FusedDetectTrack, params_from_jax
from yolo_tpu_torch.nn.tasks import load_train_params, train_leaves, validate_s2d_stem

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)


@pytest.fixture(scope="module")
def small():
    """yolov8-small at ch = 1 in both packages, the JAX init(0) tree fused (numpy)."""
    jm = JaxDetectionModel("yolov8-small.yaml", ch=1)
    raw = jax.tree_util.tree_map(np.asarray, jm.init(0))
    return jm, DetectionModel("yolov8-small.yaml", ch=1, device="cpu"), raw, jax.tree_util.tree_map(np.asarray, jm.fuse(raw))


@pytest.mark.parametrize("r", [4, 8])
def test_predict_s2d_matches_jax(small, r):
    """JAX's predict_s2d (the packed stem, no neck fold) against the port's default `predict_parts` on the
    same frames through the kernels' twins: boxes within 1e-4 px, scores within 1e-5, in f32."""
    jm, pm, _, fused = small
    params_from_jax(pm, fused, torch.float32)
    x = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 1), np.uint8)
    xp = JS.pack_input(x, r).astype(np.float32) / 255.0
    jb, js = jm.predict_s2d({**fused, "s2d": JS.fold_stem(fused, r)}, jnp.asarray(xp), dtype=jnp.float32, parts=True)
    pb, ps = pm.predict_parts(torch.from_numpy(x.astype(np.float32) / 255.0), plain=True)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-5)


@pytest.mark.parametrize("r", [4, 8])
def test_fused_s2d_matches_jax(small, r):
    """FusedDetectTrack(s2d=r) on a 16-frame 64x64 clip in chunks of 8: statuses, ids, emits, detection
    counts and stats equal to JAX's s2d pipeline, boxes within 1e-4 px; the port keeps the /255 fold (its
    default route). A frame the pack factor does not divide, and s2d with int8, raise ValueError."""
    jm, pm, _, fused = small
    clip = np.random.default_rng(1).integers(0, 255, (16, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=(64, 64), chunk=8, conf=1e-4, n_max=8, d_max=4)
    want, wstats = JaxFusedDetectTrack(jm, fused, dtype=jnp.float32, s2d=r, **kw).run_clip(clip)
    ft = FusedDetectTrack(pm, fused, dtype=torch.float32, device="cpu", s2d=r, **kw)
    got, gstats = ft.run_clip(clip)
    assert gstats == wstats and wstats["detection_frames"] > 0 and ft.norm_folded
    for g, w in zip(got, want):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        FusedDetectTrack(pm, fused, device="cpu", s2d=r, **{**kw, "frame_hw": (62, 64)})
    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedDetectTrack(pm, fused, device="cpu", s2d=r, int8=True, **kw)


def test_train_stem_matches_jax(small):
    """JAX's stem_apply_train (r = 4) against the port's train walk of layers 0-1 on the unfused tree in
    training mode: the P2 activation within 1e-5, both layers' BN batch moments within 1e-6 with JAX's
    counts, and the stem weights' and BN parameters' gradients of a scalar of the activation within 1e-4
    relative of jax.grad's."""
    jm, pm, raw, _ = small
    load_train_params(pm, raw)
    pm.train()
    x = np.random.default_rng(2).integers(0, 255, (2, 32, 48, 1), np.uint8)
    xp = JS.pack_input(x, 4).astype(np.float32) / 255.0
    proj = np.random.default_rng(3).normal(size=(2, 8, 12, pm.layers[1].c2)).astype(np.float32)

    def loss(p0, p1):
        ctx = Ctx(train=True, dtype=jnp.float32)
        z = JS.stem_apply_train(p0, p1, jnp.asarray(xp), ctx)
        return (z * proj).sum(), (z, ctx.stats)

    (_, (jz, jstats)), (g0, g1) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(raw["model"]["0"], raw["model"]["1"])
    z = pm.layers[1].forward_train(pm.layers[0].forward_train(torch.from_numpy(x.astype(np.float32) / 255.0)))
    (z * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    for i, g in (("0", g0), ("1", g1)):
        m = pm.layers[int(i)]
        mean, var, n = jstats[f"model/{i}/bn"]
        assert m.batch_stats[2] == n
        np.testing.assert_allclose(m.batch_stats[0].numpy(), np.asarray(mean), rtol=0, atol=1e-6)
        np.testing.assert_allclose(m.batch_stats[1].numpy(), np.asarray(var), rtol=0, atol=1e-6)
        leaves = train_leaves(pm)
        for path, want in (("conv/weight", np.asarray(g["conv"]["weight"]).transpose(3, 2, 0, 1)),
                           ("bn/weight", np.asarray(g["bn"]["weight"])), ("bn/bias", np.asarray(g["bn"]["bias"]))):
            got = leaves[f"model/{i}/{path}"].grad.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=f"{i}/{path}")
    pm.eval()


def test_validate_stem_refuses_other_stems():
    """A stem whose first conv is not 3x3 stride 2 is refused, by FusedDetectTrack(s2d=4) too, as the JAX
    package's check refuses it."""
    d = {"nc": 1, "backbone": [[-1, 1, "Conv", [16, 3, 1]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]]],
         "head": [[[2], 1, "Detect", ["nc"]]]}
    pm = DetectionModel(d, device="cpu")
    with pytest.raises(ValueError, match="layer 0"):
        validate_s2d_stem(pm)
    with pytest.raises(ValueError, match="layer 0"):
        FusedDetectTrack(pm, pm.init(0), frame_hw=(64, 64), chunk=8, device="cpu", s2d=4)
    with pytest.raises(AssertionError, match="layer 0"):
        JS.validate_stem(JaxDetectionModel(d))
