"""The RT-DETR backbones of the port against the JAX package's on the CPU: HGNetV2's HGStem, HGBlock (k x k ReLU convs
or LightConv) and LightConv, the CSP block RepC3 (each through its initial tree, BN fold and both forms in f32 and
bf16), and the TorchVision ResNet backbones (resnet18 / 34 / 50 / 101) with yolo11-cls-resnet18 over them.

Tolerances, stated again at each test: trees and folds exact; modules 1e-4 (f32) and 2e-2 (bf16) of their largest
output, as the v10 file's; TorchVision's train form within 2 x JAX's f32 distance from the port's f64 form (its fused
form 1e-4); classify probabilities 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu_torch
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import tasks as PT

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v10 import _close, _in_dtype
from tests.test_torch_v8_variants import _flat, _jax_forward, _load_train, _random_bn


# --- (a) HGNetV2's modules and RepC3 ---------------------------------------------------------------------------------------

MODULE_CASES = [  # (id, the module from either package's namespace, input channels, H x W)
    ("HGStem", lambda M: M.HGStem(3, 16, 32), 3, (26, 30)),
    ("HGBlock", lambda M: M.HGBlock(16, 8, 32, 3, 3), 16, (13, 14)),
    ("HGBlock-light-shortcut", lambda M: M.HGBlock(32, 8, 32, 5, 2, True, True), 32, (13, 14)),
    ("LightConv", lambda M: M.LightConv(16, 24, 5), 16, (13, 14)),
    ("RepC3", lambda M: M.RepC3(16, 32, 2), 16, (13, 14)),
    ("RepC3-e0.5", lambda M: M.RepC3(16, 32, 1, 0.5), 16, (13, 14)),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-2)}


def _jax_fold(p):
    """JAX's conv-by-conv fold of a module subtree (ConvBNAct.fuse; RepConv.fuse where a subtree holds a 3x3 conv1)."""
    if not isinstance(p, dict):
        return p
    if "conv1" in p and "conv2" in p and np.shape(p["conv1"]["conv"]["weight"])[0] == 3:
        return JM.RepConv(1, 1).fuse(p)
    if "bn" in p and "conv" in p:
        return JM.ConvBNAct.fuse(None, p)
    return {k: _jax_fold(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_backbone_module_matches_jax(case, form, dtype, two_threads):
    """HGStem, HGBlock (k x k ReLU convs; LightConv with the shortcut), LightConv and RepC3 (with and without cv3)
    against JAX's on N(0, 1) NHWC input, BN drawn at random: the initial subtree bit for bit, the port's fold bit for
    bit against JAX's (a LightConv's `conv1` / `conv2` fold group by group, a RepConv's into one 3x3), the train form
    (BN on the batch's moments, the same count) and the fused form within 1e-4 of the largest output in f32 and
    2e-2 in bf16 (one element in a thousand up to 2.5 x that), the output spread (std > 0.1)."""
    name, build, cin, hw = case
    jdt, pdt, tol, mtol = DTYPES[dtype]
    jm, pm = build(JM), build(PM)
    tree = jm.init(np.random.default_rng(0))
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, tree)), _flat(pm.init(np.random.default_rng(0)))
    assert set(got_t) == set(want_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    rng = np.random.default_rng(3)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    x = rng.normal(0, 1, (2, *hw, cin)).astype(np.float32)
    if form == "train":
        want, ctx = _jax_forward(jm, tree, jnp.asarray(x, jdt), True, jdt)
        _load_train(pm, tree)
        pm.train()
        got = pm.forward_train(torch.from_numpy(x).to(pdt))
        convs = [m for m in pm.modules() if isinstance(m, PM.ConvBNAct)]
        assert len(convs) == len(ctx.stats) and all(m.batch_stats is not None for m in convs)
    else:
        fused = PT.fuse(tree)
        jf = jax.tree_util.tree_map(np.asarray, _jax_fold(tree))
        want_f, got_f = _flat(jf), _flat(fused)
        assert set(got_f) == set(want_f)
        for k in want_f:
            np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)
        want, _ = _jax_forward(jm, jf, jnp.asarray(x, jdt), False, jdt)
        pm.load_jax(fused, "cpu", pdt)
        got = _in_dtype(pm, pdt)(torch.from_numpy(x).to(pdt))
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    _close(got.detach().float().numpy(), want, tol, dtype)
    assert want.std() > 0.1


# --- (b) TorchVision -----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["resnet18", "resnet34", "resnet50", "resnet101"])
def test_torchvision_matches_jax(model, two_threads):
    """TorchVision(512, model) at full width: init bit for bit; on two 256² N(0, 1) images with BN drawn at random, the
    train form (BN on the batch's moments) within 2 x JAX's f32 distance from the port's f64 train form (at least 1e-4
    of the largest output: through 50 or 101 layers of batch-moment BN both packages lie 8e-4 / 5e-3 from it in f32),
    the stride-32 map (8x8); the fused form (every group folded conv by conv, as the classify models fold) within 1e-4
    of the largest output; truncate=0 pools it to
    1x1 (JAX's mean). Another model and split=True raise NotImplementedError in both packages."""
    jm, pm = JM.TorchVision(512, model), PM.TorchVision(512, model)
    tree = jm.init(np.random.default_rng(0))
    _same_tree(pm.init(np.random.default_rng(0)), jax.tree_util.tree_map(np.asarray, tree))
    rng = np.random.default_rng(3)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    x = rng.normal(0, 1, (2, 256, 256, 3)).astype(np.float32)
    want, ctx = _jax_forward(jm, tree, jnp.asarray(x), True)
    _load_train(pm, tree)
    pm.train()
    got = pm.forward_train(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 8, 8, pm.c_out)
    with torch.no_grad():  # the f64 train form: the yardstick of f32 rounding through this depth
        exact = pm.double().forward_train(torch.from_numpy(x).double()).numpy()
    pm.float()
    want, bound = np.asarray(want), 1e-4 * max(np.abs(np.asarray(want)).max(), 1.0)
    assert np.abs(got - exact).max() <= max(2 * np.abs(want - exact).max(), bound)
    jf = _jax_fold(tree)
    want, _ = _jax_forward(jm, jf, jnp.asarray(x), False)
    pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
    _close(pm(torch.from_numpy(x)).numpy(), np.asarray(want), 1e-4, "f32")
    if model == "resnet18":
        jp, pp = JM.TorchVision(512, model, truncate=0), PM.TorchVision(512, model, truncate=0)
        pp.load_jax(PT.fuse(tree), "cpu", torch.float32)
        want, _ = _jax_forward(jp, jf, jnp.asarray(x), False)
        _close(pp(torch.from_numpy(x)).numpy(), np.asarray(want), 1e-4, "f32")
        for bad in (dict(model="vit_b_16"), dict(split=True)):
            for M in (JM, PM):
                with pytest.raises(NotImplementedError):
                    M.TorchVision(512, **bad)


def test_yolo11_cls_resnet18_matches_jax(two_threads):
    """yolo11-cls-resnet18 (nc 1000): the tree bit for bit, its f32 probabilities on two seeded 64² images with BN drawn
    at random against JAX's ClassificationModel.predict (1e-5); the facade's predict returns top-5 probs."""
    jm = JT.ClassificationModel("yolo11-cls-resnet18.yaml")
    y = yolo_tpu_torch.YOLO("yolo11-cls-resnet18.yaml", device="cpu")
    assert y.task == "classify" and type(y.model.layers[0]) is PM.TorchVision
    tree = jax.tree_util.tree_map(np.asarray, jm.init(0))
    _same_tree(y.params, tree)
    tree = _random_bn(tree, np.random.default_rng(2))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.predict(p, x))(tree, jnp.asarray(x)))
    PT.params_from_jax(y.model, tree)
    got = y.model.predict(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    y.params = tree
    r = y.predict(np.random.default_rng(0).integers(0, 255, (80, 96, 3), np.uint8), imgsz=64, compute_dtype="float32", verbose=False)[0]
    assert len(r.probs.top5) == 5
