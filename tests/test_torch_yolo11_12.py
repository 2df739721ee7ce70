"""The yolo11 and yolo12 families of the port (detect, segment, pose, obb and classify) against the JAX package's on the
CPU: C3k, C3k2, Attention, PSABlock, C2PSA, AAttn, ABlock, A2C2f and the non-legacy Detect class branch (depth-wise 3x3
then 1x1) through each module's initial tree, BN fold and both forms; the ten yamls' trees, fuse and f32 predict; the
layer lists at the other scales; one train step; the checkpoints; the routes that keep these blocks off the C2f and
head kernels; and the entry points (benchmark, int8 predict, tiled predict, track, FusedDetectTrack, a server lane,
tune), with the refusal JAX shares (the channel-major head kernel takes the legacy branches only).

Tolerances, the v8 variants' (tests/test_torch_v8_variants.py), stated again at each test: trees exact; f32 predictions
at 64² within 1e-3 px for boxes and keypoint positions and 1e-5 for scores, coefficients, visibilities and prototypes;
classify probabilities 1e-6; int8 predictions at the same counts and classes, boxes 0.05 px and conf 1e-3; train-step
losses 1e-4 relative, BN moments 1e-4 of their largest, gradients 1e-3 of their tensor's largest (at least 1e-6);
module outputs 1e-4 of their largest; FusedDetectTrack's tracks, ids and stats exact, floats 1e-3; served, tiled and
tracked boxes in f32 1e-3 px and conf 1e-5."""

import csv
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
from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_head_cm
from yolo_tpu_torch.ops.tiling import tiled_predict
from yolo_tpu_torch.utils.loss import v8DetectionLoss

from tests.test_loss import _random_case
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v8_variants import _flat, _jax_forward, _load_train, _random_bn
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)

FAMILIES = [f"yolo{v}n{t}.yaml" for v in (11, 12) for t in ("", "-seg", "-pose", "-obb", "-cls")]
JAX_CLASS = {"detect": JT.DetectionModel, "segment": JT.SegmentationModel, "pose": JT.PoseModel, "obb": JT.OBBModel,
             "classify": JT.ClassificationModel}
HYP = type("Hyp", (), dict(box=7.5, cls=0.5, dfl=1.5))
F32 = dict(imgsz=64, compute_dtype="float32", max_det=30, verbose=False, conf=0.25)
INT8_PX, INT8_CONF = 0.05, 1e-3


def _models(name):
    d = PT.yaml_model_load(name)
    task = PT.guess_model_task(d)
    return JAX_CLASS[task](name), PT.model_class_for(d, task)(name, device="cpu"), task


def _jax_fuse(jm, params):
    """JAX's BN fold, layer by layer as `DetectionModel.fuse` walks it (a classify model has no `fuse`): its
    generic walk leaves PSABlock's `ffn` groups unfused."""
    return {"model": {str(s.i): JT._fuse_module(s.module, params["model"][str(s.i)]) for s in jm.layers}}


# --- (a) the modules ------------------------------------------------------------------------------------------


MODULE_CASES = [  # (id, the module from either package's namespace, input channels, input H x W)
    ("C3k", lambda M: M.C3k(32, 32, 2), 32, (13, 14)),
    ("C3k-k5-no-shortcut", lambda M: M.C3k(16, 32, 1, False, 1, 0.5, 5), 16, (13, 14)),
    ("C3k2", lambda M: M.C3k2(32, 64, 2, False, 0.25), 32, (13, 14)),  # half-width 3x3 bottlenecks
    ("C3k2-c3k", lambda M: M.C3k2(32, 64, 1, True), 32, (13, 14)),
    ("Attention", lambda M: M.Attention(64, 2, 0.5), 64, (13, 14)),
    ("PSABlock", lambda M: M.PSABlock(64, 0.5, 2), 64, (13, 14)),
    ("C2PSA", lambda M: M.C2PSA(128, 128, 2), 128, (13, 14)),
    ("AAttn-area1", lambda M: M.AAttn(64, 2, 1), 64, (13, 14)),
    ("AAttn-area4", lambda M: M.AAttn(64, 2, 4), 64, (8, 14)),
    ("ABlock", lambda M: M.ABlock(64, 2, 1.2, 4), 64, (8, 14)),
    ("A2C2f-c3k", lambda M: M.A2C2f(32, 64, 1, False, -1), 32, (13, 14)),
    ("A2C2f-a2", lambda M: M.A2C2f(32, 64, 2, True, 4), 32, (8, 14)),
    ("A2C2f-a2-residual", lambda M: M.A2C2f(64, 64, 1, True, 1, True, 1.2), 64, (13, 14)),
    ("Detect-level", lambda M: M.Detect(3, (32,), False), 32, (13, 14)),  # the yolo11 / yolo12 class branch
]


def _run(m, tree, x, form):
    """One module's forward in either package; a Detect takes (and gives) a list of one level."""
    head = isinstance(m, (JM.Detect, PM.Detect))
    arg = [x] if head else x
    if isinstance(m, torch.nn.Module):
        out = m.forward_train(arg) if form == "train" else m(arg)
        return (out[0] if head else out).detach().numpy()
    out, ctx = _jax_forward(m, tree, jax.tree_util.tree_map(jnp.asarray, arg) if head else jnp.asarray(x), form == "train")
    return np.asarray(out[0] if head else out), ctx



@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(case, form, two_threads):
    """Each new module against JAX's on N(0, 1) NHWC input (2 x H x W), BN's γ, β and moments drawn at random: the
    initial subtree bit for bit and the fused one (the port's `fuse`, JAX's generic fold: PSABlock's ffn keeps its BN
    in both) bit for bit; the train form (BN on the batch's moments, which match JAX's within 1e-5 of their largest
    with the same count) and the fused form within 1e-4 of the largest output (at least 1e-4), the output spread
    (std > 0.1) so that a module that ignored its input would fail."""
    _, build, cin, hw = case
    jm, pm = build(JM), build(PM)
    tree = jm.init(np.random.default_rng(0))
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, tree)), _flat(pm.init(np.random.default_rng(0)))
    assert list(got_t) == list(want_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    rng = np.random.default_rng(3)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    x = rng.normal(0, 1, (2, *hw, cin)).astype(np.float32)
    if form == "train":
        want, ctx = _run(jm, tree, x, "train")
        _load_train(pm, tree)
        pm.train()
        got = _run(pm, None, torch.from_numpy(x), "train")
        convs = {(f"/{n.replace('.', '/')}/bn" if n else "/bn"): m for n, m in pm.named_modules() if isinstance(m, PM.ConvBNAct)}
        assert set(convs) == set(ctx.stats)
        for key, m in convs.items():
            mean, var, n = ctx.stats[key]
            assert m.batch_stats[2] == n, key
            for g, w in zip(m.batch_stats[:2], (np.asarray(mean), np.asarray(var))):
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0), err_msg=key)
    else:
        jf = jax.tree_util.tree_map(np.asarray, JT._fuse_module(jm, tree))
        pf = PT.fuse(tree)
        want_f, got_f = _flat(jf), _flat(pf)
        assert list(got_f) == list(want_f)
        for k in want_f:
            np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)
        assert any("['bn']" in k for k in got_f) == any("['ffn']" in k for k in got_f)  # only PSABlock's ffn keeps BN
        want, _ = _run(jm, jf, x, "fused")
        pm.load_jax(pf, "cpu", torch.float32)
        got = _run(pm, None, torch.from_numpy(x), "fused")
    assert got.shape == want.shape and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1.0))


def test_area_attention_refuses_pixels_that_do_not_divide_into_strips():
    """AAttn at area 4 on a 13x14 map (182 pixels): JAX's reshape fails (TypeError), the port raises ValueError naming
    the map and the strips; a map that divides runs."""
    jm, pm = JM.AAttn(64, 2, 4), PM.AAttn(64, 2, 4)
    tree = jm.init(np.random.default_rng(0))
    x = np.random.default_rng(1).normal(0, 1, (1, 13, 14, 64)).astype(np.float32)
    with pytest.raises(TypeError):
        jm(JT._fuse_module(jm, tree), jnp.asarray(x), JM.Ctx(train=False))
    pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
    with pytest.raises(ValueError, match="13x14 = 182 pixels into 4 strips"):
        pm(torch.from_numpy(x))
    assert pm(torch.from_numpy(x[:, :12])).shape == (1, 12, 14, 64)


def test_a2c2f_gamma_trains_as_in_jax(two_threads):
    """A2C2f's residual gamma (scales l and x) is a leaf of the train form: its gradient through a seeded linear read-out
    of the train-form output equals JAX's within 1e-4 of its largest, and JAX's tree path names it."""
    jm, pm = JM.A2C2f(64, 64, 1, True, 1, True, 1.2), PM.A2C2f(64, 64, 1, True, 1, True, 1.2)
    rng = np.random.default_rng(5)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, jm.init(np.random.default_rng(0))), rng)
    x = rng.normal(0, 1, (2, 8, 9, 64)).astype(np.float32)
    r = rng.normal(0, 1, (2, 8, 9, 64)).astype(np.float32)

    def loss(gamma):
        return jnp.sum(jm({**tree, "gamma": gamma}, jnp.asarray(x), JM.Ctx(train=True)) * r)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(tree["gamma"])))  # jitted: op by op, each primitive compiles alone
    _load_train(pm, tree)
    pm.train()
    assert set(pm.train_leaves()) == {"gamma"}
    (pm.forward_train(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(pm.gamma_train.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# --- (b) the ten yamls ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tree_fuse_and_predict_match_jax(name, two_threads):
    """`init(0)` leaf for leaf and bit for bit, the BN fold bit for bit (JAX's, which leaves PSABlock's ffn unfused, as
    the port's does), the strides, a non-legacy head, and the f32 predict of the fused tree on one seeded 64² image
    against JAX's (a classify model's JAX predict on the unfused tree, exact f32 BN): boxes and keypoint positions
    within 1e-3 px, scores, coefficients, visibilities, angles and prototypes 1e-5, classify probabilities 1e-6."""
    jm, pm, task = _models(name)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    pp = pm.init(0)
    want, got = _flat(jp), _flat(pp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jf, pf = jax.tree_util.tree_map(np.asarray, _jax_fuse(jm, jp)), PT.fuse(pp)
    want, got = _flat(jf), _flat(pf)
    assert list(got) == list(want) and any("ffn" in k and "running_var" in k for k in got) == ("yolo11" in name)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pm.stride == list(getattr(jm, "stride", [1]))
    assert task == "classify" or pm.head.legacy is jm.layers[-1].module.legacy is False
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    PT.params_from_jax(pm, pf)
    w, g = jax.jit(jm.predict)(jp if task == "classify" else jf, jnp.asarray(x)), pm.predict(torch.from_numpy(x))
    if task == "classify":
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        return
    if task == "segment":
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), rtol=0, atol=1e-5)
        w, g = w[0], g[0]
    w, g = np.asarray(w), g.numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
    if task == "pose":
        K = w[:, 4 + pm.nc :].reshape(1, -1, 3, w.shape[-1])
        np.testing.assert_allclose(g[:, 4 : 4 + pm.nc], w[:, 4 : 4 + pm.nc], rtol=0, atol=1e-5)
        Kg = g[:, 4 + pm.nc :].reshape(K.shape)
        np.testing.assert_allclose(Kg[:, :, :2], K[:, :, :2], rtol=0, atol=1e-3)
        np.testing.assert_allclose(Kg[:, :, 2], K[:, :, 2], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=0, atol=1e-5)


# --- (c) the layer lists at the other scales ------------------------------------------------------------------


def _jax_convs(obj) -> list:
    """(kind, c1, c2, k, s, g) of every ConvBNAct and Conv2d inside a JAX module, found through its attributes."""
    if isinstance(obj, JM.ConvBNAct):
        return [("conv", obj.c1, obj.c2, obj.k, obj.s, obj.g)]
    if isinstance(obj, JM.Conv2d):
        return [("conv2d", obj.c1, obj.c2, obj.k, 1, 1)]
    if isinstance(obj, (list, tuple)):
        return [c for o in obj for c in _jax_convs(o)]
    if type(obj).__module__ == JM.__name__:
        return [c for v in vars(obj).values() for c in _jax_convs(v)]
    return []


def _port_convs(m) -> list:
    return [("conv", c.c1, c.c2, c.k, c.s, c.g) if isinstance(c, PM.ConvBNAct) else ("conv2d", c.c1, c.c2, c.k, 1, 1)
            for c in m.modules() if isinstance(c, (PM.ConvBNAct, PM.Conv2d))]


@pytest.mark.parametrize("scale", ["s", "m", "l", "x"])
@pytest.mark.parametrize("family", ["yolo11", "yolo12"])
def test_layer_lists_at_other_scales_match_jax(family, scale):
    """yolo11<scale> and yolo12<scale> (no weights drawn): JAX's rows, sources and save list; each layer's module, and
    every conv inside it (c1, c2, k, s, groups) as JAX's; C3k2's blocks C3k from scale m on, A2C2f's residual gamma and
    1.2-wide MLP at l and x, and the non-legacy head."""
    name = f"{family}{scale}.yaml"
    d = PT.yaml_model_load(name)
    jlayers, jsave = JT.parse_model(JT.yaml_model_load(name), 3)
    with torch.device("meta"):  # the modules' zero tensors take no memory
        layers, froms, save = PT.parse_model(d, 3)
    assert froms == [s.f for s in jlayers] and save == jsave and len(layers) == len(jlayers)
    for m, spec in zip(layers, jlayers):
        jmod = spec.module
        assert type(m) is PT.MODULE_MAP[spec.type], spec.type
        assert sorted(_port_convs(m)) == sorted(_jax_convs(jmod)), (spec.i, spec.type)
        if isinstance(m, PM.C3k2):
            kinds = [type(b).__name__ for b in m.m]
            assert kinds == [type(b).__name__ for b in jmod.m] and (scale == "s" or set(kinds) == {"C3k"})
        if isinstance(m, PM.A2C2f):
            assert m.residual == jmod.residual == (m.a2 and scale in ("l", "x"))
        if isinstance(m, PM.Detect):
            assert m.legacy is jmod.legacy is False


# --- (d) one train step ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolo11n.yaml", "yolo12n.yaml"])
def test_train_step_matches_jax(name, two_threads):
    """One train step at nc = 3 from init(0) on two seeded 128² images with `_random_case`'s targets (at 64² the
    stride-32 maps are 2x2: the BN moments of eight values, normalized by their small spread, take the f32 rounding of
    the attention blocks up to 2e-4 of their largest in either package): JAX's
    value_and_grad of forward_features + v8DetectionLoss against the port's train forward and backward: the loss and
    its items 1e-4 relative, every BN's batch moments 1e-4 of their largest (at least 1) with the same count, every
    gradient 1e-3 of its tensor's largest and at least 1e-6; the frozen leaves get none in either package."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": cls, "bboxes": boxes, "mask_gt": mask}
    jm = JT.DetectionModel(name, nc=3)
    jp = jm.init(0)

    def forward_loss(params):
        ctx = JM.Ctx(train=True)
        total, comps = JaxLoss(jm, HYP)(jm.forward_features(params, jnp.asarray(x), ctx), {k: jnp.asarray(v) for k, v in batch.items()})
        return total, (comps, ctx.stats)

    (jt, (jcomps, jstats)), jg = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(jp)
    pm = PT.DetectionModel(name, nc=3, device="cpu")
    PT.load_train_params(pm, pm.init(0))
    pm.train()
    total, comps = v8DetectionLoss(pm, HYP)(pm.forward_features(torch.from_numpy(x)), {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=1e-4)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-4)
    bns = [("/".join(["model", *n.split(".")[1:]]) + "/bn", m) for n, m in pm.named_modules() if isinstance(m, PM.ConvBNAct)]
    assert len(bns) == len(jstats)
    for key, m in bns:
        mean, var, n = jstats[key]
        assert m.batch_stats[2] == n
        for got, want in zip(m.batch_stats[:2], (np.asarray(mean), np.asarray(var))):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1.0), err_msg=key)
    flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    params = {k: t for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)}
    assert set(params) < set(flat)
    for k, t in params.items():
        got = PT.tree_from_leaves(pm, {k: t.grad})
        for part in k.split("/"):
            got = got[part]
        np.testing.assert_allclose(got, flat[k], rtol=0, atol=max(1e-3 * np.abs(flat[k]).max(), 1e-6), err_msg=k)
    for k in set(flat) - set(params):
        assert not np.abs(flat[k]).any(), k


@pytest.mark.parametrize("name", ["yolo11n.yaml", "yolo12n.yaml"])
def test_attention_zero_grad_leaves_are_rounding_noise(name, two_threads):
    """chip_smoke.zero_grad_leaves of yolo11n (C2PSA's pe, proj and ffn.1 BN biases) and yolo12n (each ABlock's pe,
    proj and mlp.1 BN biases) on one train step (nc 3, two seeded 256² images, `_random_case`'s targets scaled to
    them): exactly the BN biases whose gradient is within 1e-5 of their BN weight's largest gradient (a constant they
    add to a residual stream reaches the loss only through 1x1 convs into training-mode BNs), which
    `train_step_f32_phase` holds card against CPU against that largest gradient instead of their own."""
    import chip_smoke

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 256, 256, 3)).astype(np.float32))
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": torch.from_numpy(cls), "bboxes": torch.from_numpy(boxes) * 4, "mask_gt": torch.from_numpy(mask)}
    pm = PT.DetectionModel(name, nc=3, device="cpu")
    PT.load_train_params(pm, pm.init(0))
    pm.train()
    total, _ = v8DetectionLoss(pm, HYP)(pm.forward_features(x), batch)
    total.backward()
    g = {k: t.grad for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)}
    scale = {k: float(g[k[: -len("bias")] + "weight"].abs().max()) for k in g if k.endswith("/bn/bias")}
    small = {k for k, w in scale.items() if w > 0 and float(g[k].abs().max()) <= 1e-5 * w}  # w = 0: a level no target reaches
    assert small == chip_smoke.zero_grad_leaves(pm) and len(small) == (3 if "11" in name else 24)


# --- (e) checkpoints ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolo11n-seg.yaml", "yolo12n-pose.yaml"])
def test_checkpoints_cross_between_packages(name, tmp_path):
    """A .npz that JAX writes loads in the port as the same task with JAX's tree, bit for bit; the port's .npz loads in
    JAX with the port's tree; the port's .pt (the non-legacy class branch as cv3.<level>.<0|1>.<0|1>.* in torch
    layout) reads back to the same tree in both packages."""
    jy, task = yolo_tpu.YOLO(name), PT.guess_model_task(PT.yaml_model_load(name))
    py = yolo_tpu_torch.YOLO(str(jy.save(str(tmp_path / "jax.npz"))), device="cpu")
    assert py.task == task and py.model.head.legacy is False
    _same_tree(py.params, jy.params)
    back = yolo_tpu.YOLO(str(py.save(str(tmp_path / "port.npz"))))
    assert back.task == task
    _same_tree(back.params, py.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)  # the export writes into the working directory
        pt = py.export(format="pt")
    sd = torch.load(str(tmp_path / pt), weights_only=True)["state_dict"]
    head = len(py.model.layers) - 1
    assert sd[f"model.{head}.cv3.0.0.0.conv.weight"].shape[1:] == (1, 3, 3)  # the depth-wise 3x3, OIHW
    for y in (yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu"), yolo_tpu.YOLO(str(tmp_path / pt))):
        assert y.task == task
        _same_tree(y.params, py.params)


# --- (f) the routes -------------------------------------------------------------------------------------------


def _refuse(*_, **__):
    raise AssertionError("a yolo11 / yolo12 block reached a C2f or head kernel")


@pytest.mark.parametrize("name", FAMILIES)
def test_blocks_never_reach_the_c2f_and_head_kernels(name, monkeypatch, two_threads):
    """Every C2f and head kernel wrapper (and its twin) patched to fail: the model's predict runs (`plain` both ways),
    as JAX's C2f kernel takes `type(self) is C2f` only and its head kernels the legacy branches; no neck fold is
    found; the channel-major head route refuses."""
    for mod, names in ((cuda_c2f, ("fused_c2f", "c2f_plain", "fused_c2f_upconcat", "c2f_upconcat_plain")),
                       (cuda_head, ("fused_head_level", "head_level_plain")), (cuda_head_cm, ("head_level_cm", "head_level_cm_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, _refuse)
    pm = PT.model_class_for(PT.yaml_model_load(name))(name, device="cpu")
    PT.params_from_jax(pm, PT.fuse(pm.init(0)))
    assert pm._upconcat == {} and any(isinstance(m, PM.C3k2) for m in pm.layers)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    for plain in (False, True):
        out = pm.predict(x, plain=plain)
        assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))
    if pm.task != "classify":
        with pytest.raises(ValueError, match="legacy"):
            pm.predict_parts(x, head_cm=True)


# --- (g) the entry points -------------------------------------------------------------------------------------


def _tuned(model):
    """init(0)'s tree with the head's last convs set so that the untrained model finds the drawn squares, as the task
    tests tune theirs: box bins 1 and 2 raised (boxes of about three strides), class logits near 0, the random weights
    of those convs scaled down but kept (varied scores)."""
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), model.init(0))
    head = p["model"][str(len(model.layers) - 1)]
    for l in range(model.head.nl):
        box, cls = head["cv2"][str(l)]["2"], head["cv3"][str(l)]["2"]
        for conv in (box, cls):
            conv["weight"] = conv["weight"] * 0.05
        box["bias"] = np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
        cls["bias"] = np.zeros_like(cls["bias"])
    return p


def _frames():
    rng = np.random.default_rng(9)
    frames = []
    for h, w in ((96, 128), (120, 100)):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        for _ in range(3):
            cx, cy, s = rng.uniform(15, w - 15), rng.uniform(15, h - 15), rng.uniform(5, 12)
            cv2.rectangle(img, (int(cx - s), int(cy - s)), (int(cx + s), int(cy + s)), float(rng.uniform(150, 230)), -1)
        frames.append(cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    return frames


@pytest.fixture(scope="module")
def pairs():
    """{yaml: (JAX YOLO, port YOLO)} of yolo11n and yolo12n holding the same tuned tree (nc 80), and two BGR frames of
    other sizes than the input (the letterbox resizes and pads)."""
    out = {}
    for name in ("yolo11n.yaml", "yolo12n.yaml"):
        jy, py = yolo_tpu.YOLO(name), yolo_tpu_torch.YOLO(name, device="cpu")
        tree = _tuned(PT.DetectionModel(name, device="cpu"))
        jy.params, py.params = tree, tree
        out[name] = (jy, py)
    return out, _frames()


def _paired(got, want, got_cls, want_cls):
    """Row order of `got` matched to `want`'s, each row to the nearest unmatched box of its class (near-equal scores
    may come out in either order; an untrained head scores every class alike, and boxes clipped to the frame repeat)."""
    got_cls, want_cls = np.asarray(got_cls), np.asarray(want_cls)
    free, order = np.ones(len(got), bool), []
    for w, c in zip(want, want_cls):
        cost = np.abs(got[:, :4] - w[None, :4]).sum(-1) + 1e6 * (got_cls != c) + 1e9 * ~free
        order.append(int(np.argmin(cost)))
        free[order[-1]] = False
    assert len(got) == len(want)
    return order


def _same_boxes(got, want, px, conf):
    assert len(got) == len(want)
    if not len(want):
        return 0
    o = _paired(got.boxes.xyxy, want.boxes.xyxy, got.boxes.cls, want.boxes.cls)
    np.testing.assert_allclose(got.boxes.xyxy[o], want.boxes.xyxy, rtol=0, atol=px)
    np.testing.assert_allclose(got.boxes.conf[o], want.boxes.conf, rtol=0, atol=conf)
    np.testing.assert_array_equal(got.boxes.cls[o], want.boxes.cls)
    return len(want)


@pytest.mark.parametrize("name", ["yolo11n.yaml", "yolo12n.yaml"])
def test_int8_predict_matches_jax(name, pairs, two_threads):
    """`predict(int8=True)` (f32, imgsz 64, conf 0.25; dynamic activation scales, PSABlock's unfused ffn convs left float
    in both, as JAX's quantize skips a conv with a BN group) on the resized frames: the same counts and classes, boxes
    0.05 px and conf 1e-3, with detections; the model walks int8, and a later float predict of the same YOLO goes back to
    the float route. (The float route through `YOLO.predict` is held at 1e-3 px by the tiled, track and server tests.)"""
    (models, frames) = pairs
    jy, py = models[name]
    jy.predictor = py.predictor = None
    want, got = jy.predict(frames, int8=True, **F32), py.predict(frames, int8=True, **F32)
    assert py.model.int8 and sum(_same_boxes(g, w, INT8_PX, INT8_CONF) for g, w in zip(got, want)) > 0
    assert any(m.eval_bn is not None for m in py.model.modules() if isinstance(m, PM.ConvBNAct)) == ("yolo11" in name)
    py.predict(frames, int8=False, **F32)
    assert not py.model.int8
    jy.predictor = py.predictor = None


def test_tiled_predict_and_track_match_jax(pairs, two_threads):
    """yolo12n: tiled_predict(tile=64, overlap=0.25, f32) of a 128x160 frame, the merged boxes (1e-3 px), scores
    (1e-5) and classes of JAX's; yolo11n: `track` (ByteTrack, f32, persist) over the two frames, JAX's rows (ids exact)."""
    (models, frames) = pairs
    jy, py = models["yolo12n.yaml"]
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
    jy, py = models["yolo11n.yaml"]
    kw = dict(tracker="bytetrack.yaml", persist=True, **F32)
    n = 0
    for f in frames + frames[:1]:
        w, g = jy.track(f, **kw)[0], py.track(f, **kw)[0]
        n += _same_boxes(g, w, 1e-3, 1e-5)
        if len(w) and w.boxes.id is not None:
            o = _paired(g.boxes.xyxy, w.boxes.xyxy, g.boxes.cls, w.boxes.cls)
            np.testing.assert_array_equal(g.boxes.id[o], w.boxes.id)
    assert n > 0
    jy.predictor = py.predictor = None


def test_fused_detect_track_matches_jax_and_refuses_the_cm_head(pairs):
    """FusedDetectTrack with yolo12n's tuned tree (f32, 8 gray 64² frames in chunks of 4, a bright square in each):
    JAX's tracks, ids and stats exactly, boxes, confidences and velocities 1e-3 (1e-4 relative), with detections;
    `pallas_head2=True` fails in JAX (an assertion of its channel-major head route: its kernel takes the legacy branches)
    and raises ValueError here."""
    (models, _) = pairs
    jy, py = models["yolo12n.yaml"]
    clip = np.random.default_rng(2).integers(0, 255, (8, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=(64, 64), chunk=4, conf=0.25, n_max=8, d_max=4)
    want_outs, want_stats = JaxFusedDetectTrack(jy.model, jy.params, dtype=jnp.float32, **kw).run_clip(clip)
    got_outs, got_stats = FusedDetectTrack(py.model, py.params, dtype=torch.float32, device="cpu", **kw).run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)
    xs = [jnp.zeros((1, 64 // s, 64 // s, c)) for s, c in zip(jy.model.stride, (64, 128, 256))]
    with pytest.raises(AssertionError, match="legacy"):  # the route JAX's pallas_head2=True takes, at its first line
        jy.model.layers[-1].module.decode_from_inputs_cm(jy.model.fuse(jy.params)["model"]["21"], xs, JM.Ctx(train=False))
    with pytest.raises(ValueError, match="legacy"):
        FusedDetectTrack(py.model, py.params, dtype=torch.float32, device="cpu", pallas_head2=True, **kw).run_clip(clip[:4])


def test_benchmark_rows_and_server_lane_match_jax(pairs, tmp_path, monkeypatch, two_threads):
    """yolo12n-seg's `benchmark(imgsz=32)`: JAX's rows (its timing stubbed) in keys, batches 1 / 8 / 32 and dtype, the
    port's latencies positive; a server lane of yolo11n's tuned tree (f32, imgsz 64) replies to each frame with the
    boxes of JAX's predict (1e-3 px, conf 1e-5, classes equal)."""
    from tests.test_torch_serve import _serve
    from yolo_tpu_torch.serve import DetectionServer
    from yolo_tpu_torch.utils.remote import RemoteModel

    monkeypatch.setattr(JB, "_time_fn", lambda fn, args, **kw: (1e-3, 0.0))
    want = yolo_tpu.YOLO("yolo12n-seg.yaml").benchmark(imgsz=32)
    got = yolo_tpu_torch.YOLO("yolo12n-seg.yaml", device="cpu").benchmark(imgsz=32)
    assert [list(r) for r in got] == [list(r) for r in want] == [["batch", "dtype", "latency_ms", "std_ms", "fps"]] * 3
    assert [(r["batch"], r["dtype"]) for r in got] == [(r["batch"], r["dtype"]) for r in want]
    assert all(r["latency_ms"] > 0 for r in got)
    (models, frames) = pairs
    jy, py = models["yolo11n.yaml"]
    src = str(py.save(str(tmp_path / "yolo11n.npz")))
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


def test_tune_trains_and_validates_yolo12n(tiny_dataset, tmp_path, monkeypatch, two_threads):
    """yolo12n's `tune(iterations=2, epochs=1, imgsz=32)` on the tiny detect split under one clock: JAX's
    tune_results.csv columns and hyperparameters exactly (the same draws; JAX's `train` stubbed to fitness 0.25); the
    port trains each iteration and scores it with its validator (finite fitness), and best.npz is a yolo12n
    checkpoint whose A2C2f trees JAX reads."""
    clock = SimpleNamespace(time=lambda: 1_700_000_123.456)
    monkeypatch.setattr(JTN, "time", clock)
    monkeypatch.setattr(PTN, "time", clock)
    monkeypatch.setattr(yolo_tpu.YOLO, "train", lambda self, **kw: {"fitness": 0.25})
    kw = dict(iterations=2, data=tiny_dataset, epochs=1, imgsz=32, batch=4, workers=0, plots=False, val=True, amp=False)
    want = yolo_tpu.YOLO("yolo12n.yaml").tune(project=str(tmp_path / "jax"), **kw)
    got = yolo_tpu_torch.YOLO("yolo12n.yaml", device="cpu").tune(project=str(tmp_path / "torch"), **kw)
    read = lambda p: list(csv.DictReader(open(p)))  # noqa: E731
    jrows, prows = read(tmp_path / "jax/tune/tune_results.csv"), read(tmp_path / "torch/tune/tune_results.csv")
    assert list(prows[0]) == list(jrows[0]) == ["iteration", "fitness", *JTN.DEFAULT_SPACE]
    for p, j in zip(prows, jrows):
        assert {k: float(v) for k, v in p.items() if k in JTN.DEFAULT_SPACE} == {k: float(v) for k, v in j.items() if k in JTN.DEFAULT_SPACE}
    assert np.isfinite([float(r["fitness"]) for r in prows]).all() and set(got) == set(want)
    best = yolo_tpu.YOLO(str(tmp_path / "torch/tune/best.npz"))
    assert best.task == "detect" and isinstance(best.model.layers[6].module, JM.A2C2f)
