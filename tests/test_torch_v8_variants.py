"""The v8 variant families of the port (yolov8-p6, -ghost, -ghost-p2, -ghost-p6, -seg-p6, -pose-p6,
-cls-resnet50, -cls-resnet101, and yolov5 / yolov5-p6, which build with the same modules) against the JAX
package's on the CPU: ConvBNAct's padding, groups and activation, MaxPool2d, DWConv, C3, C2, GhostConv,
GhostBottleneck, C3Ghost, ResNetBlock and ResNetLayer through each model's initial tree, BN fold, f32
predict, int8 convs, one train step, and FusedDetectTrack with a ghost-p2 and a p6 model.

Tolerances, stated again at each test: trees exact; f32 predictions at 64² (128² for the p6 models, whose
coarsest level is 1/64) within 1e-3 px for boxes and keypoint positions and 1e-5 for scores, coefficients,
visibilities and prototypes; classify probabilities 1e-6; int8 conv codes exact; int8 predictions 1e-2 of
the largest; train-step losses 1e-4 relative, BN moments 1e-4 of their largest, gradients 1e-3 of their
tensor's largest (at least 1e-6);
FusedDetectTrack's tracks, ids and stats exact, floats 1e-3."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.nn.quantize import quantize_params as jax_quantize_params
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu.utils.loss import v8DetectionLoss as JaxLoss
from yolo_tpu_torch import FusedDetectTrack
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import quantize as PQ
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.utils.loss import v8DetectionLoss

from tests.test_loss import _random_case
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

VARIANTS = ["yolov8n-p6.yaml", "yolov8n-ghost.yaml", "yolov8n-ghost-p2.yaml", "yolov8n-ghost-p6.yaml", "yolov8n-seg-p6.yaml",
            "yolov8n-pose-p6.yaml", "yolov8n-cls-resnet50.yaml", "yolov8n-cls-resnet101.yaml", "yolov5n.yaml", "yolov5n-p6.yaml"]
JAX_CLASS = {"detect": JT.DetectionModel, "segment": JT.SegmentationModel, "pose": JT.PoseModel, "classify": JT.ClassificationModel}
HYP = type("Hyp", (), dict(box=7.5, cls=0.5, dfl=1.5))


def _models(name):
    d = PT.yaml_model_load(name)
    task = PT.guess_model_task(d)
    return JAX_CLASS[task](name), PT.model_class_for(d, task)(name, device="cpu"), task


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_fuse(jm, params):
    """JAX's BN fold: `DetectionModel.fuse`; a classify model has none, so every conv + BN group goes through JAX's
    `ConvBNAct.fuse` (JAX's generic module walk would leave ResNetLayer's groups unfused: its modules are not
    named after its tree's `layer` key)."""
    if hasattr(jm, "fuse"):
        return jm.fuse(params)

    def walk(p):
        if not isinstance(p, dict):
            return p
        return JM.ConvBNAct.fuse(None, p) if "bn" in p and "conv" in p else {k: walk(v) for k, v in p.items()}

    return walk(params)


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_tree_fuse_and_predict_match_jax(name, two_threads):
    """`init(0)` leaf for leaf and bit for bit, the BN fold bit for bit, the layer strides, and the f32 predict of
    the fused tree on one seeded image (64², the p6 models 128²) against JAX's (a classify model's JAX predict on the
    unfused tree, exact f32 BN): boxes and keypoint positions within 1e-3 px, scores, coefficients, visibilities and
    prototypes 1e-5, classify probabilities 1e-6."""
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
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pm.stride == list(getattr(jm, "stride", [1]))
    size = 128 if max(pm.stride) == 64 else 64
    x = np.random.default_rng(1).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
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


MODULE_CASES = [  # (id, the module from either package's namespace, input channels)
    ("C3-n2", lambda M: M.C3(16, 32, 2), 16),  # yolov5's bottlenecks: 1x1 then 3x3
    ("C3-n1-no-shortcut", lambda M: M.C3(16, 24, 1, False), 16),
    ("C2-n2", lambda M: M.C2(16, 32, 2), 16),
    ("GhostConv-k3", lambda M: M.GhostConv(16, 32, 3, 1), 16),
    ("GhostConv-s2", lambda M: M.GhostConv(16, 32, 3, 2), 16),
    ("GhostBottleneck-s2", lambda M: M.GhostBottleneck(16, 32, 3, 2), 16),  # the DWConv branch and shortcut
    ("GhostBottleneck-s1", lambda M: M.GhostBottleneck(32, 32, 3, 1), 32),
    ("C3Ghost-n2", lambda M: M.C3Ghost(16, 32, 2), 16),
    ("DWConv-s2", lambda M: M.DWConv(16, 32, 3, 2), 16),
    ("DWConv-k5-no-act", lambda M: M.DWConv(16, 16, 5, 1, act=False), 16),
    ("ResNetBlock-s2", lambda M: M.ResNetBlock(16, 8, 2), 16),
    ("ResNetBlock-identity", lambda M: M.ResNetBlock(32, 8, 1), 32),
    ("ResNetLayer-n2-s2", lambda M: M.ResNetLayer(16, 8, 2, False, 2), 16),
    ("ResNetLayer-stem", lambda M: M.ResNetLayer(3, 16, 1, True, 1), 3),
]


def _random_bn(tree, rng):
    """The tree with every BN's γ, β and running moments drawn at random, so that the fold is not the identity."""
    if not isinstance(tree, dict):
        return tree
    if "bn" in tree:
        c = np.asarray(tree["bn"]["weight"]).shape[0]
        bn = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c), "running_mean": rng.normal(0, 0.3, c),
              "running_var": rng.uniform(0.5, 2.0, c)}
        return {**tree, "bn": {k: v.astype(np.float32) for k, v in bn.items()}}
    return {k: _random_bn(v, rng) for k, v in tree.items()}


@torch.no_grad()
def _load_train(module, tree):
    """An unfused module subtree into the port module's train form (OIHW convs, a Detect's DFL projection flat), as
    `load_train_params` loads a model."""
    for name, m in module.named_modules():
        if hasattr(m, "train_leaves"):
            for rel, t in m.train_leaves().items():
                node = tree
                for k in [*(name.split(".") if name else []), *rel.split("/")]:
                    node = node[k]
                a = np.asarray(node, np.float32)
                a = a.reshape(-1) if rel.endswith("dfl/conv/weight") else a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(t.shape))  # a 0-d leaf (NAS alpha) comes back 1-d


def _jax_forward(m, tree, arg, train: bool, dtype=jnp.float32):
    """A JAX module's forward → (its output, a record of its Ctx with the BN batch moments `stats`). In f32 under one
    jit: op by op, each primitive of the walk compiles on its own, which took most of the module tests' time, and XLA's
    fusion keeps f32 results as they are. In bf16 op by op, as JAX's own modules run it: a fusion would skip the bf16
    rounding between ops (RepNCSPELAN4's train form then lies 0.14 from the op-by-op one in one element of 23,296)."""
    def run(tree, arg):
        ctx = JM.Ctx(train=train, dtype=dtype)
        return m(tree, arg, ctx), ctx.stats

    out, stats = (jax.jit(run) if dtype == jnp.float32 else run)(tree, arg)
    return out, SimpleNamespace(stats=stats)


@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_variant_module_matches_jax(case, form, two_threads):
    """Each new module against JAX's on unit-scale random NHWC input (2x13x14, N(0, 1)), BN's γ, β and moments drawn at
    random: the initial subtree bit for bit; the train form (BN on the batch's moments, which match JAX's within 1e-5
    of their largest with the same count) and the fused form (JAX's BN fold in both packages) within 1e-4 of the
    largest output (at least 1e-4), the output spread (std > 0.1) so that a module that ignored its input would fail."""
    _, build, cin = case
    jm, pm = build(JM), build(PM)
    tree = jm.init(np.random.default_rng(0))
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, tree)), _flat(pm.init(np.random.default_rng(0)))
    assert list(got_t) == list(want_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    rng = np.random.default_rng(3)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    x = rng.normal(0, 1, (2, 13, 14, cin)).astype(np.float32)
    if form == "train":
        want, ctx = _jax_forward(jm, tree, jnp.asarray(x), True)
        want = np.asarray(want)
        _load_train(pm, tree)
        pm.train()
        got = pm.forward_train(torch.from_numpy(x)).detach().numpy()
        # JAX's stats path of ResNetBlock's projection leaves out its tree's '0' group
        projections = {f"{n}.shortcut.0".lstrip(".") for n, m in pm.named_modules() if isinstance(m, PM.ResNetBlock)}
        convs = {(f"/{n.replace('.', '/')}/bn" if n else "/bn").replace("/shortcut/0/", "/shortcut/" if n in projections else "/shortcut/0/"): m
                 for n, m in pm.named_modules() if isinstance(m, PM.ConvBNAct)}
        assert set(convs) == set(ctx.stats)
        for key, m in convs.items():
            mean, var, n = ctx.stats[key]
            assert m.batch_stats[2] == n, key
            for g, w in zip(m.batch_stats[:2], (np.asarray(mean), np.asarray(var))):
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0), err_msg=key)
    else:
        want = np.asarray(jm(_jax_fuse(jm, tree), jnp.asarray(x), JM.Ctx(train=False)))
        pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("k, s, g", [(5, 1, 16), (3, 2, 24), (1, 1, 4)])
def test_grouped_int8_conv_is_exact(k, s, g):
    """A grouped int8 conv (GhostConv's depth-wise 5x5, DWConv's stride-2 3x3, a 4-group 1x1) equals an f64 grouped
    conv of the same codes exactly, 'same' padded as the ConvBNAct pads it."""
    rng = np.random.default_rng(k * 10 + g)
    cin = cout = 48 if g != 16 else 16
    x = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    got = PQ.int8_conv(torch.from_numpy(x), PQ.weight_matrix(w, "cpu", g), k, s, cout, k // 2, g)
    xt = torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w.astype(np.float64).transpose(3, 2, 0, 1))
    want = torch.nn.functional.conv2d(xt, wt, stride=s, padding=k // 2, groups=g).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))


@pytest.mark.parametrize("name", ["yolov8n-ghost.yaml", "yolov5n.yaml"])
def test_variant_int8_predict_matches_jax(name, two_threads):
    """The quantized fused tree (JAX's `quantize_params`, bit for bit in both packages: GhostConv's depth-wise and
    DWConv's grouped weights, yolov5's padded stem) through `predict` with dynamic activation scales in f32 on one
    64² image: within 1e-2 of the largest output of JAX's (a dynamic int8 code may flip where an f32 SiLU lands on
    a rounding edge); the model walks int8."""
    jm, pm, _ = _models(name)
    jf = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(0)))
    jq = jax_quantize_params(jf)
    pq = PQ.quantize_params(PT.fuse(pm.init(0)))
    want_t, got_t = _flat(jq), _flat(pq)
    assert list(got_t) == list(want_t) and any("w_int8" in k for k in got_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    PT.params_from_jax(pm, pq)
    assert pm.int8 and any(m.q is not None and m.g > 1 for m in pm.modules() if isinstance(m, PM.ConvBNAct)) == ("ghost" in name)
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    w = np.asarray(jax.jit(jm.predict)(jq, jnp.asarray(x)))
    g = pm.predict(torch.from_numpy(x), neck_opt=False).numpy()
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * np.abs(w).max())


@pytest.mark.parametrize("name, size", [("yolov8n-ghost-p2.yaml", 64), ("yolov8n-p6.yaml", 256)])
def test_variant_train_step_matches_jax(name, size, two_threads):
    """One train step at nc = 3 from init(0) on two seeded images with `_random_case`'s targets (64², the p6 model
    256²: at 64² its stride-64 level is 1x1, and the BN variance of two values loses its digits to cancellation in
    either package): JAX's value_and_grad of forward_features + v8DetectionLoss against the port's train forward and
    backward: the loss and its items 1e-4 relative, every BN's batch moments 1e-4 of their largest (at least 1) with
    the same count, every gradient 1e-3 of its tensor's largest, and at least 1e-6 (GhostBottleneck's last BN reaches
    the loss only through C3's linear cv3 into a training-mode BN, which takes every constant away: its bias has a zero
    gradient, rounding noise of ~1e-7 in both packages); the frozen leaves get none in either package."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
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


@pytest.mark.parametrize("name, hw", [("yolov8n-p6.yaml", (256, 256)), ("yolov8n-ghost-p2.yaml", (128, 160))])
def test_calibrated_kernel_inputs_are_live(name, hw, two_threads):
    """chip_smoke's kernel holds at the variant shapes, on the CPU's plain twins and one seeded noise image: through the
    init(0) tree the deepest kernel inputs fade so far that no output of their twin depends on them beyond 10x TOL
    (`live_share` 0: a hold there cannot fail); with the BN moments taken from the input (`bn_calibrated`) every C2f
    and Detect instance's share is at least LIVE_SHARE (0.94-1.0 here)."""
    import chip_smoke
    from yolo_tpu_torch.ops import cuda_c2f, cuda_head

    plain = {"c2f": cuda_c2f.c2f_plain, "c2f_upconcat": cuda_c2f.c2f_upconcat_plain, "head_level": cuda_head.head_level_plain}
    m = PT.DetectionModel(name, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, *hw, 3)).astype(np.float32))

    def shares(tree):
        PT.params_from_jax(m, tree, torch.float32)
        rec, _, _ = chip_smoke.capture_instances(m, x)
        assert {n for n, _ in rec} == ({"head_level"} if "ghost" in name else {"c2f", "head_level"})
        return [chip_smoke.live_share(n, plain[n], a, plain[n](*a)) for n, a in rec]

    assert min(shares(m.init(0))) == 0.0
    assert min(shares(chip_smoke.bn_calibrated(m, m.init(0), x))) >= chip_smoke.LIVE_SHARE


def test_zero_grad_leaves_are_rounding_noise():
    """chip_smoke.zero_grad_leaves, the BN biases of yolov8n-ghost-p2 whose gradient is zero by construction, on one
    train step (nc 3, two seeded 320² images, `_random_case`'s targets) on the CPU: each is within 1e-5 of the largest
    gradient of its BN's weight, and so is its change between 1 and 6 intra-op threads (1.7-4.7e-7 of it here), which
    is what `train_step_f32_phase` holds card against CPU; every other BN bias's gradient that reaches the loss is above
    1e-5 of its weight's."""
    import chip_smoke

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 320, 320, 3)).astype(np.float32))
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": torch.from_numpy(cls), "bboxes": torch.from_numpy(boxes), "mask_gt": torch.from_numpy(mask)}
    n_threads, grads = torch.get_num_threads(), []
    try:
        for threads in (1, 6):
            torch.set_num_threads(threads)
            pm = PT.DetectionModel("yolov8n-ghost-p2.yaml", nc=3, device="cpu")
            PT.load_train_params(pm, pm.init(0))
            pm.train()
            total, _ = v8DetectionLoss(pm, HYP)(pm.forward_features(x), batch)
            total.backward()
            grads.append({k: t.grad.detach().clone() for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)})
    finally:
        torch.set_num_threads(n_threads)
    one, six = grads
    zero = chip_smoke.zero_grad_leaves(pm)
    assert len(zero) == 12
    for k in (k for k in six if k.endswith("/bn/bias")):
        scale = float(six[k[: -len("bias")] + "weight"].abs().max())
        if scale == 0 and k not in zero:  # a Detect branch of a level that no target reaches: no gradient at all
            continue
        if k in zero:
            assert float(six[k].abs().max()) <= 1e-5 * scale, k
            assert float((one[k] - six[k]).abs().max()) <= 1e-5 * scale, k
        else:
            assert float(six[k].abs().max()) > 1e-5 * scale, k


@pytest.mark.parametrize("name, hw", [("yolov8n-ghost-p2.yaml", (64, 96)), ("yolov8n-p6.yaml", (128, 128))])
def test_variant_fused_detect_track_matches_jax(name, hw):
    """FusedDetectTrack with the variant's fused init(0) tree (f32, 16 frames in chunks of 8, a bright square in
    each): JAX's tracks, ids and stats exactly, boxes, confidences and velocities 1e-3 (1e-4 relative), with
    detections present; the JAX pipeline takes any DetectionModel through `predict_parts`, and so does the port's."""
    jm = JT.DetectionModel(name)
    jp = jm.fuse(jm.init(0))
    clip = np.random.default_rng(2).integers(0, 255, (16, *hw, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=hw, chunk=8, conf=1e-4, n_max=8, d_max=4)
    want_outs, want_stats = JaxFusedDetectTrack(jm, jp, dtype=jnp.float32, **kw).run_clip(clip)
    ft = FusedDetectTrack(PT.DetectionModel(name, device="cpu"), jax.tree_util.tree_map(np.asarray, jp), dtype=torch.float32,
                          device="cpu", **kw)
    got_outs, got_stats = ft.run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)
