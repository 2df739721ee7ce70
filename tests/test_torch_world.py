"""YOLO-World in the port against the JAX package on the CPU: MaxSigmoidAttnBlock, C2fAttn, ImagePoolingAttn (odd
maps), ContrastiveHead, BNContrastiveHead and WorldDetect through each module's initial tree, BN fold and both forms;
both World yamls' trees, folds (JAX leaves a BNContrastiveHead's `norm` and a MaxSigmoidAttnBlock's `ec` unfolded, as
the port does) and predicts; the predictor, the validator's metrics and the tracker of yolov8n-world; one train step
of yolov8n-worldv2 and of yolov8n-world (`train_step_against_jax`, which the YOLOE tests share); the close-set
fine-tune's prompts; the .npz round trip with the placeholder prompts.

Tolerances, stated again at each test: trees exact; module outputs 1e-4 of their largest |value|, BN moments 1e-5
of their largest; f32 predict at 64² within 1e-3 px for boxes and 1e-5 for scores; metrics 1e-4; a train step's loss
and items 1e-4 relative, in f64 every gradient 1e-3 of its largest and the BN moments 1e-4, in f32 the gradient's
cosine above 0.999."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine import validator as JV
from yolo_tpu.engine.model import YOLOWorld as JaxYOLOWorld
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.utils.loss import v8DetectionLoss as JaxLoss
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import open_vocab as OV
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.utils.loss import v8DetectionLoss

from tests.test_loss import _random_case
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v8_variants import _flat, _load_train, _random_bn
from tests.test_torch_yolo11_12 import _paired
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)

TOL = 1e-4  # a module's output, of its largest |value|
PX, SCORE = 1e-3, 1e-5
GC = 64  # the guide's width in the module cases (the models' is 512)
HYP = type("Hyp", (), dict(box=7.5, cls=0.5, dfl=1.5))


# --- (a) the modules ------------------------------------------------------------------------------------------


def _maps(rng, *shapes):
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


MODULE_CASES = [  # (id, the module from either package's namespace, its inputs: (arg, guide) from a Generator)
    ("MaxSigmoidAttnBlock-ec", lambda M: M.MaxSigmoidAttnBlock(16, 32, nh=2, ec=32, gc=GC),
     lambda r: (_maps(r, (2, 5, 7, 16))[0], _maps(r, (2, 4, GC))[0])),
    ("MaxSigmoidAttnBlock-scale", lambda M: M.MaxSigmoidAttnBlock(32, 32, nh=4, ec=32, gc=GC, scale=True),
     lambda r: (_maps(r, (2, 6, 6, 32))[0], _maps(r, (2, 3, GC))[0])),
    ("C2fAttn", lambda M: M.C2fAttn(16, 32, 2, ec=16, nh=2, gc=GC), lambda r: (_maps(r, (2, 7, 9, 16))[0], _maps(r, (2, 3, GC))[0])),
    ("C2fAttn-shortcut", lambda M: M.C2fAttn(24, 32, 1, ec=16, nh=1, gc=GC, shortcut=True),
     lambda r: (_maps(r, (2, 6, 5, 24))[0], _maps(r, (2, 2, GC))[0])),
    ("ImagePoolingAttn-odd", lambda M: M.ImagePoolingAttn(32, (16, 24), ct=GC, nh=4),
     lambda r: (_maps(r, (2, 5, 7, 16), (2, 20, 20, 24)), _maps(r, (2, 3, GC))[0])),
    ("ImagePoolingAttn-scale", lambda M: M.ImagePoolingAttn(32, (16, 24, 8), ct=GC, nh=2, scale=True),
     lambda r: (_maps(r, (2, 9, 11, 16), (2, 5, 6, 24), (2, 3, 3, 8)), _maps(r, (2, 5, GC))[0])),
    ("ContrastiveHead", lambda M: M.ContrastiveHead(), lambda r: tuple(_maps(r, (2, 5, 7, GC), (2, 3, GC)))),
    ("BNContrastiveHead", lambda M: M.BNContrastiveHead(GC), lambda r: tuple(_maps(r, (2, 5, 7, GC), (2, 3, GC)))),
    ("WorldDetect", lambda M: M.WorldDetect(3, GC, False, (16, 32)), lambda r: (_maps(r, (2, 8, 9, 16), (2, 4, 5, 32)), _maps(r, (2, 3, GC))[0])),
    ("WorldDetect-bn", lambda M: M.WorldDetect(3, GC, True, (16, 32)), lambda r: (_maps(r, (2, 8, 9, 16), (2, 4, 5, 32)), _maps(r, (2, 3, GC))[0])),
]


def _awake(tree, rng):
    """The tree with random BN moments (ConvBNActs' `bn` and the contrastive heads' `norm`), the MaxSigmoidAttnBlock and
    contrastive biases moved off their init, and an ImagePoolingAttn scale of 0.5: nothing of it the identity."""
    tree = _random_bn(tree, rng)

    def walk(t):
        if not isinstance(t, dict):
            return t
        out = {k: walk(v) for k, v in t.items()}
        if "norm" in t:
            c = np.asarray(t["norm"]["weight"]).shape[0]
            out["norm"] = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c), "running_mean": rng.normal(0, 0.3, c),
                           "running_var": rng.uniform(0.5, 2.0, c)}
            out["norm"] = {k: v.astype(np.float32) for k, v in out["norm"].items()}
        if "logit_scale" in t:
            out["bias"] = np.asarray(t["bias"]) + np.float32(10.0)
        if "gl" in t:
            out["bias"] = rng.normal(0, 0.5, np.shape(t["bias"])).astype(np.float32)
        if "projections" in t and "scale" in t:
            out["scale"] = np.full_like(t["scale"], 0.5)
        return out

    return walk(tree)


def _jax_run(jm, tree, arg, guide, train):
    """A JAX module's forward with the guide in its Ctx → (output, the Ctx's BN batch moments), under one jit."""
    def run(tree, arg, guide):
        ctx = JM.Ctx(train=train, dtype=jnp.float32, guide=guide, guide0=guide)
        out = jm(tree, arg, guide, ctx) if isinstance(jm, JM.ContrastiveHead | JM.BNContrastiveHead) else jm(tree, arg, ctx)
        return out, ctx.stats

    return jax.jit(run)(tree, arg, guide)


def _port_run(pm, arg, guide, train):
    arg = [torch.from_numpy(a) for a in arg] if isinstance(arg, list) else torch.from_numpy(arg)
    guide = torch.from_numpy(guide)
    if isinstance(pm, OV.WorldDetect):
        return pm.forward_train(arg, guide) if train else pm(arg, guide)
    return pm.run(arg, guide, train)


def _close(got, want, tol=TOL):
    got = np.concatenate([np.asarray(g).reshape(-1) for g in got]) if isinstance(got, list) else np.asarray(got)
    want = np.concatenate([np.asarray(w).reshape(-1) for w in want]) if isinstance(want, list) else np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(case, form, two_threads):
    """Each module against JAX's on N(0, 1) inputs and guides: the initial subtree bit for bit; the train form (BN on
    the batch's moments; a BNContrastiveHead's moments 1e-5 of their largest with the same count) and the fused form
    (the BN fold bit for bit in both packages, so a BNContrastiveHead's `norm` and a MaxSigmoidAttnBlock's `ec` stay
    unfolded) within 1e-4 of the largest output, on a tree whose BN moments and biases are drawn at random."""
    _, build, inputs = case
    jm, pm = build(JM), build(OV)
    tree = jm.init(np.random.default_rng(0))
    _same_tree(pm.init(np.random.default_rng(0)), tree)
    rng = np.random.default_rng(1)
    tree = _awake(jax.tree_util.tree_map(np.asarray, tree), rng)
    arg, guide = inputs(rng)
    if form == "train":
        want, stats = _jax_run(jm, tree, arg, guide, True)
        _load_train(pm, tree)
        pm.train()
        got = _port_run(pm, arg, guide, True)
        if isinstance(pm, OV.BNContrastiveHead):
            m, v, n = stats["/norm"]
            assert pm.batch_stats[2] == n
            np.testing.assert_allclose(pm.batch_stats[0].numpy(), m, rtol=0, atol=1e-5 * np.abs(m).max())
            np.testing.assert_allclose(pm.batch_stats[1].numpy(), v, rtol=0, atol=1e-5 * np.abs(v).max())
    else:
        fused = JT._fuse_module(jm, tree)
        _same_tree(PT.fuse(tree), jax.tree_util.tree_map(np.asarray, fused))
        want, _ = _jax_run(jm, fused, arg, guide, False)
        pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
        got = _port_run(pm, arg, guide, False)
    got = [g.detach() for g in got] if isinstance(got, list) else got.detach()
    _close([g.numpy() for g in got] if isinstance(got, list) else got.numpy(), want)


@pytest.mark.parametrize("hw", [(5, 7), (20, 20), (3, 3), (2, 7)], ids=["5x7", "20x20", "3x3", "2x7"])
def test_adaptive_pool_bins_match_jax(hw, two_threads):
    """`F.adaptive_max_pool2d` (ImagePoolingAttn's 3 x 3 bins) gives JAX's floor/ceil slices exactly, odd maps and a
    map narrower than its bins included."""
    x = np.random.default_rng(3).normal(0, 1, (2, *hw, 5)).astype(np.float32)
    want = np.asarray(JM._adaptive_max_pool(jnp.asarray(x), 3))
    got = torch.nn.functional.adaptive_max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


# --- (b) the two yamls -----------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolov8s-world.yaml", "yolov8s-worldv2.yaml"])
def test_yaml_tree_fuse_and_predict_match_jax(name, two_threads):
    """At the published s width: `init(0)` leaf for leaf and bit for bit, the placeholder prompts (the JAX package's
    default_rng(0) draw), the BN fold bit for bit (a BNContrastiveHead's `norm` stays, World v1's ContrastiveHead has
    none), the layer list (C2fAttn rows, World v1's ImagePoolingAttn) and the strides; the backbone's C2f blocks are the
    kernel's instances and no C2fAttn is; then the f32 predict of an awake tree on two seeded 64² images and five
    random text embeddings against JAX's `WorldModel.predict`: boxes 1e-3 px, scores 1e-5."""
    jm, pm = JT.WorldModel(name), PT.WorldModel(name, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    _same_tree(pm.init(0), jp)
    np.testing.assert_array_equal(pm.txt_feats, jm.txt_feats)
    jf = jax.tree_util.tree_map(np.asarray, jm.fuse(jp))
    _same_tree(PT.fuse(jp), jf)
    assert any("norm" in k for k in _flat(jf)) == name.endswith("v2.yaml")
    assert [type(m).__name__ for m in pm.layers].count("C2fAttn") == 4
    assert ("ImagePoolingAttn" in [type(m).__name__ for m in pm.layers]) == (name == "yolov8s-world.yaml")
    assert pm.stride == list(jm.stride) == [8, 16, 32] and len(pm.c2f_instances(640, 640)) == 4 and not pm._upconcat
    tree = _awake(jp, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    x, txt = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32), rng.normal(0, 1, (1, 5, 512)).astype(np.float32)
    jm.set_text_features(txt)
    pm.set_text_features(txt)
    want = np.asarray(jax.jit(jm.predict)(jm.fuse(tree), jnp.asarray(x)))
    PT.params_from_jax(pm, PT.fuse(tree))
    got = pm.predict(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 9, 84) and pm.nc == pm.head.nc == 5 and np.ptp(want[:, 4:]) > 0.1
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=PX)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0, atol=SCORE)
    b, s = pm.predict_parts(torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat([b, s], -1).transpose(1, 2).numpy(), got, rtol=0, atol=1e-6)


# --- (c) predictor, validator, tracker --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """(JAX YOLOWorld, port YOLOWorld) of yolov8n-world holding one awake tree (its contrastive biases at 0: scores
    about 0.3-0.7; the box branches' last convs zeroed but for bins 1 and 2: boxes of about three
    strides about each anchor, not the whole frame), with one random text embedding (the tiny dataset's one class)."""
    jy, py = JaxYOLOWorld("yolov8n-world.yaml"), yolo_tpu_torch.YOLOWorld("yolov8n-world.yaml", device="cpu")
    tree = _awake(jax.tree_util.tree_map(np.asarray, jy.params), np.random.default_rng(4))
    for l in range(3):
        box = tree["model"]["23"]["cv2"][str(l)]["2"]
        box["weight"], box["bias"] = box["weight"] * 0.0, np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
    txt = np.random.default_rng(5).normal(0, 1, (1, 1, 512)).astype(np.float32)
    for y in (jy, py):
        y.params = tree
        y.set_text_features(txt, names=["target"])
    return jy, py


def _frames(n=3):
    rng = np.random.default_rng(6)
    return [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(n)]


def test_predict_and_track_match_jax(world, two_threads):
    """`YOLOWorld.predict` (f32, conf 0.2, one class) on three seeded 64² frames: JAX's rows, paired by box, within
    1e-3 px and 1e-5 in score, the same count; then `track` (ByteTrack, persist) frame by frame: the same boxes and the
    same ids as JAX's tracker."""
    jy, py = world
    for frame in _frames():
        j = jy.predict(frame, imgsz=64, conf=0.2, compute_dtype="float32", verbose=False)[0]
        p = py.predict(frame, imgsz=64, conf=0.2, compute_dtype="float32", verbose=False)[0]
        wb = np.asarray(j.boxes.xyxy)
        assert len(wb) and len(p.boxes.xyxy) == len(wb)
        o = _paired(p.boxes.xyxy, wb, p.boxes.cls, np.asarray(j.boxes.cls))
        np.testing.assert_allclose(p.boxes.xyxy[o], wb, rtol=0, atol=PX)
        np.testing.assert_allclose(p.boxes.conf[o], np.asarray(j.boxes.conf), rtol=0, atol=SCORE)
    jy.predictor = py.predictor = None
    for frame in _frames():
        j = jy.track(frame, imgsz=64, conf=0.2, compute_dtype="float32", persist=True, tracker="bytetrack.yaml", verbose=False)[0]
        p = py.track(frame, imgsz=64, conf=0.2, compute_dtype="float32", persist=True, tracker="bytetrack.yaml", verbose=False)[0]
        wb = np.asarray(j.boxes.xyxy)
        assert len(p.boxes.xyxy) == len(wb) and len(wb)
        o = _paired(p.boxes.xyxy, wb, p.boxes.cls, np.asarray(j.boxes.cls))
        np.testing.assert_allclose(p.boxes.xyxy[o], wb, rtol=0, atol=PX)
        np.testing.assert_array_equal(np.asarray(p.boxes.id)[o], np.asarray(j.boxes.id))
    jy.predictor = py.predictor = None


def test_val_matches_jax(world, tiny_dataset, two_threads):
    """`YOLOWorld.val` (f32, imgsz 64, conf 0.001) on the 8-image fixture: JAX's validator's precision, recall, mAP50,
    mAP50-95 and fitness within 1e-4, the same confusion matrix (its background column counting the untrained boxes)."""
    jy, py = world
    jv = JV.DetectionValidator(args={**jy.overrides, "data": tiny_dataset, "imgsz": 64, "plots": False, "mode": "val"})
    want = jv(model=jy.model, params=jy.params)
    got = py.val(data=tiny_dataset, imgsz=64, plots=False)
    assert jv.confusion_matrix.matrix.sum() > 0
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    np.testing.assert_array_equal(py.validator.confusion_matrix.matrix, jv.confusion_matrix.matrix)


# --- (d) training, checkpoints -----------------------------------------------------------------------------------


class _WideJnp(types.ModuleType):
    """`jax.numpy` with `float32` read as `float64`: set as the `jnp` of JAX's modules, it widens the casts that pin
    f32 (the attention's and the contrastive heads' products, the BN moments, the loss) for a true f64 step."""

    def __init__(self):
        super().__init__("jax.numpy")

    def __getattr__(self, key):
        return jnp.float64 if key == "float32" else getattr(jnp, key)


def train_step_against_jax(jm, make_port, jp, null, monkeypatch) -> None:
    """One train step at nc 3 on two seeded 64² images with `_random_case`'s targets: JAX's value_and_grad of
    `jm.forward_features` (its prompts installed) + v8DetectionLoss from the tree `jp` against the train forward and
    backward of `make_port(dtype)`, the port's model of the same yaml with the same prompts and `jp` loaded. In f64 on
    both sides (JAX's modules read a `jnp` whose float32 is float64; the port's `.float()` leaves an f64 tensor as it
    is): the loss and its items 1e-4 relative; every BN's batch moments (the ConvBNActs' and the BNContrastiveHeads'
    `norm`) 1e-4 of their largest (at least 1) with the same count; the port's trained leaves exactly JAX's but the BN
    running moments and the DFL's fixed bins (JAX's gradient 0 there), none without a gradient but those under the path
    prefixes `null` (a leaf outside the train forward has none); every gradient within 1e-3 of its own largest (at
    least 1e-16 of the largest of all); and the leaves whose gradient is 0 (at most 1e-16 of the largest of all, where
    f64's rounding leaves an exact zero) exactly those under `null`. In f32, over the other leaves: the loss and its items 1e-4 relative, and the
    gradient's direction (each leaf scaled by its largest, cosine > 0.999)."""
    from yolo_tpu.utils import loss as JL, tal as JTAL

    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": cls, "bboxes": boxes * 2, "mask_gt": mask}
    hi = str(len(jm.layers) - 1)

    def jax_step(dtype):
        def forward_loss(params):
            ctx = JM.Ctx(train=True, dtype=dtype)
            out = jm.forward_features(params, jnp.asarray(x, dtype), ctx)
            total, comps = JaxLoss(jm, HYP)(out, {k: jnp.asarray(v) for k, v in batch.items()})
            return total, (comps, ctx.stats)

        tree = jax.tree.map(lambda a: np.asarray(a, dtype), jp)
        (total, (comps, stats)), grads = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(tree)
        flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(grads)}
        return float(total), np.asarray(comps), jax.tree.map(np.asarray, stats), flat

    def port_step(dtype):
        pm = make_port(dtype)
        pm.train()
        out = pm.forward_features(torch.from_numpy(x).to(dtype))
        total, comps = v8DetectionLoss(pm, HYP)(out, {k: torch.from_numpy(v) for k, v in batch.items()})
        total.backward()
        params = {k: t for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)}
        grads = {}
        for k, t in params.items():
            assert t.grad is not None or k.startswith(null), f"{k}: no gradient"  # only a leaf outside the forward has none
            g = PT.tree_from_leaves(pm, {k: torch.zeros_like(t) if t.grad is None else t.grad})
            for part in k.split("/"):
                g = g[part]
            grads[k] = np.asarray(g)
        return pm, float(total.detach()), comps.detach().numpy(), grads

    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (JM, JT, JL, JTAL):
            mp.setattr(mod, "jnp", _WideJnp())
        narrow = torch.Tensor.float
        mp.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64 else narrow(t, *a, **k))
        jt, jcomps, jstats, flat = jax_step(jnp.float64)
        pm, total, comps, grads = port_step(torch.float64)
    assert all(v.dtype == np.float64 for v in flat.values()) and all(v.dtype == np.float64 for v in grads.values())
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    bns = {"/".join(["model", *n.split(".")[1:]]) + "/bn": m for n, m in pm.named_modules()
           if isinstance(m, PM.ConvBNAct) and m.batch_stats is not None}
    bns |= {f"model/{hi}/cv4/{l}/norm": m for l, m in enumerate(pm.head.cv4) if isinstance(m, OV.BNContrastiveHead)}
    assert set(bns) == set(jstats), sorted(set(bns) ^ set(jstats))[:10]
    for key, m in bns.items():
        mean, var, n = jstats[key]
        assert m.batch_stats[2] == n, key
        for got, want in zip(m.batch_stats[:2], (mean, var)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1.0), err_msg=key)
    trained = {k for k in flat if not k.endswith(("running_mean", "running_var", "dfl/conv/weight"))}  # DFL's fixed bins
    assert set(grads) == trained, sorted(set(grads) ^ trained)[:10]
    top = max(np.abs(v).max() for v in flat.values())
    for k in sorted(grads):
        np.testing.assert_allclose(grads[k], flat[k], rtol=0, atol=max(1e-3 * np.abs(flat[k]).max(), 1e-16 * top), err_msg=k)
    for k in set(flat) - trained:
        assert not np.abs(flat[k]).any(), k
    zeros = {k for k in trained if np.abs(flat[k]).max() <= 1e-16 * top}  # f64 rounding lands at 1e-17-1e-21 of it
    nulls = {k for k in trained if k.startswith(null)}
    assert zeros == nulls, (sorted(zeros - nulls), sorted(nulls - zeros))

    jt, jcomps, _, flat = jax_step(jnp.float32)
    _, total, comps, grads = port_step(torch.float32)
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    keys = sorted(set(grads) - nulls)
    scale = {k: np.abs(flat[k]).max() for k in keys}
    g = np.concatenate([np.ravel(grads[k]) / scale[k] for k in keys])
    w = np.concatenate([np.ravel(flat[k]) / scale[k] for k in keys])
    assert float(g @ w / np.linalg.norm(g) / np.linalg.norm(w)) > 0.999


@pytest.mark.parametrize("name", ["yolov8n-worldv2.yaml", "yolov8n-world.yaml"])
def test_train_step_matches_jax(name, two_threads, monkeypatch):
    """`train_step_against_jax` on World v2 (BNContrastiveHeads) and World v1 (ContrastiveHeads and an
    ImagePoolingAttn, whose refreshed guide reaches the later C2fAttns), each from init(0) with its contrastive biases
    at -4 and three random text embeddings: the loss and its items 1e-4 relative, the BN moments 1e-4, every gradient
    1e-3 of its largest in f64, the f32 gradient's direction above 0.999. The leaves whose gradient is 0 are those that
    must be: v2's embed-conv biases before a train-mode BN, and v1's key biases (a shift of every key, which the
    softmax ignores)."""
    txt = np.random.default_rng(8).normal(0, 1, (1, 3, 512)).astype(np.float32)
    jm = JT.WorldModel(name, nc=3)
    jm.set_text_features(txt)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    hi = str(len(jm.layers) - 1)
    for l in range(3):
        jp["model"][hi]["cv4"][str(l)]["bias"] = np.array([-4.0], np.float32)
    pool = [k for k, m in enumerate(jm.layers) if isinstance(m.module, JM.ImagePoolingAttn)]
    null = (tuple(f"model/{hi}/cv3/{l}/2/bias" for l in range(3)) if not pool else
            (f"model/{pool[0]}/key/0/bias", f"model/{pool[0]}/key/1/bias"))

    def make_port(dtype):
        pm = PT.WorldModel(name, nc=3, device="cpu").to(dtype)
        pm.set_text_features(txt)
        return PT.load_train_params(pm, jp)

    train_step_against_jax(jm, make_port, jp, null, monkeypatch)


def test_finetune_embeds_the_names_and_checkpoints_cross(tiny_dataset, tmp_path, two_threads):
    """A close-set fine-tune (`YOLOWorld.train`, one epoch at 64², f32, no validation) ends with the data's one class
    named and its prompt the port's seeded text tower's embedding of the name; the .npz it writes loads in JAX, and in
    the port, as a WorldModel whose prompts are the placeholder draw (no checkpoint holds prompts), at nc 1, the tree
    bit for bit. A .npz that JAX writes loads in the port likewise."""
    from yolo_tpu_torch.nn.text_model import build_text_model

    py = yolo_tpu_torch.YOLOWorld("yolov8n-worldv2.yaml", device="cpu")
    py.train(data=tiny_dataset, epochs=1, imgsz=64, batch=4, workers=0, amp=False, plots=False, val=False,
             project=str(tmp_path), name="w")
    assert py.model.nc == 1 and py.model.names == {0: "target"}
    np.testing.assert_allclose(py.model.txt_feats[0], build_text_model(device="cpu").encode_text(["target"]).numpy(), rtol=0, atol=1e-6)
    last = tmp_path / "w" / "weights" / "last.npz"
    for y in (yolo_tpu.YOLO(str(last)), yolo_tpu_torch.YOLO(str(last), device="cpu")):
        assert type(y.model).__name__ == "WorldModel" and y.model.nc == 1
        np.testing.assert_array_equal(y.model.txt_feats, np.random.default_rng(0).normal(0, 1, (1, 1, 512)).astype(np.float32))
        _same_tree(y.params, yolo_tpu_torch.YOLO(str(last), device="cpu").params)
    jy = JaxYOLOWorld("yolov8n-world.yaml")
    loaded = yolo_tpu_torch.YOLO(str(jy.save(str(tmp_path / "jax.npz"))), device="cpu")
    assert type(loaded.model) is PT.WorldModel and loaded.task == "detect"
    _same_tree(loaded.params, jax.tree_util.tree_map(np.asarray, jy.params))
    np.testing.assert_array_equal(loaded.model.txt_feats, jy.model.txt_feats)


def test_remat_and_calibration_take_the_prompts(two_threads):
    """The text embeddings ride the checkpoints: yolov8n-world's train forward under `remat` (every C2fAttn a
    torch.utils.checkpoint with the guide one of its inputs; ImagePoolingAttn and the head outside) gives the outputs and
    the gradients of the plain train forward, the guide's gradient included; the int8 calibration walk
    (`calibrate_act_scales`) takes the model's prompts and records every C2fAttn conv's input."""
    from yolo_tpu_torch.nn.quantize import calibrate_act_scales

    pm = PT.WorldModel("yolov8n-world.yaml", device="cpu")
    tree = _awake(jax.tree_util.tree_map(np.asarray, pm.init(0)), np.random.default_rng(12))
    PT.load_train_params(pm, tree)
    pm.train()
    x = torch.from_numpy(np.random.default_rng(13).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    runs = []
    for remat in (False, True):
        for p in pm.parameters():
            p.grad = None
        guide = torch.from_numpy(pm.txt_feats.copy()).expand(2, -1, -1).clone().requires_grad_(True)
        outs = PT.BaseModel.forward_features(pm, x, remat=remat, guide=guide)
        sum((o.float() ** 2).mean() for o in outs).backward()
        runs.append(([o.detach() for o in outs], guide.grad.clone(), [p.grad.clone() for p in pm.parameters() if p.grad is not None]))
    (o0, g0, p0), (o1, g1, p1) = runs
    assert len(p0) == len(p1) > 100 and g0.abs().max() > 0
    for a, b in zip(o0 + [g0] + p0, o1 + [g1] + p1):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    scales = calibrate_act_scales(pm, PT.fuse(tree), x.numpy(), dtype=torch.float32)
    assert all(f"model/{i}/attn/proj_conv" in scales for i in (12, 15, 19, 22))
