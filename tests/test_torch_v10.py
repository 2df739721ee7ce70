"""The yolov10 family of the port against the JAX package's on the CPU: SCDown, RepVGGDW, CIB, C2fCIB, PSA and the
end-to-end v10Detect head through each module's initial tree, BN fold and both forms in f32 and bf16; the six yamls'
trees, fuse (which leaves CIB's and PSA's `ffn` BN as JAX's does) and f32 predict; the head's two-stage top-k and its
tie order; the end-to-end predictor and validator (no NMS: JAX's rows and the Ultralytics reference's filter, written
here in numpy, with JAX's metric functions); one E2EDetectLoss train step; the checkpoints both ways; the refusals;
and the JAX fault the port does not copy (JAX's predictor runs NMS over the head's final rows).

Tolerances, the v3 / v6 / v9 / NAS file's (tests/test_torch_v3_v6_v9_nas.py), stated again at each test: trees exact;
module outputs 1e-4 (f32) and 2e-2 (bf16) of their largest, BN moments 1e-5 and 1e-2; f32 predict rows at 64² within
1e-3 px for boxes and 1e-5 for scores, classes exact; metrics 1e-4; train-step losses and items 1e-4 relative,
gradients 1e-3 of their tensor's largest (at least 1e-6) in f64 on both sides, the f32 step's gradient direction
(cosine > 0.999). The m / b / l / x predictions run at a quarter of their published width (a copy of the yaml dict
that both packages parse; their trees and folds are held at full width) to keep the file's time in budget."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine import validator as JV
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.utils.loss import E2EDetectLoss as JaxE2ELoss
from yolo_tpu_torch import FusedDetectTrack
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.ops import cuda_c2f
from yolo_tpu_torch.ops.nms import end2end_select
from yolo_tpu_torch.utils.loss import E2EDetectLoss

from tests.test_loss import _random_case
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v8_variants import _flat, _jax_forward, _load_train, _random_bn
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)
from tests.test_torch_yolo11_12 import _paired

FAMILY = [f"yolov10{s}.yaml" for s in "nsmblx"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-2)}
HYP = type("Hyp", (), dict(box=7.5, cls=0.5, dfl=1.5))
PX, SCORE = 1e-3, 1e-5


# --- (a) the modules ------------------------------------------------------------------------------------------


MODULE_CASES = [  # (id, the module from either package's namespace, input channels, input H x W)
    ("SCDown", lambda M: M.SCDown(16, 32, 3, 2), 16, (13, 14)),
    ("RepVGGDW", lambda M: M.RepVGGDW(32), 32, (13, 14)),
    ("CIB", lambda M: M.CIB(32, 32, True, 1.0, False), 32, (13, 14)),
    ("CIB-lk", lambda M: M.CIB(32, 32, True, 1.0, True), 32, (13, 14)),
    ("CIB-wider", lambda M: M.CIB(16, 32, True, 0.5, False), 16, (13, 14)),  # c1 != c2: no residual
    ("C2fCIB", lambda M: M.C2fCIB(32, 64, 2, True, False), 32, (13, 14)),
    ("C2fCIB-lk", lambda M: M.C2fCIB(32, 64, 1, True, True), 32, (13, 14)),
    ("PSA", lambda M: M.PSA(128, 128), 128, (8, 9)),
]


def _run(m, tree, x, form, dtype=jnp.float32):
    if isinstance(m, torch.nn.Module):
        out = m.forward_train(x) if form == "train" else m(x)
        return out.detach().float().numpy()
    out, ctx = _jax_forward(m, tree, jnp.asarray(x, dtype), form == "train", dtype)
    return np.asarray(out.astype(jnp.float32)), ctx


def _close(got, want, tol, dtype):
    """Within `tol` of the largest |want| (at least that much absolute); in bf16 one element in a thousand may lie up to
    2.5 x that (a chain of bf16 roundings flips an element across an edge now and then, and the convs after it carry
    the step: C2fCIB's train form lands one of 23,296 elements 4 bf16 steps, 2.1%, from JAX's)."""
    err = np.abs(got - want)
    bound = tol * max(np.abs(want).max(), 1.0)
    if dtype == "bf16":
        assert (err > bound).mean() <= 1e-3 and (err <= 2.5 * bound).all(), f"{int((err > bound).sum())} beyond, max {err.max()}"
    else:
        assert (err <= bound).all(), f"{int((err > bound).sum())} of {err.size} beyond; max |err| {err.max()}"


def _in_dtype(pm, dtype):
    for m in pm.modules():
        m.compute_dtype = dtype
    return pm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(case, form, dtype, two_threads):
    """Each new module against JAX's on N(0, 1) NHWC input (2 x H x W), BN's γ, β and moments drawn at random: the
    initial subtree bit for bit and the fused one (the port's `fuse`) bit for bit against JAX's generic fold, which
    leaves every BN of a CIB (its convs sit under the key `cv1`, which names no module) and PSA's `ffn` unfused; the
    train form (BN on the batch's moments, which match JAX's within 1e-5 of their largest in f32 and 1e-2 in bf16, with
    the same count) and the fused form within 1e-4 of the largest output in f32 and 2e-2 in bf16 (at least that much
    absolute; in bf16 one element in a thousand up to 2.5 x that), the output spread (std > 0.1) so that a module
    that ignored its input would fail."""
    name, build, cin, hw = case
    jdt, pdt, tol, mtol = DTYPES[dtype]
    jm, pm = build(JM), build(PM)
    tree = jm.init(np.random.default_rng(0))
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, tree)), _flat(pm.init(np.random.default_rng(0)))
    assert list(got_t) == list(want_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    rng = np.random.default_rng(3)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    x = rng.normal(0, 1, (2, *hw, cin)).astype(np.float32)
    xt = torch.from_numpy(x).to(pdt)
    if form == "train":
        want, ctx = _run(jm, tree, x, "train", jdt)
        _load_train(pm, tree)
        pm.train()
        got = _run(pm, None, xt, "train")
        convs = {(f"/{n.replace('.', '/')}/bn" if n else "/bn"): m for n, m in pm.named_modules() if isinstance(m, PM.ConvBNAct)}
        assert set(convs) == set(ctx.stats)
        for key, m in convs.items():
            mean, var, n = ctx.stats[key]
            assert m.batch_stats[2] == n, key
            for g, w in zip(m.batch_stats[:2], (np.asarray(mean), np.asarray(var))):
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=mtol * max(np.abs(w).max(), 1.0), err_msg=key)
    else:
        jf = jax.tree_util.tree_map(np.asarray, JT._fuse_module(jm, tree))
        pf = PT.fuse(tree)
        want_f, got_f = _flat(jf), _flat(pf)
        assert list(got_f) == list(want_f)
        for k in want_f:
            np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)
        unfused = {k.split("['bn']")[0] for k in got_f if "['bn']" in k}
        assert bool(unfused) == (name.startswith(("CIB", "C2fCIB", "PSA")))  # CIB's convs and PSA's ffn keep BN
        want, _ = _run(jm, jf, x, "fused", jdt)
        pm.load_jax(pf, "cpu", pdt)
        got = _run(_in_dtype(pm, pdt), None, xt, "fused")
    assert got.shape == want.shape and want.std() > 0.1
    _close(got, want, tol, dtype)


def _head_case(nc=3, ch=(16, 32), seed=0):
    jm, pm = JM.v10Detect(nc, ch), PM.v10Detect(nc, ch)
    tree = jm.init(np.random.default_rng(seed))
    return jm, pm, tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_v10detect_branches_match_jax(dtype, two_threads):
    """v10Detect (nc 3, two levels of 16 and 32 channels): the initial tree bit for bit (Detect's draws and priors,
    then each level's one-to-one box and class convs, with their priors), the fold bit for bit; the train form gives
    (one-to-many, one-to-one) raw outputs within the module tolerances (1e-4 / 2e-2 of the largest), and the
    one-to-one branch reads detached inputs: its outputs' gradient reaches no input map (JAX's stop_gradient), the
    one-to-many's does."""
    jdt, pdt, tol, _ = DTYPES[dtype]
    jm, pm, tree = _head_case()
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, tree)), _flat(pm.init(np.random.default_rng(0)))
    assert list(got_t) == list(want_t) and all(np.array_equal(got_t[k], want_t[k]) for k in want_t)
    rng = np.random.default_rng(4)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    assert _flat(PT.fuse(tree)).keys() == _flat(jax.tree_util.tree_map(np.asarray, JT._fuse_module(jm, tree))).keys()
    xs = [rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32), rng.normal(0, 1, (2, 4, 4, 32)).astype(np.float32)]
    many, one = jm(tree, [jnp.asarray(x, jdt) for x in xs], JM.Ctx(train=True, dtype=jdt))
    _load_train(pm, tree)
    pm.train()
    xt = [torch.from_numpy(x).to(pdt).requires_grad_(True) for x in xs]
    gmany, gone = pm.forward_train(xt)
    for gs, ws in ((gmany, many), (gone, one)):
        for g, w in zip(gs, ws):
            w = np.asarray(w.astype(jnp.float32))
            assert w.std() > 0.1
            np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0, atol=tol * np.abs(w).max())
    sum(o.float().sum() for o in gone).backward()
    assert all(x.grad is None for x in xt)  # the one-to-one branch's inputs are detached
    sum(o.float().sum() for o in gmany).backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in xt)


def test_v10detect_decode_matches_jax(two_threads):
    """The fused head's inference (f32, nc 3, random BN, class biases 0, seeded input): JAX's (B, k, 6) rows, k = min(max_det, A) =
    80 here: xyxy boxes 1e-3 px, scores 1e-5, classes exact, rows in JAX's order (the two-stage top-k)."""
    jm, pm, tree = _head_case()
    rng = np.random.default_rng(6)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    for l in ("0", "1"):  # class logits near 0 (not the prior near -11): the scores spread and their order matters
        tree["one2one_cv3"][l]["2"]["bias"] = np.zeros_like(tree["one2one_cv3"][l]["2"]["bias"])
    xs = [rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32), rng.normal(0, 1, (2, 4, 4, 32)).astype(np.float32)]
    want = np.asarray(jm(JT._fuse_module(jm, tree), [jnp.asarray(x) for x in xs], JM.Ctx(train=False)))
    pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
    got = pm.decode_end2end([torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape == (2, 80, 6) and np.ptp(want[..., 4]) > 0.05
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=PX)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=SCORE)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])


def test_v10detect_ties_keep_the_earlier_index(two_threads):
    """Every class logit of the one-to-one branch equal (its last convs zero, biases equal): both stages of the top-k
    meet nothing but ties, and the earlier index wins each, as `jax.lax.top_k` orders them: row i is anchor i // nc,
    class i % nc, in JAX's rows and the port's alike."""
    jm, pm, tree = _head_case(nc=4)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    for l in ("0", "1"):
        tree["one2one_cv3"][l]["2"]["weight"] = np.zeros_like(tree["one2one_cv3"][l]["2"]["weight"])
        tree["one2one_cv3"][l]["2"]["bias"] = np.full_like(tree["one2one_cv3"][l]["2"]["bias"], 0.5)
    xs = [np.random.default_rng(2).normal(0, 1, (1, 8, 8, 16)).astype(np.float32),
          np.random.default_rng(3).normal(0, 1, (1, 4, 4, 32)).astype(np.float32)]
    want = np.asarray(jm(JT._fuse_module(jm, tree), [jnp.asarray(x) for x in xs], JM.Ctx(train=False)))
    pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
    got = pm.decode_end2end([torch.from_numpy(x) for x in xs]).numpy()
    i = np.arange(got.shape[1])
    np.testing.assert_array_equal(got[0, :, 5], i % 4)
    np.testing.assert_array_equal(want[0, :, 5], i % 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=PX)


# --- (b) the six yamls ----------------------------------------------------------------------------------------


def _quarter(name):
    """The yaml dict of `name` at a quarter of its width (m / b / l / x): the same graph and depth, narrower."""
    d = PT.yaml_model_load(name)
    scale = d["scale"] or next(iter(d["scales"]))
    depth, width, mc = d["scales"][scale]
    return {**d, "scale": scale, "scales": {scale: [depth, width / 4, mc]}}


@pytest.mark.parametrize("name", FAMILY)
def test_family_tree_fuse_and_predict_match_jax(name, two_threads):
    """`init(0)` leaf for leaf and bit for bit at the published width, the BN fold bit for bit (JAX's generic walk:
    each CIB's five convs and PSA's ffn keep their BN, every other group folds, `cv1` of C2f, SCDown and PSA
    included), the strides and the end-to-end head; then on a tree with random BN (at a quarter width for m / b / l /
    x) and the one-to-one class biases at 0, the f32 predict rows on one seeded 64² image against JAX's
    `DetectionModel.predict`: boxes 1e-3 px, scores 1e-5, classes exact."""
    jm, pm = JT.DetectionModel(name), PT.DetectionModel(name, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    pp = pm.init(0)
    want, got = _flat(jp), _flat(pp)
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want)
    jf, pf = jax.tree_util.tree_map(np.asarray, jm.fuse(jp)), PT.fuse(pp)
    want, got = _flat(jf), _flat(pf)
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want)
    unfused = sorted({k.split("['bn']")[0] for k in got if "['bn']" in k})
    assert unfused and all("['ffn']" in k or "['m']" in k and "['cv1']" in k for k in unfused)
    assert pm.stride == list(jm.stride) and pm.end2end and pm.head.legacy is False
    if name[7] in "mblx":
        cfg = _quarter(name)
        jm, pm = JT.DetectionModel(cfg), PT.DetectionModel(cfg, device="cpu")
        jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    tree = _random_bn(jp, np.random.default_rng(5))
    head = tree["model"][str(len(pm.layers) - 1)]["one2one_cv3"]
    for l in head:  # class logits near 0 (not the prior): the scores spread and the top-k's order matters
        head[l]["2"]["bias"] = np.zeros_like(head[l]["2"]["bias"])
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    PT.params_from_jax(pm, PT.fuse(tree))
    w = np.asarray(jax.jit(lambda p, x: jm.predict(p, x))(jm.fuse(tree), jnp.asarray(x)))
    g = pm.predict(torch.from_numpy(x)).numpy()
    assert g.shape == w.shape == (1, 84, 6) and np.ptp(w[..., 4]) > 0.02
    np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=0, atol=PX)
    np.testing.assert_allclose(g[..., 4], w[..., 4], rtol=0, atol=SCORE)
    np.testing.assert_array_equal(g[..., 5], w[..., 5])


def test_c2f_widths_list_every_published_instance():
    """`cuda_c2f.C2F_WIDTHS` holds every C2f and neck-fold instance, (c1, cs, c, c2o, n, H, W), of the models of
    `WIDTH_MODELS` (yolov8 and yolov10 n-x at 640², yolov8-small n-x at 640x512), each once, as the port's
    `parse_model` builds them; yolov10's C2fCIB rows never reach the kernel and its layer 13 folds only where it is a
    plain C2f (n / s / m)."""
    want = []
    for cfg, scale, H, W in cuda_c2f.WIDTH_MODELS:
        d = PT.yaml_model_load(cfg)
        if scale:
            d["scale"] = scale
        m = PT.DetectionModel(d, device="cpu")
        if cfg.startswith("yolov10"):
            assert set(m._upconcat) == ({13, 16} if cfg[7] in "nsm" else {16})
            assert all(type(m.layers[i]) is PM.C2f for i in m._upconcat)
        want += [w for w in m.c2f_instances(H, W) if w not in want]
    assert cuda_c2f.C2F_WIDTHS == want and len(want) == 89


# --- (c) the predictor, the validator, the JAX fault ----------------------------------------------------------


def _tuned():
    """yolov10n's init(0) tree (nc 80) with every BN drawn at random and the one-to-one branches' last convs set so
    that the untrained model scores a few anchors high: box bins 1 and 2 raised (boxes of about three strides), the
    class logits' weights halved, their biases at 1 (scores of about 0.5 to 0.9)."""
    p = _random_bn(jax.tree_util.tree_map(np.asarray, PT.DetectionModel("yolov10n.yaml", device="cpu").init(0)),
                   np.random.default_rng(8))
    head = p["model"]["23"]
    for l in range(3):
        box, cls = head["one2one_cv2"][str(l)]["2"], head["one2one_cv3"][str(l)]["2"]
        box["weight"], cls["weight"] = box["weight"] * 0.05, cls["weight"] * 0.5
        box["bias"] = np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
        cls["bias"] = np.full_like(cls["bias"], 1.0)
    return p


@pytest.fixture(scope="module")
def pair():
    """(JAX YOLO, port YOLO) of yolov10n holding the same tuned tree, and its fused tree."""
    tree = _tuned()
    jy, py = yolo_tpu.YOLO("yolov10n.yaml"), yolo_tpu_torch.YOLO("yolov10n.yaml", device="cpu")
    jy.params, py.params = tree, tree
    return jy, py, jax.tree_util.tree_map(np.asarray, jy.model.fuse(tree))


def reference_filter(rows, conf, max_det, classes=None):
    """The Ultralytics reference's end-to-end branch in numpy: per image the rows whose score passes conf, then those
    of `classes`, then the first max_det."""
    out = []
    for r in np.asarray(rows):
        r = r[r[:, 4] > conf]
        if classes is not None:
            r = r[np.isin(r[:, 5], classes)]
        out.append(r[:max_det])
    return out


@pytest.mark.parametrize("kw", [dict(conf=None, max_det=300), dict(conf=0.01, max_det=7, classes=True)],
                         ids=["conf", "classes-max_det"])
def test_predict_skips_nms_and_matches_jax_rows(pair, kw, two_threads):
    """`YOLO.predict` of yolov10n (f32, one seeded 64² BGR frame, so the letterbox is the identity) gives JAX's
    `DetectionModel.predict` rows through the reference's filter (conf at the rows' median; then classes, one of them named from the end
    as a negative id, and max_det): the same count and order, boxes (clipped to the
    frame) 1e-3 px, scores 1e-5, classes exact; `end2end_select` alone on JAX's rows gives the same; augment=True
    warns and predicts at one scale (the same rows)."""
    jy, py, fused = pair
    frame = np.random.default_rng(4).integers(0, 255, (64, 64, 3), np.uint8)
    x = jnp.asarray(frame[None, ..., ::-1].astype(np.float32) / 255.0)
    rows = np.asarray(jax.jit(lambda p, x: jy.model.predict(p, x))(fused, x))
    if kw["conf"] is None:  # the rows' median score: half of them pass
        kw = {**kw, "conf": float(np.median(rows[0, :, 4]))}
    if kw.get("classes"):  # three classes that the rows name, one of them twice or more
        kw = {**kw, "classes": sorted({int(rows[0, i, 5]) for i in (3, 20, 40)} | {-int(80 - rows[0, 60, 5])})}
    want = reference_filter(rows, kw["conf"], kw["max_det"], [c % 80 for c in kw.get("classes") or []] or None)[0]
    assert 3 <= len(want) < len(rows[0])
    r = py.predict(frame, imgsz=64, compute_dtype="float32", verbose=False, **kw)[0]
    assert len(r.boxes.conf) == len(want)
    np.testing.assert_allclose(r.boxes.xyxy, np.clip(want[:, :4], 0, 64), rtol=0, atol=PX)
    np.testing.assert_allclose(r.boxes.conf, want[:, 4], rtol=0, atol=SCORE)
    np.testing.assert_array_equal(r.boxes.cls, want[:, 5])
    sel = end2end_select(torch.from_numpy(rows), kw["conf"], kw.get("classes"), kw["max_det"], nc=80)
    v = sel["valid"][0].numpy()
    np.testing.assert_array_equal(sel["boxes"][0].numpy()[v], want[:, :4])
    np.testing.assert_array_equal(sel["cls"][0].numpy()[v], want[:, 5])
    r2 = py.predict(frame, imgsz=64, compute_dtype="float32", verbose=False, augment=True, **kw)[0]
    assert py.predictor._augment_warned
    np.testing.assert_array_equal(r2.boxes.xyxy, r.boxes.xyxy)
    py.predictor.args.augment = False


def test_jax_predictor_runs_nms_over_the_final_rows(pair, two_threads):
    """The JAX package's fault, pinned: its predictor hands v10Detect's (B, max_det, 6) rows to the NMS, which reads
    them as a (B, 4 + nc, A) map, and returns a score above 1 or a class >= nc. The port's, on the same tree and frame,
    returns scores in (0, 1] and classes < nc."""
    jy, py, _ = pair
    frame = np.random.default_rng(4).integers(0, 255, (64, 64, 3), np.uint8)
    j = jy.predict(frame, imgsz=64, conf=1e-4, verbose=False)[0]
    assert (np.asarray(j.boxes.conf) > 1).any() or (np.asarray(j.boxes.cls) >= 80).any()
    p = py.predict(frame, imgsz=64, conf=1e-4, compute_dtype="float32", verbose=False)[0]
    assert len(p.boxes.conf) and (p.boxes.conf <= 1).all() and (p.boxes.conf > 0).all() and (p.boxes.cls < 80).all()


def _e2e_nms(prediction, conf_thres=0.25, iou_thres=0.45, max_det=300, **_):
    """The reference's filter in jnp, in the fixed outputs of JAX's NMS (what its validator reads), for JAX's own
    validator on the end-to-end rows."""
    keep = prediction[..., 4] > conf_thres
    order = jnp.argsort(~keep, axis=1, stable=True)[:, :max_det]
    valid = jnp.take_along_axis(keep, order, 1)
    take = lambda a: jnp.take_along_axis(a, order, 1)  # noqa: E731
    boxes = jnp.take_along_axis(prediction[..., :4], order[..., None], 1)
    return {"boxes": jnp.where(valid[..., None], boxes, 0.0), "scores": jnp.where(valid, take(prediction[..., 4]), 0.0),
            "cls": jnp.where(valid, take(prediction[..., 5]).astype(jnp.int32), -1), "valid": valid}


def test_val_matches_jax_metrics_on_reference_rows(pair, tiny_dataset, monkeypatch, two_threads):
    """`YOLO.val` of yolov10n (f32, imgsz 64, conf 0.001) on the 8-image fixture: JAX's validator, whose NMS is
    replaced by the reference's end-to-end filter (`_e2e_nms`, held against the numpy `reference_filter` on rows that
    tie and cross the threshold), gives the same metrics within 1e-4 and the same confusion matrix, from JAX's
    `DetectionModel.predict` rows and JAX's metric functions."""
    jy, py, _ = pair
    rows = np.random.default_rng(0).uniform(0, 1, (2, 40, 6)).astype(np.float32)
    rows[..., 4] = np.round(rows[..., 4], 1)
    got = _e2e_nms(jnp.asarray(rows), conf_thres=0.3, max_det=12)
    for b, ref in enumerate(reference_filter(rows, 0.3, 12)):
        v = np.asarray(got["valid"][b])
        np.testing.assert_array_equal(np.asarray(got["boxes"][b])[v], ref[:, :4])
    import yolo_tpu.ops.nms as JN

    monkeypatch.setattr(JN, "non_max_suppression", _e2e_nms)
    jv = JV.DetectionValidator(args={**jy.overrides, "data": tiny_dataset, "imgsz": 64, "plots": False, "mode": "val"})
    want = jv(model=jy.model, params=jy.params)
    got = py.val(data=tiny_dataset, imgsz=64, plots=False)
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    np.testing.assert_array_equal(py.validator.confusion_matrix.matrix, jv.confusion_matrix.matrix)


def test_track_follows_the_predicted_rows(pair, two_threads):
    """`YOLO.track` (ByteTrack, f32) over three copies of one frame: every frame's tracked boxes are among the
    predicted rows (1e-3 px), with ids that persist."""
    _, py, _ = pair
    frame = np.random.default_rng(4).integers(0, 255, (64, 64, 3), np.uint8)
    pred = py.predict(frame, imgsz=64, conf=0.05, compute_dtype="float32", verbose=False)[0]
    ids = []
    for _ in range(3):
        r = py.track(frame, imgsz=64, conf=0.05, compute_dtype="float32", persist=True, tracker="bytetrack.yaml", verbose=False)[0]
        assert len(r.boxes.xyxy) and all(np.abs(pred.boxes.xyxy - b).max(-1).min() < PX for b in r.boxes.xyxy)
        ids.append(sorted(np.asarray(r.boxes.id).tolist()))
    assert ids[1] == ids[2]
    py.predictor = None


def test_int8_tiled_benchmark_and_server_lane(pair, tmp_path, monkeypatch, two_threads):
    """The entry points on yolov10n's tuned tree (f32, imgsz 64, one seeded frame): `predict(int8=True)` gives JAX's
    `DetectionModel.predict` rows of JAX's quantized fused tree (dynamic scales; every CIB conv and PSA's ffn stay float
    in both, being unfused) through the reference's filter, at the same count and classes, boxes 0.05 px and conf 1e-3
    (rows paired by class and box: int8 codes move near-equal scores past each other);
    `tiled_predict` (tile 64 over a 96x128 frame) and a server lane reply with boxes of that frame, scores in (0, 1],
    classes below nc; the lane's rows are the port's predict's (1e-3 px, 1e-5); `benchmark(imgsz=32)` gives JAX's rows in
    keys, batches and dtypes (its timing stubbed), with positive latencies."""
    from yolo_tpu.nn.quantize import quantize_params as jax_quantize
    from yolo_tpu.utils import benchmarks as JB
    from yolo_tpu_torch.ops.tiling import tiled_predict
    from yolo_tpu_torch.serve import DetectionServer
    from yolo_tpu_torch.utils.remote import RemoteModel

    from tests.test_torch_serve import _serve

    jy, py, fused = pair
    frame = np.random.default_rng(4).integers(0, 255, (64, 64, 3), np.uint8)
    x = jnp.asarray(frame[None, ..., ::-1].astype(np.float32) / 255.0)
    rows = np.asarray(jax.jit(lambda p, x: jy.model.predict(p, x))(jax_quantize(fused), x))
    want = reference_filter(rows, 0.5, 300)[0]
    py.predictor = None
    got = py.predict(frame, imgsz=64, conf=0.5, compute_dtype="float32", int8=True, verbose=False)[0]
    assert py.model.int8 and len(want) > 3 and len(got.boxes.conf) == len(want)
    wb = np.clip(want[:, :4], 0, 64)
    o = _paired(got.boxes.xyxy, wb, got.boxes.cls, want[:, 5])  # int8 codes move near-equal scores past each other
    np.testing.assert_allclose(got.boxes.xyxy[o], wb, rtol=0, atol=0.05)
    np.testing.assert_allclose(got.boxes.conf[o], want[:, 4], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.boxes.cls[o], want[:, 5])
    py.predictor = None
    big = np.random.default_rng(5).integers(0, 255, (96, 128, 3), np.uint8)
    boxes, scores, cls = tiled_predict(py, big, tile=64, overlap=0.25, conf=0.5, compute_dtype="float32", max_det=30)
    assert len(boxes) and (scores <= 1).all() and (cls < 80).all() and boxes[:, [0, 2]].max() <= 128
    py.predictor = None
    src = str(py.save(str(tmp_path / "yolov10n.npz")))
    srv = DetectionServer({0: src}, port=0, imgsz=64, batch_window_ms=1.0, device="cpu", predict_args={"compute_dtype": "float32"})
    t = _serve(srv)
    try:
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/0") as client:
            g = client(frame)
        w = np.asarray(py.predict(frame, imgsz=64, conf=0.25, compute_dtype="float32", verbose=False)[0].boxes.data)[:, :6]
        assert len(w) and g.shape == w.shape
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
    finally:
        srv.shutdown()
        t.join(30)
    py.predictor = None
    monkeypatch.setattr(JB, "_time_fn", lambda fn, args, **kw: (1e-3, 0.0))
    want_rows, got_rows = jy.benchmark(imgsz=32), py.benchmark(imgsz=32)
    assert [(r["batch"], r["dtype"]) for r in got_rows] == [(r["batch"], r["dtype"]) for r in want_rows]
    assert [list(r) for r in got_rows] == [list(r) for r in want_rows] and all(r["latency_ms"] > 0 for r in got_rows)
    jy.predictor = py.predictor = None


# --- (d) one train step, checkpoints, refusals ----------------------------------------------------------------


class _WideJnp(types.ModuleType):
    """`jax.numpy` with `float32` read as `float64` (JAX's modules, loss and assigner read it: a true f64 step)."""

    def __init__(self):
        super().__init__("jax.numpy")

    def __getattr__(self, key):
        return jnp.float64 if key == "float32" else getattr(jnp, key)


def test_train_step_matches_jax(two_threads, monkeypatch):
    """One E2EDetectLoss step of yolov10n at nc 3 from init(0) on two seeded 64² images with `_random_case`'s targets:
    JAX's value_and_grad against the port's train forward and backward. In f64 on both sides: the loss and its six
    items (box, cls, dfl of the one-to-many branch at topk 10, then of the one-to-one at topk 1) 1e-4 relative, every
    gradient 1e-3 of its tensor's largest (at least 1e-6), the one-to-one branch's gradient confined to its own convs
    (its inputs detached); in f32 the loss and its items 1e-4 relative and the gradient's direction (cosine > 0.999)."""
    from yolo_tpu.utils import loss as JL, tal as JTAL

    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": cls, "bboxes": boxes * 2, "mask_gt": mask}
    jm = JT.DetectionModel("yolov10n.yaml", nc=3)
    jp = jm.init(0)

    def jax_step(dtype):
        def forward_loss(params):
            ctx = JM.Ctx(train=True, dtype=dtype)
            return JaxE2ELoss(jm, HYP)(jm.forward_features(params, jnp.asarray(x, dtype), ctx), {k: jnp.asarray(v) for k, v in batch.items()})

        tree = jax.tree.map(lambda a: np.asarray(a, dtype), jp)
        (total, comps), grads = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(tree)
        flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(grads)}
        return float(total), np.asarray(comps), flat

    def port_step(dtype):
        pm = PT.DetectionModel("yolov10n.yaml", nc=3, device="cpu").to(dtype)
        PT.load_train_params(pm, pm.init(0))
        pm.train()
        total, comps = E2EDetectLoss(pm, HYP)(pm.forward_features(torch.from_numpy(x).to(dtype)), {k: torch.from_numpy(v) for k, v in batch.items()})
        total.backward()
        params = {k: t for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)}
        return float(total.detach()), comps.detach().numpy(), {k: t.grad for k, t in params.items()}

    def as_jax(k, g):
        return np.zeros(0) if g is None else (g.numpy().transpose(2, 3, 1, 0) if g.ndim == 4 else g.numpy())

    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (JM, JT, JL, JTAL):
            mp.setattr(mod, "jnp", _WideJnp())
        narrow = torch.Tensor.float
        mp.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64 else narrow(t, *a, **k))
        jt, jcomps, flat = jax_step(jnp.float64)
        total, comps, grads = port_step(torch.float64)
    assert comps.shape == (6,) and flat["model/1/conv/weight"].dtype == np.float64
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    assert set(grads) <= set(flat)
    for k, g in grads.items():
        want = flat[k]
        got = as_jax(k, g)
        got = np.zeros_like(want) if got.size == 0 else got.reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * max(np.abs(want).max(), 1e-6), err_msg=k)
    o2o = {k for k in flat if "/one2one_" in k and np.abs(flat[k]).max() > 0}
    assert o2o and all(k.startswith("model/23/one2one_") for k in o2o)
    jt, jcomps, flat = jax_step(jnp.float32)
    total, comps, grads = port_step(torch.float32)
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    keys = sorted(grads)
    g = np.concatenate([as_jax(k, grads[k]).reshape(-1) if grads[k] is not None else np.zeros(flat[k].size) for k in keys])
    w = np.concatenate([flat[k].reshape(-1) for k in keys])
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999


def test_checkpoints_and_refusals(tmp_path, pair):
    """A .npz that JAX writes loads in the port as yolov10n with JAX's tree, bit for bit (the one-to-one branches and
    the unfolded groups included), the port's .npz loads in JAX with the port's tree, and the port's .pt reads back to
    the same tree in both packages. FusedDetectTrack and `predict_parts` refuse the end-to-end head
    (NotImplementedError naming it; JAX asserts), and so does an ensemble of it."""
    jy = yolo_tpu.YOLO("yolov10n.yaml")
    py = yolo_tpu_torch.YOLO(str(jy.save(str(tmp_path / "jax.npz"))), device="cpu")
    assert py.model.end2end and "one2one_cv3" in py.params["model"]["23"]
    _same_tree(py.params, jy.params)
    back = yolo_tpu.YOLO(str(py.save(str(tmp_path / "port.npz"))))
    _same_tree(back.params, py.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        pt = py.export(format="pt")
    for y in (yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu"), yolo_tpu.YOLO(str(tmp_path / pt))):
        _same_tree(y.params, py.params)
    with pytest.raises(NotImplementedError, match="end-to-end"):
        FusedDetectTrack(py.model, py.params, frame_hw=(64, 64), chunk=2, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="end-to-end"):
        py.model.predict_parts(torch.zeros(1, 64, 64, 3))
    with pytest.raises(AssertionError, match="v10"):
        jy.model.predict_parts(jy.model.fuse(jy.params), jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(NotImplementedError, match="end-to-end"):
        PT.Ensemble([py.model, py.model])
