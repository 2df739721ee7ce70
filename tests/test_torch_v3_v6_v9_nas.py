"""The yolov3, yolov6, YOLO-NAS and yolov9 families of the port against the JAX package's on the CPU: ConvBNAct with
ReLU and the yaml's `activation:` override, repeated rows, Bottleneck rows, SPP, ZeroPad2d, the raw ConvTranspose2d,
NASBottleneck, NASCSP, RepConv, RepCSP, RepNCSPELAN4, ELAN1, AConv, ADown, SPPELAN, CBLinear and CBFuse through each
module's initial tree, BN fold and both forms in f32 and bf16; the twelve yamls' trees, fuse and predict; the layer
lists at the other scales; the checkpoints and the NAS facade; the routes (a ReLU head never reaches the head
kernels, and JAX's merged-SiLU fault is not copied). One train step of yolov9t and of yolo_nas_s and the entry points
are in tests/test_torch_v3_v6_v9_nas_entry.py.

Tolerances, the yolo11 / yolo12 file's (tests/test_torch_yolo11_12.py), stated again at each test: trees exact; f32
predictions at 64² within 1e-3 px for boxes and 1e-5 for scores, coefficients and prototypes; module outputs in f32
1e-4 of their largest, BN moments 1e-5 of theirs. New here: module outputs in bf16 within 2e-2 of their largest (five
bf16 steps at the top of the range; one rounding that lands on the other side of an edge moves a value by one step,
and a conv sums a few such), their BN moments 1e-2; a calibrated tree's f32 predict held against the port's f64 one
(the test says why)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu_torch import FusedDetectTrack
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_head_cm

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v8_variants import _flat, _jax_forward, _load_train, _random_bn

FAMILIES = ["yolov3-tiny.yaml", "yolov3.yaml", "yolov3-spp.yaml", "yolov6n.yaml", "yolo_nas_s.yaml", "yolov9t.yaml",
            "yolov9s.yaml", "yolov9m.yaml", "yolov9c.yaml", "yolov9e.yaml", "yolov9c-seg.yaml", "yolov9e-seg.yaml"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-2)}


@contextlib.contextmanager
def default_act(name):
    """Both packages' ConvBNAct default activation while a module is built (what a yaml's `activation:` sets)."""
    prev = JM.ConvBNAct.DEFAULT_ACT, PM.ConvBNAct.DEFAULT_ACT
    JM.ConvBNAct.DEFAULT_ACT = PM.ConvBNAct.DEFAULT_ACT = name
    try:
        yield
    finally:
        JM.ConvBNAct.DEFAULT_ACT, PM.ConvBNAct.DEFAULT_ACT = prev


def _seq(M, *mods):
    return JM._SeqN(*mods) if M is JM else PM.Seq(*mods)


# --- (a) the modules ------------------------------------------------------------------------------------------


MODULE_CASES = [  # (id, the module from either package's namespace, input channels, input H x W)
    ("Conv-relu", lambda M: M.ConvBNAct(16, 32, 3, 1, act="relu"), 16, (13, 14)),
    ("Conv-relu-default", lambda M: _relu_conv(M), 16, (13, 14)),  # act=True under a ReLU default
    ("Bottleneck-x2", lambda M: _seq(M, M.Bottleneck(32, 32), M.Bottleneck(32, 32)), 32, (13, 14)),
    ("Bottleneck-no-shortcut", lambda M: M.Bottleneck(32, 64, False), 32, (13, 14)),
    ("Conv-x3-relu", lambda M: _seq(M, *(M.ConvBNAct(32, 32, 3, 1, act="relu") for _ in range(3))), 32, (13, 14)),
    ("SPP", lambda M: M.SPP(32, 64), 32, (13, 14)),
    ("ZeroPad2d-MaxPool2d", lambda M: _seq(M, M.ZeroPad2d([0, 1, 0, 1]), M.MaxPool2d(2, 1, 0)), 16, (13, 14)),
    ("ConvTranspose2d-raw", lambda M: M.ConvTranspose(32, 16, 2, 2, 0, False, False), 32, (13, 14)),
    ("NASBottleneck", lambda M: M.NASBottleneck(32, 32), 32, (13, 14)),
    ("NASCSP", lambda M: M.NASCSP(32, 64, 2), 32, (13, 14)),
    ("NASCSP-no-shortcut", lambda M: M.NASCSP(32, 64, 1, False), 32, (13, 14)),
    ("RepConv", lambda M: M.RepConv(32, 64), 32, (13, 14)),
    ("RepConv-bn", lambda M: M.RepConv(32, 32, bn=True), 32, (13, 14)),
    ("RepCSP", lambda M: M.RepCSP(32, 64, 2), 32, (13, 14)),
    ("RepNCSPELAN4", lambda M: M.RepNCSPELAN4(32, 64, 32, 16, 1), 32, (13, 14)),
    ("ELAN1", lambda M: M.ELAN1(32, 64, 32, 16), 32, (13, 14)),
    ("AConv-odd", lambda M: M.AConv(32, 64), 32, (13, 15)),
    ("AConv-even", lambda M: M.AConv(32, 64), 32, (12, 16)),
    ("ADown-odd", lambda M: M.ADown(32, 64), 32, (13, 15)),
    ("ADown-even", lambda M: M.ADown(32, 64), 32, (12, 16)),
    ("SPPELAN", lambda M: M.SPPELAN(32, 64, 16), 32, (13, 14)),
    ("Detect-relu", lambda M: _relu_detect(M), 32, (13, 14)),
]


def _relu_conv(M):
    with default_act("relu"):
        return M.ConvBNAct(16, 32, 3, 1)


def _relu_detect(M):
    with default_act("relu"):
        return M.Detect(3, (32,))


def _run(m, tree, x, form, dtype=jnp.float32):
    """One module's forward in either package; a Detect takes (and gives) a list of one level."""
    head = isinstance(m, (JM.Detect, PM.Detect))
    arg = [x] if head else x
    if isinstance(m, torch.nn.Module):
        out = m.forward_train(arg) if form == "train" else m(arg)
        return (out[0] if head else out).detach().float().numpy()
    out, ctx = _jax_forward(m, tree, jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), arg) if head else jnp.asarray(x, dtype),
                            form == "train", dtype)
    return np.asarray((out[0] if head else out).astype(jnp.float32)), ctx


def _bn_keys(pm) -> dict:
    """{JAX stats key: module} of every BN the train form runs: each ConvBNAct's and a RepConv's identity BN."""
    out = {}
    for n, m in pm.named_modules():
        if isinstance(m, PM.ConvBNAct) or (isinstance(m, PM.RepConv) and m.bn is not None):
            out[f"/{n.replace('.', '/')}/bn" if n else "/bn"] = m
    return out


def _in_dtype(pm, dtype):
    for m in pm.modules():
        m.compute_dtype = dtype
    return pm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(case, form, dtype, two_threads):
    """Each new module against JAX's on N(0, 1) NHWC input (2 x H x W), BN's γ, β and moments drawn at random: the
    initial subtree bit for bit and the fused one (the port's `fuse`) bit for bit against JAX's fold, but for a
    RepConv with an identity BN, whose fold JAX leaves out (ROADMAP §3): there the port's fused form is held against
    JAX's unfused eval form. The train form (BN on the batch's moments, which match JAX's within 1e-5 of their
    largest in f32 and 1e-2 in bf16, two bf16 steps, with the same count) and the fused form within 1e-4 of the largest output in f32 and 2e-2 in bf16 (at
    least that much absolute), the output spread (std > 0.1) so that a module that ignored its input would fail."""
    _, build, cin, hw = case
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
        convs = _bn_keys(pm)
        assert set(convs) == set(ctx.stats)
        for key, m in convs.items():
            mean, var, n = ctx.stats[key]
            assert m.batch_stats[2] == n, key
            for g, w in zip(m.batch_stats[:2], (np.asarray(mean), np.asarray(var))):
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=mtol * max(np.abs(w).max(), 1.0), err_msg=key)
    else:
        pf = PT.fuse(tree)
        if "RepConv-bn" in case[0]:  # JAX's fuse drops the identity BN: hold the fold against JAX's unfused eval form
            want, _ = _run(jm, tree, x, "eval", jdt)
            jf = JT._fuse_module(jm, tree)
            assert not np.array_equal(pf["conv"]["weight"], np.asarray(jf["conv"]["weight"]))
        else:
            jf = jax.tree_util.tree_map(np.asarray, JT._fuse_module(jm, tree))
            want_f, got_f = _flat(jf), _flat(pf)
            assert list(got_f) == list(want_f)
            for k in want_f:
                np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)
            want, _ = _run(jm, jf, x, "fused", jdt)
        pm.load_jax(pf, "cpu", pdt)
        got = _run(_in_dtype(pm, pdt), None, xt, "fused")
    assert got.shape == want.shape and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("n", [1, 2])
def test_nascsp_keeps_jax_f32_residual_in_bf16(n, two_threads):
    """NASCSP in bf16 (fused tree, random BN, each alpha drawn from U(0.5, 1.5)): the port's output equals JAX's in
    at least 99% of its values and within 2e-2 of the largest. In JAX the f32 0-d alpha promotes each residual sum to
    f32, which stays f32 down the bottleneck chain until cv3 rounds its input; a port that rounded each sum to bf16
    (torch's own promotion) differs from JAX in more than 5% of the values once two bottlenecks chain."""
    jm, pm = JM.NASCSP(32, 64, n), PM.NASCSP(32, 64, n)
    rng = np.random.default_rng(3)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, jm.init(np.random.default_rng(0))), rng)
    for k in tree["m"]:
        tree["m"][k]["alpha"] = np.float32(rng.uniform(0.5, 1.5))
    x = rng.normal(0, 1, (2, 13, 14, 32)).astype(np.float32)
    want, _ = _run(jm, jax.tree_util.tree_map(np.asarray, JT._fuse_module(jm, tree)), x, "fused", jnp.bfloat16)
    pm.load_jax(PT.fuse(tree), "cpu", torch.bfloat16)
    got = _run(_in_dtype(pm, torch.bfloat16), None, torch.from_numpy(x).bfloat16(), "fused")
    assert (got == want).mean() >= 0.99
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    run = PM.NASBottleneck._run
    with pytest.MonkeyPatch.context() as mp:  # the residual rounded to bf16 at each bottleneck
        mp.setattr(PM.NASBottleneck, "_run", lambda self, x, train, dtype=None: run(self, x, train, dtype).to(dtype or x.dtype))
        rounded = _run(pm, None, torch.from_numpy(x).bfloat16(), "fused")
    assert (rounded == want).mean() < (0.95 if n > 1 else 1.01)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cblinear_cbfuse_match_jax(dtype, two_threads):
    """CBLinear (a biased conv split into channel groups, the bias added in f32) on a 7x8 map and a 14x16 one, then
    CBFuse picking one split of each and summing them, repeated up to a 28x32 target, with the target in f32: the
    initial trees bit for bit, each split and the sum within 1e-4 (f32) and 2e-2 (bf16) of their largest, in the
    inference form and in the train form (CBLinear's weight and bias are leaves of it)."""
    jdt, pdt, tol, _ = DTYPES[dtype]
    ja, jb, jf = JM.CBLinear(32, [16, 24]), JM.CBLinear(16, [16, 24, 8], 3), JM.CBFuse([1, 1])
    pa, pb, pf = PM.CBLinear(32, [16, 24]), PM.CBLinear(16, [16, 24, 8], 3), PM.CBFuse([1, 1])
    rng = np.random.default_rng(4)
    ta, tb = ja.init(np.random.default_rng(0)), jb.init(np.random.default_rng(1))
    for jm, pm, t, seed in ((ja, pa, ta, 0), (jb, pb, tb, 1)):
        got = _flat(pm.init(np.random.default_rng(seed)))
        assert list(got) == list(_flat(t)) and all(np.array_equal(got[k], v) for k, v in _flat(t).items())
        pm.load_jax(PT.fuse(t), "cpu", pdt)
        _in_dtype(pm, pdt)
        _load_train(pm, t)
    xa, xb = rng.normal(0, 1, (2, 7, 8, 32)).astype(np.float32), rng.normal(0, 1, (2, 14, 16, 16)).astype(np.float32)
    target = rng.normal(0, 1, (2, 28, 32, 24)).astype(np.float32)
    ctx = JM.Ctx(train=False, dtype=jdt)
    sa, sb = ja(ta, jnp.asarray(xa, jdt), ctx), jb(tb, jnp.asarray(xb, jdt), ctx)
    want = np.asarray(jf({}, [sa, sb, jnp.asarray(target, jdt)], ctx).astype(jnp.float32))
    for train in (False, True):
        call = (lambda m, x: m.forward_train(x)) if train else (lambda m, x: m(x))
        ga = call(pa, torch.from_numpy(xa).to(pdt))
        gb = call(pb, torch.from_numpy(xb).to(pdt))
        for g, w in zip(ga + gb, list(sa) + list(sb)):
            w = np.asarray(w.astype(jnp.float32))
            np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0, atol=tol * np.abs(w).max())
        got = pf([ga, gb, torch.from_numpy(target).to(pdt)]).detach().float().numpy()
        assert got.shape == want.shape == (2, 28, 32, 24)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_activation_override_holds_for_one_build():
    """yolov6n (`activation: torch.nn.ReLU()`) builds every act=True conv as ReLU, in both packages, and NASCSP pins
    ReLU whatever the default; a yolov8n built next is SiLU again, and so is a bare ConvBNAct; JAX's name mapping:
    'relu' in the name is ReLU, 'gelu' GELU, anything else SiLU."""
    v6 = PT.DetectionModel("yolov6n.yaml", device="cpu")
    acts = {m.act for m in v6.modules() if isinstance(m, PM.ConvBNAct)}
    assert acts == {"relu"}  # the Detect head's 1x1s are Conv2d: every ConvBNAct of yolov6 ends in ReLU
    assert not v6.head.kernel_branches and v6.head.legacy
    v8 = PT.DetectionModel("yolov8n.yaml", device="cpu")
    assert {m.act for m in v8.modules() if isinstance(m, PM.ConvBNAct)} == {"silu"} and v8.head.kernel_branches
    assert PM.ConvBNAct(3, 8).act == JM.ConvBNAct(3, 8).act == "silu"
    for name, want in (("torch.nn.ReLU()", "relu"), ("nn.LeakyReLU(0.1)", "relu"), ("nn.GELU()", "gelu"), ("nn.SiLU()", "silu"),
                       ("Hardswish", "silu")):
        d = {**PT.yaml_model_load("yolov8n.yaml"), "activation": name}
        jl, _ = JT.parse_model(d, 3)
        with torch.device("meta"):
            pl, _, _ = PT.parse_model(d, 3)
        assert pl[0].act == jl[0].module.act == want, name
    assert PM.ConvBNAct.DEFAULT_ACT == JM.ConvBNAct.DEFAULT_ACT == "silu"
    nas = PT.DetectionModel("yolo_nas_s.yaml", device="cpu")
    assert {m.act for m in nas.layers[2].modules() if isinstance(m, PM.ConvBNAct)} == {"relu"}


# --- (b) the twelve yamls -------------------------------------------------------------------------------------


REDUCED = {"yolov3.yaml": 0.25, "yolov3-spp.yaml": 0.25}  # width_multiple (yolov9e's CBLinear widths do not scale: its CBFuse sums need full width)


def _cfg(name):
    """The yaml dict both packages parse; yolov3 / -spp and yolov9e / -e-seg (58-63M values) at a quarter width
    (`width_multiple`, which JAX's parse reads too) to stay within the file's CPU time."""
    d = PT.yaml_model_load(name)
    if name in REDUCED:
        d = {**d, "width_multiple": REDUCED[name]}
    return d


def _models(name):
    d = _cfg(name)
    task = PT.guess_model_task(d)
    jm = (JT.SegmentationModel if task == "segment" else JT.DetectionModel)(dict(d))
    return jm, PT.model_class_for(d, task)(dict(d), device="cpu"), task


CALIBRATED = ("yolov3-tiny.yaml", "yolov6n.yaml", "yolo_nas_s.yaml", "yolov9t.yaml", "yolov9e.yaml")  # one graph of each family


def _predict(model, tree, x, jax_model=None):
    """The f32 (B, 4 + nc [+ nm], A) predictions of the fused `tree`: JAX's where `jax_model` is given, else the port's."""
    if jax_model is not None:
        out = jax.jit(jax_model.predict)(jax.tree_util.tree_map(np.asarray, jax_model.fuse(tree)), jnp.asarray(x))
    else:
        PT.params_from_jax(model, PT.fuse(tree), model.compute_dtype)
        out = model.predict(torch.from_numpy(x).to(model.compute_dtype))
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(out, np.float64) if jax_model is not None else out.double().numpy()


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tree_fuse_and_predict_match_jax(name, two_threads):
    """`init(0)` leaf for leaf and bit for bit, the BN fold bit for bit, the strides, a legacy head (SiLU for v3 and
    v9, whose levels the head kernel takes; ReLU for v6 and NAS, walked), and the f32 predict of the fused tree on one
    seeded 64² image against JAX's: boxes within 1e-3 px, scores, coefficients and prototypes 1e-5 (yolov3 / -spp at a
    quarter width). An init(0) tree's maps fade through its depth; for one graph of each family the tree's BN moments
    are then calibrated on two seeded images (chip_smoke's `bn_calibrated`: maps near unit scale, as a trained tree's),
    which amplifies f32 rounding to 1e-2-1e-1 px in either package: there JAX's f32 predict must lie within 4x the
    port's own f32 distance from the port's f64 predict of the same tree (and 1e-3 px / 1e-5 at least), boxes and
    scores apart, the scores spread over the anchors."""
    import chip_smoke

    jm, pm, task = _models(name)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    pp = pm.init(0)
    want, got = _flat(jp), _flat(pp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jf, pf = jax.tree_util.tree_map(np.asarray, jm.fuse(jp)), PT.fuse(pp)
    want, got = _flat(jf), _flat(pf)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pm.stride == list(jm.stride)
    assert pm.head.legacy is jm.layers[-1].module.legacy is True
    assert pm.head.kernel_branches is (name.startswith("yolov3") or name.startswith("yolov9"))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    PT.params_from_jax(pm, pf)
    w, g = jax.jit(jm.predict)(jf, jnp.asarray(x)), pm.predict(torch.from_numpy(x))
    if task == "segment":
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), rtol=0, atol=1e-5)
        w, g = w[0], g[0]
    w, g = np.asarray(w), g.numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=0, atol=1e-5)
    if name not in CALIBRATED:
        return
    cal = chip_smoke.bn_calibrated(pm, pp, torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)))
    p64 = _in_dtype(pm.double(), torch.float64)
    exact = _predict(p64, cal, x)
    port = _predict(_in_dtype(pm.float(), torch.float32), cal, x)
    ref = _predict(None, cal, x, jm)
    assert ref[:, 4 : 4 + pm.nc].std() > 1e-4
    for cols, floor in ((slice(0, 4), 1e-3), (slice(4, None), 1e-5)):
        noise = np.abs(port[:, cols] - exact[:, cols]).max()
        assert np.abs(ref[:, cols] - exact[:, cols]).max() <= max(4 * noise, floor), (cols, noise)


# --- (c) the layer lists at the other scales ------------------------------------------------------------------


def _jax_convs(obj) -> list:
    """(kind, c1, c2, k, s, g, act) of every conv inside a JAX module, found through its attributes (a RepConv's fused
    3x3 is its two branch convs)."""
    if isinstance(obj, JM.ConvBNAct):
        return [("conv", obj.c1, obj.c2, obj.k, obj.s, obj.g, obj.act)]
    if isinstance(obj, JM.Conv2d):
        return [("conv2d", obj.c1, obj.c2, obj.k, 1, 1, None)]
    if isinstance(obj, (list, tuple)):
        return [c for o in obj for c in _jax_convs(o)]
    if type(obj).__module__ == JM.__name__:
        return [c for v in vars(obj).values() for c in _jax_convs(v)]
    return []


def _port_convs(m) -> list:
    return [("conv", c.c1, c.c2, c.k, c.s, c.g, c.act) if isinstance(c, PM.ConvBNAct) else ("conv2d", c.c1, c.c2, c.k, 1, 1, None)
            for c in m.modules() if isinstance(c, (PM.ConvBNAct, PM.Conv2d))]


@pytest.mark.parametrize("name", ["yolov6s.yaml", "yolov6m.yaml", "yolov6l.yaml", "yolov6x.yaml", "yolo_nas_m.yaml", "yolo_nas_l.yaml"])
def test_layer_lists_at_other_scales_match_jax(name):
    """yolov6 s to x and YOLO-NAS m and l (no weights drawn): JAX's rows, sources and save list; each layer's module (a
    repeated row: n copies in a row), and every conv inside it (c1, c2, k, s, groups, activation) as JAX's."""
    d = PT.yaml_model_load(name)
    jlayers, jsave = JT.parse_model(JT.yaml_model_load(name), 3)
    with torch.device("meta"):  # the modules' zero tensors take no memory
        layers, froms, save = PT.parse_model(d, 3)
    assert froms == [s.f for s in jlayers] and save == jsave and len(layers) == len(jlayers)
    for m, spec in zip(layers, jlayers):
        if type(spec.module).__name__ == "_SeqN":
            assert isinstance(m, PM.Seq) and len(m) == len(spec.module.mods)
        else:
            assert type(m) is PT.MODULE_MAP[spec.type], spec.type
        assert sorted(_port_convs(m), key=str) == sorted(_jax_convs(spec.module), key=str), (spec.i, spec.type)


# --- (d) checkpoints and the NAS facade -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolo_nas_s.yaml", "yolov9c-seg.yaml", "yolov3-tiny.yaml"])
def test_checkpoints_cross_between_packages(name, tmp_path):
    """A .npz that JAX writes loads in the port as the same task with JAX's tree, bit for bit (NASBottleneck's 0-d
    alpha, RepConv's two branches, the raw ZeroPad2d row); the port's .npz loads in JAX with the port's tree; the port's
    .pt (alpha a 0-d tensor, RepConv's conv1 / conv2 as torch names) reads back to the same tree in both packages."""
    jy, task = yolo_tpu.YOLO(name), PT.guess_model_task(PT.yaml_model_load(name))
    py = yolo_tpu_torch.YOLO(str(jy.save(str(tmp_path / "jax.npz"))), device="cpu")
    assert py.task == task
    _same_tree(py.params, jy.params)
    back = yolo_tpu.YOLO(str(py.save(str(tmp_path / "port.npz"))))
    assert back.task == task
    _same_tree(back.params, py.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)  # the export writes into the working directory
        pt = py.export(format="pt")
    sd = torch.load(str(tmp_path / pt), weights_only=True)["state_dict"]
    if "nas" in name:
        assert sd["model.2.m.0.alpha"].shape == ()
    if "v9" in name:
        assert sd["model.2.cv2.0.m.0.cv1.conv1.conv.weight"].shape[2:] == (3, 3)
        assert sd["model.2.cv2.0.m.0.cv1.conv2.conv.weight"].shape[2:] == (1, 1)
    for y in (yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu"), yolo_tpu.YOLO(str(tmp_path / pt))):
        assert y.task == task
        _same_tree(y.params, py.params)


def test_nas_facade_matches_jax(tmp_path):
    """NAS("yolo_nas_s" / "yolo_nas_m" / "yolo_nas_l") builds the scale named, as JAX's facade does (the same layer
    count and widths, the same init(0) tree at s); the yaml and an .npz load; a .pt raises ValueError in both."""
    for scale in "sml":
        jn = yolo_tpu.NAS(f"yolo_nas_{scale}")
        with torch.device("meta"):
            pl, _, _ = PT.parse_model(PT.yaml_model_load(f"yolo_nas_{scale}.yaml"), 3)
        assert [getattr(m, "c2", None) for m in pl[:10]] == [getattr(s.module, "c2", None) for s in jn.model.layers[:10]]
    pn, jn = yolo_tpu_torch.NAS("yolo_nas_s", device="cpu"), yolo_tpu.NAS("yolo_nas_s")
    assert pn.task == "detect" and isinstance(pn.model.layers[2], PM.NASCSP)
    _same_tree(pn.params, jax.tree_util.tree_map(np.asarray, jn.params))
    again = yolo_tpu_torch.NAS(str(jn.save(str(tmp_path / "nas.npz"))), device="cpu")
    _same_tree(again.params, pn.params)
    assert isinstance(yolo_tpu_torch.NAS("yolo_nas_s.yaml", device="cpu").model.layers[9], PM.SPP)
    for facade in (yolo_tpu_torch.NAS, yolo_tpu.NAS):
        with pytest.raises(ValueError, match="super_gradients"):
            facade("yolo_nas_s.pt")


# --- (e) the routes -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolov6n.yaml", "yolo_nas_s.yaml", "yolov9t.yaml", "yolov3-tiny.yaml"])
def test_relu_heads_never_reach_the_head_kernels(name, monkeypatch, two_threads):
    """Every C2f and head kernel wrapper and twin counted: a ReLU head (yolov6, YOLO-NAS) runs predict and predict_parts
    (the pipeline's route) with none of them, and `head_cm=True` (FusedDetectTrack's pallas_head2) raises
    NotImplementedError, at construction in FusedDetectTrack; a SiLU legacy head (yolov9, yolov3) reaches the head
    kernel's route (its twin on the CPU) once a level and the channel-major one with `head_cm`. No model of these
    families reaches the C2f kernel (it has no C2f row)."""
    calls = {}

    def counter(mod, fn):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[fn] = calls.get(fn, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)

    for mod, names in ((cuda_c2f, ("fused_c2f", "c2f_plain", "fused_c2f_upconcat", "c2f_upconcat_plain")),
                       (cuda_head, ("fused_head_level", "head_level_plain")), (cuda_head_cm, ("head_level_cm", "head_level_cm_plain"))):
        for n in names:
            counter(mod, n)
    pm = PT.DetectionModel(name, device="cpu")
    PT.params_from_jax(pm, PT.fuse(pm.init(0)))
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    for plain in (False, True):
        pm.predict(x, plain=plain)
        pm.predict_parts(x, plain=plain)
    relu = name in ("yolov6n.yaml", "yolo_nas_s.yaml")
    assert pm._upconcat == {} and not any(k.startswith("c2f") or "upconcat" in k for k in calls)
    if relu:
        assert calls == {}
        with pytest.raises(NotImplementedError, match="SiLU only"):
            pm.predict_parts(x, head_cm=True)
        with pytest.raises(NotImplementedError, match="SiLU only"):
            FusedDetectTrack(pm, pm.init(0), frame_hw=(64, 64), chunk=2, device="cpu", pallas_head2=True)
    else:
        assert calls == {"fused_head_level": 2 * pm.head.nl, "head_level_plain": 4 * pm.head.nl}
        pm.predict_parts(x, head_cm=True)
        assert calls["head_level_cm"] == pm.head.nl


def test_jax_merged_silu_fault_is_not_copied(two_threads):
    """ROADMAP §3: JAX's `predict_parts` merges a legacy head's two first 3x3 convs and applies SiLU whatever the head's
    activation, so on yolov6n with its head's first BN biases drawn from N(0, 1) its boxes lie pixels away from its own
    `predict` (the conv walk, what `YOLO.predict` runs); the port's `predict_parts` and `predict` both give JAX's
    `predict` (boxes 1e-3 px, scores 1e-5). yolov9t (SiLU) shows no such gap in JAX."""
    rng = np.random.default_rng(0)
    for name, faulty in (("yolov6n.yaml", True), ("yolov9t.yaml", False)):
        jm, pm = JT.DetectionModel(name), PT.DetectionModel(name, device="cpu")
        tree = jax.tree_util.tree_map(np.asarray, jm.init(0))
        head = tree["model"][str(len(jm.layers) - 1)]
        for br in ("cv2", "cv3"):
            for l in range(pm.head.nl):
                bn = head[br][str(l)]["0"]["bn"]
                bn["bias"] = rng.normal(0, 1, bn["bias"].shape).astype(np.float32)
        fused = jax.tree_util.tree_map(np.asarray, jm.fuse(tree))
        x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
        want = np.asarray(jax.jit(jm.predict)(fused, jnp.asarray(x)))
        jb, _ = jax.jit(jm.predict_parts)(fused, jnp.asarray(x))
        gap = np.abs(np.asarray(jb) - want[:, :4].transpose(0, 2, 1)).max()
        assert (gap > 1.0) if faulty else (gap < 1e-3), (name, gap)
        PT.params_from_jax(pm, PT.fuse(tree))
        boxes, scores = pm.predict_parts(torch.from_numpy(x))
        np.testing.assert_allclose(boxes.numpy(), want[:, :4].transpose(0, 2, 1), rtol=0, atol=1e-3)
        np.testing.assert_allclose(scores.numpy(), want[:, 4:].transpose(0, 2, 1), rtol=0, atol=1e-5)
        np.testing.assert_allclose(pm.predict(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-3)
