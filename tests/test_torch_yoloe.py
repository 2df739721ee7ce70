"""YOLOE in the port against the JAX package on the CPU: SwiGLUFFN, SAVPE, both forms of YOLOEDetect's class branch
(legacy: two 3x3 ConvBNActs; the yoloe-11 form: depth-wise 3x3 + 1x1 pairs) and YOLOESegment through each module's
initial tree, BN fold and both forms; the four yamls' trees, folds (JAX leaves SAVPE's `cv2` and `cv6` groups and the
contrastive heads' `norm` unfolded, as the port does) and predicts, a segment model's (preds, protos) included; the
text prompts (`get_tpe`), the visual prompts (`get_vpe`), `fuse_text` and the prompt-free `set_vocab` +
`predict_lrpc`; one train step of yoloe-v8n and of yoloe-11n; the close-set fine-tune's prompts.

Tolerances, stated again at each test: trees exact; module outputs 1e-4 of their largest |value|; f32 predict at 64²
within 1e-3 px for boxes and 1e-5 for scores, mask coefficients and prototypes 1e-4 of their largest; text and visual
prompt embeddings 1e-5; LRPC keep masks equal; a train step's loss and items 1e-4 relative, in f64 every gradient
1e-3 of its largest and the BN moments 1e-4, in f32 the gradient's cosine above 0.999."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu_torch.nn import open_vocab as OV
from yolo_tpu_torch.nn import tasks as PT

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v8_variants import _flat, _load_train
from tests.test_torch_world import _awake, _close, _maps, train_step_against_jax
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)

PX, SCORE, PE = 1e-3, 1e-5, 1e-5
E = 64  # the embedding width of the module cases (the models' is 512)


# --- (a) the modules ------------------------------------------------------------------------------------------


def _vp(rng, B, Q, h, w):
    return (rng.uniform(0, 1, (B, Q, h, w)) > 0.6).astype(np.float32)


MODULE_CASES = [  # (id, the module from either package's namespace, its inputs from a Generator)
    ("SwiGLUFFN", lambda M: M.SwiGLUFFN(E, E), lambda r: _maps(r, (2, 5, E))[0]),
    ("SAVPE", lambda M: M.SAVPE((16, 32, 64), 24, E), lambda r: (_maps(r, (2, 8, 12, 16), (2, 4, 6, 32), (2, 2, 3, 64)), _vp(r, 2, 3, 8, 12))),
    ("YOLOEDetect-legacy", lambda M: M.YOLOEDetect(3, E, True, (16, 32, 64), True),
     lambda r: (_maps(r, (2, 8, 10, 16), (2, 4, 5, 32), (2, 2, 3, 64)), _maps(r, (2, 3, E))[0])),
    ("YOLOEDetect-dw", lambda M: M.YOLOEDetect(3, E, True, (16, 32, 64), False),
     lambda r: (_maps(r, (2, 8, 10, 16), (2, 4, 5, 32), (2, 2, 3, 64)), _maps(r, (2, 3, E))[0])),
    ("YOLOESegment", lambda M: M.YOLOESegment(3, 8, 16, E, True, (16, 32, 64), False),
     lambda r: (_maps(r, (2, 8, 10, 16), (2, 4, 5, 32), (2, 2, 3, 64)), _maps(r, (2, 3, E))[0])),
]


def _jax_run(jm, tree, inputs, train):
    def run(tree, inputs):
        if isinstance(jm, JM.SwiGLUFFN):
            return jm(tree, inputs)
        ctx = JM.Ctx(train=train, dtype=jnp.float32)
        if isinstance(jm, JM.SAVPE):
            return jm(tree, inputs[0], inputs[1], ctx)
        ctx.guide0 = inputs[1]
        return jm(tree, inputs[0], ctx)

    return jax.jit(run)(tree, inputs)


def _port_run(pm, inputs, train):
    t = jax.tree_util.tree_map(torch.from_numpy, inputs)
    if isinstance(pm, OV.SwiGLUFFN):
        return pm.run(t, train)
    if isinstance(pm, OV.SAVPE):
        return pm.run(*t, train)
    return pm.forward_train(*t) if train else pm(*t)


def _leaves(out):
    return [np.asarray(o.detach().numpy() if isinstance(o, torch.Tensor) else o) for o in jax.tree_util.tree_leaves(out)]


@pytest.mark.parametrize("form", ["train", "fused"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(case, form, two_threads):
    """Each module against JAX's on N(0, 1) inputs (SAVPE: binary masks on the finest map): the initial subtree bit
    for bit (a YOLOE head draws Detect's own class branch first, as JAX does, then its own); the train form and the
    fused form (the BN fold bit for bit: SAVPE's `cv2` and `cv6` keep their BN in both packages) within 1e-4 of the
    largest output, on a tree whose BN moments and biases are drawn at random; a YOLOESegment gives (outputs,
    coefficients, prototypes), each held."""
    _, build, inputs = case
    jm, pm = build(JM), build(OV)
    tree = jm.init(np.random.default_rng(0))
    _same_tree(pm.init(np.random.default_rng(0)), tree)
    rng = np.random.default_rng(1)
    tree = _awake(jax.tree_util.tree_map(np.asarray, tree), rng)
    x = inputs(rng)
    if form == "train":
        want = _jax_run(jm, tree, x, True)
        _load_train(pm, tree)
        pm.train()
        got = _port_run(pm, x, True)
    else:
        fused = JT._fuse_module(jm, tree)
        _same_tree(PT.fuse(tree), jax.tree_util.tree_map(np.asarray, fused))
        if isinstance(jm, JM.SAVPE):
            assert {k.split("]")[0] for k in _flat(fused) if "'bn'" in k} == {"['cv2'", "['cv6'"}
        want = _jax_run(jm, fused, x, False)
        pm.load_jax(PT.fuse(tree), "cpu", torch.float32)
        got = _port_run(pm, x, False)
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


# --- (b) the yamls ---------------------------------------------------------------------------------------------


YAMLS = ["yoloe-v8s.yaml", "yoloe-v8s-seg.yaml", "yoloe-11s.yaml", "yoloe-11s-seg.yaml"]


def _pair(name, seed=2):
    """(JAX YOLOEModel, port YOLOEModel, their awake fused tree) of `name`, five random text prompts installed in both
    through each package's `get_tpe`."""
    jm, pm = JT.YOLOEModel(name), PT.YOLOEModel(name, device="cpu")
    tree = _awake(jax.tree_util.tree_map(np.asarray, jm.init(0)), np.random.default_rng(seed))
    txt = np.random.default_rng(seed + 1).normal(0, 1, (1, 5, 512)).astype(np.float32)
    jm.set_text_features(tree, txt)
    pm.set_text_features(tree, txt)
    fused = PT.fuse(tree)
    PT.params_from_jax(pm, fused)
    return jm, pm, fused


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_tree_fuse_and_predict_match_jax(name, two_threads):
    """At the published s width: `init(0)` leaf for leaf and bit for bit, the placeholder prompts, the BN fold bit for
    bit, the head's class-branch form (legacy on yoloe-v8, depth-wise on yoloe-11), the kernels' C2f instances (eight a
    frame on yoloe-v8s: six through kernel 1, two folded with the neck's upsample through kernel 2; none on yoloe-11s,
    whose C3k2 blocks are walked);
    then on an awake tree with five text prompts (`set_text_features` through each package's `get_tpe`: 1e-5) the f32
    predict on two seeded 64² images against JAX's `YOLOEModel.predict`: boxes 1e-3 px, scores 1e-5; a segment model's
    mask coefficients and prototypes 1e-4 of their largest."""
    jm, pm = JT.YOLOEModel(name), PT.YOLOEModel(name, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    _same_tree(pm.init(0), jp)
    np.testing.assert_array_equal(pm.cls_pe, jm.cls_pe)
    _same_tree(PT.fuse(jp), jax.tree_util.tree_map(np.asarray, jm.fuse(jp)))
    legacy = name.startswith("yoloe-v8")
    assert pm.head.legacy is legacy and isinstance(pm.head.cv3[0][0], PT.M.ConvBNAct if legacy else PT.M.Seq)
    assert pm.segment == name.endswith("-seg.yaml") and pm.task == "detect"
    inst = pm.c2f_instances(640, 640)
    assert (len(inst), sum(i[1] > 0 for i in inst)) == ((8, 2) if legacy else (0, 0))
    jm, pm, fused = _pair(name)
    np.testing.assert_allclose(pm.cls_pe, jm.cls_pe, rtol=0, atol=PE)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jm.predict)(fused, jnp.asarray(x))
    got = pm.predict(torch.from_numpy(x))
    if pm.segment:
        (w, wp), (g, gp) = want, got
        w, g, wp, gp = np.asarray(w), g.numpy(), np.asarray(wp), gp.numpy()
        np.testing.assert_allclose(g[:, 9:], w[:, 9:], rtol=0, atol=1e-4 * np.abs(w[:, 9:]).max())
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-4 * np.abs(wp).max())
        assert g.shape == (2, 4 + 5 + 32, 84) and gp.shape == (2, 16, 16, 32)
    else:
        w, g = np.asarray(want), got.numpy()
    assert g.shape[:2] == w.shape[:2] and np.ptp(w[:, 4:9]) > 0.1
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=PX)
    np.testing.assert_allclose(g[:, 4:9], w[:, 4:9], rtol=0, atol=SCORE)


def test_visual_prompts_match_jax(two_threads):
    """`get_visual_pe` of yoloe-11s (awake tree, two seeded 64² images, three prompt masks each on the 8x8 P3 grid) is
    JAX's within 1e-5, unit norm; `set_visual_pe` makes them the classes and the predict then matches JAX's (boxes
    1e-3 px, scores 1e-5), per image."""
    jm, pm, fused = _pair("yoloe-11s.yaml")
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    vp = _vp(rng, 2, 3, 8, 8)
    want = np.asarray(jax.jit(jm.get_visual_pe)(fused, jnp.asarray(x), jnp.asarray(vp)))
    got = pm.get_visual_pe(torch.from_numpy(x), torch.from_numpy(vp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PE)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    jm.set_visual_pe(want)
    pm.set_visual_pe(got)
    w, g = np.asarray(jax.jit(jm.predict)(fused, jnp.asarray(x))), pm.predict(torch.from_numpy(x)).numpy()
    assert g.shape == w.shape == (2, 7, 84) and pm.nc == 3
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=PX)
    np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=0, atol=SCORE)


class _StubTower:
    """A text model that gives fixed embeddings (the tests' stand-in for CLIP weights, as JAX's own LRPC test uses)."""

    def __init__(self, feats):
        self.feats = feats

    def encode_text(self, texts):
        assert len(texts) == len(self.feats)
        return torch.from_numpy(self.feats)


@pytest.mark.parametrize("name", ["yoloe-v8s.yaml", "yoloe-11s.yaml"])
def test_fuse_text_and_prompt_free_path_match_jax(name, two_threads):
    """`fuse_text` gives JAX's per-level (nc, c3) linears within 1e-5 of their largest; `set_vocab` (four vocabulary
    texts from a stub tower, the one-class 'object' prompt for the proposal filter) then `predict_lrpc` at conf 0.5
    (the filter drops some anchors of the first two levels, none of the last): the keep mask equal to JAX's, the kept
    anchors' boxes 1e-3 px and scores 1e-5, the names and class count the vocabulary's."""
    jm, pm, fused = _pair(name)
    rng = np.random.default_rng(6)
    vocab, obj = rng.normal(0, 1, (4, 512)).astype(np.float32), rng.normal(0, 1, (1, 1, 512)).astype(np.float32)
    hp = fused["model"][str(len(pm.layers) - 1)]
    want = jax.tree_util.tree_map(np.asarray, jm.layers[-1].module.fuse_text(hp, vocab))
    got = pm.head.fuse_text(hp, vocab)
    for k in want:
        for leaf in ("weight", "bias"):
            np.testing.assert_allclose(got[k][leaf], want[k][leaf], rtol=0, atol=1e-5 * np.abs(want[k][leaf]).max())
    jm.set_text_features(fused, obj)
    pm.set_text_features(fused, obj)
    jp = jm.set_vocab(fused, list("abcd"), text_model=type("T", (), {"encode_text": lambda self, t: vocab})())
    pp = pm.set_vocab(fused, list("abcd"), text_model=_StubTower(vocab))
    PT.params_from_jax(pm, pp)
    x = np.random.default_rng(7).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    wy, wk = jax.jit(lambda p, x: jm.predict_lrpc(p, x, conf=0.5))(jp, jnp.asarray(x))
    gy, gk = pm.predict_lrpc(torch.from_numpy(x), conf=0.5)
    wy, wk, gy, gk = np.asarray(wy), np.asarray(wk)[0], gy.numpy(), gk.numpy()[0]
    np.testing.assert_array_equal(gk, wk)
    assert 0 < wk[:80].sum() < 80 and wk[80:].all() and pm.nc == 4 and pm.names == dict(enumerate("abcd"))
    np.testing.assert_allclose(gy[0, :4, wk], wy[0, :4, wk], rtol=0, atol=PX)
    np.testing.assert_allclose(gy[0, 4:, wk], wy[0, 4:, wk], rtol=0, atol=SCORE)


@pytest.mark.parametrize("name", ["yoloe-v8n.yaml", "yoloe-11n.yaml"])
def test_train_step_matches_jax(name, two_threads, monkeypatch):
    """`tests/test_torch_world.py::train_step_against_jax` on YOLOE, both class-branch forms (yoloe-v8n's legacy
    ConvBNActs and C2f backbone, yoloe-11n's depth-wise pairs and C3k2), from init(0) with its contrastive biases at -4
    and the prompts of three random text embeddings through each package's `get_tpe`: the loss and its items 1e-4
    relative, the BN moments 1e-4, every gradient 1e-3 of its largest in f64, the f32 gradient's direction above
    0.999. The leaves whose gradient is 0 are those that must be: the biases whose per-channel shift reaches a
    train-mode BN through linear steps only (the embed convs' before the BNContrastiveHeads; in yoloe-11n's C2PSA the
    positional conv's, the projection's and the second FFN conv's BN biases), and `reprta` and `savpe`, which make
    prompts and are not in the train forward."""
    txt = np.random.default_rng(8).normal(0, 1, (1, 3, 512)).astype(np.float32)
    jm = JT.YOLOEModel(name, nc=3)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(0))
    hi = str(len(jm.layers) - 1)
    for l in range(3):
        jp["model"][hi]["cv4"][str(l)]["bias"] = np.array([-4.0], np.float32)
    jm.set_text_features(jp, txt)
    shifts = [k for k in ("/".join(str(p.key) for p in path) for path, _ in jax.tree_util.tree_leaves_with_path(jp))
              if k.endswith(("attn/pe/bn/bias", "attn/proj/bn/bias", "ffn/1/bn/bias"))]  # C2PSA's, on yoloe-11n
    null = (*(f"model/{hi}/cv3/{l}/2/bias" for l in range(3)), *shifts, f"model/{hi}/reprta/", f"model/{hi}/savpe/")

    def make_port(dtype):
        pm = PT.YOLOEModel(name, nc=3, device="cpu").to(dtype)
        pm.set_text_features(jp, txt)
        np.testing.assert_allclose(pm.cls_pe, jm.cls_pe, rtol=0, atol=PE)
        return PT.load_train_params(pm, jp)

    train_step_against_jax(jm, make_port, jp, null, monkeypatch)


def test_finetune_embeds_the_names_through_the_residual(tiny_dataset, tmp_path, two_threads):
    """A close-set fine-tune of yoloe-11n (`YOLOE.train`, one epoch at 64², f32, no validation) ends with the data's
    class named and its prompt the head's `get_tpe` of the seeded tower's embedding, with the residual's weights of the
    tree the trainer holds after resizing the head (those of the facade's nc-80 tree, kept where their shapes are):
    1e-5 of JAX's `get_tpe` of the same embedding with those weights; the checkpoint loads in both
    packages as a YOLOEModel at nc 1 with the placeholder prompts."""
    from yolo_tpu_torch.nn.text_model import build_text_model

    py = yolo_tpu_torch.YOLOE("yoloe-11n.yaml", device="cpu")
    py.train(data=tiny_dataset, epochs=1, imgsz=64, batch=4, workers=0, amp=False, plots=False, val=False,
             project=str(tmp_path), name="e")
    assert py.model.nc == 1 and py.model.names == {0: "target"}
    feats = build_text_model(device="cpu").encode_text(["target"]).numpy()[None]
    jm = JT.YOLOEModel("yoloe-11n.yaml")
    jm.set_text_features(jm.init(0), feats)
    np.testing.assert_allclose(py.model.cls_pe, jm.cls_pe, rtol=0, atol=PE)
    last = str(tmp_path / "e" / "weights" / "last.npz")
    for y in (yolo_tpu.YOLO(last), yolo_tpu_torch.YOLO(last, device="cpu")):
        assert type(y.model).__name__ == "YOLOEModel" and y.model.nc == 1
        np.testing.assert_array_equal(y.model.cls_pe, np.random.default_rng(0).normal(0, 1, (1, 1, 512)).astype(np.float32))
