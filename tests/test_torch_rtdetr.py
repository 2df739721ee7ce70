"""RT-DETR in the port against the JAX package's on the CPU: the transformer pieces (MultiheadAttention with bool and
additive masks, AIFI, the bilinear grid sample, MSDeformAttn with 2- and 4-value reference points, the decoder layer),
the narrow RTDETRDecoder in eval and train form (with and without denoising queries) and its query selection on tied
invalid anchors; the five rtdetr yamls' trees, BN fold and f32 predict; the NMS-free predictor (with `augment`) and the
validator. The other entry points and the checkpoints are in tests/test_torch_rtdetr_entry.py, the backbones (HGNetV2's
modules, RepC3, TorchVision) in tests/test_torch_rtdetr_backbones.py, training in tests/test_torch_rtdetr_train.py.

Tolerances, stated again at each test: trees and folds exact; transformer pieces f32 within 1e-5 of the largest
output (at least 1e-5 absolute); the decoder's rows 1e-4, the selected anchors exact; whole-model rows paired 1e-4
(boxes, normalized) and 1e-5 (scores), the gap between the nq-th and (nq+1)-th encoder score printed and required to
exceed 3 x the two packages' largest encoder-score difference (2 x makes the selected sets agree: a near-tie fails
loudly, never hidden by a looser bound); predictor rows 1e-3 px and 1e-5 in score; metrics 1e-4. No output holds a
NaN in either package."""

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
from yolo_tpu.nn import transformer as JTr
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.nn import transformer as PTr

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures)
from tests.test_torch_pose import _same_tree
from tests.test_torch_v8_variants import _flat, _load_train, _random_bn
from tests.test_torch_yolo11_12 import _paired
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)

PIECE_TOL = 1e-5
RTDETR_YAMLS = ["rtdetr-l.yaml", "rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml", "yolov8n-rtdetr.yaml"]
IMG = 160  # 525 anchors at strides 8-32: more than the 300 queries


def _piece_close(got, want, tol=PIECE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    bound = tol * max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= bound, f"max |err| {np.abs(got - want).max()} > {bound}"


def _jitter(tree, rng, scale=0.2):
    """`tree` with N(0, scale) added to every float leaf; a BN group's running variance drawn in [0.5, 2]."""
    if isinstance(tree, dict):
        if "running_var" in tree:
            out = {k: _jitter(v, rng, scale) for k, v in tree.items() if k != "running_var"}
            return {**out, "running_var": rng.uniform(0.5, 2.0, np.shape(tree["running_var"])).astype(np.float32)}
        return {k: _jitter(v, rng, scale) for k, v in tree.items()}
    a = np.asarray(tree)
    return (a + rng.normal(0, scale, a.shape)).astype(np.float32) if a.dtype.kind == "f" else a


# --- (a) the transformer pieces -------------------------------------------------------------------------------------


def _mha_case(mask):
    def run(M, p, rng, port):
        q, k, v = (rng.normal(0, 1, (2, n, 32)).astype(np.float32) for n in (7, 9, 9))
        m = None
        if mask == "bool":
            m = rng.random((7, 9)) < 0.3
            m[:, 0] = False  # every row sees one key
        elif mask == "additive":
            m = rng.normal(0, 2, (7, 9)).astype(np.float32)
        if port:
            t = [torch.from_numpy(a) for a in (q, k, v)]
            return M.run(*t, attn_mask=None if m is None else torch.from_numpy(m))
        return M(p, *(jnp.asarray(a) for a in (q, k, v)), attn_mask=None if m is None else jnp.asarray(m))
    return lambda T: T.MultiheadAttention(32, 4), run


def _aifi_case():
    def run(M, p, rng, port):
        x = rng.normal(0, 1, (2, 5, 7, 32)).astype(np.float32)
        return M(torch.from_numpy(x)) if port else M(p, jnp.asarray(x), JM.Ctx(train=False))
    return lambda T: T.AIFI(32, 64, 4), run


def _deform_case(points):
    def run(M, p, rng, port):
        shapes = [(6, 8), (3, 4)]
        q = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
        v = rng.normal(0, 1, (2, sum(h * w for h, w in shapes), 32)).astype(np.float32)
        ref = rng.uniform(-0.1, 1.1, (2, 5, 1, points)).astype(np.float32)  # reference points past the border too
        if points == 4:
            ref[..., 2:] = rng.uniform(0.05, 0.6, (2, 5, 1, 2))
        if port:
            return M.run(torch.from_numpy(q), torch.from_numpy(ref), torch.from_numpy(v), shapes)
        return M(p, jnp.asarray(q), jnp.asarray(ref), jnp.asarray(v), shapes)
    return lambda T: T.MSDeformAttn(32, 2, 4, 3), run


def _layer_case():
    def run(M, p, rng, port):
        shapes = [(6, 8), (3, 4)]
        e = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
        ref = rng.uniform(0.1, 0.9, (2, 5, 4)).astype(np.float32)
        f = rng.normal(0, 1, (2, 60, 32)).astype(np.float32)
        qp = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
        m = np.zeros((5, 5), bool)
        m[3:, :3] = True
        if port:
            t = [torch.from_numpy(a) for a in (e, ref, f)]
            return M.run(*t, shapes, attn_mask=torch.from_numpy(m), query_pos=torch.from_numpy(qp))
        return M(p, *(jnp.asarray(a) for a in (e, ref, f)), shapes, attn_mask=jnp.asarray(m), query_pos=jnp.asarray(qp))
    return lambda T: T.DeformableTransformerDecoderLayer(32, 4, 64, 2, 3), run


PIECES = [("MHA", _mha_case(None)), ("MHA-bool-mask", _mha_case("bool")), ("MHA-additive-mask", _mha_case("additive")),
          ("AIFI", _aifi_case()), ("MSDeformAttn-2", _deform_case(2)), ("MSDeformAttn-4", _deform_case(4)),
          ("decoder-layer", _layer_case())]


@pytest.mark.parametrize("case", PIECES, ids=[c[0] for c in PIECES])
def test_transformer_piece_matches_jax(case, two_threads):
    """Each transformer piece against JAX's on N(0, 1) inputs: the initial subtree bit for bit (MSDeformAttn's ring of
    offsets and xavier draws included), then the inference form and the train form (the same weights through
    `train_leaves`) with every weight moved by N(0, 0.2) (so that the zero-initialised offset and attention weights
    count), f32 within 1e-5 of the largest output (at least 1e-5); the bool mask blocks about a third of the
    logits, the additive one shifts them by N(0, 2); MSDeformAttn's reference points reach 0.1 past the border."""
    _, (build, run) = case
    jm, pm = build(JTr), build(PTr)
    tree = jm.init(np.random.default_rng(0))
    want_t, got_t = _flat(jax.tree_util.tree_map(np.asarray, tree)), _flat(pm.init(np.random.default_rng(0)))
    assert set(got_t) == set(want_t)
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    tree = _jitter(jax.tree_util.tree_map(np.asarray, tree), np.random.default_rng(1))
    want = np.asarray(jax.jit(lambda p: run(jm, p, np.random.default_rng(2), False))(tree))
    pm.load_jax(tree, "cpu", torch.float32)
    got = run(pm, None, np.random.default_rng(2), True)
    _piece_close(got.detach().numpy(), want)
    _load_train(pm, tree)
    if isinstance(pm, PTr.AIFI):
        got = pm.forward_train(torch.from_numpy(np.random.default_rng(2).normal(0, 1, (2, 5, 7, 32)).astype(np.float32)))
        _piece_close(got.detach().numpy(), want)
    assert np.abs(want).std() > 0.1


def test_grid_sample_matches_jax_at_the_border_and_outside(two_threads):
    """The bilinear grid sample (zero padding, align_corners=False) against JAX's four-corner gather on a 5x7 map:
    points spread over [-1.4, 1.4] (a third of them outside the map), the corners ±1 exactly and points on the pixel
    centres' edge, f32 within 1e-5."""
    rng = np.random.default_rng(0)
    value = rng.normal(0, 1, (3, 5, 7, 4)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (3, 6, 5, 2)).astype(np.float32)
    grid[0, 0] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0]]
    grid[0, 1, :, 0] = -1 + 1 / 7  # the first pixel centre's column
    want = np.asarray(JTr._grid_sample_bilinear(jnp.asarray(value), jnp.asarray(grid)))
    got = PTr.grid_sample_bilinear(torch.from_numpy(value), torch.from_numpy(grid)).numpy()
    assert (np.abs(grid) > 1).any(-1).mean() > 0.2
    _piece_close(got, want)


# --- (b) the decoder head -----------------------------------------------------------------------------------------

DECODER = dict(nc=5, ch=(32, 64, 128), hd=64, nq=20, ndl=2)


def _decoder_pair(seed=0):
    jd, pd = JTr.RTDETRDecoder(**DECODER), PTr.RTDETRDecoder(**DECODER)
    tree = jd.init(np.random.default_rng(seed))
    return jd, pd, tree


def _jax_selection(jd, p, xs):
    """JAX's encoder scores (max over classes) of the decoder's inputs → (scores (B, ΣHW), the selected anchors in
    jax.lax.top_k's order), under one jit."""
    def run(p, xs):
        ctx = JM.Ctx(train=False, dtype=jnp.float32)
        feats, shapes = [], []
        for i, x in enumerate(xs):
            pp = p["input_proj"][str(i)]
            f = jd._proj[i]({"conv": pp["0"], "bn": pp["1"]}, x, ctx)
            feats.append(f.reshape(f.shape[0], -1, f.shape[-1]))
            shapes.append(f.shape[1:3])
        feats = jnp.concatenate(feats, 1)
        _, valid = jd._generate_anchors(shapes)
        features = jd.enc_output_ln(p["enc_output"]["1"], jd.enc_output_lin(p["enc_output"]["0"], valid * feats))
        scores = jd.enc_score_head(p["enc_score_head"], features).max(-1)
        return scores, jax.lax.top_k(scores, jd.nq)[1]

    scores, ind = jax.jit(run)(p, [jnp.asarray(x) for x in xs])
    return np.asarray(scores), np.asarray(ind)


def _port_selection(pd, xs):
    with torch.no_grad():
        feats, shapes = pd.encode([torch.as_tensor(np.asarray(x)) for x in xs], False)
        _, _, enc_scores, ind = pd.select(feats, shapes, False)
    return enc_scores.max(-1).values.numpy(), ind.numpy()


def _gap_check(js, ps, nq, what):
    """The gap between the nq-th and (nq+1)-th encoder score of each image against the packages' largest difference n:
    at least 3n (2n makes the selected sets agree: no score moves more than n), or the selection is a near-tie that
    rounding may flip (printed either way)."""
    noise = float(np.abs(js - ps).max())
    s = -np.sort(-js, -1)
    gap = s[:, nq - 1] - s[:, nq] if s.shape[1] > nq else np.full(len(s), np.inf)
    print(f"{what}: nq-th gap {gap} against the packages' largest encoder-score difference {noise:.3e}")
    assert (gap > 3 * noise).all(), f"{what}: a near-tie at the nq-th query: gap {gap}, noise {noise}"


@pytest.mark.parametrize("mode", ["eval", "train", "train-dn"])
def test_decoder_matches_jax(mode, two_threads):
    """The narrow decoder (nc 5, levels of 32 / 64 / 128 channels at 16², 8², 4², hd 64, nq 20, two layers) with every
    weight of its initial tree moved by N(0, 0.2): the initial tree bit for bit, the selected anchors equal (the
    nq-th gap checked), and eval rows, or the train outputs (each layer's boxes and logits, the encoder's selected
    boxes and logits; with `dn`, eight denoising queries of JAX's `make_cdn_batch` prepended under
    `cdn_attn_mask`), within 1e-4 of the largest; the input projections' BN takes the batch's moments in train form,
    as JAX's (1e-5). In eval, the decoder handed its own selection (`ind`) gives its rows bit for bit, and handed the
    selection reversed gives them reversed (1e-5: the queries interact only through attention)."""
    jd, pd, tree0 = _decoder_pair()
    _same_tree(pd.init(np.random.default_rng(0)), jax.tree_util.tree_map(np.asarray, tree0))
    tree = _jitter(jax.tree_util.tree_map(np.asarray, tree0), np.random.default_rng(1))
    rng = np.random.default_rng(2)
    xs = [rng.normal(0, 1, (2, s, s, c)).astype(np.float32) for s, c in zip((16, 8, 4), DECODER["ch"])]
    pd.load_jax(tree, "cpu", torch.float32)
    js, jsel = _jax_selection(jd, tree, xs)
    ps, psel = _port_selection(pd, xs)
    _gap_check(js, ps, DECODER["nq"], f"decoder {mode}")
    np.testing.assert_array_equal(psel, jsel)
    if mode == "eval":
        want = np.asarray(jax.jit(lambda p, xs: jd(p, xs, JM.Ctx(train=False, dtype=jnp.float32)))(tree, xs))
        got = pd([torch.from_numpy(x) for x in xs]).numpy()
        _piece_close(got, want, 1e-4)
        given = torch.from_numpy(psel)
        np.testing.assert_array_equal(pd([torch.from_numpy(x) for x in xs], ind=given).numpy(), got)
        _piece_close(pd([torch.from_numpy(x) for x in xs], ind=given.flip(1)).numpy(), got[:, ::-1], PIECE_TOL)
        return
    ctx = JM.Ctx(train=True, dtype=jnp.float32)
    dn = None
    if mode == "train-dn":
        from yolo_tpu.utils.cdn import cdn_attn_mask, make_cdn_batch

        batch = {"cls": np.array([[1, 3], [4, 0]], np.float32), "bboxes": rng.uniform(0.2, 0.5, (2, 2, 4)).astype(np.float32),
                 "mask_gt": np.array([[1, 1], [1, 0]], np.float32)}
        d = make_cdn_batch(batch, 5, num_dn=4, rng=np.random.default_rng(3))
        ctx.dn = {**{k: jnp.asarray(d[k]) for k in ("dn_cls", "dn_bbox", "dn_valid")},
                  "attn_mask": cdn_attn_mask(d["dn_num_group"], 2, DECODER["nq"])}
        dn = {k: torch.from_numpy(np.asarray(v)) for k, v in ctx.dn.items()}
    def train_fwd(p, xs):
        c = JM.Ctx(train=True, dtype=jnp.float32)
        c.dn = ctx.dn
        return jd(p, xs, c), c.stats

    want, stats = jax.jit(train_fwd)(tree, xs)
    _load_train(pd, tree)
    pd.train()
    pd.dn = dn
    got = pd.forward_train([torch.from_numpy(x) for x in xs])
    pd.dn = None
    assert got[0].shape == (2, 2, 20 + (8 if dn else 0), 4) and got[3].shape == (2, 20, 5)
    for g, w in zip(got, want):
        _piece_close(g.detach().numpy(), np.asarray(w), 1e-4)
    stats = {k.split("/")[-2]: v for k, v in stats.items()}
    for i, m in enumerate(pd.input_proj):
        mean, var, n = m.batch_stats
        jm_, jv_, jn_ = stats[str(i)]
        assert n == jn_
        _piece_close(mean.numpy(), np.asarray(jm_))
        _piece_close(var.numpy(), np.asarray(jv_))


def test_selection_ties_keep_the_earlier_index(two_threads):
    """Tied invalid anchors enter the top-k: the narrow decoder on maps of zeros at 64², 32² and 16² (every anchor of
    a level's valid ones gets one feature, the invalid border anchors of the 64² level (x or y within 0.01 of the
    border) the zeroed one, so scores tie in two groups), the score head's sign chosen so the invalid group ranks first.
    The port's selected anchors equal jax.lax.top_k's (the earlier index first among equal scores), every one of them
    an invalid anchor; the rows hold no NaN in either package (their `inf` anchors go through the sigmoid)."""
    jd, pd, tree = _decoder_pair()
    tree = jax.tree_util.tree_map(np.asarray, tree)
    xs = [np.zeros((1, s, s, c), np.float32) for s, c in zip((64, 32, 16), DECODER["ch"])]
    for sign in (1.0, -1.0):
        tree["enc_score_head"]["weight"] = sign * np.abs(tree["enc_score_head"]["weight"])
        pd.load_jax(tree, "cpu", torch.float32)
        _, valid = jd._generate_anchors([(64, 64), (32, 32), (16, 16)])
        invalid = np.where(np.asarray(valid)[0, :, 0] == 0)[0]
        js, jsel = _jax_selection(jd, tree, xs)
        ps, psel = _port_selection(pd, xs)
        if np.isin(jsel, invalid).all():
            break
    assert np.isin(jsel, invalid).all() and len(invalid) > DECODER["nq"]
    assert len(np.unique(js[0, invalid])) == 1  # one score for them all
    np.testing.assert_array_equal(psel, jsel)
    np.testing.assert_array_equal(jsel[0], invalid[: DECODER["nq"]])
    want = np.asarray(jax.jit(lambda p, xs: jd(p, xs, JM.Ctx(train=False, dtype=jnp.float32)))(tree, xs))
    got = pd([torch.from_numpy(x) for x in xs]).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    _piece_close(got, want, 1e-4)


# --- (d) the models ------------------------------------------------------------------------------------------------


def _awake(jm, tree, seed=5):
    """An initial tree with every BN's γ, β and moments drawn at random (`_random_bn`; the decoder's input projections'
    too) and the decoder's weights moved by N(0, 0.05): its features do not fade through the depth and its zero-
    initialised box layers and offsets count."""
    rng = np.random.default_rng(seed)
    tree = _random_bn(jax.tree_util.tree_map(np.asarray, tree), rng)
    head = str(len(jm.layers) - 1)
    tree["model"][head] = _jitter(tree["model"][head], rng, 0.05)
    return tree


def _model_selection(jm, jf, pm, x):
    """Both packages' encoder scores and selected anchors of the images `x` (the port's walk folds the neck)."""
    heads = list(jm.layers[-1].f)
    ctx = JM.Ctx(train=False, dtype=jnp.float32)
    _, _, col = jax.jit(lambda p, x: jm._walk(p, x, ctx, upto=len(jm.layers) - 1, collect=set(heads)))(jf, jnp.asarray(x))
    js, jsel = _jax_selection(jm.layers[-1].module, jf["model"][str(len(jm.layers) - 1)], [col[i] for i in heads])
    with torch.no_grad():
        xs, _ = pm._walk(torch.from_numpy(x), False)
    ps, psel = _port_selection(pm.head, xs)
    return js, jsel, ps, psel


def _row_pairs(got, want):
    """The row of `got` nearest each row of `want` (L1 over box and scores), each taken once: the selected anchors are
    equal, but two near-equal encoder scores may list their queries in either order (JAX's own jitted forward and a
    second JAX computation of the same scores do)."""
    free, order = np.ones(len(got), bool), []
    for w in want:
        cost = np.abs(got - w[None]).sum(-1) + 1e9 * ~free
        order.append(int(np.argmin(cost)))
        free[order[-1]] = False
    return order


@pytest.mark.parametrize("name", RTDETR_YAMLS)
def test_model_tree_fuse_and_predict_match_jax(name, two_threads):
    """Each rtdetr yaml (scale l, x; yolov8-rtdetr at n) at full width: init(0) bit for bit, the BN fold bit for bit
    against JAX's (which leaves the decoder's `input_proj` and, in rtdetr-resnet50 / 101, every ResNetLayer's
    `layer` unfolded: its generic walk finds no module under those keys), the strides; then on two seeded images at
    160² with the tree awake (`_awake`), the f32 `predict` (yolov8n-rtdetr: C2f blocks, the neck fold included, through
    the kernels' plain twins) against JAX's: the selected anchors equal (the nq-th gap checked), the rows paired (each with
    its nearest) within 1e-4 (boxes, normalized) and 1e-5 (scores), no NaN. rtdetr-x / resnet101 check the tree and fold
    only (their forwards take the file past its time)."""
    jm = JT.RTDETRDetectionModel(name)
    pm = PT.RTDETRDetectionModel(name, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jm.init(0))
    _same_tree(pm.init(0), tree)
    jf = jax.tree_util.tree_map(np.asarray, jm.fuse(tree))
    _same_tree(PT.fuse(tree), jf)
    assert pm.stride == jm.stride == [8, 16, 32] and pm.is_rtdetr
    if name in ("rtdetr-x.yaml", "rtdetr-resnet101.yaml"):
        return
    tree = _awake(jm, tree)
    jf = jax.tree_util.tree_map(np.asarray, jm.fuse(tree))
    x = np.random.default_rng(1).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.predict(p, x))(jf, jnp.asarray(x)))
    PT.params_from_jax(pm, tree)
    got = pm.predict(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 300, 84) and np.isfinite(got).all() and np.isfinite(want).all()
    js, jsel, ps, psel = _model_selection(jm, jf, pm, x)
    _gap_check(js, ps, 300, name)
    for b in range(2):
        assert set(psel[b]) == set(jsel[b])
        perm = _row_pairs(got[b], want[b])
        np.testing.assert_allclose(got[b, perm, :4], want[b, :, :4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[b, perm, 4:], want[b, :, 4:], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(JAX YOLO, port YOLO) of yolov8n-rtdetr holding the same awake tree."""
    jy, py = yolo_tpu.YOLO("yolov8n-rtdetr.yaml"), yolo_tpu_torch.RTDETR("yolov8n-rtdetr.yaml", device="cpu")
    assert type(py.model).__name__ == type(jy.model).__name__ == "RTDETRDetectionModel"
    tree = _awake(jy.model, jy.params)
    jy.params, py.params = tree, tree
    return jy, py


def _frames():
    return [np.random.default_rng(s).integers(0, 255, (IMG, IMG, 3), np.uint8) for s in (4, 5)]


def _same_results(got, want, px=1e-3, conf=1e-5):
    for g, w in zip(got, want):
        assert len(g.boxes.conf) == len(w.boxes.conf) > 0
        o = _paired(g.boxes.xyxy, w.boxes.xyxy, g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy[o], w.boxes.xyxy, rtol=0, atol=px)
        np.testing.assert_allclose(g.boxes.conf[o], w.boxes.conf, rtol=0, atol=conf)
        np.testing.assert_array_equal(g.boxes.cls[o], w.boxes.cls)


@pytest.mark.parametrize("kw", [dict(conf=0.22), dict(conf=0.005, max_det=7, classes=[2, 5, -1])], ids=["conf", "classes-max_det"])
def test_predict_matches_jax(pair, kw, two_threads):
    """`RTDETR.predict` (f32) of two seeded 160² BGR frames (the letterbox is the identity) against JAX's predictor on
    the same tree (its best scores lie in 0.15-0.24: conf 0.22 keeps about half the queries): no NMS, each query's best class among `classes` (one named from the end) over conf, the top max_det;
    the same count, rows paired by class and box 1e-3 px, 1e-5 in score; `augment=True` changes nothing, as in JAX."""
    jy, py = pair
    frames = _frames()
    want = jy.predict(frames, imgsz=IMG, compute_dtype="float32", verbose=False, **kw)
    got = py.predict(frames, imgsz=IMG, compute_dtype="float32", verbose=False, **kw)
    _same_results(got, want)
    if "max_det" in kw:
        assert all(len(r.boxes.conf) == 7 for r in got)
        assert set(np.concatenate([r.boxes.cls for r in got]).astype(int)) <= {2, 5, 79}
    again = py.predict(frames, imgsz=IMG, compute_dtype="float32", verbose=False, augment=True, **kw)
    for a, g in zip(again, got):
        np.testing.assert_array_equal(a.boxes.xyxy, g.boxes.xyxy)
    py.predictor.args.augment = False
    jy.predictor = py.predictor = None


def test_val_matches_jax(pair, tiny_dataset, two_threads):
    """`YOLO.val` (f32, imgsz 160, conf 0.001: every query whose best score passes) of the 8-image fixture against
    JAX's RTDETRValidator: precision, recall, mAP50, mAP50-95 and fitness within 1e-4."""
    jy, py = pair
    jv = JV.RTDETRValidator(args={**jy.overrides, "data": tiny_dataset, "imgsz": IMG, "plots": False, "mode": "val"})
    want = jv(model=jy.model, params=jy.params)
    got = py.val(data=tiny_dataset, imgsz=IMG, plots=False)
    assert type(py.validator).__name__ == "RTDETRValidator"
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
