"""SAM (ViT encoder, prompt encoder, two-way transformer, mask decoder, predictor, segment-everything, facade) of the
port against the JAX package's on the CPU.

Each module takes the JAX package's initial subtree with every leaf moved by N(0, 0.1) (so the tables JAX starts at
zero, rel_pos above all, take part), installed with `sam_params_from_jax`; inputs come from numpy seeds. The whole
predictor runs JAX's small ViT (`_build_sam(32, 2, 2, (1,), 128)`) from its init(0) tree, which the port draws
itself. Tolerances, stated again at each test: trees exact; module outputs within 1e-4 of JAX's (relative to the
output's scale, at least 1); masks equal; IoU scores 1e-4."""

import jax
import numpy as np
import pytest
import torch

from yolo_tpu.models.sam import build as JB
from yolo_tpu.models.sam import modules as JS
from yolo_tpu.models.sam.model import SAM as JaxSAM
from yolo_tpu.models.sam.predict import SAMPredictor as JaxPredictor
from yolo_tpu_torch.models.sam import build as PB
from yolo_tpu_torch.models.sam import modules as PS
from yolo_tpu_torch.models.sam.build import sam_params_from_jax
from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.models.sam.model import SAM
from yolo_tpu_torch.models.sam.predict import SAMPredictor, nms_numpy

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

TOL = 1e-4
IOU = 1e-4
IMG = 128


def jittered(tree, seed: int = 0, scale: float = 0.1):
    """The tree with every leaf moved by N(0, scale); BN running variances by |N(0, scale)| (kept positive)."""
    rng = np.random.default_rng(seed)

    def walk(t, key=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        noise = rng.normal(0, scale, a.shape).astype(np.float32)
        return a + (np.abs(noise) if key == "running_var" else noise)

    return walk(tree)


def pair(jmod, tmod, seed: int = 0):
    """JAX's module's jittered initial subtree, installed in the port's module → the tree."""
    tree = jittered(jmod.init(np.random.default_rng(seed)), seed)
    sam_params_from_jax(tmod, tree)
    return tree


def close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max() if want.size else 0.0), (what, err, np.abs(want).max())
    return err


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def same_trees(a: dict, b: dict) -> int:
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k
    return sum(np.asarray(v).size for v in fa.values())


@pytest.fixture(scope="module")
def small():
    """JAX's small ViT SAM at 128² and the port's, from init(0)."""
    jm, pm = JB._build_sam(32, 2, 2, (1,), IMG), PB._build_sam(32, 2, 2, (1,), IMG).eval()
    tree = jm.init(0)
    sam_params_from_jax(pm, pm.init(0))
    return jm, pm, tree


def awake(tree: dict, seed: int = 1) -> dict:
    """init(0)'s tree with the hypernetworks' last biases moved by N(0, 2): the init(0) masks are empty (every
    logit negative); awake, they cover part of the image, so segment-everything keeps masks."""
    p = jittered(tree, seed, 0.0)
    rng = np.random.default_rng(seed)
    for m in p["mask_decoder"]["output_hypernetworks_mlps"].values():
        m["layers"]["2"]["bias"] = rng.normal(0, 2.0, m["layers"]["2"]["bias"].shape).astype(np.float32)
    return p


# --- the blocks --------------------------------------------------------------------------------------------------


def test_window_partition_round_trip_matches_jax():
    """A 10x13 map in windows of 4 (zero pad 2 and 3): the windows and the pad equal JAX's, and the inverse gives
    the map back (exact)."""
    x = rand(2, 10, 13, 8)
    wj, pj = JS.window_partition(x, 4)
    wp, pp = PS.window_partition(t(x), 4)
    assert pj == pp
    assert np.array_equal(np.asarray(wj), wp.numpy())
    back = PS.window_unpartition(wp, 4, pp, (10, 13))
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(np.asarray(JS.window_unpartition(wj, 4, pj, (10, 13))), back.numpy())


@pytest.mark.parametrize("q,k,n", [(7, 7, 13), (7, 7, 9), (5, 5, 21), (4, 8, 15), (8, 4, 30)])
def test_get_rel_pos_matches_jax(q, k, n):
    """The table sliced to (q, k, C), resized first where its length is not 2·max(q, k) - 1: longer (antialiased
    shrink), shorter (growth), q ≠ k (1e-4; JAX's jax.image.resize(method="linear"))."""
    table = rand(n, 6, seed=n)
    close(PS.get_rel_pos(q, k, t(table)).numpy(), JS.get_rel_pos(q, k, table), what=(q, k, n))


def test_add_decomposed_rel_pos_matches_jax():
    """The decomposed relative positions on (B·nH, q_h·q_w, k_h·k_w) logits (1e-4)."""
    q_hw, k_hw = (3, 5), (4, 6)
    attn, q = rand(2, 15, 24, seed=1), rand(2, 15, 8, seed=2)
    rh, rw = rand(2 * 4 - 1, 8, seed=3), rand(2 * 6 - 1, 8, seed=4)
    want = JS.add_decomposed_rel_pos(attn, q, rh, rw, q_hw, k_hw)
    close(PS.add_decomposed_rel_pos(t(attn), t(q), t(rh), t(rw), q_hw, k_hw).numpy(), want)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_mlp_block_matches_jax(act):
    """MLPBlock with exact GELU (the ViT) or ReLU (the two-way blocks) (1e-4)."""
    jm, pm = JS.MLPBlock(16, 40, act), PS.MLPBlock(16, 40, act)
    tree = pair(jm, pm)
    x = rand(3, 5, 16)
    close(pm(t(x)).detach().numpy(), jm(tree, x))


@pytest.mark.parametrize("rel", [True, False])
def test_re_attention_matches_jax(rel):
    """Multi-head attention on a 5x5 map, with and without the decomposed relative positions (1e-4)."""
    jm, pm = JS.REAttention(16, 2, True, rel, (5, 5)), PS.REAttention(16, 2, True, rel, (5, 5))
    tree = pair(jm, pm)
    x = rand(2, 5, 5, 16)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


@pytest.mark.parametrize("window", [0, 4])
def test_vit_block_matches_jax(window):
    """A ViT block on a 10x10 map: global (rel_pos 19 long) and in 4x4 windows (a zero pad of 2) (1e-4)."""
    args = (16, 2, 4.0, True, True, window, (10, 10))
    jm, pm = JS.ViTBlock(*args), PS.ViTBlock(*args)
    tree = pair(jm, pm)
    x = rand(2, 10, 10, 16)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


def test_image_encoder_vit_matches_jax():
    """The ViT encoder at 96² (grid 6, windows of 4 and a global block, the neck's 1x1 and 3x3 with their
    LayerNorm2d), pos_embed jittered (1e-4)."""
    kw = dict(img_size=96, patch_size=16, embed_dim=32, depth=3, num_heads=2, out_chans=24, window_size=4,
              global_attn_indexes=(1,))
    jm, pm = JS.ImageEncoderViT(**kw), PS.ImageEncoderViT(**kw)
    tree = pair(jm, pm)
    x = rand(1, 96, 96, 3)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


def test_position_embedding_random_matches_jax():
    """Random-Fourier encodings of coordinates and of a 5x7 grid (1e-4)."""
    jm, pm = JS.PositionEmbeddingRandom(8), PS.PositionEmbeddingRandom(8)
    tree = pair(jm, pm)
    coords = np.random.default_rng(0).uniform(0, 1, (3, 4, 2)).astype(np.float32)
    with torch.no_grad():
        close(pm.encode(t(coords)).numpy(), jm.encode(tree, coords))
        close(pm.grid((5, 7)).numpy(), jm.grid(tree, (5, 7)))


PROMPTS = {
    "points": dict(points=True),
    "boxes": dict(boxes=True),
    "points_boxes": dict(points=True, boxes=True),
    "masks": dict(masks=True),
    "none": dict(),
}


@pytest.mark.parametrize("kind", list(PROMPTS))
def test_prompt_encoder_matches_jax(kind):
    """Sparse and dense prompt embeddings: clicks of every label (-1 to 3; the pad point without boxes), boxes,
    both, a mask through the downscaler, none (1e-4)."""
    args = (32, (8, 8), (128, 128), 16)
    jm, pm = JS.PromptEncoder(*args), PS.PromptEncoder(*args)
    tree = pair(jm, pm)
    rng = np.random.default_rng(1)
    want = PROMPTS[kind]
    pts = (rng.uniform(0, 128, (2, 5, 2)).astype(np.float32), np.array([[1, 0, -1, 2, 3], [0, 1, 1, 1, 0]], np.int64))
    boxes = np.array([[10, 12, 80, 90], [0, 0, 127, 127]], np.float32)
    masks = rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    jkw = dict(points=(pts[0], pts[1].astype(np.int32)) if "points" in want else None,
               boxes=boxes if "boxes" in want else None, masks=masks if "masks" in want else None)
    pkw = dict(points=(t(pts[0]), torch.from_numpy(pts[1])) if "points" in want else None,
               boxes=t(boxes) if "boxes" in want else None, masks=t(masks) if "masks" in want else None)
    sj, dj = jm(tree, **jkw)
    with torch.no_grad():
        sp, dp = pm(**pkw)
        close(sp.numpy(), sj, what="sparse")
        close(dp.numpy(), dj, what="dense")
        close(pm.get_dense_pe().numpy(), jm.get_dense_pe(tree), what="dense pe")


def test_sam_attention_matches_jax():
    """Attention with an inner width downsampled by 2 (1e-4)."""
    jm, pm = JS.SAMAttention(32, 4, 2), PS.SAMAttention(32, 4, 2)
    tree = pair(jm, pm)
    q, k, v = rand(2, 5, 32, seed=1), rand(2, 9, 32, seed=2), rand(2, 9, 32, seed=3)
    with torch.no_grad():
        close(pm(t(q), t(k), t(v)).numpy(), jm(tree, q, k, v))


@pytest.mark.parametrize("skip,sam2", [(True, False), (False, False), (False, True)])
def test_two_way_block_matches_jax(skip, sam2):
    """A two-way block: the first layer's form (no query PE in self-attention), a later one, SAM2's (`mlp.layers`)
    (1e-4)."""
    args = (32, 4, 64, 2, skip, sam2)
    jm, pm = JS.TwoWayAttentionBlock(*args), PS.TwoWayAttentionBlock(*args)
    tree = pair(jm, pm)
    q, k, qpe, kpe = rand(2, 5, 32, seed=1), rand(2, 16, 32, seed=2), rand(2, 5, 32, seed=3), rand(2, 16, 32, seed=4)
    qj, kj = jm(tree, q, k, qpe, kpe)
    with torch.no_grad():
        qp, kp = pm(t(q), t(k), t(qpe), t(kpe))
    close(qp.numpy(), qj, what="queries")
    close(kp.numpy(), kj, what="keys")


@pytest.mark.parametrize("sam2", [False, True])
def test_two_way_transformer_matches_jax(sam2):
    """Two blocks and the final token → image attention on a 4x4 map (1e-4)."""
    jm, pm = JS.TwoWayTransformer(2, 32, 4, 64, sam2=sam2), PS.TwoWayTransformer(2, 32, 4, 64, sam2=sam2)
    tree = pair(jm, pm)
    img, pe, pts = rand(2, 4, 4, 32, seed=1), rand(1, 4, 4, 32, seed=2), rand(2, 6, 32, seed=3)
    qj, kj = jm(tree, img, pe, pts)
    with torch.no_grad():
        qp, kp = pm(t(img), t(pe), t(pts))
    close(qp.numpy(), qj, what="queries")
    close(kp.numpy(), kj, what="keys")


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(multimask):
    """The mask decoder (its transformer at width 64, the upscaling deconvolutions, the hypernetworks, the IoU head)
    on one shared embedding and three prompt sets, multimask and single (1e-4)."""
    jm = JS.MaskDecoder(64, 3, 3, 64, JS.TwoWayTransformer(2, 64, 4, 128))
    pm = PS.MaskDecoder(64, 3, 3, 64, PS.TwoWayTransformer(2, 64, 4, 128))
    tree = pair(jm, pm)
    emb, pe = rand(1, 4, 4, 64, seed=1), rand(1, 4, 4, 64, seed=2)
    sparse, dense = rand(3, 3, 64, seed=3), rand(3, 4, 4, 64, seed=4)
    mj, ij = jm(tree, emb, pe, sparse, dense, multimask)
    with torch.no_grad():
        mp, ip = pm(t(emb), t(pe), t(sparse), t(dense), multimask)
    close(mp.numpy(), mj, what="masks")
    close(ip.numpy(), ij, what="iou")


# --- the model and its entry points ------------------------------------------------------------------------------


def test_init_tree_is_jax_and_names_are_its_paths(small):
    """The port's init(0) is JAX's tree bit for bit (the small ViT: every leaf, in JAX's order), and the model's
    state dict has exactly its paths as keys."""
    jm, pm, tree = small
    n = same_trees(pm.init(0), tree)
    assert set(pm.state_dict()) == set(flatten_tree(tree))
    assert n == PB.param_count(pm) == sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(tree))


def _preds(small, tree):
    jm, pm, _ = small
    sam_params_from_jax(pm, tree)
    return JaxPredictor(jm, tree), SAMPredictor(pm)


CALLS = {
    "point": dict(points=[[40, 40]], labels=[1]),
    "box_single": dict(bboxes=[[10, 10, 80, 80]], multimask_output=False),
    "clicks_box": dict(points=[[40, 40], [70, 20]], labels=[1, 0], bboxes=[[10, 10, 80, 80]]),
    "boxes": dict(bboxes=[[10, 10, 80, 80], [50, 30, 118, 95]], multimask_output=False),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_predictor_matches_jax(small, call):
    """`set_image` on a 96x120 BGR frame (resized, padded with raw zeros), then point / box prompts: the embedding
    within 1e-4, the masks at 96x120 equal, the IoU scores 1e-4 (JAX's counts: (3, 96, 120) and (3,) for a point,
    (1, 96, 120) for a single box), on an awake tree (masks not empty)."""
    jp, pp = _preds(small, awake(small[2]))
    img = np.random.default_rng(0).integers(0, 255, (96, 120, 3), np.uint8)
    jp.set_image(img)
    pp.set_image(img)
    close(pp.features.numpy(), jp._features, what="embedding")
    rj, rp = jp(**CALLS[call]), pp(**CALLS[call])
    assert rp.masks.data.shape == rj.masks.data.shape
    assert np.array_equal(rp.masks.data, rj.masks.data)
    close(rp.iou_scores, rj.iou_scores, IOU, "iou")
    assert 0 < rp.masks.data.mean() < 1


@pytest.mark.parametrize("stride,batch", [(4, 8), (6, 5)])
def test_generate_matches_jax(small, stride, batch):
    """Segment-everything on a 96x128 frame, a 4² grid in chunks of 8 and a 6² grid in chunks of 5 (JAX pads the
    last chunk, the port does not): the same kept masks (equal), boxes (exact) and scores (1e-4), on the awake tree;
    on init(0)'s tree both keep none (JAX's count)."""
    img = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    kw = dict(points_stride=stride, points_batch_size=batch, conf_thres=0.0, stability_score_thresh=0.0)
    jp, pp = _preds(small, small[2])
    assert len(pp.generate(img, **kw).masks) == len(jp.generate(img, **kw).masks) == 0
    jp, pp = _preds(small, awake(small[2]))
    rj, rp = jp.generate(img, **kw), pp.generate(img, **kw)
    assert len(rp.masks) == len(rj.masks) > 0
    assert np.array_equal(rp.masks.data, rj.masks.data)
    assert np.array_equal(rp.boxes.xyxy, np.asarray(rj.boxes.xyxy))
    close(rp.boxes.conf, rj.boxes.conf, IOU, "scores")


def test_generate_filters_match_jax(small):
    """Segment-everything at the default filters (conf 0.88, stability 0.95) and at looser ones (0.5, 0.8): the
    same masks as JAX's."""
    img = np.random.default_rng(2).integers(0, 255, (90, 110, 3), np.uint8)
    jp, pp = _preds(small, awake(small[2], seed=3))
    for kw in (dict(), dict(conf_thres=0.5, stability_score_thresh=0.8)):
        rj, rp = jp.generate(img, points_stride=5, points_batch_size=16, **kw), pp.generate(
            img, points_stride=5, points_batch_size=16, **kw)
        assert np.array_equal(rp.masks.data, rj.masks.data), kw


def test_nms_numpy_is_jax():
    """The port's host NMS keeps JAX's indices, in order, on 300 random boxes with ties."""
    from yolo_tpu.ops.nms import nms_numpy as jax_nms

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (300, 2))], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, 300), 2).astype(np.float32)
    for thr in (0.3, 0.7):
        assert np.array_equal(nms_numpy(boxes, scores, thr), jax_nms(boxes, scores, thr))


PUBLISHED = {"sam_b": 93_735_728, "sam_l": 312_343_088, "sam_h": 641_090_864, "mobile_sam": 9_818_564,
             "sam2_t": 38_962_737, "sam2_s": 46_060_593, "sam2_b": 80_850_417}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_info_counts_at_1024_match_jax(name):
    """`SAM(name, device="meta").info()`: JAX's `SAM(name).info()["params"]` at 1024 (the JAX package's count of
    its init(0) tree, quoted), built on the meta device: nothing drawn, nothing allocated."""
    info = SAM(name, device="meta").info()
    assert info == {"params": PUBLISHED[name], "img_size": 1024}


def test_load_torch_round_trip(small, tmp_path):
    """A seeded torch-layout state dict (the jittered tree through the port's model, `torch.save`d): the port's
    `SAM.load_torch` and JAX's give the same predictions (masks equal, IoU 1e-4) and the same leaves as the tree."""
    jm, pm, tree = small
    seeded = jittered(tree, seed=7, scale=0.05)
    sam_params_from_jax(pm, seeded)
    path = tmp_path / "sam_small.pt"
    torch.save(pm.state_dict(), path)
    sam_params_from_jax(pm, tree)
    ours = SAM.__new__(SAM)
    ours.model, ours.predictor, ours.task = pm, None, "segment"
    ours.load_torch(path)
    for k, v in flatten_tree(seeded).items():
        got = pm.state_dict()[k].numpy()
        assert np.array_equal(PB.to_torch_layout(k, v, got.shape), got), k
    theirs = JaxSAM.__new__(JaxSAM)
    theirs.model, theirs.params, theirs.predictor = jm, tree, None
    theirs.load_torch(path)
    img = np.random.default_rng(4).integers(0, 255, (80, 100, 3), np.uint8)
    rj, rp = theirs.predict(img, points=[[30, 30]]), ours.predict(img, points=[[30, 30]])
    assert np.array_equal(rp.masks.data, rj.masks.data)
    close(rp.iou_scores, rj.iou_scores, IOU, "iou")


def test_facade_refuses_as_jax_does():
    """An unknown variant raises ValueError in both packages; a SAM1 variant has no video predictor (ValueError)."""
    for cls in (JaxSAM, SAM):
        with pytest.raises(ValueError):
            cls("sam_z")
    sam = SAM("mobile_sam", img_size=64, device="cpu")
    with pytest.raises(ValueError):
        sam.video_predictor(4)
