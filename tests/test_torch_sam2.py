"""SAM2 (Hiera, the FPN neck, the SAM2 mask decoder, the memory stack, image prompts and video propagation) of the
port against the JAX package's on the CPU.

Modules take JAX's initial subtree jittered by N(0, 0.1). The whole model is JAX's small video configuration
(`tests/test_sam2_video.py`'s HIERA_KW, channels, IMG = 128, two memory layers) from init(0), drawn by the port
itself, awake: the background position table N(0, 0.3), as JAX's tests set it, and the object-score head's last
bias +3 (at init(0) every frame reads "no object" and the masks sit at -1024). Tolerances, stated again at each
test: trees and host tables exact; module outputs 1e-4 of JAX's (relative to the output's scale, at least 1); image
masks equal and IoU 1e-4; video logits' signs agree on ≥ 0.999 of the pixels, logits 1e-3, object scores 1e-4."""

import jax
import numpy as np
import pytest
import torch

from yolo_tpu.models.sam import memory as JMEM
from yolo_tpu.models.sam import sam2 as J2
from yolo_tpu.models.sam.model import SAM as JaxSAM
from yolo_tpu.models.sam.predict import SAMPredictor as JaxPredictor
from yolo_tpu.models.sam.video import SAM2VideoPredictor as JaxVideo
from yolo_tpu_torch.models.sam import memory as PMEM
from yolo_tpu_torch.models.sam import sam2 as P2
from yolo_tpu_torch.models.sam.build import sam_params_from_jax
from yolo_tpu_torch.models.sam.model import SAM
from yolo_tpu_torch.models.sam.predict import SAMPredictor
from yolo_tpu_torch.models.sam.video import SAM2VideoPredictor

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_sam import IOU, close, jittered, pair, rand, same_trees, t

HIERA_KW = dict(embed_dim=32, num_heads=1, stages=(1, 1, 2, 1), window_spec=(4, 2, 4, 2), global_att_blocks=(3,),
                window_pos_embed_bkg_spatial_size=(7, 7))
CHANNELS = [256, 128, 64, 32]
IMG = 128
SIGN = 0.999
LOGITS = 1e-3


# --- the image encoder ---------------------------------------------------------------------------------------------


def test_bicubic_matrix_and_pos_embed_match_jax():
    """cv2's bicubic matrix (7² → 24x30 and 8²) bit for bit, and Hiera's positional table (the interpolated
    background plus the tiled window table, both jittered) at a 32² grid (1e-4)."""
    for dst in ((24, 30), (8, 8)):
        assert np.array_equal(P2._bicubic_matrix((7, 7), dst), J2._bicubic_matrix((7, 7), dst))
    jm, pm = J2.Hiera(**HIERA_KW), P2.Hiera(**HIERA_KW)
    tree = pair(jm, pm)
    with torch.no_grad():
        close(pm._pos_embed((32, 32)).numpy(), jm._pos_embed(tree, (32, 32)))


@pytest.mark.parametrize("q_stride", [None, (2, 2)])
def test_multi_scale_attention_matches_jax(q_stride):
    """Attention on an 8x8 map, with and without the pooled query (1e-4)."""
    jm, pm = J2.MultiScaleAttention(16, 32, 2, q_stride), P2.MultiScaleAttention(16, 32, 2, q_stride)
    tree = pair(jm, pm)
    x = rand(2, 8, 8, 16)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


@pytest.mark.parametrize("dim_out,q_stride,window", [(16, None, 4), (32, (2, 2), 4), (32, None, 4), (16, None, 0)])
def test_multi_scale_block_matches_jax(dim_out, q_stride, window):
    """Hiera blocks on a 10x10 map: windowed (a pad), a stage change (proj, pooled shortcut, the halved window's
    unpartition), a width change alone, global (1e-4). A global block never pools (no builder makes one; both
    packages divide by its zero window)."""
    args = (16, dim_out, 2, 4.0, q_stride, window)
    jm, pm = J2.MultiScaleBlock(*args), P2.MultiScaleBlock(*args)
    tree = pair(jm, pm)
    x = rand(2, 10, 10, 16)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


def test_hiera_and_fpn_neck_match_jax():
    """The small Hiera's four stage maps on a normalised 128² image and the neck's fused levels (1e-4 each)."""
    jh, ph = J2.Hiera(**HIERA_KW), P2.Hiera(**HIERA_KW)
    jn, pn = J2.FpnNeck(256, CHANNELS), P2.FpnNeck(256, CHANNELS)
    th, tn = pair(jh, ph), pair(jn, pn, 1)
    x = rand(1, IMG, IMG, 3)
    fj = jax.jit(jh.__call__)(th, x)
    with torch.no_grad():
        fp = ph(t(x))
        for a, b in zip(fp, fj):
            close(a.numpy(), b, what="trunk")
        for a, b in zip(pn(fp), jax.jit(jn.__call__)(tn, fj)):
            close(a.numpy(), b, what="neck")


def _decoder():
    kw = dict(iou_prediction_use_sigmoid=True, dynamic_multimask_via_stability=True,
              use_multimask_token_for_obj_ptr=True)
    jm = J2.SAM2MaskDecoder(64, 3, transformer=J2.TwoWayTransformer(2, 64, 4, 128, sam2=True), **kw)
    pm = P2.SAM2MaskDecoder(64, 3, transformer=P2.TwoWayTransformer(2, 64, 4, 128, sam2=True), **kw)
    return jm, pm, pair(jm, pm)


@pytest.mark.parametrize("multimask", [True, False])
def test_sam2_mask_decoder_matches_jax(multimask):
    """The SAM2 decoder (object-score token, high-resolution skips, sigmoid IoU) on three prompt sets: the image
    form (masks, IoU, object logits) and the video form (the dynamic multimask via stability when single, the
    mask tokens kept for the object pointer) (1e-4)."""
    jm, pm, tree = _decoder()
    emb, pe = rand(1, 4, 4, 64, seed=1), rand(1, 4, 4, 64, seed=2)
    sparse, dense = rand(3, 3, 64, seed=3), rand(3, 4, 4, 64, seed=4)
    hr = (rand(3, 16, 16, 8, seed=5), rand(3, 8, 8, 16, seed=6))
    outs_j = jax.jit(jm.__call__, static_argnums=5)(tree, emb, pe, sparse, dense, multimask, hr)
    video_j = jax.jit(jm.forward_video, static_argnums=5)(tree, emb, pe, sparse, dense, multimask, hr)
    with torch.no_grad():
        outs_p = pm(t(emb), t(pe), t(sparse), t(dense), multimask, tuple(map(t, hr)))
        video_p = pm.forward_video(t(emb), t(pe), t(sparse), t(dense), multimask, tuple(map(t, hr)))
    for a, b in zip(outs_p + video_p, outs_j + video_j):
        close(a.numpy(), b)


def test_dynamic_multimask_picks_as_jax():
    """The stability swap on logits built to be stable for one prompt and unstable for another: the same masks and
    scores chosen (exact)."""
    jm, pm, _ = _decoder()
    rng = np.random.default_rng(0)
    masks = rng.normal(0, 1, (2, 4, 8, 8)).astype(np.float32)
    masks[0, 0] = np.where(masks[0, 0] > 0, 5.0, -5.0)  # stable: no logit within ±0.05
    ious = rng.uniform(0, 1, (2, 4)).astype(np.float32)
    mj, ij = jm._dynamic_multimask_via_stability(masks, ious)
    mp, ip = pm._dynamic_multimask_via_stability(t(masks), t(ious))
    assert np.array_equal(mp.numpy(), np.asarray(mj)) and np.array_equal(ip.numpy(), np.asarray(ij))


# --- the memory stack ----------------------------------------------------------------------------------------------


def test_positional_encodings_match_jax():
    """The sine tables (exact: the same numpy), the RoPE angles (exact), the 1-D sine embedding and the rotation
    (1e-5 absolute)."""
    assert np.array_equal(PMEM.sine_pos_embed_2d(6, 9, 64), JMEM.sine_pos_embed_2d(6, 9, 64))
    assert np.array_equal(PMEM.axial_rope_angles(32, 8, 6), JMEM.axial_rope_angles(32, 8, 6))
    pos = np.array([0.0, 0.25, 1.0, 3.0, -2.0], np.float32)
    assert np.abs(PMEM.get_1d_sine_pe(t(pos), 64).numpy() - np.asarray(JMEM.get_1d_sine_pe(pos, 64))).max() < 1e-5
    x, ang = rand(2, 3, 48, 32), JMEM.axial_rope_angles(32, 8, 6)
    assert np.abs(PMEM.apply_rotary(t(x), t(ang)).numpy() - np.asarray(JMEM.apply_rotary(x, ang))).max() < 1e-5


@pytest.mark.parametrize("cross", [False, True])
def test_rope_attention_matches_jax(cross):
    """RoPE self-attention on a 4x6 grid, and cross-attention to three memory blocks plus 8 pointer tokens left
    unrotated, with a key mask that drops a block and half the pointers (1e-4)."""
    kw = dict(kv_in_dim=16, rope_k_repeat=True) if cross else {}
    jm, pm = JMEM.RoPEAttention(32, 1, feat_hw=(4, 6), **kw), PMEM.RoPEAttention(32, 1, feat_hw=(4, 6), **kw)
    tree = pair(jm, pm)
    q = rand(2, 24, 32, seed=1)
    if not cross:
        with torch.no_grad():
            close(pm(t(q), t(q), t(q)).numpy(), jm(tree, q, q, q))
        return
    k, v = rand(2, 80, 16, seed=2), rand(2, 80, 16, seed=3)
    mask = np.ones((2, 80), bool)
    mask[0, 24:48] = False
    mask[1, 76:] = False
    want = jm(tree, q, k, v, num_k_exclude_rope=8, key_mask=mask)
    with torch.no_grad():
        close(pm(t(q), t(k), t(v), num_k_exclude_rope=8, key_mask=torch.from_numpy(mask)).numpy(), want)


def test_memory_attention_matches_jax():
    """Two memory-attention layers on a 4x6 grid against two memory blocks and 8 pointer tokens, masked (1e-4)."""
    jm, pm = JMEM.MemoryAttention(32, 2, 64, 16, (4, 6)), PMEM.MemoryAttention(32, 2, 64, 16, (4, 6))
    tree = pair(jm, pm)
    curr, cpos = rand(2, 24, 32, seed=1), rand(2, 24, 32, seed=2)
    mem, mpos = rand(2, 56, 16, seed=3), rand(2, 56, 16, seed=4)
    mask = np.ones((2, 56), bool)
    mask[1, 24:48] = False
    want = jm(tree, curr, mem, cpos, mpos, num_obj_ptr_tokens=8, key_mask=mask)
    with torch.no_grad():
        got = pm(t(curr), t(mem), t(cpos), t(mpos), num_obj_ptr_tokens=8, key_mask=torch.from_numpy(mask))
    close(got.numpy(), want)


def test_mask_downsampler_cx_block_memory_encoder_match_jax():
    """The stride-16 mask embedder on a 64² mask, a ConvNeXt block, and the memory encoder (features and sine
    positions) on a 4x4 map (1e-4)."""
    jd, pd = JMEM.MaskDownSampler(32), PMEM.MaskDownSampler(32)
    jc, pc = JMEM.CXBlock(32), PMEM.CXBlock(32)
    je, pe = JMEM.MemoryEncoder(16, 32), PMEM.MemoryEncoder(16, 32)
    td, tc, te = pair(jd, pd), pair(jc, pc, 1), pair(je, pe, 2)
    m, x = rand(2, 64, 64, 1), rand(2, 4, 4, 32, seed=1)
    with torch.no_grad():
        close(pd(t(m)).numpy(), jd(td, m), what="downsampler")
        close(pc(t(x)).numpy(), jc(tc, x), what="cx block")
        for a, b in zip(pe(t(x), t(m)), jax.jit(je.__call__)(te, x, m)):
            close(a.numpy(), b, what="memory encoder")


# --- the model -----------------------------------------------------------------------------------------------------


def awake2(tree: dict) -> dict:
    """init(0)'s tree with the background table N(0, 0.3) (as JAX's tests set it) and the object-score head's last
    bias +3 (at init(0) its logit is below 0 on every frame: every mask would read NO_OBJ_SCORE)."""
    p = jittered(tree, 0, 0.0)
    p["image_encoder"]["trunk"]["pos_embed"] = np.random.default_rng(5).normal(
        0, 0.3, p["image_encoder"]["trunk"]["pos_embed"].shape).astype(np.float32)
    p["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] += 3.0
    return p


@pytest.fixture(scope="module")
def small2():
    jm = J2.SAM2Model(J2.Hiera(**HIERA_KW), J2.FpnNeck(256, CHANNELS), img_size=IMG, memory_layers=2)
    pm = P2.SAM2Model(P2.Hiera(**HIERA_KW), P2.FpnNeck(256, CHANNELS), img_size=IMG, memory_layers=2).eval()
    tree = jm.init(0)
    same_trees(pm.init(0), tree)
    tree = awake2(tree)
    sam_params_from_jax(pm, tree)
    return jm, pm, tree


CALLS = {
    "point": dict(points=[[40, 40]], labels=[1]),
    "box": dict(bboxes=[[10, 10, 80, 80]], multimask_output=False),
    "clicks_box": dict(points=[[40, 40], [70, 60]], labels=[1, 0], bboxes=[[10, 10, 90, 80]]),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_sam2_image_prompts_match_jax(small2, call):
    """SAM2's image path through the shared predictor on a 96x120 frame: the embedding and both skips 1e-4, masks
    equal, IoU 1e-4 (JAX's count: (3, 96, 120) for a point)."""
    jm, pm, tree = small2
    img = np.random.default_rng(0).integers(0, 255, (96, 120, 3), np.uint8)
    jp, pp = JaxPredictor(jm, tree).set_image(img), SAMPredictor(pm).set_image(img)
    close(pp.features[0].numpy(), jp._features[0], what="embed")
    for a, b in zip(pp.features[1], jp._features[1]):
        close(a.numpy(), b, what="skip")
    rj, rp = jp(**CALLS[call]), pp(**CALLS[call])
    assert np.array_equal(rp.masks.data, rj.masks.data)
    close(rp.iou_scores, rj.iou_scores, IOU, "iou")


def _clip(T=8, seed=3):
    """A seeded noise background with a bright square moving 6 px a frame (JAX's tests' clip)."""
    base = np.random.default_rng(seed).uniform(0, 255, (IMG, IMG, 3)).astype(np.float32)
    frames = np.repeat(base[None], T, 0)
    for f in range(T):
        c = 30 + 6 * f
        frames[f, c - 12 : c + 12, c - 12 : c + 12] = 250.0
    return frames


def _agree(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    agree = ((got > 0) == (want > 0)).mean()
    assert agree >= SIGN, (what, agree)
    close(got, want, LOGITS, what)
    return agree


PROMPTS = {"click": dict(points=[[30, 30]], labels=[1]), "box": dict(box=[[14, 14, 46, 46]]),
           "box_clicks": dict(box=[[14, 14, 46, 46]], points=[[30, 30], [60, 90]], labels=[1, 0])}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_video_propagation_matches_jax(small2, prompt, reverse):
    """Prompt frame 0 (a click; a box as corners 2 / 3; a box and two clicks, single mask), then track 7 frames
    forward, or the clip reversed with `reverse=True`: every frame's (1, 128, 128) logits agree in sign on ≥ 0.999
    of the pixels and within 1e-3, object scores 1e-4; the masks are not empty."""
    jm, pm, tree = small2
    clip = _clip()[::-1] if reverse else _clip()
    jv, pv = JaxVideo(jm, tree, num_frames=len(clip), reverse=reverse), SAM2VideoPredictor(pm, len(clip), reverse)
    mj, sj = jv.add_prompt(clip[0], **PROMPTS[prompt])
    mp, sp = pv.add_prompt(clip[0], **PROMPTS[prompt])
    assert mp.shape == (1, IMG, IMG) and sp.shape == (1, 1)
    _agree(mp, mj, "prompt frame")
    close(sp, sj, IOU, "score")
    Mj, Sj = jv.propagate(clip[1:])
    Mp, Sp = pv.propagate(clip[1:])
    assert Mp.shape == (7, 1, IMG, IMG) and Sp.shape == (7, 1, 1)
    for f in range(7):
        _agree(Mp[f], Mj[f], f"frame {f + 1}")
    close(Sp, Sj, IOU, "scores")
    assert 0 < (Mp > 0).mean() < 1


def test_sam2_refuses_as_jax_does(small2):
    """SAM2 has no segment-everything (NotImplementedError in both); a video frame not at img_size fails in both
    (JAX in Hiera's table, the port with ValueError); tracking before a prompt raises."""
    jm, pm, tree = small2
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(NotImplementedError):
        JaxPredictor(jm, tree).generate(img, points_stride=2)
    with pytest.raises(NotImplementedError):
        SAMPredictor(pm).generate(img, points_stride=2)
    frame = np.zeros((96, 120, 3), np.float32)
    with pytest.raises(Exception):
        JaxVideo(jm, tree, num_frames=4).add_prompt(frame, points=[[30, 30]], labels=[1])
    with pytest.raises(ValueError, match="video frames must be 128x128"):
        SAM2VideoPredictor(pm, 4).add_prompt(frame, points=[[30, 30]], labels=[1])
    with pytest.raises(RuntimeError):
        SAM2VideoPredictor(pm, 4).track(np.zeros((IMG, IMG, 3), np.float32))


def test_sam2_t_facade_matches_jax():
    """`SAM("sam2_t", img_size=128, device="cpu")` against JAX's: init(0) without a bridge, a point's (3, 96, 120)
    masks equal and IoU 1e-4; `video_predictor(4)`: add_prompt (1, 128, 128) and (1, 1), propagate of 3 frames
    (3, 1, 128, 128) and (3, 1, 1), signs ≥ 0.999 of JAX's."""
    ours, theirs = SAM("sam2_t", img_size=IMG, device="cpu"), JaxSAM("sam2_t", img_size=IMG)
    img = np.random.default_rng(1).integers(0, 255, (96, 120, 3), np.uint8)
    rj, rp = theirs.predict(img, points=[[40, 40]]), ours.predict(img, points=[[40, 40]])
    assert rp.masks.data.shape == (3, 96, 120)
    assert np.array_equal(rp.masks.data, rj.masks.data)
    close(rp.iou_scores, rj.iou_scores, IOU, "iou")
    clip = _clip(4)
    vj, vp = theirs.video_predictor(4), ours.video_predictor(4)
    mj, sj = vj.add_prompt(clip[0], points=[[30, 30]], labels=[1])
    mp, sp = vp.add_prompt(clip[0], points=[[30, 30]], labels=[1])
    assert mp.shape == (1, IMG, IMG) and sp.shape == (1, 1)
    Mj, _ = vj.propagate(clip[1:])
    Mp, Sp = vp.propagate(clip[1:])
    assert Mp.shape == (3, 1, IMG, IMG) and Sp.shape == (3, 1, 1)
    assert ((Mp > 0) == (Mj > 0)).mean() >= SIGN
