"""MobileSAM (the TinyViT encoder and SAM's heads) of the port against the JAX package's on the CPU.

Each TinyViT module takes JAX's initial subtree jittered by N(0, 0.1) (BN running variances by |N(0, 0.1)|); the
whole model is `build_mobile_sam(128)` from init(0), drawn by the port itself. Tolerances, stated again at each
test: trees exact; module outputs 1e-4 of JAX's (relative to the output's scale, at least 1); masks equal; IoU
scores 1e-4."""

import jax
import numpy as np
import pytest
import torch

from yolo_tpu.models.sam import tiny_encoder as JT
from yolo_tpu.models.sam.build import build_mobile_sam as jax_build
from yolo_tpu.models.sam.model import SAM as JaxSAM
from yolo_tpu.models.sam.predict import SAMPredictor as JaxPredictor
from yolo_tpu_torch.models.sam import tiny_encoder as PT
from yolo_tpu_torch.models.sam.build import build_mobile_sam, sam_params_from_jax
from yolo_tpu_torch.models.sam.model import SAM
from yolo_tpu_torch.models.sam.predict import SAMPredictor

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_sam import IOU, awake, close, jittered, rand, same_trees, t

IMG = 128


def _conv_bn_pair(a, b, ks, groups, seed=0):
    tree = jittered(JT._conv2d_bn_init(np.random.default_rng(seed), a, b, ks, groups), seed)
    pm = PT.Conv2dBN(a, b, ks, 1, ks // 2, groups)
    sam_params_from_jax(pm, tree)
    return tree, pm


@pytest.mark.parametrize("ks,groups", [(1, 1), (3, 1), (3, 8)])
def test_conv2d_bn_matches_jax(ks, groups):
    """Conv2d_BN in eval form: 1x1, 3x3, depthwise 3x3 with running statistics (1e-4)."""
    tree, pm = _conv_bn_pair(8, 8, ks, groups)
    x = rand(2, 9, 11, 8)
    with torch.no_grad():
        close(pm(t(x)).numpy(), JT._conv2d_bn(tree, x, 1, ks // 2, groups))


def test_tiny_attention_matches_jax():
    """Windowed attention with a bias per offset (`attention_biases[:, bias_idxs]`, jittered) on 4x4 windows (1e-4)."""
    jm, pm = JT.TinyAttention(16, 8, 2, 1.0, (4, 4)), PT.TinyAttention(16, 8, 2, 1.0, (4, 4))
    tree = jittered(jm.init(np.random.default_rng(0)))
    sam_params_from_jax(pm, tree)
    x = rand(3, 16, 16)
    assert np.array_equal(pm.bias_idxs.numpy(), jm.bias_idxs)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


@pytest.mark.parametrize("res,ws", [(4, 4), (6, 4), (8, 8)])
def test_tiny_vit_block_matches_jax(res, ws):
    """A TinyViT block at a map its window covers (no partition), one it pads (6 in windows of 4) and 8 in 8 (1e-4)."""
    jm, pm = JT.TinyViTBlock(16, (res, res), 2, ws), PT.TinyViTBlock(16, (res, res), 2, ws)
    tree = jittered(jm.init(np.random.default_rng(1)), 1)
    sam_params_from_jax(pm, tree)
    x = rand(2, res * res, 16)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


@pytest.mark.parametrize("out_dim", [24, 320])
def test_patch_merging_matches_jax(out_dim):
    """PatchMerging with stride 2 (out 24) and stride 1 (out 320, as MobileSAM's last stage) (1e-4)."""
    jm, pm = JT._PatchMerging((8, 8), 16, out_dim), PT._PatchMerging((8, 8), 16, out_dim)
    tree = jittered(jm.init(np.random.default_rng(2)), 2)
    sam_params_from_jax(pm, tree)
    x = rand(2, 64, 16)
    with torch.no_grad():
        close(pm(t(x)).numpy(), jm(tree, x))


@pytest.fixture(scope="module")
def mobile():
    jm, pm = jax_build(IMG), build_mobile_sam(IMG).eval()
    tree = jm.init(0)
    return jm, pm, tree


def test_tiny_vit_init_and_forward_match_jax(mobile):
    """`build_mobile_sam(128)`'s init(0) is JAX's tree bit for bit (the neck drawn before the stages, as JAX draws
    it); the TinyViT encoder on a normalised 128² image, jittered tree (1e-4)."""
    jm, pm, tree = mobile
    same_trees(pm.init(0), tree)
    jit = jittered(tree, 5, 0.05)
    sam_params_from_jax(pm, jit)
    x = rand(1, IMG, IMG, 3)
    with torch.no_grad():
        close(pm.image_encoder(t(x)).numpy(), jax.jit(jm.image_encoder.__call__)(jit["image_encoder"], x))


CALLS = {
    "point": dict(points=[[50, 40]], labels=[1]),
    "box": dict(bboxes=[[10, 10, 80, 80]], multimask_output=False),
    "clicks": dict(points=[[50, 40], [20, 70], [90, 10]], labels=[1, 1, 0]),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_mobile_sam_predictor_matches_jax(mobile, call):
    """MobileSAM's predictor on a 90x110 BGR frame: masks equal, IoU scores 1e-4, on an awake tree (JAX's counts:
    (3, 90, 110) for a point, (1, 90, 110) for a single box)."""
    jm, pm, tree = mobile
    tree = awake(tree, seed=2)
    sam_params_from_jax(pm, tree)
    img = np.random.default_rng(0).integers(0, 255, (90, 110, 3), np.uint8)
    jp, pp = JaxPredictor(jm, tree).set_image(img), SAMPredictor(pm).set_image(img)
    rj, rp = jp(**CALLS[call]), pp(**CALLS[call])
    assert np.array_equal(rp.masks.data, rj.masks.data)
    close(rp.iou_scores, rj.iou_scores, IOU, "iou")


def test_mobile_sam_generate_matches_jax(mobile):
    """MobileSAM's segment-everything (a 5² grid in chunks of 7) keeps JAX's masks and boxes, awake tree."""
    jm, pm, tree = mobile
    tree = awake(tree, seed=4)
    sam_params_from_jax(pm, tree)
    img = np.random.default_rng(1).integers(0, 255, (96, 128, 3), np.uint8)
    kw = dict(points_stride=5, points_batch_size=7, conf_thres=0.0, stability_score_thresh=0.0)
    rj, rp = JaxPredictor(jm, tree).generate(img, **kw), SAMPredictor(pm).generate(img, **kw)
    assert len(rp.masks) == len(rj.masks) > 0
    assert np.array_equal(rp.masks.data, rj.masks.data)
    assert np.array_equal(rp.boxes.xyxy, np.asarray(rj.boxes.xyxy))


def test_mobile_sam_facade_matches_jax():
    """`SAM("mobile_sam", img_size=128, device="cpu")` against JAX's `SAM("mobile_sam", img_size=128)`: the same
    init(0) weights (no bridge), a box prompt's (1, 96, 120) mask equal, its IoU 1e-4; `info` counts equal."""
    ours, theirs = SAM("mobile_sam", img_size=IMG, device="cpu"), JaxSAM("mobile_sam", img_size=IMG)
    img = np.random.default_rng(3).integers(0, 255, (96, 120, 3), np.uint8)
    rj = theirs.predict(img, bboxes=[[10, 10, 80, 80]], multimask_output=False)
    rp = ours.predict(img, bboxes=[[10, 10, 80, 80]], multimask_output=False)
    assert rp.masks.data.shape == (1, 96, 120)
    assert np.array_equal(rp.masks.data, rj.masks.data)
    close(rp.iou_scores, rj.iou_scores, IOU, "iou")
    assert ours.info() == theirs.info()
