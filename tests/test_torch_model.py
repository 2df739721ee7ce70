"""The port's model against the JAX package: box/anchor ops, the yolov8-small P2
graph (scale math, strides, neck fold) with bridged weights, and the .npz
loader + BN fold. f32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yolo_tpu.engine.exporter import load_npz as jax_load_npz
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.ops import anchors as janchors
from yolo_tpu.ops import boxes as jboxes
from yolo_tpu_torch import DetectionModel, fuse, load_npz, params_from_jax
from yolo_tpu_torch.ops import anchors, boxes

from tests.conftest import ROOT

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


def test_box_and_anchor_ops_match_jax():
    rng = np.random.default_rng(0)
    xywh = rng.uniform(1, 50, (5, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(boxes.xywh2xyxy(torch.from_numpy(xywh)).numpy(), jboxes.xywh2xyxy(xywh))
    a, b = jboxes.xywh2xyxy(xywh[0]), jboxes.xywh2xyxy(xywh[1])
    np.testing.assert_array_equal(boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(), jboxes.box_iou(a, b))
    shapes, strides = [(4, 6), (2, 3)], [8, 16]
    pa, ps = anchors.make_anchors(shapes, strides)
    ja, js = janchors.make_anchors(shapes, strides)
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_array_equal(ps.numpy(), js)
    dist = rng.uniform(0, 8, (2, len(ja), 4)).astype(np.float32)
    for xywh_out in (True, False):
        np.testing.assert_array_equal(
            anchors.dist2bbox(torch.from_numpy(dist), pa[None], xywh=xywh_out).numpy(),
            janchors.dist2bbox(dist, ja[None], xywh=xywh_out),
        )


def test_predict_parts_matches_jax():
    """yolov8-small P2 (scale n, 1 channel, 1 class) with JAX fuse(init(0)) weights:
    the port's forward (neck fold, plain twins on the CPU) equals the JAX
    package's predict_parts. Boxes atol 1e-3 px, scores atol 1e-5."""
    jm = JaxDetectionModel("yolov8-small.yaml", ch=1, nc=1)
    jp = jm.fuse(jm.init(0))
    model = params_from_jax(DetectionModel("yolov8-small.yaml", ch=1, nc=1, device="cpu"), jax.tree_util.tree_map(np.asarray, jp))
    assert model.stride == [4, 8, 16, 32] == jm.stride
    assert model._upconcat == {12: 6, 15: 4, 18: 2} and model._neck_skip == {10, 11, 13, 14, 16, 17}
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 96, 1)).astype(np.float32)
    got_b, got_s = model.predict_parts(torch.from_numpy(x))
    for neck_opt in (True, False):
        want_b, want_s = jm.predict_parts(jp, jnp.asarray(x), neck_opt=neck_opt)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-3)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    # the plain=True route (what the kernels are held against on the card) agrees on the CPU too
    pb, ps = model.predict_parts(torch.from_numpy(x), plain=True)
    np.testing.assert_allclose(pb.numpy(), got_b.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ps.numpy(), got_s.numpy(), rtol=0, atol=1e-5)


def test_load_npz_and_fuse_match_jax_leaf_by_leaf():
    jm, jp, jmeta = jax_load_npz(WEIGHTS)
    want = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jm.fuse(jp)))[0]
    model, params, meta = load_npz(WEIGHTS, device="cpu")
    got = dict(jax.tree_util.tree_flatten_with_path(fuse(params))[0])
    assert meta["names"] == jmeta["names"] and len(model.layers) == len(jm.layers)
    assert len(got) == len(want) == 183
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))
    # an unfused tree is folded by the bridge itself
    loaded = params_from_jax(model, params)
    np.testing.assert_array_equal(
        loaded.layers[2].cv1.weight.permute(2, 3, 1, 0).numpy(), np.asarray(jm.fuse(jp)["model"]["2"]["cv1"]["conv"]["weight"])
    )
