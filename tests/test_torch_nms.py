"""The port's NMS against the JAX package: the keep mask (ops/cuda_nms plain twin on
the CPU) against the Pallas kernel in interpret mode, and the whole fixed-shape
non_max_suppression_parts (both the kernel route and the nms_fixed route)
against JAX's, with planted equal scores and duplicate boxes. The outputs must
be identical: the same f32 arithmetic, term for term."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.ops.nms import non_max_suppression_parts as jax_nms_parts
from yolo_tpu.ops.pallas_nms import pallas_nms_keep
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.nms import non_max_suppression_parts


def _sorted_candidates(rng, B, K, n_valid, ties: bool):
    boxes = np.zeros((B, K, 4), np.float32)
    scores = np.full((B, K), -1.0, np.float32)
    for b in range(B):
        centers = rng.uniform(20, 120, (n_valid, 2))
        sizes = rng.uniform(8, 40, (n_valid, 2))
        bx = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
        if ties:  # duplicate boxes and equal scores
            bx[1::7] = bx[0::7][: len(bx[1::7])]
            sc = np.round(rng.uniform(0.1, 1.0, n_valid), 1).astype(np.float32)
        else:
            sc = rng.uniform(0.05, 1.0, n_valid).astype(np.float32)
        order = np.argsort(-sc, kind="stable")
        boxes[b, :n_valid], scores[b, :n_valid] = bx[order], sc[order]
    return boxes, scores


@pytest.mark.parametrize("ties", [False, True])
def test_nms_keep_matches_pallas(ties):
    rng = np.random.default_rng(0)
    boxes, scores = _sorted_candidates(rng, B=3, K=64, n_valid=50, ties=ties)
    before = cuda_nms.nms_keep.launches
    got = cuda_nms.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45).numpy()
    assert cuda_nms.nms_keep.launches == before  # CPU tensors take the plain twin
    want = np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(scores), 0.45, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_parts_matches_jax(plain, ties):
    """Anchors-major parts (B, A, 4) xywh + (B, A, nc) scores → identical fixed outputs."""
    rng = np.random.default_rng(1)
    B, A, nc = 3, 300, 2
    xy = rng.uniform(10, 200, (B, A, 2))
    wh = rng.uniform(4, 30, (B, A, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)  # many exactly equal scores
        boxes[:, 1::5] = boxes[:, 0::5][:, : boxes[:, 1::5].shape[1]]  # duplicate boxes
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=20, max_nms=64)
    got = non_max_suppression_parts(torch.from_numpy(boxes), torch.from_numpy(scores), plain=plain, **kw)
    want = jax_nms_parts(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    for k in ("boxes", "scores", "cls", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].any()
