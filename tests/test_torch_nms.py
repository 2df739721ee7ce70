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

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)


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


def _model_keep(boxes, scores, thr):
    """numpy model of csrc/nms.cu's algorithm: the walk cut at n = 1 + the last
    slot with score > 0, the bit matrix M in 32-bit words (bit b of word w is
    slot 32w + b) filled only right of the diagonal word, the division skipped
    where the intersection is 0 and thr >= 0, and the warp's walk: 32 slots a
    round resolved from the diagonal words, then lane l ORs the kept rows into
    its removed words l, l + 32, ..."""
    B, K, _ = boxes.shape
    thr = np.float32(thr)
    keep = np.zeros((B, K), bool)
    for b in range(B):
        s = scores[b]
        real = np.nonzero(s > 0)[0]
        n = int(real[-1]) + 1 if len(real) else 0
        Wn = (n + 31) // 32
        x1, y1, x2, y2 = (boxes[b, :n, k] for k in range(4))
        area = (x2 - x1) * (y2 - y1)
        w = np.maximum(np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None]), np.float32(0))
        h = np.maximum(np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None]), np.float32(0))
        inter = w * h
        hit = np.zeros((n, n), bool)
        divide = ~((inter == 0) & (thr >= 0))  # the kernel divides only here
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter[divide] / ((area[:, None] + area[None] - inter) + np.float32(1e-7))[divide]
        hit[divide] = iou > thr
        hit &= np.arange(n)[None] > np.arange(n)[:, None]
        bits = np.zeros((n, 32 * Wn), bool)
        bits[:, :n] = hit
        M = (bits.reshape(n, Wn, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        M[np.arange(Wn)[None] < (np.arange(n) // 32)[:, None]] = 0xDEADBEEF  # never filled: the walk must not read it
        rem = np.zeros(Wn, np.uint32)
        for c in range(Wn):
            base, rows = 32 * c, min(32, n - 32 * c)
            r = int(rem[c])
            for i in range(rows):  # the diagonal words, a test and an OR per slot
                if not (r >> i) & 1:
                    r |= int(M[base + i, c])
            kept = [i for i in range(rows) if not (r >> i) & 1]
            for lane in range(32):
                for word in range(lane, Wn, 32):
                    if word > c:
                        for i in kept:
                            rem[word] |= M[base + i, word]
            rem[c] = r
        j = np.arange(n)
        keep[b, :n] = ~((rem[j >> 5] >> (j & 31).astype(np.uint32)) & 1).astype(bool) & (s[:n] > 0)
    return keep


def _edge_case(case, K, seed=0):
    """Candidates (3, K, 4), scores (3, K) and a threshold for one named edge case."""
    rng = np.random.default_rng(seed)
    B = 3
    thr = 0.0 if case == "thr0" else 0.45
    n_valid = {"n0": 0, "nK": K}.get(case, max(K - K // 3 - 1, min(K, 1)))
    ties = case in ("ties", "thr0", "degenerate")
    boxes, scores = _sorted_candidates(rng, B, K, n_valid, ties=ties)
    if case == "n0":
        boxes = rng.uniform(0, 100, (B, K, 4)).astype(np.float32)  # real boxes, all padding scores
    if case == "equal":
        boxes[:] = np.array([10, 20, 30, 40], np.float32)
    if case == "degenerate":  # zero width, zero height, negative area, a point, among real boxes
        boxes[:, 0::4, 2] = boxes[:, 0::4, 0]
        boxes[:, 1::4, 3] = boxes[:, 1::4, 1]
        boxes[:, 2::4, 0], boxes[:, 2::4, 2] = boxes[:, 2::4, 2].copy(), boxes[:, 2::4, 0].copy()
        boxes[:, 3::8] = boxes[:, 3::8, :1]
    return boxes, scores, thr


NMS_EDGE_CASES = ["random", "n0", "nK", "ties", "equal", "thr0", "degenerate"]


@pytest.mark.parametrize("case", NMS_EDGE_CASES)
@pytest.mark.parametrize("K", [1, 31, 32, 33, 64, 1024])
def test_nms_kernel_model_matches_twin_and_pallas(K, case):
    """The kernel's algorithm, modelled in numpy, against the plain twin and the
    Pallas kernel (interpret mode) at the kernel's word edges: bit for bit."""
    boxes, scores, thr = _edge_case(case, K)
    got = _model_keep(boxes, scores, thr)
    twin = cuda_nms.nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy()
    want = np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(scores), thr, interpret=True))
    np.testing.assert_array_equal(twin, want)
    np.testing.assert_array_equal(got, want)
    if case == "n0":
        assert not got.any()
    elif case == "equal" or K == 1:
        assert got.sum() == 3  # one box per image
    elif case == "ties":
        assert 0 < got.sum() < (scores > 0).sum()  # the duplicates were suppressed


@pytest.mark.parametrize("K", [33, 1280, 1281])
def test_nms_model_matches_twin_on_edge_candidates(K):
    """The card's edge candidates (ops/cuda_nms.py::edge_candidates: crowded boxes,
    duplicates, ties, padding, an all-padding image) through the kernel's model and
    the twin, at a word's edge and at the last K of the one-launch form and the first
    of the two-launch one: bit for bit."""
    boxes, scores = cuda_nms.edge_candidates(4, K, seed=K)
    want = cuda_nms.nms_keep_plain(boxes, scores, 0.5).numpy()
    np.testing.assert_array_equal(_model_keep(boxes.numpy(), scores.numpy(), 0.5), want)
    assert not want[3].any() and 0 < want.sum() < (scores > 0).sum()


@pytest.mark.parametrize("plain", [False, True])
def test_nms_parts_at_d_max_300_matches_jax(plain):
    """max_nms = 1200, max_det = 300: the K that FusedDetectTrack(d_max=300) gives."""
    rng = np.random.default_rng(2)
    B, A, nc = 2, 1500, 2
    xy = rng.uniform(10, 600, (B, A, 2))
    wh = rng.uniform(4, 40, (B, A, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (B, A, nc)), 2).astype(np.float32)
    boxes[:, 1::9] = boxes[:, 0::9][:, : boxes[:, 1::9].shape[1]]
    kw = dict(conf_thres=0.05, iou_thres=0.45, max_det=300, max_nms=1200)
    got = non_max_suppression_parts(torch.from_numpy(boxes), torch.from_numpy(scores), plain=plain, **kw)
    want = jax_nms_parts(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    for k in ("boxes", "scores", "cls", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].any()


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("classes", [[0, 5], [5], [-1, 2], [-4, 1], [-3]])
def test_nms_parts_classes_out_of_range_match_jax(plain, classes):
    """nc = 3: ids >= nc or < -nc select nothing (JAX's scatter drops them), negative ids count from the end."""
    rng = np.random.default_rng(3)
    B, A, nc = 2, 200, 3
    xy = rng.uniform(10, 200, (B, A, 2))
    wh = rng.uniform(4, 30, (B, A, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=30, max_nms=64, classes=classes)
    got = non_max_suppression_parts(torch.from_numpy(boxes), torch.from_numpy(scores), plain=plain, **kw)
    want = jax_nms_parts(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    for k in ("boxes", "scores", "cls", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    kept = {c % nc for c in classes if -nc <= c < nc}
    assert set(got["cls"][got["valid"]].tolist()) == kept
