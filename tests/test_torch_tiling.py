"""The port's tiled inference (`yolo_tpu_torch.ops.tiling`) against the JAX package's
(`yolo_tpu.ops.tiling`), mirroring tests/test_ops.py's tiling cases: the grid and the tiles
exactly, the merge (frame coordinates, duplicates across tiles, class-awareness, the greedy
NMS on seeded boxes) exactly, and `tiled_predict` with best.npz in f32 on an IR frame whose
targets sit in tile overlaps: same boxes within 1e-3 px, conf 1e-4. The port sends the 9
tiles as one batch (padded to 16); the JAX facade's default batch of 1 sends them one by one,
which changes no result."""

import numpy as np
import pytest

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.ops import tiling as JT
from yolo_tpu_torch.ops import tiling as PT

from tests.conftest import ROOT
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


@pytest.mark.parametrize("h, w, tile, overlap", [(512, 640, 256, 0.25), (200, 320, 160, 0.25), (100, 90, 256, 0.5),
                                                 (64, 1000, 64, 0.0), (256, 320, 128, 0.25)])
def test_tile_grid_matches_jax(h, w, tile, overlap):
    grid = PT.tile_grid(h, w, tile, overlap)
    assert grid == JT.tile_grid(h, w, tile, overlap)
    t = min(tile, h, w)
    cov = np.zeros((h, w), bool)
    for y, x in grid:
        assert 0 <= y <= h - t and 0 <= x <= w - t
        cov[y : y + t, x : x + t] = True
    assert cov.all(), "tiles must cover every pixel"
    img = np.random.default_rng(0).integers(0, 255, (h, w, 3), np.uint8)
    np.testing.assert_array_equal(PT.slice_tiles(img, grid, t), JT.slice_tiles(img, grid, t))


def _planted(grid, tile):
    """One object at frame (300..320, 250..270) seen by every tile holding it, one near the origin."""
    tgt = np.array([300.0, 250.0, 320.0, 270.0])
    per_tile = []
    for y0, x0 in grid:
        dets = []
        if tgt[0] >= x0 and tgt[2] <= x0 + tile and tgt[1] >= y0 and tgt[3] <= y0 + tile:
            dets.append([tgt[0] - x0, tgt[1] - y0, tgt[2] - x0, tgt[3] - y0, 0.9, 0.0])
        if y0 == 0 and x0 == 0:
            dets.append([10, 10, 30, 30, 0.8, 0.0])
        d = np.asarray(dets, np.float32).reshape(-1, 6)
        per_tile.append((d[:, :4], d[:, 4], d[:, 5]))
    return tgt, per_tile


def test_tile_merge_matches_jax():
    grid = PT.tile_grid(512, 640, tile=256, overlap=0.25)
    assert len(grid) == 9
    tgt, per_tile = _planted(grid, 256)
    got = PT.merge_tile_detections(per_tile, grid, iou_thres=0.5)
    want = JT.merge_tile_detections(per_tile, grid, iou_thres=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.float32
    assert len(got[0]) == 2, f"duplicates not merged: {got[0]}"
    np.testing.assert_allclose(got[0][np.argmax(got[1])], tgt, atol=1e-5)
    empty = PT.merge_tile_detections([(np.zeros((0, 4)), np.zeros(0), np.zeros(0))] * len(grid), grid)
    assert [a.shape for a in empty] == [(0, 4), (0,), (0,)]


@pytest.mark.parametrize("class_aware, kept", [(True, 2), (False, 1)])
def test_tile_merge_is_class_aware_like_jax(class_aware, kept):
    b = np.array([[10.0, 10, 50, 50]], np.float32)
    per_tile = [(np.concatenate([b, b]), np.array([0.9, 0.8], np.float32), np.array([0.0, 1.0], np.float32))]
    got = PT.merge_tile_detections(per_tile, [(0, 0)], iou_thres=0.5, class_aware=class_aware)
    want = JT.merge_tile_detections(per_tile, [(0, 0)], iou_thres=0.5, class_aware=class_aware)
    assert len(got[0]) == kept
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_greedy_nms_matches_jax():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 200, (300, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (300, 2)).astype(np.float32)], -1)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    for thr in (0.1, 0.45, 0.9):
        assert PT._greedy_nms(boxes, scores, thr) == JT._greedy_nms(boxes, scores, thr)


def _ir_targets(rng, h, w, centres):
    yy, xx = np.mgrid[0:h, 0:w]
    img = 30 + rng.normal(0, 2, (h, w))
    for cx, cy in centres:
        img = img + 170 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2))
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)


def test_tiled_predict_matches_jax():
    """256x320 IR frame, tile 128, overlap 0.25 (9 tiles); targets inside one tile, in the overlap
    of two and of four: same merged boxes as JAX (f32, 1e-3 px, conf 1e-4), each target once."""
    rng = np.random.default_rng(6)
    centres = ((40, 40), (110, 60), (112, 112), (270, 200))
    img = _ir_targets(rng, 256, 320, centres)
    kw = dict(tile=128, overlap=0.25, conf=0.1, iou=0.6, compute_dtype="float32")
    py = yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")
    got = PT.tiled_predict(py, img, **kw)
    want = JT.tiled_predict(yolo_tpu.YOLO(str(WEIGHTS)), img, **kw)
    assert len(got[0]) == len(want[0]) == len(centres)
    order_g, order_w = np.argsort(got[0][:, 0]), np.argsort(want[0][:, 0])
    np.testing.assert_allclose(got[0][order_g], want[0][order_w], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1][order_g], want[1][order_w], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2][order_g], want[2][order_w])
    centre = (got[0][order_g, :2] + got[0][order_g, 2:]) / 2
    np.testing.assert_allclose(centre, sorted(centres), atol=2.0)
    assert py.predictor.args.batch == 9  # the tiles went as one batch (B = 16 on the device)
