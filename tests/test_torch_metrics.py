"""The port's detection metrics (yolo_tpu_torch/utils/metrics.py) against the JAX
package's on seeded numpy cases: both are host numpy, so every result is held
exactly equal. Cases: several classes, tied confidences, no predictions, no
ground truth, an empty split, several predictions on one ground-truth box."""

import numpy as np
import pytest
import torch

from yolo_tpu.ops import boxes as JB
from yolo_tpu.utils import metrics as JM
from yolo_tpu_torch.ops import boxes as PB
from yolo_tpu_torch.utils import metrics as PM

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)


def _image(rng, n_gt, n_pred, nc, ties=False, stack_on=None):
    """One image: gt boxes/classes and predictions jittered around them plus strays.
    `ties` rounds confidences to 0.1 (equal scores); `stack_on` puts every prediction on that gt box."""
    xy = rng.uniform(0, 500, (n_gt, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 80, (n_gt, 2))], -1).astype(np.float32)
    gt_cls = rng.integers(0, nc, n_gt).astype(np.float32)
    src = rng.integers(0, max(n_gt, 1), n_pred) if stack_on is None else np.full(n_pred, stack_on)
    if n_gt:
        pb = gt[src] + rng.normal(0, 4, (n_pred, 4)).astype(np.float32)
        pc = np.where(rng.random(n_pred) < 0.8, gt_cls[src], rng.integers(0, nc, n_pred)).astype(np.float32)
    else:
        xy = rng.uniform(0, 500, (n_pred, 2))
        pb = np.concatenate([xy, xy + 20], -1).astype(np.float32)
        pc = rng.integers(0, nc, n_pred).astype(np.float32)
    stray = rng.random(n_pred) < 0.2
    pb[stray] += 200
    pb[:, 2:] = np.maximum(pb[:, 2:], pb[:, :2] + 1)
    conf = rng.random(n_pred).astype(np.float32)
    if ties:
        conf = np.round(conf, 1).astype(np.float32)
    return pb, conf, pc, gt, gt_cls


CASES = {  # name → per-image (n_gt, n_pred, kwargs)
    "several_classes": [(5, 9, {}), (3, 4, {}), (7, 12, {})],
    "tied_confidences": [(4, 10, dict(ties=True)), (6, 8, dict(ties=True))],
    "no_predictions": [(4, 0, {}), (2, 0, {})],
    "no_ground_truth": [(0, 5, {}), (0, 3, {})],
    "mixed_empty_images": [(3, 0, {}), (0, 4, {}), (5, 6, {}), (0, 0, {})],
    "stacked_on_one_gt": [(3, 8, dict(stack_on=1)), (2, 6, dict(stack_on=0))],
}


def _run(M, images, nc):
    metrics, cm, tps = M.DetMetrics(names={i: str(i) for i in range(nc)}), M.ConfusionMatrix(nc=nc), []
    for pb, conf, pc, gt, gt_cls in images:
        tp = M.match_predictions(pb, pc, gt, gt_cls)
        tps.append(tp)
        metrics.update(tp, conf, pc, gt_cls)
        cm.process_batch(pb, conf, pc, gt, gt_cls)
    return metrics.process(), cm.matrix, tps, metrics


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_match_jax(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    nc = 3
    images = [_image(rng, g, p, nc, **kw) for g, p, kw in CASES[case]]
    got, want = _run(PM, images, nc), _run(JM, images, nc)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    if case not in ("no_predictions", "no_ground_truth"):
        assert got[3].per_class == want[3].per_class
    if case in ("several_classes", "tied_confidences"):
        assert got[0]["mAP50"] > 0 and sum(int(tp.sum()) for tp in got[2]) > 0
    if case == "stacked_on_one_gt":  # one gt box, many predictions: at most one TP per gt and threshold
        assert all(int(tp.sum(0).max()) <= 1 for tp in got[2])


def test_empty_split_matches_jax():
    got, want = PM.DetMetrics(), JM.DetMetrics()
    assert got.process() == want.process() == {k: 0.0 for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness")}
    assert got.fitness == want.fitness == 0.0 and got.keys() == want.keys()


def test_ap_per_class_compute_ap_and_smooth_match_jax():
    rng = np.random.default_rng(7)
    n = 60
    tp = rng.random((n, 10)) < np.linspace(0.8, 0.2, 10)
    conf = np.round(rng.random(n), 2)  # ties
    pred_cls, target_cls = rng.integers(0, 4, n).astype(float), rng.integers(0, 4, 40).astype(float)
    got, want = PM.ap_per_class(tp, conf, pred_cls, target_cls), JM.ap_per_class(tp, conf, pred_cls, target_cls)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    recall, precision = np.sort(rng.random(25)), rng.random(25)
    for a, b in zip(PM.compute_ap(recall, precision), JM.compute_ap(recall, precision)):
        np.testing.assert_array_equal(a, b)
    y = rng.random(1000)
    for f in (0.05, 0.1):
        np.testing.assert_array_equal(PM.smooth(y, f), JM.smooth(y, f))


def test_match_predictions_iou_and_thresholds_match_jax():
    rng = np.random.default_rng(3)
    pb, _, pc, gt, gt_cls = _image(rng, 6, 10, 2)
    iou = JB.box_iou(gt, pb)
    thr = np.array([0.3, 0.5, 0.75])
    np.testing.assert_array_equal(PM.match_predictions_iou(pc, gt_cls, iou, thr), JM.match_predictions_iou(pc, gt_cls, iou, thr))
    np.testing.assert_array_equal(PM.match_predictions(pb, pc, gt, gt_cls, thr), JM.match_predictions(pb, pc, gt, gt_cls, thr))
    conf = rng.random(10)
    cm_p, cm_j = PM.ConfusionMatrix(2, conf=0.1, iou_thres=0.3), JM.ConfusionMatrix(2, conf=0.1, iou_thres=0.3)
    cm_p.process_batch(pb, conf, pc, gt, gt_cls)
    cm_j.process_batch(pb, conf, pc, gt, gt_cls)
    np.testing.assert_array_equal(cm_p.matrix, cm_j.matrix)


def test_rotated_boxes_raise_naming_obb():
    """Rotated (x, y, w, h, r) boxes, which raised naming the OBB task before it was ported, are matched by probiou as
    the JAX package matches them: the TP matrix of seeded overlapping boxes equals JAX's at the ten thresholds."""
    from yolo_tpu.utils.metrics import match_predictions as jax_match

    rng = np.random.default_rng(5)
    gt = np.concatenate([rng.uniform(20, 80, (6, 2)), rng.uniform(8, 30, (6, 2)), rng.uniform(0, 3, (6, 1))], -1).astype(np.float32)
    pred = (gt[[0, 1, 2, 3, 0, 4, 5, 5]] + rng.normal(0, [1.5, 1.5, 2, 2, 0.1], (8, 5))).astype(np.float32)
    gt_cls, pred_cls = rng.integers(0, 2, 6).astype(np.float32), rng.integers(0, 2, 8).astype(np.float32)
    pred_cls[:4] = gt_cls[:4]
    got, want = PM.match_predictions(pred, pred_cls, gt, gt_cls), jax_match(pred, pred_cls, gt, gt_cls)
    assert got.shape == (8, 10) and got[:, 0].sum() > 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("as_torch", [False, True])
def test_normalized_box_conversions_match_jax(as_torch):
    rng = np.random.default_rng(6)
    xywhn = rng.random((7, 4)).astype(np.float32)
    xyxy = np.asarray(JB.xywhn2xyxy(xywhn, w=640, h=512, padw=3.0, padh=-2.5), np.float32)
    arg = (lambda v: torch.from_numpy(v)) if as_torch else (lambda v: v)
    out = (lambda v: v.numpy()) if as_torch else np.asarray
    np.testing.assert_array_equal(out(PB.xywhn2xyxy(arg(xywhn), w=640, h=512, padw=3.0, padh=-2.5)), xyxy)
    for clip in (False, True):
        np.testing.assert_allclose(out(PB.xyxy2xywhn(arg(xyxy), w=640, h=512, clip=clip, eps=1e-3)),
                                   JB.xyxy2xywhn(xyxy, w=640, h=512, clip=clip, eps=1e-3), rtol=0, atol=1e-7)
    assert PB.xywhn2xyxy(xywhn[:0]).shape == (0, 4)
