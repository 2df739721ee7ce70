"""The port's model init, box helpers, task-aligned assigner and detection loss against the
JAX package: `DetectionModel.init` bit for bit and a fresh `YOLO(yaml).predict`,
`bbox_iou` in its four variants and `bbox2dist`, the assigner at tests/test_loss.py's
`_random_case` shapes and on exact ties, and `v8DetectionLoss` with its gradient with
respect to every head output against `jax.value_and_grad`. Inputs come from seeded numpy
generators; tolerances are stated at each comparison."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.ops import anchors as JAn
from yolo_tpu.ops import boxes as JB
from yolo_tpu.utils import loss as JL
from yolo_tpu.utils.tal import TaskAlignedAssigner as JaxAssigner
from yolo_tpu_torch.nn.tasks import DetectionModel
from yolo_tpu_torch.ops import anchors as PAn
from yolo_tpu_torch.ops import boxes as PB
from yolo_tpu_torch.utils import loss as PL
from yolo_tpu_torch.utils.tal import TaskAlignedAssigner

from tests.test_loss import _random_case
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cfg", ["yolov8-small.yaml", "yolov8n.yaml"])
def test_init_equals_jax_bit_for_bit(cfg, seed):
    """The same tree: the same paths (unfused `conv` / `bn` groups, HWIO), the same dtypes, the same values."""
    want, got = _leaves(JaxDetectionModel(cfg).init(seed)), _leaves(DetectionModel(cfg, device="cpu").init(seed))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w)), jax.tree_util.keystr(path)


def test_fresh_yolo_predict_matches_jax():
    """YOLO("yolov8-small.yaml") in each package holds the same seeded weights, so an f32 predict
    gives the same boxes (1e-2 px), scores (1e-4) and classes; rows compared in x1 order."""
    rng = np.random.default_rng(21)
    frame = rng.integers(0, 255, (96, 128, 3), np.uint8)
    kw = dict(conf=0.012, iou=0.7, imgsz=(96, 128), verbose=False, compute_dtype="float32", max_det=300)
    want = yolo_tpu.YOLO("yolov8-small.yaml").predict(frame, **kw)[0]
    got = yolo_tpu_torch.YOLO("yolov8-small.yaml", device="cpu").predict(frame, **kw)[0]
    assert len(got) == len(want) > 0
    g, w = (r.boxes.data[np.argsort(r.boxes.xyxy[:, 0], kind="stable")] for r in (got, want))
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
    np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(g[:, 5], w[:, 5])


def _box_pairs(rng, n, xywh):
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(0.5, 30, (n, 2))
    b = np.concatenate([xy, wh], -1) if xywh else np.concatenate([xy, xy + wh], -1)
    return b.astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False])
@pytest.mark.parametrize("variant", ["IoU", "GIoU", "DIoU", "CIoU"])
def test_bbox_iou_matches_jax(variant, xywh):
    """Aligned pairs, overlapping and apart, in both box forms: within 1e-6."""
    rng = np.random.default_rng(3)
    a, b = _box_pairs(rng, 256, xywh), _box_pairs(rng, 256, xywh)
    b[:64] = a[:64] + rng.normal(0, 1, (64, 4)).astype(np.float32) * [1, 1, 0.1, 0.1]  # near-identical pairs
    kw = {variant: True} if variant != "IoU" else {}
    want = np.asarray(JB.bbox_iou(jnp.asarray(a), jnp.asarray(b), xywh=xywh, **kw))
    got = PB.bbox_iou(torch.from_numpy(a), torch.from_numpy(b), xywh=xywh, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(4)
    anchors = rng.uniform(0, 40, (100, 2)).astype(np.float32)
    boxes = _box_pairs(rng, 100, xywh=False)
    want = np.asarray(JAn.bbox2dist(jnp.asarray(anchors), jnp.asarray(boxes), 15))
    got = PAn.bbox2dist(torch.from_numpy(anchors), torch.from_numpy(boxes), 15).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _assigner_inputs(feats, cls, boxes, mask, strides=(8, 16, 32), reg_max=16):
    """The loss's inputs to the assigner, in numpy: sigmoid scores, decoded pixel boxes,
    pixel anchors, labels, pixel xyxy ground truths (padded rows zero), their mask."""
    B = feats[0].shape[0]
    shapes = [f.shape[1:3] for f in feats]
    flat = np.concatenate([f.reshape(B, -1, f.shape[-1]) for f in feats], 1).astype(np.float64)
    anc, st = JAn.make_anchors(shapes, strides, 0.5)
    logits = flat[..., : 4 * reg_max].reshape(B, -1, 4, reg_max)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    dist = (e / e.sum(-1, keepdims=True) * np.arange(reg_max)).sum(-1)
    pd = np.concatenate([anc - dist[..., :2], anc + dist[..., 2:]], -1) * st
    scores = 1 / (1 + np.exp(-flat[..., 4 * reg_max :]))
    ih, iw = shapes[0][0] * strides[0], shapes[0][1] * strides[0]
    xy, wh = boxes[..., :2] * [iw, ih], boxes[..., 2:] * [iw, ih]
    gt = np.concatenate([xy - wh / 2, xy + wh / 2], -1) * mask[..., None]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(scores), f32(pd), f32(anc * st), cls[..., None].astype(np.int64), f32(gt), f32(mask[..., None])


def _assign_both(inputs, nc):
    want = JaxAssigner(topk=10, num_classes=nc, alpha=0.5, beta=6.0)(*(jnp.asarray(a) for a in inputs))
    got = TaskAlignedAssigner(topk=10, num_classes=nc, alpha=0.5, beta=6.0)(*(torch.from_numpy(a) for a in inputs))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("seed,n_gt", [(0, (3, 1)), (1, (3, 1)), (2, (6, 4))])
def test_assigner_matches_jax(seed, n_gt):
    """At `_random_case`'s shapes: equal labels, foreground, ground-truth indices and boxes; target scores within 1e-6."""
    feats, cls, boxes, mask, _ = _random_case(seed=seed, n_gt=n_gt)
    (tl_w, tb_w, ts_w, fg_w, idx_w), (tl_g, tb_g, ts_g, fg_g, idx_g) = _assign_both(_assigner_inputs(feats, cls, boxes, mask), 3)
    assert fg_g.any() and np.array_equal(fg_g, fg_w)
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_array_equal(tl_g, tl_w)
    np.testing.assert_array_equal(tb_g, tb_w)
    np.testing.assert_allclose(ts_g, ts_w, rtol=0, atol=1e-6)


def test_assigner_exact_ties_take_the_lowest_index():
    """An untrained head: every anchor of a level predicts the same box size and score, so a
    ground truth centred between anchors sees exactly equal metrics at several of them, more
    than topk inside it; the picks (lowest index first) equal the JAX package's."""
    B, nc, reg_max = 1, 2, 16
    feats = [np.zeros((B, h, w, 4 * reg_max + nc), np.float32) for h, w in ((8, 8), (4, 4), (2, 2))]
    for f in feats:
        f[..., 4 * reg_max :] = -2.0
    cls = np.zeros((B, 2), np.float32)
    boxes = np.array([[[0.5, 0.5, 0.6, 0.6], [0.25, 0.25, 0.2, 0.2]]], np.float32)  # centred on the grid's corners
    mask = np.ones((B, 2), np.float32)
    inputs = _assigner_inputs(feats, cls, boxes, mask)
    ja = JaxAssigner(topk=10, num_classes=nc, alpha=0.5, beta=6.0)
    in_gt = np.asarray(ja._candidates_in_gts(jnp.asarray(inputs[2]), jnp.asarray(inputs[4])))
    metric, _ = ja._box_metrics(*(jnp.asarray(a) for a in (inputs[0], inputs[1], inputs[3], inputs[4])), jnp.asarray(in_gt))
    m = np.sort(np.asarray(metric)[0, 0][in_gt[0, 0]])[::-1]
    assert len(m) > 10 and m[9] == m[10]  # the tenth pick ties with the eleventh inside the first box
    (tl_w, tb_w, ts_w, fg_w, idx_w), (tl_g, tb_g, ts_g, fg_g, idx_g) = _assign_both(inputs, nc)
    assert fg_w.any()
    np.testing.assert_array_equal(fg_g, fg_w)
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_allclose(ts_g, ts_w, rtol=0, atol=1e-6)


def test_df_loss_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(0, 2, (5, 7, 4, 16)).astype(np.float32)
    target = rng.uniform(-1, 17, (5, 7, 4)).astype(np.float32)
    want = np.asarray(JL._df_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = PL._df_loss(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class _Model:
    """What the losses read of a model: nc, the head's reg_max, the strides."""

    def __init__(self, nc, strides=(8, 16, 32)):
        self.nc, self.stride, self.head = nc, list(strides), SimpleNamespace(reg_max=16)


@pytest.mark.parametrize("seed,n_gt", [(0, (3, 1)), (1, (3, 1)), (2, (10, 4))])  # the last: topk·N beyond A
def test_detection_loss_and_gradient_match_jax(seed, n_gt):
    """The total (× batch) and the (box, cls, dfl) components within 1e-5 relative, and the gradient
    of the total with respect to every level's raw output within 1e-5 of its largest, against
    `jax.value_and_grad` of the JAX loss. With 10 ground truths topk·N exceeds the 84 anchors: the
    JAX loss then takes its all-anchor path, the port a slot table of every anchor."""
    feats, cls, boxes, mask, _ = _random_case(seed=seed, n_gt=n_gt)
    batch = {"cls": cls, "bboxes": boxes, "mask_gt": mask}
    jloss = JL.v8DetectionLoss(_Model(3), HYP)
    (jt, jc), jg = jax.value_and_grad(lambda f: jloss(f, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(
        [jnp.asarray(f) for f in feats])
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    pt, pc = PL.v8DetectionLoss(_Model(3), HYP)(tf, {k: torch.from_numpy(v) for k, v in batch.items()})
    pt.backward()
    assert float(jc[0]) > 0 and float(jc[2]) > 0  # foreground was assigned
    np.testing.assert_allclose(float(pt.detach()), float(jt), rtol=1e-5)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)
    for g, t in zip(jg, tf):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("source", ["yolov8-small.yaml", "demos/artifacts/train/weights/best.npz"])
def test_check_amp_matches_jax(source):
    """The trainer's bf16 check agrees with the JAX package's: it passes on a fresh model and refuses
    the demo's trained weights (their boxes move more than 2 px in bf16 on the 64x64 probe)."""
    from yolo_tpu.utils.checks import check_amp as jax_check_amp
    from yolo_tpu_torch.utils.checks import check_amp

    from tests.conftest import ROOT

    path = source if source.endswith(".yaml") else str(ROOT / source)
    jy, py = yolo_tpu.YOLO(path), yolo_tpu_torch.YOLO(path, device="cpu")
    assert check_amp(py.model, py.params) == jax_check_amp(jy.model, jy.params) == source.endswith(".yaml")
