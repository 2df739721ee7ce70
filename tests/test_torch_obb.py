"""The obb task of the port (yolov8n-obb) against the JAX package's on the CPU: the rotated box ops (probiou, the corner
conversions, dist2rbox), OBBModel's initial tree, routing and forward, the rotated NMS, the predictor's oriented boxes,
OBBoxes and the Results obb API, the checkpoints, DOTA rows with their cache and collate, every augmentation with its
corners, the rotated assigner, v8OBBLoss on both of JAX's routes, OBBValidator, the trainer on a seeded rotated split,
YOLO.track with oriented boxes, and the left-out entry points. Inputs come from seeded numpy generators; the JAX side
runs as its own tests run it (jitted, on the CPU); the port runs the kernels' plain twins, as it does on a CPU tensor.

Tolerances, stated again at each test: initial trees, labels, augmentations, the collate, the assigner's choices and
NMS indices exact; the box ops 1e-6 (1e-5 for probiou's log / sqrt terms); f32 boxes 1e-2 px (the forward 1e-3), angles
and scores 1e-4 (the forward 1e-5); bf16 forward boxes 0.5 px, angles and scores 5e-3; loss items 1e-5 relative, the
loss's gradients 1e-6 of each box or class tensor's largest and 5e-5 of each angle tensor's largest (probiou's log and
square roots reach the angle through sin and cos: single elements differ by 1e-5 of themselves); validator keys 1e-4;
trained losses and metrics 1e-3."""

import copy
import csv
import math
import random
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.cfg import get_cfg as jax_get_cfg
from yolo_tpu.data import augment as JA
from yolo_tpu.data import dataset as JD
from yolo_tpu.nn import tasks as JT
from yolo_tpu.ops import anchors as JAnc
from yolo_tpu.ops import boxes as JB
from yolo_tpu.ops.nms import non_max_suppression_rotated as jax_nms_rotated
from yolo_tpu.utils.loss import v8OBBLoss as JaxOBBLoss
from yolo_tpu.utils.tal import RotatedTaskAlignedAssigner as JaxRotatedAssigner
from yolo_tpu_torch import cfg as PC
from yolo_tpu_torch.data import augment as PA
from yolo_tpu_torch.data import dataset as PD
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.ops import anchors as PAnc
from yolo_tpu_torch.ops import boxes as PB
from yolo_tpu_torch.ops.nms import non_max_suppression_rotated
from yolo_tpu_torch.utils.loss import v8OBBLoss
from yolo_tpu_torch.utils.tal import RotatedTaskAlignedAssigner

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)

HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
OBB_KEYS = ("cls", "bboxes", "mask_gt")


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _same_tree(got, want, exact=True):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]) if exact else np.allclose(got[k], want[k], atol=0), k


def _obb_cfg(loader, nc) -> dict:
    d = dict(loader("yolov8n-obb.yaml"))
    d["nc"] = nc
    return d


def _models(nc=2):
    """The JAX and the port OBBModel of yolov8n-obb at `nc`."""
    return JT.OBBModel(_obb_cfg(JT.yaml_model_load, nc)), PT.OBBModel(_obb_cfg(PT.yaml_model_load, nc), device="cpu")


def _tuned(params, nc):
    """init(0)'s tree with the head's last convs set so that an untrained model finds bright targets: box bins 1 and 2
    raised (boxes of about 3 strides), class logits near 0, angle logits 0.3 (an angle near 0.07π), the random weights
    of those convs scaled down but kept (varied outputs)."""
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    head = p["model"]["22"]
    for l in range(3):
        box, cls, ang = head["cv2"][str(l)]["2"], head["cv3"][str(l)]["2"], head["cv4"][str(l)]["2"]
        for conv in (box, cls, ang):
            conv["weight"] *= 0.05
        box["bias"] = np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
        cls["bias"] = np.zeros(nc, np.float32)
        ang["bias"] = np.full(1, 0.3, np.float32)
    return p


def _rect(rng, w, h, aspect=(2.0, 6.0), length=(0.25, 0.5)):
    """A rotated rectangle inside a w x h frame: (cx, cy, long side, short side, angle in radians)."""
    L = rng.uniform(*length) * min(w, h)
    S = L / rng.uniform(*aspect)
    a = rng.uniform(0, math.pi)
    r = 0.5 * math.hypot(L, S)
    return rng.uniform(r, w - r), rng.uniform(r, h - r), L, S, a


def _draw(img, rect, value):
    pts = cv2.boxPoints(((rect[0], rect[1]), (rect[2], rect[3]), math.degrees(rect[4])))
    cv2.fillPoly(img, [np.round(pts).astype(np.int32)], float(value))
    return pts


def _write_obb_split(root, n, seed, w=64, h=64, split="val", nc=2, aspect=(2.0, 6.0)):
    """n seeded IR-like frames with 1-3 bright rotated rectangles each and their DOTA rows (cls, four normalized corners)
    → the dataset yaml."""
    rng = np.random.default_rng(seed)
    for d in (f"images/{split}", f"labels/{split}"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            pts = _draw(img, _rect(rng, w, h, aspect), rng.uniform(150, 230))
            lines.append(f"{int(rng.integers(0, nc))} " + " ".join(f"{v:.6f}" for v in (pts / [w, h]).ravel()))
        cv2.imwrite(str(root / f"images/{split}/{i}.png"), cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    names = "".join(f"  {c}: c{c}\n" for c in range(nc))
    (root / "data.yaml").write_text(f"path: {root}\n{split}: images/{split}\nnames:\n{names}")
    return str(root / "data.yaml")


# --- (a) the rotated box ops ------------------------------------------------------------------------------------


def _rboxes(rng, n):
    return np.concatenate([rng.uniform(0, 100, (n, 2)), rng.uniform(2, 40, (n, 2)), rng.uniform(-1, 2.5, (n, 1))], -1).astype(np.float32)


def test_rotated_box_ops_match_jax():
    """probiou (plain and with the CIoU flag, numpy and torch), xywhr2xyxyxyxy (numpy and torch), xyxyxyxy2xywhr (cv2,
    angle in (0, π/2]) and dist2rbox on seeded boxes against JAX's: corners and the decode within 1e-6 (1e-4 px), probiou
    within 1e-5 (its log and square roots), the CIoU weight held out of torch's gradient."""
    rng = np.random.default_rng(0)
    a, b = _rboxes(rng, 40), _rboxes(rng, 30)
    b[:5] = a[:5] + rng.normal(0, 1, (5, 5)).astype(np.float32)  # overlapping pairs
    for ciou in (False, True):
        want = np.asarray(JB.probiou(jnp.asarray(a[:, None]), jnp.asarray(b[None]), CIoU=ciou))
        got_np = PB.probiou(a[:, None], b[None], CIoU=ciou)
        got_t = PB.probiou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None], CIoU=ciou).numpy()
        assert got_np.shape == got_t.shape == want.shape == (40, 30, 1) and want.max() > 0.5
        np.testing.assert_allclose(got_np, np.asarray(JB.probiou(a[:, None], b[None], CIoU=ciou)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_t, want, rtol=0, atol=1e-5)
    ta = torch.from_numpy(a[:5]).requires_grad_()
    PB.probiou(ta, torch.from_numpy(b[:5]), CIoU=True).sum().backward()
    ja = jax.grad(lambda x: JB.probiou(x, jnp.asarray(b[:5]), CIoU=True).sum())(jnp.asarray(a[:5]))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=0, atol=1e-5 * np.abs(np.asarray(ja)).max())
    want = np.asarray(JB.xywhr2xyxyxyxy(jnp.asarray(a)))
    np.testing.assert_allclose(PB.xywhr2xyxyxyxy(a), JB.xywhr2xyxyxyxy(a), rtol=0, atol=1e-4)
    np.testing.assert_allclose(PB.xywhr2xyxyxyxy(torch.from_numpy(a)).numpy(), want, rtol=0, atol=1e-4)
    got, want = PB.xyxyxyxy2xywhr(want.reshape(-1, 8)), JB.xyxyxyxy2xywhr(want.reshape(-1, 8))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got[:, 4] > 0).all() and (got[:, 4] <= math.pi / 2 + 1e-6).all()
    dist = rng.uniform(0, 15, (2, 50, 4)).astype(np.float32)
    ang = rng.uniform(-0.8, 2.4, (2, 50, 1)).astype(np.float32)
    anc = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    want = np.asarray(JAnc.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anc)[None]))
    got = PAnc.dist2rbox(torch.from_numpy(dist), torch.from_numpy(ang), torch.from_numpy(anc)[None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- (b) the model --------------------------------------------------------------------------------------------


def test_obb_model_init_and_routing_match_jax():
    """OBBModel("yolov8n-obb.yaml").init(0) is the JAX package's tree bit for bit (3,239,651 values at nc 80; the angle
    branch c4 16 to ne 1); YOLO("yolov8n-obb.yaml") is an obb model; the task helpers route `-obb` yamls and OBB heads as
    JAX's do; at nc 15 (DOTAv1's classes) the trees agree too."""
    pm, jm = PT.OBBModel("yolov8n-obb.yaml", device="cpu"), JT.OBBModel("yolov8n-obb.yaml")
    _same_tree(pm.init(0), jm.init(0))
    assert PT.param_count(pm.init(0)) == jm.param_count(jm.init(0)) == 3_239_651
    assert (pm.head.ne, pm.head.cv4[0][0].c2, pm.stride, pm.nc) == (1, 16, [8, 16, 32], 80)
    py = yolo_tpu_torch.YOLO("yolov8n-obb.yaml", device="cpu")
    assert py.task == "obb" and isinstance(py.model, PT.OBBModel)
    d = JT.yaml_model_load("yolov8n-obb.yaml")
    assert PT.model_class_for(d) is PT.OBBModel and PT.guess_model_task(d) == JT.guess_model_task(d) == "obb"
    jm15, pm15 = _models(15)
    _same_tree(pm15.init(0), jm15.init(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_obb_forward_matches_jax(dtype, two_threads):
    """yolov8n-obb (nc 2, the tuned tree through `params_from_jax`) on two seeded 64x64 images: predictions (2, 4 + 2 + 1,
    84), the neck folded and not, against JAX's `OBBModel.predict`. f32: boxes within 1e-3 px, scores and angles 1e-5;
    bf16: boxes 0.5 px, scores and angles 5e-3."""
    jm, pm = _models(2)
    params = _tuned(jm.init(0), 2)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(lambda p, v: jm.predict(p, v, dtype=jdt))(params, jnp.asarray(x)), np.float32)
    PT.params_from_jax(pm, params, tdt)
    big, small = (1e-3, 1e-5) if dtype == "float32" else (0.5, 5e-3)
    for neck_opt in (True, False):
        got = pm.predict(torch.from_numpy(x).to(tdt), neck_opt=neck_opt)
        assert got.dtype == torch.float32 and got.shape == (2, 7, 84)
        got = got.numpy()
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=big)
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0, atol=small)


# --- (c) the rotated NMS -----------------------------------------------------------------------------------------


def _obb_preds(rng, B=3, nc=2, A=700, spread=30):
    """(B, 4 + nc + 1, A) predictions packed into a small area (so suppression happens), 40 anchors with equal scores."""
    sc = rng.uniform(0, 1, (B, nc, A)) ** 3
    sc[:, :, 100:140] = 0.7  # ties
    return np.concatenate([rng.uniform(20, 20 + spread, (B, 2, A)), rng.uniform(5, 40, (B, 2, A)), sc,
                           rng.uniform(-0.7, 2.3, (B, 1, A))], 1).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"agnostic": True}, {"classes": [1]}, {"classes": [-1, 5]}, {"classes": [-3]},
                                {"max_nms": 300, "max_det": 50}, {"iou_thres": 0.2}])
def test_rotated_nms_matches_jax(kw):
    """non_max_suppression_rotated on seeded (3, 7, 700) predictions with ties, against JAX's index for index: boxes
    (xywhr), scores, classes and valid equal (the port pads to max_det where JAX stops at K); `classes` keeps only ids
    in [-nc, nc) (-1 is the last class, 5 and -3 select nothing), `agnostic` suppresses across classes. Suppression is
    not greedy: a box goes when any higher-scored box, kept or not, reaches the threshold."""
    preds = _obb_preds(np.random.default_rng(3))
    kw = {"conf_thres": 0.2, "iou_thres": 0.5, "max_det": 100, **kw}
    want = {k: np.asarray(v) for k, v in jax_nms_rotated(jnp.asarray(preds), **kw).items()}
    got = {k: v.numpy() for k, v in non_max_suppression_rotated(torch.from_numpy(preds), **kw).items()}
    n = want["valid"].shape[1]
    assert set(got) == set(want) and got["boxes"].shape == (3, kw["max_det"], 5)
    for k in want:
        np.testing.assert_array_equal(got[k][:, :n], want[k], err_msg=k)
    assert not got["valid"][:, n:].any()
    if kw.get("classes") == [-3]:
        assert not want["valid"].any()
    else:
        assert 0 < want["valid"].sum() < 3 * min(kw["max_det"], 300)  # suppression happened


def test_rotated_nms_is_not_greedy():
    """Three boxes in a row, each overlapping the next past the threshold but the first not the third: greedy NMS would
    keep the first and the third; the rotated NMS keeps only the first, as JAX's does."""
    boxes = np.array([[50, 50, 20, 10, 0.0], [56, 50, 20, 10, 0.0], [62, 50, 20, 10, 0.0]], np.float32)
    pairs = PB.probiou(boxes[:, None], boxes[None])[..., 0]
    assert pairs[0, 1] >= 0.5 and pairs[1, 2] >= 0.5 and pairs[0, 2] < 0.5
    preds = np.concatenate([boxes[:, :4].T, np.array([[0.9, 0.8, 0.7]]), boxes[:, 4:].T], 0)[None].astype(np.float32)
    got = non_max_suppression_rotated(torch.from_numpy(preds), conf_thres=0.1, iou_thres=0.5, max_det=3)
    want = jax_nms_rotated(jnp.asarray(preds), conf_thres=0.1, iou_thres=0.5, max_det=3)
    assert got["valid"].numpy().tolist() == np.asarray(want["valid"]).tolist() == [[True, False, False]]


# --- (d) predict, Results, checkpoints ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def obb_pair():
    """The JAX and the port YOLO("yolov8n-obb.yaml") holding the same tuned tree (nc 80), and two BGR frames of other
    sizes than the input (so the letterbox resizes and pads) with bright rotated targets."""
    jy, py = yolo_tpu.YOLO("yolov8n-obb.yaml"), yolo_tpu_torch.YOLO("yolov8n-obb.yaml", device="cpu")
    jy.params = _tuned(jy.params, 80)
    py.params = _tuned(py.params, 80)
    rng = np.random.default_rng(9)
    frames = []
    for h, w in ((96, 128), (120, 100)):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        for _ in range(3):
            _draw(img, _rect(rng, w, h), rng.uniform(150, 230))
        frames.append(cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    return jy, py, frames


PREDICT_KW = dict(imgsz=64, compute_dtype="float32", max_det=30, verbose=False, classes=None, agnostic_nms=False, conf=0.2)


@pytest.mark.parametrize("nms", [{}, {"agnostic_nms": True}, {"classes": [5]}, {"classes": [80]}])
def test_predict_obb_matches_jax(obb_pair, nms):
    """`predict` (f32, imgsz 64, max_det 30) on resized frames against JAX's obb route: equal detection counts and
    classes, centres and sizes (through the inverse letterbox) within 1e-2 px, angles and conf 1e-4; no axis-aligned
    boxes; `agnostic_nms` and `classes` honoured (class 80 of nc 80 keeps nothing)."""
    jy, py, frames = obb_pair
    kw = {**PREDICT_KW, **nms}
    for rj, rp in zip(jy.predict(frames, **kw), py.predict(frames, **kw)):
        assert len(rj) == len(rp) == len(rp.obb) and len(rp.boxes) == 0
        assert len(rp) == 0 if nms.get("classes") == [80] else len(rp) > 0
        np.testing.assert_allclose(rp.obb.xywhr[:, :4], rj.obb.xywhr[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(rp.obb.xywhr[:, 4], rj.obb.xywhr[:, 4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(rp.obb.conf, rj.obb.conf, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(rp.obb.cls, rj.obb.cls)


def test_results_obb_match_jax(obb_pair, tmp_path):
    """OBBoxes / Results of a predict against JAX's: xywhr, xyxyxyxy, the xyxy envelope, conf, cls, len, __getitem__;
    Results' rows (an index, a list, an empty list), update(obb=) with track ids, verbose, summary / to_json with the
    four corners (pixels and normalized), save_txt's 8 normalized corners (with and without conf), and plot's rotated
    quads with their labels (equal pixels)."""
    jy, py, frames = obb_pair
    rj, rp = jy.predict(frames[0], **PREDICT_KW)[0], py.predict(frames[0], **PREDICT_KW)[0]
    rp.obb.data, rj.obb.data = rj.obb.data.copy(), rj.obb.data.copy()  # the same boxes: the views and the pixels
    op, oj = rp.obb, rj.obb
    assert len(op) == len(oj) > 1 and op.cpu().numpy() is op and not op.is_track
    for name in ("xywhr", "xyxyxyxy", "xyxy", "conf", "cls"):
        np.testing.assert_allclose(getattr(op, name), getattr(oj, name), rtol=0, atol=1e-5, err_msg=name)
    for sel in (1, [2, 0], []):
        sp, sj = rp[sel], rj[sel]
        assert len(sp) == len(sj)
        np.testing.assert_array_equal(sp.obb.data, sj.obb.data)
    assert rp.verbose() == rj.verbose()
    for normalize in (False, True):
        got, want = rp.summary(normalize=normalize), rj.summary(normalize=normalize)
        assert got == want and set(got[0]["box"]) == {"x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4"}
    assert rp.to_json() == rj.to_json()
    for conf in (False, True):
        rp.save_txt(tmp_path / f"p{conf}.txt", save_conf=conf)
        rj.save_txt(tmp_path / f"j{conf}.txt", save_conf=conf)
        lines = (tmp_path / f"p{conf}.txt").read_text().splitlines()
        assert lines == (tmp_path / f"j{conf}.txt").read_text().splitlines() and len(lines[0].split()) == 9 + conf
    np.testing.assert_array_equal(rp.plot(), rj.plot())
    ids = np.arange(len(op), dtype=np.float32)[:, None] + 1
    tracked = np.concatenate([op.data[:, :5], ids, op.data[:, 5:]], -1)
    rp.update(obb=tracked)
    rj.update(obb=tracked)
    assert rp.obb.is_track and np.array_equal(rp.obb.id, ids[:, 0])
    assert rp.summary() == rj.summary() and "track_id" in rp.summary()[0]
    np.testing.assert_array_equal(rp.plot(), rj.plot())


def test_obb_checkpoints_cross_between_packages(obb_pair, tmp_path):
    """An obb .npz that JAX writes loads in the port as an OBBModel with JAX's tree and gives JAX's oriented boxes
    (1e-2 px); the port's .npz loads in JAX as an OBBModel; the port's .pt (cv4.* in torch layout) reads back to the same
    tree in both packages."""
    jy, py, frames = obb_pair
    y = yolo_tpu_torch.YOLO(str(jy.save(str(tmp_path / "jax.npz"))), device="cpu")
    assert y.task == "obb" and isinstance(y.model, PT.OBBModel)
    _same_tree(y.params, jy.params)
    rp, rj = y.predict(frames[1], **PREDICT_KW)[0], jy.predict(frames[1], **PREDICT_KW)[0]
    np.testing.assert_allclose(rp.obb.xywhr, rj.obb.xywhr, rtol=0, atol=1e-2)
    jback = yolo_tpu.YOLO(str(py.save(str(tmp_path / "port.npz"))))
    assert jback.task == "obb" and isinstance(jback.model, JT.OBBModel)
    _same_tree(jback.params, py.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)  # the export writes into the working directory
        pt = py.export(format="pt")
    sd = torch.load(str(tmp_path / pt), weights_only=True)["state_dict"]
    assert tuple(sd["model.22.cv4.2.2.weight"].shape) == (1, 16, 1, 1)
    for back in (yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu"), yolo_tpu.YOLO(str(tmp_path / pt))):
        assert back.task == "obb"
        _same_tree(back.params, py.params, exact=False)


# --- (e) DOTA labels, the collate and the augmentations ------------------------------------------------------------


@pytest.fixture(scope="module")
def obb_root(tmp_path_factory):
    """A 6-frame 64x80 rotated split (two classes), a box row after the DOTA rows of one frame and a background frame."""
    root = tmp_path_factory.mktemp("obb")
    data = _write_obb_split(root, 6, 31, w=80, h=64)
    with open(root / "labels/val/4.txt", "a") as f:
        f.write("0 0.5 0.5 0.3 0.4\n")  # a plain box row after the DOTA rows: no corners
    (root / "labels/val/5.txt").unlink()  # background
    return root, data


def _obb_datasets(root, **kw):
    kw = dict(cache=False, task="obb", **kw)
    return PD.YOLODataset(str(root / "images/val"), **kw), JD.YOLODataset(str(root / "images/val"), **kw)


def _same_sample(a, b, what=""):
    for k in ("img", "bboxes", "cls", "obb"):
        assert (a.get(k) is None) == (b.get(k) is None), (what, k)
        if a.get(k) is not None:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_obb_labels_cache_and_collate_match_jax(obb_root):
    """DOTA rows (`cls` + 4 normalized corners) parse to JAX's labels (the corners (n, 4, 2), their envelope the box; the
    box row's box but no corners, the background frame's none), through the port's own label cache too; load_raw's
    pixel corners, the val letterbox's and the collate's (B, N, 5) normalized xywhr (cv2 minAreaRect) equal JAX's; a
    batch of background images collates as (B, N, 4), as JAX's does."""
    root, _ = obb_root
    got, want = _obb_datasets(root, imgsz=64)
    for cache in (False, True, True):  # parsed, written, read back
        labels = got._load_labels(cache)
        for g, w in zip(labels, want.labels):
            for k in ("cls", "bboxes", "obb"):
                assert (g[k] is None) == (w[k] is None), k
                if w[k] is not None:
                    np.testing.assert_array_equal(g[k], w[k])
    assert got.labels[0]["obb"].shape == (len(got.labels[0]["cls"]), 4, 2) and got.labels[5]["obb"] is None
    assert len(got.labels[4]["obb"]) == len(got.labels[4]["cls"]) - 1
    samples = []
    for i in range(len(got)):
        _same_sample(got.load_raw(i), want.load_raw(i), f"raw {i}")
        a, b = got[i], want[i]
        _same_sample(a, b, f"val {i}")
        if i != 4:
            samples.append(a)
    cp, cj = PD.collate_batch(samples, 8), JD.collate_batch(samples, 8)
    assert cp["bboxes"].shape == (len(samples), 8, 5) and (cp["bboxes"][..., 4] > 0).any()
    for k in ("img", "cls", "bboxes", "mask_gt"):
        np.testing.assert_array_equal(cp[k], cj[k])
    bg = [got[5], got[5]]
    assert PD.collate_batch(bg, 8)["bboxes"].shape == JD.collate_batch(bg, 8)["bboxes"].shape == (2, 8, 4)
    detect = PD.YOLODataset(str(root / "images/val"), imgsz=64, cache=False)
    assert detect.labels[0]["obb"] is None  # without task='obb' a DOTA row is a polygon


def _raw(ds, i):
    return copy.deepcopy(ds.load_raw(i))


OBB_STEPS = {
    "flip": lambda m, ds, rng: m.random_flip(_raw(ds, 0), lr_p=0.5, ud_p=0.5, rng=rng),
    "perspective": lambda m, ds, rng: m.random_perspective(_raw(ds, 0), degrees=10, translate=0.25, scale=0.5, shear=2,
                                                             perspective=0.0005, border=(-8, -8), rng=rng),
    "mosaic4": lambda m, ds, rng: m.mosaic4([_raw(ds, i) for i in (0, 5, 1, 2)], 64, rng=rng),
    "copy_paste": lambda m, ds, rng: m.copy_paste(_raw(ds, 1), _raw(ds, 0), p=0.9, rng=rng),
    "mixup": lambda m, ds, rng: m.mixup(_raw(ds, 0), _raw(ds, 2), rng=rng),
    "cutmix": lambda m, ds, rng: m.cutmix(_raw(ds, 2), m.mosaic4([_raw(ds, i) for i in (0, 1, 3, 0)], 40, rng=rng), rng=rng),
    "cutmix_no_corners": lambda m, ds, rng: m.cutmix(_raw(ds, 2), {**_raw(ds, 1), "obb": None}, rng=rng),
}


@pytest.mark.parametrize("step", list(OBB_STEPS))
def test_obb_augmentations_match_jax(obb_root, step):
    """Each augmentation on the rotated split's frames, eight draws from one `random.Random(seed)` per package: the same
    images, boxes, classes and corners (flipped, warped and clipped, shifted into the mosaic, a pasted box's own corners,
    the cut-in donor's corners or its clipped box's); the corners stay one a box; the RNGs end in the same state."""
    got, _ = _obb_datasets(obb_root[0], imgsz=64)
    moved = 0
    for seed in range(8):
        rp, rj = random.Random(seed), random.Random(seed)
        a, b = OBB_STEPS[step](PA, got, rp), OBB_STEPS[step](JA, got, rj)
        _same_sample(a, b, f"{step} seed {seed}")
        assert rp.random() == rj.random()
        assert a["obb"].shape == (len(a["bboxes"]), 4, 2)
        moved += not np.array_equal(a["obb"], got.load_raw(0)["obb"])
    assert moved


def test_mosaic9_carries_corners(obb_root):
    """mosaic9 on rotated frames: the same image, boxes and classes as JAX's under one seed; the port also carries each
    tile's corners, scaled and shifted as its boxes are (JAX's mosaic9 drops them): each box stays their envelope."""
    got, _ = _obb_datasets(obb_root[0], imgsz=64)
    items = (0, 1, 2, 3, 4, 5, 0, 1, 2)
    for seed in range(3):
        a = PA.mosaic9([_raw(got, i) for i in items if i != 4], 64, rng=random.Random(seed))
        b = JA.mosaic9([_raw(got, i) for i in items if i != 4], 64, rng=random.Random(seed))
        for k in ("img", "bboxes", "cls"):
            np.testing.assert_array_equal(a[k], b[k])
        assert "obb" not in b and a["obb"].shape == (len(a["bboxes"]), 4, 2)
        inside = (a["bboxes"][:, 2] - a["bboxes"][:, 0] > 1) & (a["bboxes"][:, 0] > 0) & (a["bboxes"][:, 2] < 128)
        inside &= (a["bboxes"][:, 1] > 0) & (a["bboxes"][:, 3] < 128)
        env = np.concatenate([a["obb"].min(1), a["obb"].max(1)], -1)
        np.testing.assert_allclose(env[inside], a["bboxes"][inside], atol=1e-3)


@pytest.mark.parametrize("recipe", ["mosaic", "mixup_cutmix"])
def test_obb_train_transforms_match_jax(obb_root, recipe):
    """TrainTransforms on the rotated dataset (mosaic4, copy-paste, perspective, mixup or cutmix, HSV, flips), every frame
    whose rows are all DOTA rows three times from one RNG per package: the same images, boxes, classes and corners."""
    hyp = dict(mosaic=0.7, copy_paste=0.3, degrees=5.0, fliplr=0.5, flipud=0.2) if recipe == "mosaic" else \
        dict(mosaic=0.8, mixup=0.5, cutmix=0.4, copy_paste=0.0, fliplr=0.5)
    root = obb_root[0]
    listing = root / "clean.txt"  # frame 4 mixes a box row into its DOTA rows: mosaic would draw it
    listing.write_text("".join(f"images/val/{i}.png\n" for i in (0, 1, 2, 3, 5)))
    kw = dict(imgsz=64, augment=True, cache=False, task="obb")
    p = PD.YOLODataset(str(listing), hyp=PC.get_cfg(hyp), **kw)
    j = JD.YOLODataset(str(listing), hyp=jax_get_cfg(overrides=hyp), **kw)
    rp, rj = random.Random(5), random.Random(5)
    for i in list(range(len(p))) * 3:
        a, b = p.transforms(p.load_raw(i), rp), j.transforms(j.load_raw(i), rj)
        _same_sample(a, b, f"{recipe} frame {i}")
        assert a["img"].shape == (64, 64, 3)


# --- (f) the assigner, the loss, the validator ----------------------------------------------------------------------


def _obb_batch(rng, N):
    """A collated-style batch of 2 images with 3 labelled rotated boxes each among N rows, and a box under 2 px."""
    b = {"cls": np.zeros((2, N), np.float32), "bboxes": np.zeros((2, N, 5), np.float32), "mask_gt": np.zeros((2, N), np.float32)}
    for i in range(2):
        for j in range(3):
            b["cls"][i, j] = rng.integers(0, 2)
            b["bboxes"][i, j] = [*rng.uniform(0.3, 0.7, 2), *rng.uniform(0.1, 0.5, 2), rng.uniform(0, math.pi / 2)]
            b["mask_gt"][i, j] = 1
        b["bboxes"][i, 3] = [0.5, 0.5, 0.01, 0.3, 0.2]  # 0.64 px wide at 64²: out of mask_gt
        b["mask_gt"][i, 3] = 1
    return b


def test_rotated_assigner_matches_jax():
    """RotatedTaskAlignedAssigner on seeded scores and rotated boxes (2 images, 84 anchors at 64², 6 rows of which 4
    real, one a duplicate so that anchors are claimed twice): the labels, the xywhr target boxes, the target scores
    (1e-6), the foreground mask and the gt indices equal JAX's; the candidates are the points inside each rotated box."""
    rng = np.random.default_rng(5)
    _, pm = _models(2)
    anc, strides = PAnc.make_anchors([(8, 8), (4, 4), (2, 2)], [8, 16, 32], 0.5)
    anc_px = (anc * strides).numpy()
    scores = rng.uniform(0, 1, (2, 84, 2)).astype(np.float32)
    pd = np.concatenate([anc_px[None].repeat(2, 0) + rng.normal(0, 3, (2, 84, 2)), rng.uniform(6, 30, (2, 84, 2)),
                         rng.uniform(0, 1.5, (2, 84, 1))], -1).astype(np.float32)
    gt = np.zeros((2, 6, 5), np.float32)
    gt[:, :4] = np.concatenate([rng.uniform(16, 48, (2, 4, 2)), rng.uniform(10, 40, (2, 4, 2)), rng.uniform(0, 3, (2, 4, 1))], -1)
    gt[:, 3] = gt[:, 0] * [1, 1, 1.1, 0.9, 1]
    labels = rng.integers(0, 2, (2, 6, 1)).astype(np.int32)
    mask = np.zeros((2, 6, 1), np.float32)
    mask[:, :4] = 1
    want = JaxRotatedAssigner(topk=10, num_classes=2, alpha=0.5, beta=6.0)(
        jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc_px), jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask))
    got = RotatedTaskAlignedAssigner(topk=10, num_classes=2, alpha=0.5, beta=6.0)(
        torch.from_numpy(scores), torch.from_numpy(pd), torch.from_numpy(anc_px), torch.from_numpy(labels),
        torch.from_numpy(gt), torch.from_numpy(mask))
    names = ("labels", "boxes", "scores", "fg", "gt_idx")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "scores":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3].sum() > 10
    inside = RotatedTaskAlignedAssigner._candidates_in_gts(torch.from_numpy(anc_px), torch.from_numpy(gt)).numpy()
    for b in range(2):
        for n in range(4):
            poly = PB.xywhr2xyxyxyxy(gt[b, n]).astype(np.float32)
            ref = np.array([cv2.pointPolygonTest(poly, (float(x), float(y)), True) for x, y in anc_px]) > 1e-3
            assert (inside[b, n] | ~ref).all()  # every anchor well inside is a candidate


@pytest.mark.parametrize("n_boxes", [4, 12])
def test_obb_loss_matches_jax(n_boxes, two_threads):
    """v8OBBLoss on seeded raw outputs (64² input: 84 anchors, nc 2) and rotated labels with one box under 2 px: the three
    items (box, cls, dfl) within 1e-5 relative of JAX's, on its compact route (topk · N = 40 < 84) and its all-anchor
    route (N = 12); the gradients of the box and class inputs within 1e-6 of their largest and of the angle inputs within
    5e-5 of theirs; the under-2-px box is out of the assignment (its w scaled by the height, as JAX's order has it)."""
    jm, pm = _models(2)
    rng = np.random.default_rng(1)
    feats = [rng.normal(0, 1, (2, h, h, 66)).astype(np.float32) for h in (8, 4, 2)]
    angs = [rng.normal(0, 1, (2, h, h, 1)).astype(np.float32) for h in (8, 4, 2)]
    batch = _obb_batch(rng, n_boxes)
    inputs = [torch.from_numpy(a).requires_grad_() for a in feats + angs]
    total, got = v8OBBLoss(pm, HYP)((inputs[:3], inputs[3:]), {k: torch.from_numpy(batch[k]) for k in OBB_KEYS})
    total.backward()
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(float(total.detach()), float(got.sum()) * 2, rtol=1e-6)
    jl = JaxOBBLoss(jm, HYP)
    assert jl.compact
    (_, want), grads = jax.jit(jax.value_and_grad(lambda f, k, b: jl((f, k), b), argnums=(0, 1), has_aux=True))(
        feats, angs, {k: jnp.asarray(batch[k]) for k in OBB_KEYS})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for i, (t, g) in enumerate(zip(inputs, [*grads[0], *grads[1]])):
        g = np.asarray(g)
        tol = 1e-6 if i < 3 else 5e-5
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=tol * max(np.abs(g).max(), 1e-12))


def test_obb_loss_gradient_is_finite_on_a_background_image(two_threads):
    """A batch of a labelled image and a background one (no valid row): the loss items equal JAX's (1e-5 relative), the
    port's gradients are finite where JAX's are NaN (probiou's square root of a zero-padded target: a known difference),
    and the labelled image's gradients equal JAX's on that image alone, times 2 (the loss is the mean item times the
    batch), within 1e-6 of their largest (5e-5 for the angles)."""
    jm, pm = _models(2)
    rng = np.random.default_rng(3)
    feats = [rng.normal(0, 1, (2, h, h, 66)).astype(np.float32) for h in (8, 4, 2)]
    angs = [rng.normal(0, 1, (2, h, h, 1)).astype(np.float32) for h in (8, 4, 2)]
    batch = _obb_batch(rng, 4)
    batch["mask_gt"][1] = 0  # image 1: background
    inputs = [torch.from_numpy(a).requires_grad_() for a in feats + angs]
    total, got = v8OBBLoss(pm, HYP)((inputs[:3], inputs[3:]), {k: torch.from_numpy(batch[k]) for k in OBB_KEYS})
    total.backward()
    jl = JaxOBBLoss(jm, HYP)
    grad = jax.jit(jax.value_and_grad(lambda f, k, b: jl((f, k), b), argnums=(0, 1), has_aux=True))
    (_, want), grads = grad(feats, angs, {k: jnp.asarray(batch[k]) for k in OBB_KEYS})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert all(torch.isfinite(t.grad).all() for t in inputs)
    assert not all(np.isfinite(np.asarray(g)).all() for g in [*grads[0], *grads[1]])
    one = {k: jnp.asarray(batch[k][:1]) for k in OBB_KEYS}
    _, grads = grad([f[:1] for f in feats], [a[:1] for a in angs], one)
    for i, (t, g) in enumerate(zip(inputs, [*grads[0], *grads[1]])):
        g = 2 * np.asarray(g)
        tol = 1e-6 if i < 3 else 5e-5
        np.testing.assert_allclose(t.grad.numpy()[:1], g, rtol=0, atol=tol * max(np.abs(g).max(), 1e-12))


def test_obb_validator_matches_jax(tmp_path, two_threads):
    """OBBValidator on 8 seeded 64x64 frames with 1-3 rotated targets of aspect 1-1.6 (each package on its own copy of the
    split) with the tuned tree: every key within 1e-4 of JAX's, mAP50 above 0."""
    data = {pkg: _write_obb_split(tmp_path / pkg, 8, 21, aspect=(1.0, 1.6), nc=2) for pkg in ("jax", "torch")}
    jy, py = yolo_tpu.YOLO("yolov8n-obb.yaml"), yolo_tpu_torch.YOLO("yolov8n-obb.yaml", device="cpu")
    jy.model, py.model = _models(2)
    jy.params = _tuned(jy.model.init(0), 2)
    py.params = _tuned(py.model.init(0), 2)
    kw = dict(imgsz=64, batch=4, workers=1, plots=False)
    want = jy.val(data=data["jax"], **kw)
    got = py.val(data=data["torch"], **kw)
    assert set(got) == set(want) and got["mAP50"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


# --- (g) training --------------------------------------------------------------------------------------------------

TINY = dict(epochs=2, imgsz=64, batch=4, workers=1, mosaic=0.5, close_mosaic=1, amp=False, plots=False, exist_ok=True,
            optimizer="AdamW", lr0=0.002)


def _rows(run_dir):
    with open(run_dir / "results.csv") as f:
        return list(csv.DictReader(f))


def test_obb_train_matches_jax(tmp_path, two_threads):
    """YOLO("yolov8n-obb.yaml").train for 2 epochs on an 8-image rotated split (imgsz 64, batch 4, AdamW, mosaic 0.5
    closed for the last epoch, f32) in each package: results.csv has the JAX columns, each epoch's box, cls and dfl loss
    within 1e-3 (relative) and each val metric within 1e-3 of the JAX trainer's; last.npz and best.npz are obb
    checkpoints, and the trained model predicts oriented boxes."""
    data = {pkg: _write_obb_split(tmp_path / f"d{pkg}", 8, 41, split="train", nc=2) for pkg in ("jax", "torch")}
    for pkg in data:  # the same frames serve as the val split
        (tmp_path / f"d{pkg}" / "data.yaml").write_text((tmp_path / f"d{pkg}" / "data.yaml").read_text() + "val: images/train\n")
    jy, py = yolo_tpu.YOLO("yolov8n-obb.yaml"), yolo_tpu_torch.YOLO("yolov8n-obb.yaml", device="cpu")
    jm = jy.train(data=data["jax"], project=str(tmp_path), name="jax", **TINY)
    pm = py.train(data=data["torch"], project=str(tmp_path), name="torch", device="cpu", **TINY)
    got, want = _rows(tmp_path / "torch"), _rows(tmp_path / "jax")
    assert list(got[0]) == list(want[0]) and len(got) == len(want) == 2 and set(pm) == set(jm)
    for g, w in zip(got, want):
        assert float(g["train/box_loss"]) > 0
        for k in w:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3, atol=1e-6, err_msg=k)
            elif k.startswith("metrics/"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-3, k
    for name in ("last.npz", "best.npz"):
        ck = yolo_tpu_torch.YOLO(str(tmp_path / "torch" / "weights" / name), device="cpu")
        assert ck.task == "obb" and ck.model.nc == 2
    assert py.task == "obb" and isinstance(py.trainer.loss_fn, v8OBBLoss)
    r = py.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, conf=0.0, max_det=5, verbose=False)[0]
    assert 0 < len(r) <= 5 and r.obb.data.shape == (len(r), 7)


# --- (h) track and the left-outs ------------------------------------------------------------------------------------


def _track_frames(n=4):
    """n BGR 96x128 frames of three bright rotated targets drifting right by 2 px a frame."""
    rng = np.random.default_rng(12)
    base = rng.normal(40, 6, (96, 128)).clip(0, 255).astype(np.float32)
    rects = [(30, 40, 34, 14, 0.4), (70, 30, 30, 12, 1.2), (100, 64, 36, 16, 2.5)]
    frames = []
    for f in range(n):
        img = base.copy()
        for cx, cy, L, S, a in rects:
            _draw(img, (cx + 2 * f, cy, L, S, a), 200.0)
        frames.append(cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    return frames


@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "botsort.yaml"])
def test_track_obb_matches_jax(obb_pair, tracker, tmp_path):
    """YOLO.track (persist, f32, imgsz 64) over four frames with an obb model, against JAX's: equal tracked rows per frame
    (centres and sizes 1e-2 px, angles, ids, conf 1e-4 and classes), the rows [cx, cy, w, h, angle, id, conf, cls]; the
    association runs on probiou (ByteTrack, and BoT-SORT without camera motion)."""
    jy, py, _ = obb_pair
    if tracker == "botsort.yaml":
        import yaml

        cfg = yaml.safe_load((PT.CFG_DIR / "trackers" / tracker).read_text())
        tracker = str(tmp_path / "botsort_none.yaml")
        (tmp_path / "botsort_none.yaml").write_text(yaml.safe_dump({**cfg, "gmc_method": "none"}))
    jy._tracker = py._tracker = None
    kw = dict(PREDICT_KW, persist=True, tracker=tracker, conf=0.1)
    n_tracked = 0
    for frame in _track_frames():
        rj, rp = jy.track(frame, **kw)[0], py.track(frame, **kw)[0]
        assert rp.obb.data.shape == rj.obb.data.shape and rp.obb.is_track == rj.obb.is_track and len(rp.boxes) == 0
        np.testing.assert_allclose(rp.obb.data[:, :4], rj.obb.data[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(rp.obb.data[:, 4:], rj.obb.data[:, 4:], rtol=0, atol=1e-4)
        n_tracked += len(rp) if rp.obb.is_track else 0
    assert n_tracked > 0


def test_obb_entry_points_left_out_raise(obb_pair, tmp_path):
    """The slice's left-out entry points name themselves with NotImplementedError: where the JAX package runs them with
    an obb model (benchmark, tune, tiled inference, int8 predict, a server lane, which stays out of service) they name
    ROADMAP item 2; where JAX fails too (FusedDetectTrack asserts a plain Detect head; an ensemble) the port refuses.
    augment=True warns and predicts at one scale (JAX's obb route ignores it)."""
    from yolo_tpu_torch.ops.tiling import tiled_predict
    from yolo_tpu_torch.pipeline.fused import FusedDetectTrack
    from yolo_tpu_torch.serve import _ModelLane

    _, py, frames = obb_pair
    for call, what in ((lambda: py.benchmark(imgsz=64), "benchmark.*ROADMAP item 2"),
                       (lambda: py.tune(data="x.yaml"), "tune.*ROADMAP item 2"),
                       (lambda: tiled_predict(py, frames[0], tile=64), "tiled.*ROADMAP item 2"),
                       (lambda: py.predict(frames[0], int8=True, imgsz=64), "int8.*ROADMAP item 2"),
                       (lambda: FusedDetectTrack(py.model, py.params, device="cpu"), "FusedDetectTrack"),
                       (lambda: yolo_tpu_torch.YOLO(["yolov8n-obb.yaml", "yolov8n-obb.yaml"], device="cpu"), "ensemble")):
        with pytest.raises(NotImplementedError, match=what):
            call()
    py.predictor = None
    one = py.predict(frames[0], **PREDICT_KW)[0]
    aug = py.predict(frames[0], augment=True, **PREDICT_KW)[0]
    np.testing.assert_array_equal(aug.obb.data, one.obb.data)
    py.predictor = None  # a reused predictor keeps augment
    lane = _ModelLane(str(py.save(str(tmp_path / "obb.npz"))), 0.25, 0.7, 64, 300, "cpu", {})
    assert lane.yolo is None and "obb" in lane.error
