"""The pose task of the port (yolov8n-pose) against the JAX package's on the CPU, and the yolov8n-p2 yaml the port
lacked: PoseModel's initial tree, routing and forward, NMS with 51 extra columns, the predictor's keypoints, Keypoints
and the Results keypoint API, Instances, pose label rows and their collate, every augmentation with keypoints,
kpt_iou, v8PoseLoss on both of JAX's routes, PoseValidator, one train step, the trainer on JAX's tiny pose recipe,
the checkpoints, YOLO.track with a pose and a segment model, and the left-out entry points. Inputs come from seeded
numpy generators; the JAX side runs as its own tests run it (jitted, on the CPU); the port runs the kernels' plain
twins, as it does on a CPU tensor.

Tolerances, stated again at each test: initial trees, labels, augmentations, the collate and NMS exact; f32 boxes and
keypoint x, y 1e-3 px, scores and visibilities 1e-5; bf16 within a few bf16 ulps (boxes and keypoint x, y 0.5 px,
scores and visibilities 5e-3); loss items 1e-5 relative and the loss's gradients 1e-6 of their largest; validator
keys 1e-4; an f32 step's gradients 1e-3 of their tensor's largest (tests/test_torch_segment.py's level: the train
forward's f32 rounding reaches them, up to 6.2e-4 here), its update 1e-5."""

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
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_tpu.utils import instance as JI
from yolo_tpu.utils import optim as JO
from yolo_tpu.utils.loss import v8PoseLoss as JaxPoseLoss
from yolo_tpu.utils.metrics import OKS_SIGMA as JAX_OKS_SIGMA
from yolo_tpu.utils.metrics import kpt_iou as jax_kpt_iou
from yolo_tpu_torch import cfg as PC
from yolo_tpu_torch.data import augment as PA
from yolo_tpu_torch.data import dataset as PD
from yolo_tpu_torch.engine.trainer import DetectionTrainer
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.ops.nms import non_max_suppression
from yolo_tpu_torch.utils import instance as PI
from yolo_tpu_torch.utils.loss import v8PoseLoss
from yolo_tpu_torch.utils.metrics import OKS_SIGMA, kpt_iou

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5, pose=12.0, kobj=1.0)
POSE_KEYS = ("cls", "bboxes", "mask_gt", "keypoints")
FLIP4 = [0, 1, 3, 2]  # the tiny recipe's four keypoints: head, centre, left foot, right foot


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _same_tree(got, want, exact=True):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]) if exact else np.allclose(got[k], want[k], atol=0), k


def _pose_cfg(loader, kpt_shape=(17, 3), nc=1) -> dict:
    d = dict(loader("yolov8n-pose.yaml"))
    d.update(kpt_shape=list(kpt_shape), nc=nc)
    return d


def _models(kpt_shape=(17, 3), nc=1):
    """The JAX and the port PoseModel of yolov8n-pose at `kpt_shape` and `nc`."""
    return (JT.PoseModel(_pose_cfg(JT.yaml_model_load, kpt_shape, nc)),
            PT.PoseModel(_pose_cfg(PT.yaml_model_load, kpt_shape, nc), device="cpu"))


def _tuned(params, nc):
    """init(0)'s tree with the head's last convs set so that an untrained model finds bright figures: box bins 1 and 2
    raised (boxes of about 3 strides), class logits near 0, keypoint x and y raws 0.25 (each keypoint at its anchor's
    centre) and visibility logits 2, the random weights of those convs scaled down but kept (varied outputs)."""
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    head = p["model"]["22"]
    for l in range(3):
        box, cls, kpt = head["cv2"][str(l)]["2"], head["cv3"][str(l)]["2"], head["cv4"][str(l)]["2"]
        for conv in (box, cls, kpt):
            conv["weight"] *= 0.05
        box["bias"] = np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
        cls["bias"] = np.zeros(nc, np.float32)
        nk = len(kpt["bias"])
        ndim = 3 if nk % 3 == 0 else 2
        kpt["bias"] = np.tile(np.array([0.25, 0.25, 2.0][:ndim], np.float32), nk // ndim)
    return p


def _figure(rng, w, h, kpt_shape):
    """A bright rectangle's label row (normalized cx cy w h) and keypoints (K, ndim) near its centre, a share
    of them at visibility 1 and a share at 0."""
    K, ndim = kpt_shape
    bw, bh = rng.uniform(0.2, 0.35) * w, rng.uniform(0.25, 0.4) * h
    cx, cy = rng.uniform(bw / 2 + 2, w - bw / 2 - 2), rng.uniform(bh / 2 + 2, h - bh / 2 - 2)
    kxy = np.stack([cx + rng.uniform(-0.15, 0.15, K) * bw, cy + rng.uniform(-0.15, 0.15, K) * bh], -1)
    vis = rng.choice([0.0, 1.0, 2.0], K, p=[0.15, 0.25, 0.6])
    kp = np.concatenate([kxy / [w, h], vis[:, None]], -1)[:, :ndim].astype(np.float32)
    if ndim == 2:
        kp[vis == 0] = 0.0
    return (cx, cy, bw, bh), kp


def _write_pose_split(root, n, seed, kpt_shape=(4, 3), w=64, h=64, split="val", flip_idx=FLIP4):
    """n seeded IR-like frames with 1-2 bright rectangles each and their pose rows (nc 1) → the dataset yaml,
    with `kpt_shape` and (unless None) `flip_idx`."""
    rng = np.random.default_rng(seed)
    for d in (f"images/{split}", f"labels/{split}"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        lines = []
        for _ in range(int(rng.integers(1, 3))):
            (cx, cy, bw, bh), kp = _figure(rng, w, h, kpt_shape)
            cv2.rectangle(img, (int(cx - bw / 2), int(cy - bh / 2)), (int(cx + bw / 2), int(cy + bh / 2)), float(rng.uniform(150, 230)), -1)
            lines.append(f"0 {cx / w:.6f} {cy / h:.6f} {bw / w:.6f} {bh / h:.6f} " + " ".join(f"{v:.6f}" for v in kp.ravel()))
        cv2.imwrite(str(root / f"images/{split}/{i}.png"), cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    extra = f"flip_idx: {list(flip_idx)}\n" if flip_idx is not None else ""
    (root / "data.yaml").write_text(f"path: {root}\n{split}: images/{split}\nkpt_shape: {list(kpt_shape)}\n{extra}names:\n  0: person\n")
    return str(root / "data.yaml")


# --- (0) the yolov8n-p2 repair -----------------------------------------------------------------------------


def test_p2_yaml_builds_and_predicts_as_jax():
    """YOLO("yolov8n-p2.yaml", device="cpu") builds the 4-level DetectionModel (strides 4-32) with JAX's init(0) tree bit
    for bit; its f32 predict on a seeded 120x100 frame (imgsz 64, conf 0.0001) equals JAX's: equal detection counts and
    classes, boxes within 1e-3 px, conf 1e-5; both guess_model_task functions call it detect."""
    jy, py = yolo_tpu.YOLO("yolov8n-p2.yaml"), yolo_tpu_torch.YOLO("yolov8n-p2.yaml", device="cpu")
    assert py.task == "detect" and type(py.model) is PT.DetectionModel and py.model.stride == [4, 8, 16, 32]
    _same_tree(py.params, jy.params)
    frame = np.random.default_rng(3).integers(0, 255, (120, 100, 3), np.uint8)
    kw = dict(imgsz=64, conf=0.0001, compute_dtype="float32", max_det=50, verbose=False)
    rj, rp = jy.predict(frame, **kw)[0], py.predict(frame, **kw)[0]
    assert len(rj) == len(rp) > 0
    np.testing.assert_allclose(rp.boxes.xyxy, rj.boxes.xyxy, rtol=0, atol=1e-3)
    np.testing.assert_allclose(rp.boxes.conf, rj.boxes.conf, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rp.boxes.cls, rj.boxes.cls)
    d = JT.yaml_model_load("yolov8n-p2.yaml")
    assert PT.guess_model_task(d) == JT.guess_model_task(d) == "detect"
    assert PT.guess_model_task(PT.yaml_model_load("yolov8n-p2.yaml")) == "detect"


# --- (a) the model ----------------------------------------------------------------------------------------


def test_pose_model_init_and_routing_match_jax():
    """PoseModel("yolov8n-pose.yaml").init(0) is the JAX package's tree bit for bit (3,306,482 values, kpt_shape (17, 3),
    nk 51, c4 51); YOLO("yolov8n-pose.yaml") is a pose model; the task helpers route `-pose` yamls and Pose heads as
    JAX's do; a yaml's kpt_shape reaches the head; yolov8n-pose-p6 (C2 since the seventeenth slice) is a four-level pose
    model with JAX's strides, and yolo11n-pose (C3k2 since the eighteenth slice) is a pose model with JAX's strides and
    the non-legacy class branch."""
    pm, jm = PT.PoseModel("yolov8n-pose.yaml", device="cpu"), JT.PoseModel("yolov8n-pose.yaml")
    _same_tree(pm.init(0), jm.init(0))
    assert PT.param_count(pm.init(0)) == jm.param_count(jm.init(0)) == 3_306_482
    assert (pm.head.kpt_shape, pm.head.nk, pm.head.cv4[0][0].c2, pm.stride) == ((17, 3), 51, 51, [8, 16, 32])
    py = yolo_tpu_torch.YOLO("yolov8n-pose.yaml", device="cpu")
    assert py.task == "pose" and isinstance(py.model, PT.PoseModel)
    d = JT.yaml_model_load("yolov8n-pose.yaml")
    assert PT.model_class_for(d) is PT.PoseModel and PT.guess_model_task(d) == JT.guess_model_task(d) == "pose"
    jm4, pm4 = _models((4, 2), nc=3)
    assert pm4.head.kpt_shape == jm4.head.kpt_shape == (4, 2) and pm4.nc == 3
    _same_tree(pm4.init(0), jm4.init(0))
    p6 = PT.PoseModel("yolov8n-pose-p6.yaml", device="cpu")
    assert p6.stride == JT.PoseModel("yolov8n-pose-p6.yaml").stride == [8, 16, 32, 64] and p6.head.kpt_shape == (17, 3)
    y11 = PT.PoseModel("yolo11n-pose.yaml", device="cpu")
    assert y11.stride == JT.PoseModel("yolo11n-pose.yaml").stride == [8, 16, 32] and y11.head.kpt_shape == (17, 3)
    assert y11.head.legacy is False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pose_forward_matches_jax(dtype, two_threads):
    """yolov8n-pose (nc 1, the tuned tree through `params_from_jax`) on two seeded 64x64 images: predictions (2, 56, 84),
    the neck folded and not, against JAX's `PoseModel.predict`. f32: boxes and keypoint x, y within 1e-3 px, scores and
    visibilities 1e-5; bf16: boxes and keypoint x, y 0.5 px, scores and visibilities 5e-3."""
    jm, pm = JT.PoseModel("yolov8n-pose.yaml"), PT.PoseModel("yolov8n-pose.yaml", device="cpu")
    params = _tuned(jm.init(0), 1)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(lambda p, v: jm.predict(p, v, dtype=jdt))(params, jnp.asarray(x)), np.float32)
    PT.params_from_jax(pm, params, tdt)
    px = np.zeros(56, bool)
    px[:4] = True
    px[5:][np.arange(51) % 3 != 2] = True  # keypoint x and y rows
    big, small = (1e-3, 1e-5) if dtype == "float32" else (0.5, 5e-3)
    for neck_opt in (True, False):
        got = pm.predict(torch.from_numpy(x).to(tdt), neck_opt=neck_opt)
        assert got.dtype == torch.float32 and got.shape == (2, 56, 84)
        got = got.numpy()
        np.testing.assert_allclose(got[:, px], want[:, px], rtol=0, atol=big)
        np.testing.assert_allclose(got[:, ~px], want[:, ~px], rtol=0, atol=small)


# --- (b) NMS with 51 extras ---------------------------------------------------------------------------------


@pytest.mark.parametrize("agnostic,classes", [(False, None), (True, None), (False, [1])])
def test_nms_with_51_extra_columns_matches_jax(agnostic, classes):
    """(2, 4 + 2 + 51, 600) predictions with overlapping boxes: with nc given the 51 keypoint rows ride through NMS as
    extras; boxes, scores, classes, valid and extras equal JAX's through the kernel's route and the select-max twin
    (exactly), extras zero where not valid; `classes` and `agnostic` as JAX's."""
    rng = np.random.default_rng(4)
    B, nc, A = 2, 2, 600
    preds = np.concatenate([rng.uniform(20, 100, (B, 2, A)), rng.uniform(5, 40, (B, 2, A)), rng.uniform(0, 1, (B, nc, A)) ** 3,
                            rng.uniform(0, 120, (B, 51, A))], 1).astype(np.float32)
    kw = dict(conf_thres=0.2, iou_thres=0.5, agnostic=agnostic, classes=classes, max_det=100, nc=nc)
    want = {k: np.asarray(v) for k, v in jax_nms(jnp.asarray(preds), **kw).items()}
    assert want["valid"].sum() > 20 and want["extra"].shape == (B, 100, 51)
    for plain in (False, True):
        got = non_max_suppression(torch.from_numpy(preds), plain=plain, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert not np.abs(want["extra"][~want["valid"]]).any()


# --- (c) predict, Results, checkpoints ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_pair():
    """The JAX and the port YOLO("yolov8n-pose.yaml") holding the same tuned tree (nc 1, 17 keypoints), and two BGR
    frames of other sizes than the input (so the letterbox resizes and pads)."""
    jy, py = yolo_tpu.YOLO("yolov8n-pose.yaml"), yolo_tpu_torch.YOLO("yolov8n-pose.yaml", device="cpu")
    jy.params = _tuned(jy.params, 1)
    py.params = _tuned(py.params, 1)
    rng = np.random.default_rng(9)
    frames = []
    for h, w in ((96, 128), (120, 100)):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        for _ in range(3):
            (cx, cy, bw, bh), _ = _figure(rng, w, h, (17, 3))
            cv2.rectangle(img, (int(cx - bw / 2), int(cy - bh / 2)), (int(cx + bw / 2), int(cy + bh / 2)), float(rng.uniform(150, 230)), -1)
        frames.append(cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    return jy, py, frames


PREDICT_KW = dict(imgsz=64, compute_dtype="float32", max_det=30, verbose=False, classes=None, agnostic_nms=False)


@pytest.mark.parametrize("nms", [{}, {"agnostic_nms": True}, {"classes": [0]}, {"classes": [1]}])
def test_predict_keypoints_match_jax(pose_pair, nms):
    """`predict` (f32, imgsz 64, max_det 30) on resized frames against JAX's pose route: equal detection counts and
    classes, boxes within 1e-3 px, conf 1e-5, keypoint x, y (through the inverse letterbox, clipped to the frame)
    1e-3 px and visibilities 1e-5; `agnostic_nms` and `classes` honoured (class 1 of nc 1 keeps nothing)."""
    jy, py, frames = pose_pair
    kw = {**PREDICT_KW, **nms}
    for rj, rp in zip(jy.predict(frames, **kw), py.predict(frames, **kw)):
        assert len(rj) == len(rp) and rp.keypoints.data.shape == rj.keypoints.data.shape == (len(rp), 17, 3)
        assert len(rp) == 0 if nms.get("classes") == [1] else len(rp) > 0
        np.testing.assert_allclose(rp.boxes.xyxy, rj.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(rp.boxes.conf, rj.boxes.conf, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(rp.boxes.cls, rj.boxes.cls)
        np.testing.assert_allclose(rp.keypoints.xy, rj.keypoints.xy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(rp.keypoints.conf, rj.keypoints.conf, rtol=0, atol=1e-5)
        h, w = rp.orig_shape
        assert (rp.keypoints.xy >= 0).all() and (rp.keypoints.xy[..., 0] <= w).all() and (rp.keypoints.xy[..., 1] <= h).all()


def test_results_keypoints_match_jax(pose_pair):
    """Keypoints / Results of a predict against JAX's: xy, xyn, conf, len, __getitem__, cpu / numpy; Results' rows with
    their keypoints (an index, a list, an empty list), `new` (no keypoints), summary / to_json with keypoints (pixels and
    normalized), and plot with the skeleton (equal pixels; without `kpt_line` no limbs)."""
    jy, py, frames = pose_pair
    rj, rp = jy.predict(frames[0], **PREDICT_KW)[0], py.predict(frames[0], **PREDICT_KW)[0]
    kp, kj = rp.keypoints, rj.keypoints
    assert len(kp) == len(kj) > 1 and kp.cpu().numpy() is kp
    for a, b in ((kp.xy, kj.xy), (kp.xyn, kj.xyn)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    np.testing.assert_allclose(kp.conf, kj.conf, rtol=0, atol=1e-5)
    np.testing.assert_allclose(kp[1:3].data, kj[1:3].data, rtol=0, atol=1e-3)
    for sel in (1, [2, 0], []):
        sp, sj = rp[sel], rj[sel]
        assert sp.keypoints.data.shape == sj.keypoints.data.shape
        np.testing.assert_allclose(sp.keypoints.data, sj.keypoints.data, rtol=0, atol=1e-3)
    assert rp.new().keypoints is None
    for normalize in (False, True):  # boxes and keypoints 1e-3 (of pixels, or of a normalized side), conf 1e-5
        got, want = rp.summary(normalize=normalize), rj.summary(normalize=normalize)
        assert len(got) == len(want) and all(g.keys() == w.keys() == {"name", "class", "confidence", "box", "keypoints"}
                                             for g, w in zip(got, want))
        for g, w in zip(got, want):
            assert abs(g["confidence"] - w["confidence"]) <= 1e-5
            for k in ("x", "y", "visible"):
                np.testing.assert_allclose(g["keypoints"][k], w["keypoints"][k], rtol=0, atol=1e-3)
    assert '"keypoints"' in rp.to_json()
    rp.keypoints.data, rj.keypoints.data = rj.keypoints.data, rj.keypoints.data  # the same points: plot pixel for pixel
    rp.boxes.data[:] = rj.boxes.data
    np.testing.assert_array_equal(rp.plot(), rj.plot())
    np.testing.assert_array_equal(rp.plot(kpt_line=False), rj.plot(kpt_line=False))
    assert not np.array_equal(rp.plot(kpt_line=False), rp.plot())


def test_pose_checkpoints_cross_between_packages(pose_pair, tmp_path):
    """A pose .npz that JAX writes loads in the port as a PoseModel with JAX's tree and gives JAX's keypoints (1e-3 px);
    the port's .npz (kpt_shape in its meta) loads in JAX as a PoseModel; the port's .pt (cv4.* in torch layout) reads
    back to the same tree in both packages."""
    jy, py, frames = pose_pair
    y = yolo_tpu_torch.YOLO(str(jy.save(str(tmp_path / "jax.npz"))), device="cpu")
    assert y.task == "pose" and isinstance(y.model, PT.PoseModel) and y.model.head.kpt_shape == (17, 3)
    _same_tree(y.params, jy.params)
    rp, rj = y.predict(frames[1], **PREDICT_KW)[0], jy.predict(frames[1], **PREDICT_KW)[0]
    np.testing.assert_allclose(rp.keypoints.data[..., :2], rj.keypoints.data[..., :2], rtol=0, atol=1e-3)
    path = py.save(str(tmp_path / "port.npz"))
    with np.load(path) as f:
        import json

        assert json.loads(bytes(f["__meta__"]).decode())["kpt_shape"] == [17, 3]
    jback = yolo_tpu.YOLO(str(path))
    assert jback.task == "pose" and isinstance(jback.model, JT.PoseModel)
    _same_tree(jback.params, py.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)  # the export writes into the working directory
        pt = py.export(format="pt")
    sd = torch.load(str(tmp_path / pt), weights_only=True)["state_dict"]
    assert tuple(sd["model.22.cv4.2.2.weight"].shape) == (51, 51, 1, 1)
    for back in (yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu"), yolo_tpu.YOLO(str(tmp_path / pt))):
        assert back.task == "pose"
        _same_tree(back.params, py.params, exact=False)


# --- (d) Instances --------------------------------------------------------------------------------------------


def test_instances_match_jax():
    """Bboxes and Instances against JAX's: the JAX package's own test_instances scenario, then seeded boxes with
    segments and (N, 5, 3) keypoints through every conversion, scale, denormalize / normalize, padding, both flips,
    clip (keypoints outside lose their visibility), remove_zero_area_boxes, indexing and concatenate: equal arrays."""
    b = PI.Bboxes(np.array([[10, 20, 30, 60]], np.float32), "xyxy")
    for fmt, want in (("xywh", [[20, 40, 20, 40]]), ("ltwh", [[10, 20, 20, 40]]), ("xyxy", [[10, 20, 30, 60]])):
        b.convert(fmt)
        assert np.allclose(b.bboxes, want)
    assert b.areas()[0] == pytest.approx(800)
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (6, 2)), rng.uniform(0.05, 0.5, (6, 2))], 1).astype(np.float32)
    boxes[2, 2] = 0.0  # a zero-width box
    segs = rng.uniform(-0.1, 1.1, (6, 7, 2)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(-0.1, 1.1, (6, 5, 2)), rng.integers(0, 3, (6, 5, 1))], -1).astype(np.float32)
    out = []
    for mod in (PI, JI):
        inst = mod.Instances(boxes.copy(), segs.copy(), kpts.copy(), bbox_format="xywh", normalized=True)
        inst.denormalize(100, 80)
        inst.convert_bbox("ltwh")
        inst.scale(1.5, 0.75)
        inst.add_padding(3, -4)
        inst.fliplr(150)
        inst.flipud(60)
        inst.clip(150, 60)
        areas = inst.bbox_areas
        good = inst.remove_zero_area_boxes()
        sub = inst[[0, 2]]
        inst.normalize(150, 60)
        cat = mod.Bboxes.concatenate([mod.Bboxes(boxes[:2].copy(), "xywh"), mod.Bboxes(boxes[2:4].copy(), "ltwh")])
        out.append((inst.bboxes, inst.segments, inst.keypoints, areas, good, sub.bboxes, sub.keypoints, len(inst),
                    cat.bboxes, cat.format, inst[1]._bboxes.format))
    for g, w in zip(*out):
        np.testing.assert_array_equal(g, w)
    assert not out[0][4].all() and (out[0][2][..., 2] == 0).any()


# --- (e) labels, the collate and the augmentations ------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_root(tmp_path_factory):
    """A 6-frame 64x80 pose split ((4, 3) keypoints, flip_idx), a box row and a background frame among them."""
    root = tmp_path_factory.mktemp("pose")
    data = _write_pose_split(root, 6, 31, w=80, h=64)
    with open(root / "labels/val/4.txt", "a") as f:
        f.write("0 0.5 0.5 0.3 0.4\n")  # a plain box row after the pose rows
    (root / "labels/val/5.txt").unlink()  # background
    return root, data


def _pose_datasets(root, **kw):
    d = PD.check_det_dataset(str(root / "data.yaml"))
    kw = dict(kpt_shape=d["kpt_shape"], flip_idx=d.get("flip_idx"), cache=False, **kw)
    return PD.YOLODataset(str(root / "images/val"), **kw), JD.YOLODataset(str(root / "images/val"), **kw)


def _same_sample(a, b, what=""):
    for k in ("img", "bboxes", "cls", "keypoints"):
        assert (a.get(k) is None) == (b.get(k) is None), (what, k)
        if a.get(k) is not None:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_pose_labels_and_collate_match_jax(pose_root):
    """Pose rows (`cls cx cy w h` + 4 × `x y v`) parse to JAX's labels (a box row's keypoints zero, the background frame's
    None), through the port's own label cache too; load_raw's pixel keypoints, the val letterbox's and the collate's
    (B, N, 4, 3) normalized keypoints equal JAX's; a batch without keypoints has none."""
    root, _ = pose_root
    got, want = _pose_datasets(root, imgsz=64)
    for cache in (False, True, True):  # parsed, written, read back
        labels = got._load_labels(cache)
        for g, w in zip(labels, want.labels):
            for k in ("cls", "bboxes", "keypoints"):
                assert (g[k] is None) == (w[k] is None), k
                if w[k] is not None:
                    np.testing.assert_array_equal(g[k], w[k])
    kp4 = got.labels[4]["keypoints"]
    assert kp4.shape == (len(got.labels[4]["cls"]), 4, 3) and not kp4[-1].any() and kp4[0].any() and got.labels[5]["keypoints"] is None
    samples = []
    for i in range(len(got)):
        _same_sample(got.load_raw(i), want.load_raw(i), f"raw {i}")
        a, b = got[i], want[i]
        _same_sample(a, b, f"val {i}")
        samples.append(a)
    cp, cj = PD.collate_batch(samples, 8), JD.collate_batch(samples, 8)
    assert cp["keypoints"].shape == (len(samples), 8, 4, 3)
    for k in ("img", "cls", "bboxes", "mask_gt", "keypoints"):
        np.testing.assert_array_equal(cp[k], cj[k])
    assert "keypoints" not in PD.collate_batch([{k: v for k, v in s.items() if k != "keypoints"} for s in samples], 8)


def _raw(ds, i):
    import copy

    return copy.deepcopy(ds.load_raw(i))


POSE_STEPS = {
    "flip": lambda m, ds, rng: m.random_flip(_raw(ds, 0), lr_p=0.5, ud_p=0.5, rng=rng, flip_idx=FLIP4),
    "flip_no_idx": lambda m, ds, rng: m.random_flip(_raw(ds, 1), lr_p=0.5, ud_p=0.5, rng=rng),
    "perspective": lambda m, ds, rng: m.random_perspective(_raw(ds, 0), degrees=10, translate=0.25, scale=0.5, shear=2,
                                                             perspective=0.0005, border=(-8, -8), rng=rng),
    "mosaic4": lambda m, ds, rng: m.mosaic4([_raw(ds, i) for i in (0, 4, 5, 2)], 64, rng=rng),
    "copy_paste": lambda m, ds, rng: m.copy_paste(_raw(ds, 1), _raw(ds, 0), p=0.9, rng=rng),
    "mixup": lambda m, ds, rng: m.mixup(_raw(ds, 0), _raw(ds, 4), rng=rng),
    "cutmix": lambda m, ds, rng: m.cutmix(_raw(ds, 2), m.mosaic4([_raw(ds, i) for i in (0, 1, 3, 0)], 40, rng=rng), rng=rng),
}


@pytest.mark.parametrize("step", list(POSE_STEPS))
def test_pose_augmentations_match_jax(pose_root, step):
    """Each augmentation on the pose split's frames, eight draws from one `random.Random(seed)` per package: the same
    images, boxes, classes and keypoints (the flip swaps them by flip_idx, warns once without one and then never flips
    them horizontally; the perspective hides those it throws off the canvas; pasted and cut-in rows get invisible ones);
    the RNGs end in the same state."""
    got, _ = _pose_datasets(pose_root[0], imgsz=64)
    moved = 0
    for seed in range(8):
        rp, rj = random.Random(seed), random.Random(seed)
        a, b = POSE_STEPS[step](PA, got, rp), POSE_STEPS[step](JA, got, rj)
        _same_sample(a, b, f"{step} seed {seed}")
        assert rp.random() == rj.random()
        assert a["keypoints"].shape == (len(a["bboxes"]), 4, 3)
        moved += not np.array_equal(a["keypoints"], got.load_raw(0)["keypoints"])
    assert moved
    if step == "flip_no_idx":
        assert PA.random_flip._warned_flip_idx


def test_mosaic9_carries_keypoints(pose_root):
    """mosaic9 on pose frames: the same image, boxes and classes as JAX's under one seed; the port also carries each
    tile's keypoints, scaled and shifted as its boxes are (JAX's mosaic9 drops them)."""
    got, _ = _pose_datasets(pose_root[0], imgsz=64)
    items = (0, 1, 2, 3, 4, 5, 0, 1, 2)
    for seed in range(3):
        a = PA.mosaic9([_raw(got, i) for i in items], 64, rng=random.Random(seed))
        b = JA.mosaic9([_raw(got, i) for i in items], 64, rng=random.Random(seed))
        for k in ("img", "bboxes", "cls"):
            np.testing.assert_array_equal(a[k], b[k])
        assert "keypoints" not in b and a["keypoints"].shape == (len(a["bboxes"]), 4, 3)
        # each tile's keypoints keep their place inside their (unclipped) box: map the box back and compare
        k = 0
        for i in items:
            raw = got.load_raw(i)
            n = len(raw["bboxes"])
            if not n:
                continue
            r = 64 / max(raw["img"].shape[:2])
            off = (a["keypoints"][k : k + n, :, :2] - raw["keypoints"][..., :2] * r)
            np.testing.assert_allclose(off, np.broadcast_to(off[:1, :1], off.shape), atol=1e-4)
            np.testing.assert_array_equal(a["keypoints"][k : k + n, :, 2], raw["keypoints"][..., 2])
            k += n


@pytest.mark.parametrize("recipe", ["mosaic", "mixup_cutmix"])
def test_pose_train_transforms_match_jax(pose_root, recipe):
    """TrainTransforms on the pose dataset (mosaic4, copy-paste, perspective, mixup or cutmix, HSV, flips with flip_idx),
    every frame three times from one RNG per package: the same images, boxes, classes and keypoints."""
    hyp = dict(mosaic=0.7, copy_paste=0.3, degrees=5.0, fliplr=0.5, flipud=0.2) if recipe == "mosaic" else \
        dict(mosaic=0.8, mixup=0.5, cutmix=0.4, copy_paste=0.0, fliplr=0.5)
    root = pose_root[0]
    p = PD.YOLODataset(str(root / "images/val"), imgsz=64, augment=True, hyp=PC.get_cfg(hyp), cache=False, kpt_shape=(4, 3), flip_idx=FLIP4)
    j = JD.YOLODataset(str(root / "images/val"), imgsz=64, augment=True, hyp=jax_get_cfg(overrides=hyp), cache=False, kpt_shape=(4, 3),
                       flip_idx=FLIP4)
    rp, rj = random.Random(5), random.Random(5)
    for i in list(range(len(p))) * 3:
        a, b = p.transforms(p.load_raw(i), rp), j.transforms(j.load_raw(i), rj)
        _same_sample(a, b, f"{recipe} frame {i}")
        assert a["img"].shape == (64, 64, 3)


def test_val_transforms_move_keypoints_and_polygons_as_jax(pose_root):
    """The validation letterbox of a 64x80 frame (a 16 px pad) scales and shifts keypoints and polygons as JAX's does."""
    got, _ = _pose_datasets(pose_root[0], imgsz=64)
    raw = got.load_raw(0)
    raw["segments"] = [np.array([[4, 5], [40, 8], [30, 50]], np.float32)] * len(raw["bboxes"])
    a, b = PA.ValTransforms(64)(dict(raw)), JA.ValTransforms(64)(dict(raw))
    _same_sample(a, b)
    for sa, sb in zip(a["segments"], b["segments"]):
        np.testing.assert_array_equal(sa, sb)
    assert a["ratio_pad"][1][1] > 0 and not np.array_equal(a["segments"][0], raw["segments"][0])


# --- (f) OKS, the loss, the validator -------------------------------------------------------------------------


def test_kpt_iou_matches_jax():
    """kpt_iou (COCO's sigmas and 1 / K ones, unlabelled keypoints skipped) equals JAX's within 1e-7; OKS_SIGMA is JAX's."""
    np.testing.assert_array_equal(OKS_SIGMA, JAX_OKS_SIGMA)
    rng = np.random.default_rng(2)
    for K, sigma in ((17, OKS_SIGMA), (4, np.ones(4) / 4)):
        gt = np.concatenate([rng.uniform(0, 100, (5, K, 2)), rng.integers(0, 3, (5, K, 1))], -1).astype(np.float32)
        gt[0, :, 2] = 0  # a gt with no labelled keypoint
        pred = np.concatenate([gt[[1, 2, 3, 1]][..., :2] + rng.normal(0, 2, (4, K, 2)), rng.uniform(0, 1, (4, K, 1))], -1)
        area = rng.uniform(400, 2500, 5).astype(np.float32)
        got, want = kpt_iou(gt, pred, area, sigma), jax_kpt_iou(gt, pred, area, sigma)
        assert got.shape == (5, 4) and not got[0].any() and got.max() > 0.5
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _pose_batch(rng, K, ndim, N):
    """A collated-style batch of 2 images with 3 labelled figures each among N rows, keypoints normalized."""
    batch = {"cls": np.zeros((2, N), np.float32), "bboxes": np.zeros((2, N, 4), np.float32), "mask_gt": np.zeros((2, N), np.float32),
             "keypoints": np.zeros((2, N, K, ndim), np.float32)}
    for b in range(2):
        for j in range(3):
            c, wh = rng.uniform(0.3, 0.7, 2), rng.uniform(0.1, 0.4, 2)
            batch["cls"][b, j], batch["bboxes"][b, j], batch["mask_gt"][b, j] = rng.integers(0, 2), [*c, *wh], 1
            batch["keypoints"][b, j, :, :2] = c + rng.uniform(-0.5, 0.5, (K, 2)) * wh
            if ndim == 3:
                batch["keypoints"][b, j, :, 2] = rng.integers(0, 3, K)
    return batch


@pytest.mark.parametrize("kpt_shape", [(17, 3), (4, 2)])
@pytest.mark.parametrize("n_boxes", [4, 12])
def test_pose_loss_matches_jax(kpt_shape, n_boxes, two_threads):
    """v8PoseLoss on seeded raw outputs (64² input: 84 anchors, nc 2): the five items (box, pose, kobj, cls, dfl) within
    1e-5 relative of JAX's, with (17, 3) keypoints (COCO's sigmas, the kobj BCE) and (4, 2) ones (1 / K sigmas, no kobj),
    on JAX's compact route (topk · N = 40 < 84) and its all-anchor route (N = 12), JAX's loss forced onto each route
    in turn: both give the same items, and the gradients of the inputs within 1e-6 of their largest."""
    jm, pm = _models(kpt_shape, nc=2)
    rng = np.random.default_rng(1)
    K, ndim = kpt_shape
    feats = [rng.normal(0, 1, (2, h, h, 66)).astype(np.float32) for h in (8, 4, 2)]
    kps = [rng.normal(0, 1, (2, h, h, K * ndim)).astype(np.float32) for h in (8, 4, 2)]
    batch = _pose_batch(rng, K, ndim, n_boxes)
    inputs = [torch.from_numpy(a).requires_grad_() for a in feats + kps]
    total, got = v8PoseLoss(pm, HYP)((inputs[:3], inputs[3:]), {k: torch.from_numpy(batch[k]) for k in POSE_KEYS})
    total.backward()
    assert got.shape == (5,) and float(got[1]) > 0 and (float(got[2]) > 0) == (ndim == 3)
    np.testing.assert_allclose(float(total.detach()), float(got.sum()) * 2, rtol=1e-6)
    for compact in (True, False):
        jl = JaxPoseLoss(jm, HYP)
        jl.compact = compact
        (_, want), grads = jax.jit(jax.value_and_grad(lambda f, k, b: jl((f, k), b), argnums=(0, 1), has_aux=True))(
            feats, kps, {k: jnp.asarray(batch[k]) for k in POSE_KEYS})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        for t, g in zip(inputs, [*grads[0], *grads[1]]):
            g = np.asarray(g)
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-6 * max(np.abs(g).max(), 1e-12))


def test_pose_validator_matches_jax(tmp_path, two_threads):
    """PoseValidator on 8 seeded 64x64 frames with 1-2 figures each ((4, 3) keypoints; each package on its own copy of
    the split) with the tuned tree: every box and `pose_` key within 1e-4 of JAX's, fitness their sum, pose mAP50 above 0."""
    data = {pkg: _write_pose_split(tmp_path / pkg, 8, 21) for pkg in ("jax", "torch")}
    jy, py = yolo_tpu.YOLO("yolov8n-pose.yaml"), yolo_tpu_torch.YOLO("yolov8n-pose.yaml", device="cpu")
    jy.model, py.model = _models((4, 3), nc=1)
    jy.params = _tuned(jy.model.init(0), 1)
    py.params = _tuned(py.model.init(0), 1)
    kw = dict(imgsz=64, batch=4, workers=1, plots=False)
    want = jy.val(data=data["jax"], **kw)
    got = py.val(data=data["torch"], **kw)
    assert set(got) == set(want) and "pose_mAP50-95" in got and got["pose_mAP50"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert abs(got["fitness"] - got["pose_fitness"] - (0.1 * got["mAP50"] + 0.9 * got["mAP50-95"])) <= 1e-9


# --- (g) training --------------------------------------------------------------------------------------------------


def test_pose_train_step_matches_jax(two_threads):
    """One step of yolov8n-pose at nc 2 on two seeded 64x64 images with (17, 3) keypoints: JAX's value_and_grad of
    forward_features + v8PoseLoss against the port's train forward and backward (the five items 1e-5 relative, every BN's
    batch moments 1e-4, every gradient 1e-3 of its tensor's largest), then the trainer's AdamW update with the BN running
    moments against JAX's optimizer and `apply_bn_stats` (every leaf 1e-5)."""
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    batch = _pose_batch(np.random.default_rng(8), 17, 3, 8)
    jm, _ = _models((17, 3), nc=2)
    jp = jm.init(0)

    def forward_loss(params):
        ctx = JM.Ctx(train=True)
        total, comps = JaxPoseLoss(jm, HYP)(jm.forward_features(params, jnp.asarray(x), ctx), {k: jnp.asarray(batch[k]) for k in POSE_KEYS})
        return total, (comps, ctx.stats)

    (_, (jcomps, jstats)), jg = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(jp)
    t = DetectionTrainer(overrides=dict(model="yolov8n-pose.yaml", device="cpu", optimizer="AdamW", batch=2, box=7.5, cls=0.5, dfl=1.5),
                         model=_models((17, 3), nc=2)[1])
    t._build_state(iterations=1)
    assert isinstance(t.loss_fn, v8PoseLoss)
    total, comps = t.loss_fn(t.model.forward_features(torch.from_numpy(x)), {k: torch.from_numpy(batch[k]) for k in POSE_KEYS})
    total.backward()
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5, atol=1e-6)
    bns = [(n, m) for n, m in t.model.named_modules() if getattr(m, "batch_stats", None) is not None]
    assert len(bns) == len(jstats) == 63
    for name, m in bns:
        mean, var, n = jstats["/".join(["model", *name.split(".")[1:]]) + "/bn"]
        np.testing.assert_allclose(m.batch_stats[0].numpy(), np.asarray(mean), rtol=0, atol=1e-4)
        np.testing.assert_allclose(m.batch_stats[1].numpy(), np.asarray(var), rtol=0, atol=1e-4)
        assert m.batch_stats[2] == n
    flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    for k, p in t.leaves.items():
        if isinstance(p, torch.nn.Parameter):
            got = PT.tree_from_leaves(t.model, {k: p.grad})
            for part in k.split("/"):
                got = got[part]
            np.testing.assert_allclose(got, flat[k], rtol=0, atol=1e-3 * max(np.abs(flat[k]).max(), 1e-12), err_msg=k)
    lr, mom = 1e-3, 0.9
    jopt = JO.build_optimizer("AdamW", t.args.weight_decay * 2 * 32 / 64)
    new = jax.jit(lambda g, p: jopt.update(g, jopt.init(p), p, lr, mom, lr_bias=lr)[0])(jg, jp)
    want = _flat(JO.apply_bn_stats(new, jstats))
    for k, p in t.leaves.items():
        if isinstance(p, torch.nn.Parameter):
            g = flat[k]
            p.grad = torch.from_numpy((g.transpose(3, 2, 0, 1) if g.ndim == 4 else g).copy())
    t._update(lr, mom, lr)
    got = {k.replace("/", "."): np.asarray(v) for k, v in _flat(PT.tree_from_leaves(t.model, t.leaves)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def tiny_pose_dataset(tmp_path_factory):
    """JAX's tiny pose recipe (tests/test_pose_obb.py): 8 synthetic 160x128 frames, one bright figure each with 4
    keypoints (head, centre, left foot, right foot, the last occluded), kpt_shape [4, 3], flip_idx [0, 1, 3, 2]."""
    root = tmp_path_factory.mktemp("posetiny")
    (root / "images/train").mkdir(parents=True)
    (root / "labels/train").mkdir(parents=True)
    rng = np.random.default_rng(3)
    W, H = 160, 128
    for i in range(8):
        img = rng.normal(30, 8, (H, W, 3)).clip(0, 255).astype(np.uint8)
        cx, cy = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7)
        w, h = 0.2, 0.3
        cv2.rectangle(img, (int((cx - w / 2) * W), int((cy - h / 2) * H)), (int((cx + w / 2) * W), int((cy + h / 2) * H)), (220, 220, 220), -1)
        kpts = [(cx, cy - h / 2 + 0.02, 2), (cx, cy, 2), (cx - w / 4, cy + h / 2 - 0.02, 2), (cx + w / 4, cy + h / 2 - 0.02, 1)]
        for kx, ky, _ in kpts:
            cv2.circle(img, (int(kx * W), int(ky * H)), 2, (40, 40, 40), -1)
        row = f"0 {cx:.4f} {cy:.4f} {w:.4f} {h:.4f} " + " ".join(f"{kx:.4f} {ky:.4f} {v}" for kx, ky, v in kpts)
        cv2.imwrite(str(root / f"images/train/{i}.png"), img)
        (root / f"labels/train/{i}.txt").write_text(row + "\n")
    (root / "dataset.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/train\n"
                                       "kpt_shape: [4, 3]\nflip_idx: [0, 1, 3, 2]\nnames:\n  0: person\n")
    return str(root / "dataset.yaml")


def test_pose_train_on_the_tiny_recipe(tiny_pose_dataset, tmp_path, two_threads):
    """YOLO("yolov8n-pose.yaml").train on JAX's tiny pose recipe (3 epochs, imgsz 160, batch 4, AdamW, mosaic 0, f32):
    the dataset's kpt_shape [4, 3] overrides the yaml's, results.csv has three rows with the five finite loss columns
    and the pose metrics, last.npz and best.npz are pose checkpoints at (4, 3), and the trained model predicts (4, 3)
    keypoints; the loader's first batch carries (4, 64, 4, 3) normalized keypoints."""
    import csv

    from yolo_tpu_torch.data import build_dataloader, build_yolo_dataset, check_det_dataset

    data = check_det_dataset(tiny_pose_dataset)
    ds = build_yolo_dataset(PC.get_cfg({"imgsz": 160, "mosaic": 1.0}), data["train"], data, mode="train", stride=32)
    assert ds.kpt_shape == (4, 3) and ds.flip_idx == FLIP4
    b = next(iter(build_dataloader(ds, 4, workers=1, seed=0)))
    vis = b["keypoints"][..., 2] != 0
    assert b["keypoints"].shape == (4, 64, 4, 3) and vis.sum() > 0
    assert (b["keypoints"][vis][:, :2] >= 0).all() and (b["keypoints"][vis][:, :2] <= 1).all()
    y = yolo_tpu_torch.YOLO("yolov8n-pose.yaml", device="cpu")
    m = y.train(data=tiny_pose_dataset, epochs=3, imgsz=160, batch=4, workers=1, optimizer="AdamW", lr0=0.002, warmup_epochs=0.5,
                mosaic=0.0, project=str(tmp_path), name="pexp", val=True, plots=False, amp=False)
    assert m is not None and "pose_mAP50-95" in m
    assert y.trainer.model.head.kpt_shape == (4, 3) and y.task == "pose"
    rows = list(csv.DictReader(open(tmp_path / "pexp" / "results.csv")))
    assert len(rows) == 3 and "metrics/pose_mAP50" in rows[-1]
    for comp in ("box", "pose", "kobj", "cls", "dfl"):
        assert np.isfinite(float(rows[-1][f"train/{comp}_loss"]))
    for name in ("last.npz", "best.npz"):
        ck = yolo_tpu_torch.YOLO(str(tmp_path / "pexp" / "weights" / name), device="cpu")
        assert ck.task == "pose" and ck.model.head.kpt_shape == (4, 3)
    r = y.predict(np.zeros((128, 160, 3), np.uint8), imgsz=160, conf=0.0, max_det=5, verbose=False)[0]
    assert r.keypoints.data.shape == (len(r), 4, 3)


def test_pose_check_amp_holds_keypoints_in_pixels():
    """check_amp on yolov8n-pose at init(0): keypoint x and y are held as boxes are (2 px) and visibilities as scores
    (0.05), so an untrained pose model keeps bf16; a tree whose keypoint raws are large moves x, y by whole pixels in
    bf16 and still passes, where the JAX package's check (keypoint pixels at 0.05) turns bf16 off."""
    from yolo_tpu.utils.checks import check_amp as jax_check_amp

    from yolo_tpu_torch.utils.checks import check_amp

    jm, pm = JT.PoseModel("yolov8n-pose.yaml"), PT.PoseModel("yolov8n-pose.yaml", device="cpu")
    params = _tuned(jm.init(0), 1)
    for l in range(3):
        params["model"]["22"]["cv4"][str(l)]["2"]["bias"][0::3] = 7.3
    assert check_amp(pm, params)
    assert not jax_check_amp(jm, params)


# --- (h) track and the left-outs ------------------------------------------------------------------------------------


def _track_frames(n=4):
    """n BGR 96x128 frames of three bright figures drifting right by 2 px a frame."""
    rng = np.random.default_rng(12)
    base = rng.normal(40, 6, (96, 128)).clip(0, 255).astype(np.float32)
    boxes = [(14, 20, 40, 60), (60, 14, 84, 50), (90, 40, 118, 84)]
    frames = []
    for f in range(n):
        img = base.copy()
        for x1, y1, x2, y2 in boxes:
            cv2.rectangle(img, (x1 + 2 * f, y1), (x2 + 2 * f, y2), 200.0, -1)
        frames.append(cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    return frames


@pytest.mark.parametrize("task", ["pose", "segment"])
def test_track_carries_keypoints_and_masks_as_jax(pose_pair, task):
    """YOLO.track (bytetrack, persist, f32, imgsz 64) over four frames with a pose and a segment model, against JAX's:
    equal tracked rows and ids per frame (boxes 1e-3 px), and each track's keypoints (1e-3 px) or masks (equal) follow
    their box, in the tracker's order."""
    from tests.test_torch_segment import _tuned as seg_tuned

    if task == "pose":
        jy, py, _ = pose_pair
    else:
        jy, py = yolo_tpu.YOLO("yolov8n-seg.yaml"), yolo_tpu_torch.YOLO("yolov8n-seg.yaml", device="cpu")
        jy.params, py.params = seg_tuned(jy.params, 80), seg_tuned(py.params, 80)
    jy._tracker = py._tracker = None
    kw = dict(imgsz=64, compute_dtype="float32", max_det=30, verbose=False, persist=True, tracker="bytetrack.yaml", conf=0.1)
    if task == "segment":
        kw["retina_masks"] = False
    n_tracked = 0
    for frame in _track_frames():
        rj, rp = jy.track(frame, **kw)[0], py.track(frame, **kw)[0]
        assert rp.boxes.data.shape == rj.boxes.data.shape and rp.boxes.is_track == rj.boxes.is_track
        np.testing.assert_allclose(rp.boxes.data, rj.boxes.data, rtol=0, atol=1e-3)
        if task == "pose":
            assert len(rp.keypoints) == len(rp)
            np.testing.assert_allclose(rp.keypoints.data, rj.keypoints.data, rtol=0, atol=1e-3)
        else:
            assert len(rp.masks) == len(rp)
            np.testing.assert_array_equal(rp.masks.data, rj.masks.data)
        n_tracked += len(rp) if rp.boxes.is_track else 0
    assert n_tracked > 0


def test_pose_entry_points_left_out_raise(pose_pair):
    """What stays refused for a pose model names itself with NotImplementedError: FusedDetectTrack (the JAX package
    asserts a plain Detect head) and ensembles (JAX's raises AttributeError); augment=True warns and predicts at one
    scale (as JAX's pose route ignores it). benchmark, tune, tiled inference, int8 predict and a server lane run since
    the seventeenth slice (tests/test_torch_task_entry_points.py holds them against JAX)."""
    from yolo_tpu_torch.pipeline.fused import FusedDetectTrack

    _, py, frames = pose_pair
    for call, what in ((lambda: FusedDetectTrack(py.model, py.params, device="cpu"), "FusedDetectTrack"),
                       (lambda: yolo_tpu_torch.YOLO(["yolov8n-pose.yaml", "yolov8n-pose.yaml"], device="cpu"), "ensemble")):
        with pytest.raises(NotImplementedError, match=what):
            call()
    py.predictor = None
    one = py.predict(frames[0], **PREDICT_KW)[0]
    aug = py.predict(frames[0], augment=True, **PREDICT_KW)[0]
    np.testing.assert_array_equal(aug.keypoints.data, one.keypoints.data)
    py.predictor = None  # a reused predictor keeps augment
