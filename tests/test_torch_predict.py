"""The port's predict facade against the JAX package: box helpers, letterbox
(host and device), `non_max_suppression` with `classes` / `agnostic` and
planted ties, `Detect.decode` / `DetectionModel.predict`, the Results
containers and `YOLO(best.npz).predict`. Inputs come from seeded numpy
generators; the port runs on the CPU through the kernels' plain twins.
Tolerances are stated at each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine import results as JR
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.ops import boxes as JB
from yolo_tpu.ops import letterbox as JL
from yolo_tpu.ops import nms as JN
from yolo_tpu_torch import DetectionModel, params_from_jax
from yolo_tpu_torch.engine import results as PR
from yolo_tpu_torch.engine.predictor import BasePredictor, PredictArgs, _iter_source, _snap_batch
from yolo_tpu_torch.ops import boxes as PB
from yolo_tpu_torch.ops import letterbox as PL
from yolo_tpu_torch.ops import nms as PN

from tests.conftest import ROOT
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


def _boxes(rng, n):
    xy = rng.uniform(-20, 600, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 120, (n, 2))], -1).astype(np.float32)


# --- ops/boxes ------------------------------------------------------------------


@pytest.mark.parametrize("as_torch", [False, True])
def test_box_helpers_match_jax(as_torch):
    rng = np.random.default_rng(0)
    b = _boxes(rng, 9)
    arg = torch.from_numpy(b) if as_torch else b
    out = lambda v: v.numpy() if as_torch else v  # noqa: E731
    np.testing.assert_allclose(out(PB.xyxy2xywh(arg)), JB.xyxy2xywh(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out(PB.clip_boxes(arg, (512, 640))), JB.clip_boxes(b, (512, 640)), rtol=0, atol=0)
    for img1, img0, ratio_pad, xywh in [
        ((640, 640), (512, 640), None, False),
        ((384, 640), (1080, 1920), None, False),
        ((640, 640), (512, 640), ((1.0, 1.0), (0.0, 64.0)), False),
        ((640, 640), (300, 500), None, True),
    ]:
        got = PB.scale_boxes(img1, arg, img0, ratio_pad=ratio_pad, xywh=xywh)
        want = JB.scale_boxes(img1, b, img0, ratio_pad=ratio_pad, xywh=xywh)
        np.testing.assert_allclose(out(got), want, rtol=1e-6, atol=1e-5)
    assert PB.xyxy2xywh(b[:0]).shape == (0, 4)


# --- ops/letterbox ----------------------------------------------------------------


@pytest.mark.parametrize("shape,new_shape,kw", [
    ((512, 640), (640, 640), {}),
    ((300, 500), 640, {}),
    ((1080, 1920), (384, 640), dict(scaleup=False)),
    ((100, 90), (640, 640), dict(auto=True, stride=32)),
    ((480, 640), (640, 640), dict(center=False)),
])
def test_letterbox_params_match_jax(shape, new_shape, kw):
    assert PL.letterbox_params(shape, new_shape, **kw) == JL.letterbox_params(shape, new_shape, **kw)


def test_letterbox_without_resize_is_exact_and_needs_no_cv2(monkeypatch):
    import sys

    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (512, 640, 3), np.uint8)
    want, want_meta = JL.LetterBox((640, 640))(img, return_meta=True)
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` would raise: padding alone must not need it
    got, got_meta = PL.LetterBox((640, 640))(img, return_meta=True)
    assert got_meta == want_meta == ((1.0, 1.0), (0.0, 64.0))
    np.testing.assert_array_equal(got, want)
    gray = PL.LetterBox((640, 640))(img[..., 0])
    assert gray.shape == (640, 640, 1) and gray[0, 0, 0] == 114 and gray[64, 5, 0] == img[0, 5, 0]


@pytest.mark.parametrize("shape,kw", [((300, 500), {}), ((700, 900), {}), ((40, 50), dict(scaleup=False)), ((200, 100), dict(scale_fill=True))])
def test_letterbox_with_resize_matches_jax(shape, kw):
    """Both sides resize with cv2's INTER_LINEAR; they may differ by one intensity level at most."""
    img = np.random.default_rng(2).integers(0, 255, (*shape, 3), np.uint8)
    got, got_meta = PL.LetterBox((640, 640), **kw)(img, return_meta=True)
    want, want_meta = JL.LetterBox((640, 640), **kw)(img, return_meta=True)
    assert got_meta == want_meta and got.shape == want.shape == (640, 640, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("src,dst", [((48, 60), (96, 96)), ((100, 140), (64, 64)), ((64, 80), (80, 80))])
def test_letterbox_device_matches_jax(src, dst):
    """Up, down (both sides antialias when they shrink) and pad only; atol 1e-3 on 0..255 values."""
    x = np.random.default_rng(3).uniform(0, 255, (2, *src, 3)).astype(np.float32)
    got, got_meta = PL.letterbox_device(torch.from_numpy(x), src, dst)
    want, want_meta = JL.letterbox_device(jnp.asarray(x), src, dst)
    assert got_meta == want_meta and tuple(got.shape) == (2, *dst, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


# --- ops/nms ------------------------------------------------------------------------


def _planted_prediction(rng, B=3, A=80, nc=4):
    cxcy = rng.uniform(20, 200, (B, A, 2))
    wh = rng.uniform(8, 60, (B, A, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    boxes[:, 1::5] = boxes[:, 0::5]  # duplicate boxes
    scores = rng.uniform(0, 1, (B, A, nc)).round(1).astype(np.float32)  # many equal scores
    scores[:, 1::5] = scores[:, 0::5]  # duplicates tie with their originals, in every class
    scores[:, 7] = 0.9  # one anchor with all classes tied: argmax must take class 0 on both sides
    return np.concatenate([boxes, scores], -1).transpose(0, 2, 1).copy()


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("classes,agnostic", [(None, False), ([1, 3], False), (None, True), ([0, 2], True)])
def test_non_max_suppression_matches_jax(plain, classes, agnostic):
    pred = _planted_prediction(np.random.default_rng(4))
    kw = dict(conf_thres=0.25, iou_thres=0.5, classes=classes, agnostic=agnostic, max_det=20, max_nms=64)
    want = JN.non_max_suppression(jnp.asarray(pred), **kw)
    got = PN.non_max_suppression(torch.from_numpy(pred), plain=plain, **kw)
    assert int(got["valid"].sum()) > 10
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(want["cls"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=0)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-4)
    if classes is not None:
        assert set(got["cls"][got["valid"]].tolist()) <= set(classes)
    # with nc given, the rows after 4 + nc ride through as extras (the segment task's coefficients), as in JAX
    want, got = JN.non_max_suppression(jnp.asarray(pred), nc=2, **kw), PN.non_max_suppression(torch.from_numpy(pred), nc=2, plain=plain, **kw)
    assert set(got) == set(want) == {"boxes", "scores", "cls", "valid", "extra"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)


# --- Detect.decode / DetectionModel.predict ---------------------------------------------


@pytest.fixture(scope="module")
def tiny_model():
    jm = JaxDetectionModel("yolov8n.yaml", nc=3)
    jp = jm.fuse(jm.init(0))
    pm = DetectionModel("yolov8n.yaml", nc=3, device="cpu")
    params_from_jax(pm, jax.tree_util.tree_map(np.asarray, jp), torch.float32)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    return jm, jp, pm, x


@pytest.mark.parametrize("neck_opt", [True, False])
def test_model_predict_matches_jax(tiny_model, neck_opt):
    jm, jp, pm, x = tiny_model
    want = np.asarray(jax.jit(lambda p, v: jm.predict(p, v, dtype=jnp.float32, neck_opt=neck_opt))(jp, jnp.asarray(x)))
    got = pm.predict(torch.from_numpy(x), neck_opt=neck_opt)
    assert tuple(got.shape) == want.shape == (2, 4 + 3, 8 * 12 + 4 * 6 + 2 * 3)
    np.testing.assert_allclose(got[:, :4].numpy(), want[:, :4], rtol=0, atol=2e-3)  # boxes, px
    np.testing.assert_allclose(got[:, 4:].numpy(), want[:, 4:], rtol=0, atol=1e-4)  # scores


def test_detect_decode_matches_jax(tiny_model):
    """The raw per-level walk (Detect.forward) and its decode, against JAX Detect.__call__ / decode_parts / decode."""
    jm, jp, pm, x = tiny_model
    ctx = yolo_tpu.nn.modules.Ctx(train=False, dtype=jnp.float32)
    hp = jp["model"][str(jm.layers[-1].i)]
    rng = np.random.default_rng(6)
    xs = [rng.normal(0, 1, (2, h, w, m.c1)).astype(np.float32) for (h, w), m in zip([(8, 12), (4, 6), (2, 3)], [b[0] for b in pm.head.cv2])]
    want_outs = jm.head(hp, [jnp.asarray(v) for v in xs], ctx)
    got_outs = pm.head([torch.from_numpy(v) for v in xs])
    for g, w in zip(got_outs, want_outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    want_b, want_s = jm.head.decode_parts(hp, want_outs)
    got_b, got_s = pm.head.decode_parts(got_outs)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    got = pm.head.decode(got_outs)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.head.decode(hp, want_outs)), rtol=0, atol=2e-3)
    # the kernels' route from the head inputs gives the same decode
    kb, ks = pm.head.decode_from_inputs([torch.from_numpy(v) for v in xs])
    np.testing.assert_allclose(kb.numpy(), got_b.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ks.numpy(), got_s.numpy(), rtol=0, atol=1e-5)


def test_model_init_is_seeded_and_loadable():
    pm = DetectionModel("yolov8n.yaml", nc=2, device="cpu")
    p0, p1, p2 = pm.init(0), pm.init(0), pm.init(1)
    w = lambda p: p["model"]["0"]["conv"]["weight"]  # noqa: E731
    assert w(p0).shape == (3, 3, 3, 16) and np.array_equal(w(p0), w(p1)) and not np.array_equal(w(p0), w(p2))
    head = p0["model"][str(len(pm.layers) - 1)]
    assert np.all(head["cv2"]["0"]["2"]["bias"] == 1.0) and head["dfl"]["conv"]["weight"].shape == (1, 1, 16, 1)
    np.testing.assert_allclose(head["cv3"]["1"]["2"]["bias"], np.log(5 / 2 / (640 / 16) ** 2), rtol=1e-6)
    params_from_jax(pm, p0, torch.float32)
    out = pm.predict(torch.rand(1, 64, 64, 3))
    assert tuple(out.shape) == (1, 6, 84) and bool(torch.isfinite(out).all())


# --- engine/results -------------------------------------------------------------------------


def test_results_containers_match_jax():
    rng = np.random.default_rng(7)
    data = np.concatenate([_boxes(rng, 5), rng.uniform(0, 1, (5, 1)), rng.integers(0, 2, (5, 1))], -1).astype(np.float32)
    img = np.zeros((512, 640, 3), np.uint8)
    names = {0: "aircraft", 1: "bird"}
    got, want = PR.Results(img, "a.jpg", names, boxes=data), JR.Results(img, "a.jpg", names, boxes=data)
    assert len(got) == len(want) == 5 and got.verbose() == want.verbose() and got.orig_shape == (512, 640)
    for attr in ("xyxy", "conf", "cls", "xywh", "xyxyn", "xywhn"):
        np.testing.assert_allclose(getattr(got.boxes, attr), getattr(want.boxes, attr), rtol=0, atol=1e-6, err_msg=attr)
    assert got.boxes.id is None and set(got.speed) == {"preprocess", "inference", "postprocess"}
    np.testing.assert_array_equal(got[1:3].boxes.data, want[1:3].boxes.data)
    np.testing.assert_array_equal(got[2].boxes.data, want[2].boxes.data)
    np.testing.assert_array_equal(got.boxes[[0, 4]].data, want.boxes[[0, 4]].data)
    empty = PR.Results(img, "a.jpg", names)
    assert len(empty) == 0 and empty.verbose() == JR.Results(img, "a.jpg", names).verbose() == "512x640 (no detections), "
    tracked = PR.Boxes(np.insert(data, 4, np.arange(5), axis=1), (512, 640))
    assert tracked.is_track and list(tracked.id) == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(tracked.conf, data[:, 4])
    with pytest.raises(ValueError, match="6 or 7"):
        PR.Boxes(np.zeros((2, 5), np.float32), (4, 4))


@pytest.mark.parametrize("tracked", [False, True])
def test_results_plot_save_txt_and_json_match_jax(tracked, tmp_path):
    """The same boxes (some partly outside the image, one class unnamed) in both packages' Results:
    equal `plot` pixels (default and thin lines, labels off, a gray image), equal `save_txt` lines
    (with and without conf), equal `summary` / `to_json` (plain and normalised) and `save` files."""
    from yolo_tpu.utils.files import imread

    rng = np.random.default_rng(15)
    data = np.concatenate([_boxes(rng, 6), rng.uniform(0, 1, (6, 1)), rng.integers(0, 3, (6, 1))], -1).astype(np.float32)
    if tracked:
        data = np.insert(data, 4, np.arange(10, 16), axis=1)
    img = rng.integers(0, 255, (512, 640, 3), np.uint8)
    names = {0: "aircraft", 1: "bird"}
    got, want = PR.Results(img, "dir/f.png", names, boxes=data), JR.Results(img, "dir/f.png", names, boxes=data)
    for kw in ({}, dict(line_width=1, conf=False), dict(labels=False), dict(img=img[..., 0])):
        np.testing.assert_array_equal(got.plot(**kw), want.plot(**kw))
    assert not np.array_equal(got.plot(), img)
    for conf in (False, True):
        got.save_txt(tmp_path / f"p{conf}.txt", save_conf=conf)
        want.save_txt(tmp_path / f"j{conf}.txt", save_conf=conf)
        assert (tmp_path / f"p{conf}.txt").read_text() == (tmp_path / f"j{conf}.txt").read_text() != ""
    for normalize in (False, True):
        assert got.summary(normalize=normalize) == want.summary(normalize=normalize)
        assert got.to_json(normalize=normalize) == want.to_json(normalize=normalize)
    assert ("track_id" in got.summary()[0]) == tracked
    assert got.save(str(tmp_path / "p.png")) == str(tmp_path / "p.png")
    want.save(str(tmp_path / "j.png"))
    np.testing.assert_array_equal(imread(tmp_path / "p.png"), imread(tmp_path / "j.png"))
    empty = PR.Results(img, "a.jpg", names)
    empty.save_txt(tmp_path / "e.txt")
    assert (tmp_path / "e.txt").read_text() == "" and empty.to_json() == "[]"


@pytest.mark.parametrize("shape,dst", [((512, 640, 3), (640, 640)), ((300, 500, 3), (640, 640)), ((700, 900, 3), (640, 640)),
                                       ((1080, 1920, 3), (640, 640)), ((100, 80, 1), (64, 96)), ((64, 96, 3), (64, 96)),
                                       ((100, 80, 1), (100, 96))])
def test_native_letterbox_matches_jax_library(shape, dst):
    """The port's native library (its copy of preprocess.cpp, its own build) against the JAX package's
    on the same input: bit for bit, meta equal (the f32 ratio), one image and a batch of three; the
    frames that need no resize (512x640 and 100x80 padded, 64x96 as it is) take the port's row copy."""
    from yolo_tpu_torch import native as PNAT

    rng = np.random.default_rng(16)
    img = rng.integers(0, 255, shape, np.uint8)
    got, got_meta = PNAT.letterbox(img, dst)
    want, want_meta = yolo_tpu.native.letterbox(img, dst)
    assert got_meta == want_meta and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    frames = rng.integers(0, 255, (3, *shape), np.uint8)
    got_b, got_bmeta = PNAT.letterbox_batch(frames, dst)
    want_b, want_bmeta = yolo_tpu.native.letterbox_batch(frames, dst)
    assert got_bmeta == want_bmeta
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_b[1], PNAT.letterbox(frames[1], dst)[0])
    with pytest.raises(ValueError, match="uint8"):
        PNAT.letterbox(img.astype(np.float32), dst)


# --- engine/predictor + engine/model ------------------------------------------------------------


def _ir_frame(rng, h, w, cx, cy):
    yy, xx = np.mgrid[0:h, 0:w]
    img = 30 + rng.normal(0, 2, (h, w)) + 170 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def yolos():
    return yolo_tpu.YOLO(str(WEIGHTS)), yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")


def _assert_same_results(got, want, box_atol):
    assert [len(r) for r in got] == [len(r) for r in want]
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and g.path == w.path
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=box_atol)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)


def test_yolo_predict_matches_jax(yolos):
    """Three 96x128 frames that fit imgsz exactly (pure padding on both sides):
    same count, boxes within 1e-2 px, conf within 1e-4. The JAX side is asked
    for f32 (its default compute dtype is bf16); a batch of 3 snaps to 4."""
    jy, py = yolos
    rng = np.random.default_rng(8)
    frames = [np.repeat(_ir_frame(rng, 96, 128, cx, cy)[..., None], 3, -1) for cx, cy in ((40, 30), (90, 60), (20, 80))]
    frames.append(np.full((96, 128, 3), 30, np.uint8))  # nothing to detect
    kw = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=3, compute_dtype="float32")
    want = jy.predict(frames, **kw)
    got = py.predict(frames, **kw)
    assert [len(r) for r in got] == [1, 1, 1, 0]
    _assert_same_results(got, want, box_atol=1e-2)
    assert got[0].names == want[0].names and all(v is not None and v >= 0 for v in got[0].speed.values())
    assert py.names == jy.names and py.stride == jy.stride == [4, 8, 16, 32]
    # a reused predictor takes new settings: nothing passes conf 0.99; the single gray frame is expanded
    assert [len(r) for r in py.predict(frames, **{**kw, "conf": 0.99})] == [0, 0, 0, 0]
    one = py(frames[0][..., 0], **kw)
    assert len(one) == 1 and one[0].path == "array"
    np.testing.assert_allclose(one[0].boxes.data, got[0].boxes.data, rtol=0, atol=1e-4)
    # plain=True (the twins by name) is the same route on the CPU (a batch of 1, so sums differ in the last bit)
    np.testing.assert_allclose(py.predict(frames[0], plain=True, **kw)[0].boxes.data, got[0].boxes.data, rtol=0, atol=1e-5)
    # augment=True is test-time augmentation (held against JAX in test_yolo_predict_augment_matches_jax)
    assert len(py.predict(frames[0], augment=True, **kw)) == 1
    py.predictor.args.augment = False  # settings persist on a reused predictor; the module's other tests run at one scale


def _ir_targets(rng, h, w, sigma):
    """An (h, w, 3) IR frame with three bright targets of `sigma` px at fixed fractions of the frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = 30 + rng.normal(0, 2, (h, w))
    for fx, fy in ((0.2, 0.3), (0.6, 0.7), (0.8, 0.2)):
        img = img + 170 * np.exp(-((xx - fx * w) ** 2 + (yy - fy * h) ** 2) / (2 * sigma**2))
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)


@pytest.mark.parametrize("route", ["native", "cv2"])
def test_yolo_predict_resized_frames_match_jax(yolos, route, monkeypatch):
    """Frames the letterbox resizes into imgsz 640 (300x500 and 700x900 scale up, 1080x1920 down),
    f32 in both packages: the default route letterboxes with the native library on both sides,
    YOLO_TPU_NATIVE_PRE=0 with cv2 on both. Same counts and classes, boxes within 1e-2 px, conf 1e-4."""
    from yolo_tpu_torch import native

    if route == "cv2":
        monkeypatch.setenv("YOLO_TPU_NATIVE_PRE", "0")
    else:
        assert native.available() and yolo_tpu.native.available()
    jy, py = yolos
    rng = np.random.default_rng(14)
    frames = [_ir_targets(rng, h, w, 4.0 * max(1.0, max(h, w) / 640)) for h, w in ((300, 500), (700, 900), (1080, 1920))]
    kw = dict(conf=0.1, iou=0.6, imgsz=640, verbose=False, batch=1, compute_dtype="float32")
    want, got = jy.predict(frames, **kw), py.predict(frames, **kw)
    assert [len(r) for r in got] == [3, 3, 3]
    _assert_same_results(got, want, box_atol=1e-2)


def test_yolo_predict_letterboxed_source_matches_jax(yolos):
    """A (N, H, W, 3) array batch that needs padding (64x128 into 128x128): the
    boxes come back in source coordinates, clipped to the source."""
    jy, py = yolos
    rng = np.random.default_rng(9)
    batch = np.stack([np.repeat(_ir_frame(rng, 64, 128, cx, cy)[..., None], 3, -1) for cx, cy in ((40, 30), (100, 8))])
    kw = dict(conf=0.1, iou=0.6, imgsz=128, verbose=False, batch=2, compute_dtype="float32")
    want = jy.predict(batch, **kw)
    got = py.predict(batch, stream=True, **kw)
    assert not isinstance(got, list)
    got = list(got)
    _assert_same_results(got, want, box_atol=1e-2)
    assert sum(len(r) for r in got) >= 2 and got[0].path == "image0.jpg"
    assert all(r.boxes.xyxy[:, [1, 3]].max() <= 64 for r in got if len(r))


def _write_media(root, rng):
    """Two PNG frames and a 3-frame mp4v video of 96x128 IR frames with one target each."""
    import cv2

    root.mkdir(parents=True, exist_ok=True)
    for i, (cx, cy) in enumerate(((40, 30), (90, 60))):
        cv2.imwrite(str(root / f"f{i}.png"), np.repeat(_ir_frame(rng, 96, 128, cx, cy)[..., None], 3, -1))
    vw = cv2.VideoWriter(str(root / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (128, 96))
    for cx in (20, 60, 100):
        vw.write(np.repeat(_ir_frame(rng, 96, 128, cx, 50)[..., None], 3, -1))
    vw.release()
    return root


def test_predictor_save_outputs_match_jax(yolos, tmp_path):
    """`save`, `save_txt` (with conf), `save_crop` and `save_frames` from a BasePredictor of each package
    on a directory of two PNGs and a video (f32, conf 0.1): the same files under <project>/<name>
    (<stem>.jpg, <stem>.mp4 and its frames, labels/<stem>[_<frame>].txt, crops/<class>/...), label lines
    with the same classes and values within 1e-4 (a box 1e-2 px of 128), the same video frame count."""
    import cv2

    jy, py = yolos
    media = _write_media(tmp_path / "media", np.random.default_rng(17))
    kw = {"conf": 0.1, "iou": 0.6, "imgsz": (96, 128), "batch": 1, "compute_dtype": "float32", "verbose": False, "save": True,
          "save_txt": True, "save_conf": True, "save_crop": True, "save_frames": True, "exist_ok": True, "name": "pred"}
    jp = yolo_tpu.engine.predictor.BasePredictor(jy.model, jy.params, overrides={**kw, "project": str(tmp_path / "jax")}, names=jy.names)
    pp = BasePredictor(py.model, py.params, overrides={**kw, "project": str(tmp_path / "port"), "device": "cpu"}, names=py.names)
    want, got = jp(str(media)), pp(str(media))
    assert [len(r) for r in got] == [len(r) for r in want] == [1] * 5
    assert pp.save_dir == tmp_path / "port" / "pred"
    files = lambda d: sorted(str(f.relative_to(d)) for f in d.rglob("*") if f.is_file())  # noqa: E731
    assert files(pp.save_dir) == files(jp.save_dir) == sorted([
        "f0.jpg", "f1.jpg", "clip.mp4", "clip_frames/0.jpg", "clip_frames/1.jpg", "clip_frames/2.jpg",
        "labels/f0.txt", "labels/f1.txt", "labels/clip_0.txt", "labels/clip_1.txt", "labels/clip_2.txt",
        "crops/aircraft/f0_0_0.jpg", "crops/aircraft/f1_0_0.jpg",
        "crops/aircraft/clip_0_0.jpg", "crops/aircraft/clip_1_0.jpg", "crops/aircraft/clip_2_0.jpg"])
    for f in files(pp.save_dir):
        if f.endswith(".txt"):
            g, w = (np.loadtxt(d / f, ndmin=2) for d in (pp.save_dir, jp.save_dir))
            np.testing.assert_array_equal(g[:, 0], w[:, 0])
            np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0, atol=1e-4)
        elif f.endswith(".jpg"):
            g, w = (cv2.imread(str(d / f)) for d in (pp.save_dir, jp.save_dir))
            assert g.shape == w.shape and np.abs(g.astype(int) - w.astype(int)).mean() < 1.0
    counts = [int(cv2.VideoCapture(str(d / "clip.mp4")).get(cv2.CAP_PROP_FRAME_COUNT)) for d in (pp.save_dir, jp.save_dir)]
    assert counts == [3, 3]


def test_yolo_predict_save_crop_like_jax(yolos, tmp_path, monkeypatch):
    """`YOLO.predict(..., save_crop=True)` from the working directory: crops under runs/detect/predict/crops
    in both packages, the same names; `save=False` (the facade's default) writes no image."""
    jy, py = yolos
    frame = np.repeat(_ir_frame(np.random.default_rng(18), 96, 128, 50, 40)[..., None], 3, -1)
    kw = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=1, compute_dtype="float32", save_crop=True)
    names = {}
    for pkg, y in (("jax", jy), ("port", py)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        assert len(y.predict(frame, **kw)[0]) == 1
        y.predictor.args.save_crop = False  # the facade keeps a setting on its predictor
        names[pkg] = sorted(str(f.relative_to(tmp_path / pkg)) for f in (tmp_path / pkg).rglob("*") if f.is_file())
    assert names["port"] == names["jax"] == ["runs/detect/predict/crops/aircraft/array_0_0.jpg"]


def test_predictor_pieces():
    assert [_snap_batch(n) for n in (1, 2, 3, 5, 16, 17)] == [1, 2, 4, 8, 16, 32]
    a = PredictArgs()
    assert (a.conf, a.iou, a.imgsz, a.half, a.classes, a.agnostic_nms, a.max_det, a.batch, a.vid_stride) == (
        0.25, 0.7, 640, False, None, False, 300, 16, 1)
    f = np.zeros((8, 8, 3), np.uint8)
    assert [(p, i) for _, p, i in _iter_source([f, f])] == [("array0", 0), ("array1", 0)]
    assert [p for _, p, _ in _iter_source(np.zeros((2, 8, 8, 3), np.uint8))] == ["image0.jpg", "image1.jpg"]
    # a float batch is (B, 3, H, W) or (B, H, W, 3) in [0, 1], as the JAX LoadTensor takes it
    halves = [im for im, _, _ in _iter_source(np.full((2, 3, 8, 8), 0.5, np.float32))]
    assert len(halves) == 2 and halves[0].shape == (8, 8, 3) and (halves[0] == 128).all()
    with pytest.raises(ValueError, match="normalized"):
        list(_iter_source(np.full((2, 8, 8, 3), 2.0, np.float32)))
    for missing in ("frames.txt", "no_such_clip.mp4"):  # a missing source: FileNotFoundError, as in JAX
        with pytest.raises(FileNotFoundError):
            list(_iter_source(missing))


def test_predictor_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        yolo_tpu_torch.YOLO("yolov8n.yaml")
    model = DetectionModel("yolov8n.yaml", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BasePredictor(model, model.init(0))
    pred = BasePredictor(model, model.init(0), overrides={"device": "cpu", "half": True, "verbose": False})
    assert pred.device == torch.device("cpu") and pred.dtype == torch.bfloat16
    out = pred._predict(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert out["boxes"].shape == (1, 300, 4) and out["valid"].dtype == torch.bool
    assert yolo_tpu_torch.YOLO("yolov8n-pose.yaml", task="pose", device="cpu").task == "pose"
    assert yolo_tpu_torch.YOLO("yolov8n-obb.yaml", task="obb", device="cpu").task == "obb"
    with pytest.raises(NotImplementedError, match="pose, obb"):  # the ported tasks are named: an unknown one is not among them
        yolo_tpu_torch.YOLO("yolov8n.yaml", task="depth", device="cpu")
    with pytest.raises(ValueError, match="unsupported model source"):
        yolo_tpu_torch.YOLO("weights.onnx", device="cpu")


def test_reused_yolo_takes_half_and_back():
    """`half` on a YOLO that has already predicted changes the compute dtype of
    the installed weights and of the forward, and changes back; the same
    settings do not reload the tree."""
    py = yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
    frame = np.random.default_rng(10).integers(0, 255, (64, 64, 3), np.uint8)
    kw = dict(imgsz=64, conf=0.001, verbose=False, compute_dtype="float32")
    stem = py.model.layers[0]
    r32 = py.predict(frame, **kw)
    pred = py.predictor
    assert pred.dtype == torch.float32 and stem.weight.dtype == torch.float32
    seen = []
    real = py.model.predict
    py.model.predict = lambda x, **k: (seen.append(x.dtype), real(x, **k))[1]
    r16 = py.predict(frame, half=True, **kw)
    assert py.predictor is pred and pred.dtype == torch.bfloat16 and stem.weight.dtype == torch.bfloat16
    w16 = stem.weight
    py.predict(frame, **kw)  # `half` stays as it was set: nothing is reloaded
    assert stem.weight is w16
    r32b = py.predict(frame, half=False, **kw)
    assert seen == [torch.bfloat16, torch.bfloat16, torch.float32] and stem.weight.dtype == torch.float32
    np.testing.assert_array_equal(r32b[0].boxes.data, r32[0].boxes.data)
    assert len(r16) == 1


def _frame_640x512(seed):
    """A 640x512 BGR frame with three bright targets; imgsz 640 only pads it (no resize, so no
    bilinear rounding that differs between the two packages' letterboxes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:512, 0:640]
    img = 30 + rng.normal(0, 2, (512, 640))
    for cx, cy in ((100, 120), (400, 300), (300, 80)):
        img = img + 170 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2))
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)


# bf16 against bf16 (the two packages round their activations in another order): boxes and scores
# may differ by a few bf16 steps, 2^-8 of a score near 1
BF16_BOX_PX, BF16_CONF = 0.25, 2e-2


@pytest.mark.parametrize("dtype", ["default", "float32"])
def test_yolo_predict_dtype_matches_jax(dtype, two_threads):
    """A fresh YOLO in each package (the JAX predictor fixes its dtype at its first call): at the
    defaults both compute in bf16 and agree at the bf16 tolerance; asked for f32, both agree at
    1e-2 px / 1e-4 conf. Rows are compared in x1 order (bf16 scores can tie)."""
    frame = _frame_640x512(13)
    kw = {} if dtype == "default" else {"compute_dtype": "float32"}
    jy, py = yolo_tpu.YOLO(str(WEIGHTS)), yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")
    want, got = jy.predict(frame, verbose=False, **kw)[0], py.predict(frame, verbose=False, **kw)[0]
    bf16 = dtype == "default"
    assert py.predictor.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert jy.predictor.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    assert len(got) == len(want) == 3
    g, w = (r.boxes.data[np.argsort(r.boxes.xyxy[:, 0])] for r in (got, want))
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=BF16_BOX_PX if bf16 else 1e-2)
    np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=BF16_CONF if bf16 else 1e-4)
    np.testing.assert_array_equal(g[:, 5], w[:, 5])


@pytest.mark.parametrize("kw", [
    dict(save=False), dict(augment=False), dict(show=False), dict(line_width=2), dict(stream_buffer=False),
    dict(mode="track", tracker="bytetrack.yaml", persist=True), dict(epochs=3, lr0=0.1, format="npz"),
    dict(classes=[0, 3]),
])
def test_yolo_predict_takes_the_cfg_keys_like_jax(yolos, kw):
    """Keys of the JAX package's cfg that ask for nothing unported change nothing
    (JAX's predict keeps them too); class ids beyond nc = 1 select nothing. The
    results equal JAX's at the tolerances of test_yolo_predict_matches_jax."""
    jy, py = yolos
    rng = np.random.default_rng(11)
    frame = np.repeat(_ir_frame(rng, 96, 128, 50, 40)[..., None], 3, -1)
    base = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=1, compute_dtype="float32")
    want = jy.predict(frame, **base, **{k: v for k, v in kw.items() if k != "persist"})
    got = py.predict(frame, **base, **kw)
    assert len(got[0]) == 1
    _assert_same_results(got, want, box_atol=1e-2)


def test_predict_settings_that_ask_for_unported_features_raise():
    py = yolo_tpu_torch.YOLO("yolov8-small.yaml", device="cpu")
    frame = np.random.default_rng(12).integers(0, 255, (64, 64, 3), np.uint8)
    kw = dict(imgsz=64, conf=0.001, verbose=False)
    one = py.predict(frame, classes=[0], **kw)
    np.testing.assert_array_equal(py.predict(frame, classes=[0, 3], **kw)[0].boxes.data, one[0].boxes.data)
    assert len(one[0]) > 0 and len(py.predict(frame, classes=[3], **kw)[0]) == 0
    with pytest.raises(TypeError, match="'no_such_key' is not a setting"):
        py.predict(frame, no_such_key=1, **kw)
    a = PredictArgs()
    a.update(dict(compute_dtype="bfloat16", save=False, mode="track"))
    pred = BasePredictor(py.model, py.params, overrides={"device": "cpu", "compute_dtype": "bfloat16"})
    assert a.compute_dtype == "bfloat16" and pred.dtype == torch.bfloat16
    from yolo_tpu.cfg import DEFAULT_CFG_DICT
    from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT as PORT_CFG_DICT  # the key set `PredictArgs.update` accepts

    assert set(PORT_CFG_DICT) == set(DEFAULT_CFG_DICT)


# --- the three repairs: settings checks, Boxes.cpu()/numpy() and Results.new(), the re-exports ---


@pytest.mark.parametrize("bad, error", [
    (dict(conf=1.5), ValueError), (dict(iou=-0.1), ValueError), (dict(save_txt=1), TypeError),
    (dict(max_det=10.0), TypeError), (dict(conf="0.3"), TypeError),
])
def test_predict_checks_its_settings_like_jax(bad, error):
    """A fresh YOLO's predict raises JAX's error type, naming the setting, before any forward."""
    frame = np.zeros((64, 64, 3), np.uint8)
    name = next(iter(bad))
    for y in (yolo_tpu.YOLO("yolov8-small.yaml"), yolo_tpu_torch.YOLO("yolov8-small.yaml", device="cpu")):
        with pytest.raises(error, match=name):
            y.predict(frame, imgsz=64, verbose=False, **bad)
    a = PredictArgs()
    with pytest.raises(error, match=name):
        a.update(bad)


def test_boxes_cpu_numpy_and_results_new_match_jax(yolos):
    jy, py = yolos
    frame = np.repeat(_ir_frame(np.random.default_rng(15), 96, 128, 60, 40)[..., None], 3, -1)
    kw = dict(conf=1e-4, iou=0.6, imgsz=(96, 128), verbose=False, compute_dtype="float32")
    want, got = jy.predict(frame, **kw)[0], py.predict(frame, **kw)[0]
    assert got.boxes.cpu() is got.boxes and got.boxes.numpy() is got.boxes
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(got.boxes.cpu().numpy().xyxy, want.boxes.cpu().numpy().xyxy, rtol=0, atol=1e-2)
    for g, w in ((got.new(), want.new()), (got.new(got.boxes.data[:3]), want.new(want.boxes.data[:3]))):
        assert type(g) is PR.Results and len(g) == len(w) and g.orig_shape == w.orig_shape and g.path == w.path
        assert g.speed is got.speed and g.orig_img is got.orig_img and g.names == w.names
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, rtol=0, atol=1e-2)


@pytest.mark.parametrize("sub", ["kalman", "pipeline", "nn", "ops"])
def test_subpackages_reexport_like_jax(sub):
    import importlib

    jax_pkg, port_pkg = (importlib.import_module(f"{p}.{sub}") for p in ("yolo_tpu", "yolo_tpu_torch"))
    assert port_pkg.__all__ == jax_pkg.__all__
    for name in jax_pkg.__all__:
        assert getattr(port_pkg, name).__name__ == getattr(jax_pkg, name).__name__
    from yolo_tpu_torch.kalman import EnhancedMultiTargetTracker  # README's object API
    from yolo_tpu_torch.ops import ltwh2xyxy, non_max_suppression, xyxy2ltwh  # noqa: F401
    from yolo_tpu_torch.pipeline import FusedDetectTrack  # noqa: F401

    assert EnhancedMultiTargetTracker is yolo_tpu_torch.kalman.multi_tracker.EnhancedMultiTargetTracker


@pytest.mark.parametrize("as_torch", [False, True])
def test_ltwh_helpers_match_jax(as_torch):
    b = _boxes(np.random.default_rng(16), 7)
    arg = torch.from_numpy(b) if as_torch else b
    for fn in ("ltwh2xyxy", "xyxy2ltwh"):
        got = getattr(PB, fn)(arg)
        assert torch.is_tensor(got) == as_torch
        np.testing.assert_array_equal(got.numpy() if as_torch else got, getattr(JB, fn)(b))


# --- test-time augmentation, ensembles, info, embed ---------------------------------


@pytest.mark.parametrize("ratio", [0.83, 0.67, 1.25])
def test_scale_img_matches_jax_resize(ratio):
    """The TTA resize: JAX's antialiased bilinear `jax.image.resize` and the 0.447 pad, within 1e-5."""
    from yolo_tpu.nn.tasks import _scale_img as jax_scale
    from yolo_tpu_torch.nn.tasks import _scale_img

    x = np.random.default_rng(17).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    want = np.asarray(jax_scale(jnp.asarray(x), ratio, 32))
    got = _scale_img(torch.from_numpy(x), ratio, 32).numpy()
    assert got.shape == want.shape and got.shape[1] % 32 == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_predict_augment_matches_jax():
    """yolov8-small (P2, four levels: the tail clip counts anchors per level) from init(0), two
    96x128 images: the (B, 4 + nc, A') predictions within 1e-3 px and 1e-4 in the scores."""
    jm = JaxDetectionModel("yolov8-small.yaml")
    jp = jm.init(0)
    pm = DetectionModel("yolov8-small.yaml", device="cpu")
    params_from_jax(pm, jax.tree_util.tree_map(np.asarray, jp), torch.float32)
    x = np.random.default_rng(18).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.predict_augment)(jp, jnp.asarray(x)))
    got = pm.predict_augment(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[-1] < 3 * pm.predict(torch.from_numpy(x)).shape[-1]
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0, atol=1e-4)


def test_yolo_predict_augment_matches_jax():
    """`predict(augment=True)` on best.npz, f32, three IR frames: the same detections as JAX
    (1e-2 px, conf 1e-4, the facade's gates)."""
    jy, py = yolo_tpu.YOLO(str(WEIGHTS)), yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")
    rng = np.random.default_rng(19)
    frames = [np.repeat(_ir_frame(rng, 96, 128, cx, cy)[..., None], 3, -1) for cx, cy in ((40, 30), (90, 60), (20, 80))]
    kw = dict(conf=0.05, iou=0.6, imgsz=(96, 128), verbose=False, batch=3, compute_dtype="float32", augment=True)
    want, got = jy.predict(frames, **kw), py.predict(frames, **kw)
    _assert_same_results(got, want, box_atol=1e-2)
    assert sum(len(r) for r in got) >= 3


def test_ensemble_matches_jax(tmp_path):
    """As tests/test_model.py::test_ensemble_nms_concat: yolov8n init(0) + yolov8s init(1) joined on
    the anchor axis (1e-4); `Ensemble.init` is JAX's tuple bit for bit; `YOLO([a, b])` predicts as
    JAX's (f32, the facade's gates), augment=True falls back to one scale; members must share nc."""
    from yolo_tpu.nn.tasks import Ensemble as JaxEnsemble
    from yolo_tpu_torch.nn.tasks import Ensemble

    ja, jb = JaxDetectionModel("yolov8n.yaml"), JaxDetectionModel("yolov8s.yaml")
    pa, pb = DetectionModel("yolov8n.yaml", device="cpu"), DetectionModel("yolov8s.yaml", device="cpu")
    jens, ens = JaxEnsemble([(ja, None), (jb, None)]), Ensemble([pa, pb])
    jparams, params = jens.init(0), ens.init(0)
    for g, w in zip(params, jparams):
        for (kg, vg), (kw_, vw) in zip(jax.tree_util.tree_leaves_with_path(g), jax.tree_util.tree_leaves_with_path(w)):
            assert kg == kw_
            np.testing.assert_array_equal(vg, np.asarray(vw))
    assert ens.stride == jens.stride and ens.nc == jens.nc and ens.names == jens.names
    for m, p in zip(ens.models, params):
        params_from_jax(m, p, torch.float32)
    x = np.random.default_rng(20).normal(size=(1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jens.predict)(jparams, jnp.asarray(x)))
    got = ens.predict(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    yolo_tpu.YOLO("yolov8n.yaml").save(a)
    yolo_tpu.YOLO("yolov8s.yaml").save(b)
    jy, py = yolo_tpu.YOLO([a, b]), yolo_tpu_torch.YOLO([a, b], device="cpu")
    assert isinstance(py.model, Ensemble) and py.overrides["model"] == jy.overrides["model"]
    img = np.random.default_rng(21).integers(0, 255, (96, 96, 3), dtype=np.uint8)
    kw = dict(imgsz=64, conf=0.01, verbose=False, compute_dtype="float32")
    want, got = jy.predict(img, **kw), py.predict(img, **kw)
    _assert_same_results(got, want, box_atol=1e-2)
    aug = py.predict(img, **kw, augment=True)  # TTA is for a plain DetectionModel: a warning, then one scale
    np.testing.assert_array_equal(aug[0].boxes.data, got[0].boxes.data)
    assert type(py.fuse().params) is tuple
    np.testing.assert_allclose(py.predict(img, **kw)[0].boxes.data, got[0].boxes.data, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="nc"):
        Ensemble([pa, DetectionModel("yolov8n.yaml", nc=3, device="cpu")])


@pytest.mark.parametrize("source", ["yaml", "npz"])
def test_info_matches_jax(source):
    """{layers, parameters, stride} equal JAX's, fused and not (best.npz: 2,282,908 parameters)."""
    path = "yolov8-small.yaml" if source == "yaml" else str(WEIGHTS)
    jy, py = yolo_tpu.YOLO(path), yolo_tpu_torch.YOLO(path, device="cpu")
    for _ in range(2):
        got, want = py.info(verbose=False), jy.info(verbose=False)
        assert got == want and got["layers"] == 26
        jy.fuse(), py.fuse()
    if source == "npz":
        assert got["parameters"] == 2_282_908


@pytest.mark.parametrize("layers", [None, [9, 12, 15], [10, 11, 12]], ids=["default", "folded", "unfolded"])
def test_embed_matches_jax(layers):
    """As tests/test_engine.py::test_model_embed_facade (yolov8n, two 80x100 images, imgsz 64), each
    vector within 1e-4 of JAX's. [9, 12, 15]: C2f 12 and 15 close folded chains; [10, 11, 12] names an
    Upsample and a Concat, so the walk does not fold. plain=True (the twins by name) the same."""
    jy, py = yolo_tpu.YOLO("yolov8n.yaml"), yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
    imgs = [np.random.default_rng(i).integers(0, 255, (80, 100, 3), np.uint8) for i in range(2)]
    want, got = jy.embed(imgs, layers=layers, imgsz=64), py.embed(imgs, layers=layers, imgsz=64)
    assert len(got) == 2 and got[0].dtype == np.float32 and got[0].shape == want[0].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert not np.allclose(got[0], got[1])
    np.testing.assert_allclose(py.embed(imgs[0], layers=layers, imgsz=64, plain=True)[0], got[0], rtol=0, atol=1e-5)


# --- the settings ported last: embed (taken, changes nothing), show (headless), visualize ---


def test_predict_embed_setting_changes_nothing_like_jax(yolos):
    """`predict(embed=[5])` returns the ordinary Results, as the JAX predictor (which never reads the
    key) does: the same as without it, and the same as JAX's (boxes 1e-2 px, conf 1e-4)."""
    jy, py = yolos
    frame = np.repeat(_ir_frame(np.random.default_rng(21), 96, 128, 60, 40)[..., None], 3, -1)
    kw = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=1, compute_dtype="float32")
    want = jy.predict(frame, embed=[5], **kw)
    got = py.predict(frame, embed=[5], **kw)
    assert len(got[0]) == 1
    _assert_same_results(got, want, box_atol=1e-2)
    np.testing.assert_array_equal(py.predict(frame, **kw)[0].boxes.data, got[0].boxes.data)


def test_predict_show_without_a_display_warns_once(yolos, monkeypatch):
    """show=True where no display exists: JAX's warning once (its own cv2.imshow aborts the process
    there, so JAX runs with show=False), `show` off after it, and the same Results as JAX's."""
    import logging

    from yolo_tpu_torch.utils import LOGGER

    jy, py = yolos
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr(BasePredictor, "_show_warned", False, raising=False)
    frame = np.repeat(_ir_frame(np.random.default_rng(22), 96, 128, 40, 60)[..., None], 3, -1)
    kw = dict(conf=0.1, iou=0.6, imgsz=(96, 128), verbose=False, batch=2, compute_dtype="float32")
    want = jy.predict([frame, frame], **kw)
    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    h = Catch(level=logging.WARNING)
    LOGGER.addHandler(h)
    try:
        got = py.predict([frame, frame], show=True, **kw)
        again = py.predict(frame, show=True, **kw)
    finally:
        LOGGER.removeHandler(h)
    assert [m for m in seen if "show=True unavailable (headless?)" in m] == seen and len(seen) == 1
    assert py.predictor.args.show is False
    _assert_same_results(got, want, box_atol=1e-2)
    np.testing.assert_allclose(again[0].boxes.data, got[0].boxes.data, rtol=0, atol=1e-4)  # B = 1 sums in another order


class _Axis:
    def imshow(self, *a, **k):
        pass

    def axis(self, *a, **k):
        pass


def test_predict_visualize_writes_jax_feature_maps(yolos, tmp_path, monkeypatch):
    """visualize=True writes the JAX package's files for the batch's first image: the same
    stage{i}_{Module}_features.png / .npy names, each .npy within 1e-4 of JAX's (an f32 walk).
    matplotlib's drawing is stubbed in both packages (a grid takes ~1 s to draw; its .png is
    written empty), so the test holds the names and the arrays."""
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "subplots", lambda r, c, **k: (None, np.array([_Axis() for _ in range(r * c)])))
    monkeypatch.setattr(plt, "subplots_adjust", lambda **k: None)
    monkeypatch.setattr(plt, "savefig", lambda f, **k: open(f, "wb").close())
    monkeypatch.setattr(plt, "close", lambda *a: None)
    jy, py = yolos
    frame = np.repeat(_ir_frame(np.random.default_rng(23), 64, 64, 30, 20)[..., None], 3, -1)
    kw = dict(conf=0.1, imgsz=64, verbose=False, batch=1, visualize=True, exist_ok=True, project=str(tmp_path))
    for y, name in ((jy, "jax"), (py, "torch")):
        y.predictor = None  # a fresh predictor, so each writes under its own run directory
        y.predict(frame, name=name, **kw)
        y.predictor = None
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    got = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert got == want and len(want) == 2 * (len(py.model.layers) - 1)  # every layer but the head: a grid and its array
    for name in want:
        if name.endswith(".npy"):
            a, b = np.load(tmp_path / "torch" / name), np.load(tmp_path / "jax" / name)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
