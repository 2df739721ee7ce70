"""The segment task of the port (yolov8n-seg) against the JAX package's on the CPU: ConvTranspose, Proto and
the Segment head, SegmentationModel's initial tree and forward, NMS with extra columns, the mask ops, the
predictor's masks, the collate's masks, v8SegmentationLoss, SegmentationValidator, one train step, Results'
masks and the checkpoints. Inputs come from seeded numpy generators; the JAX side runs as its own tests run
it (jitted, on the CPU); the port runs the kernels' plain twins, as it does on a CPU tensor.

Tolerances, stated again at each test: the initial tree and the collate's masks exact; f32 predictions 1e-4
(boxes in pixels of a 64² image, scores, coefficients) and prototypes 1e-5; bf16 within a few bf16 ulps
(boxes 0.5 px, scores 5e-3, coefficients and prototypes 2e-2); NMS outputs and masks equal; loss items
1e-5 relative; validator keys 1e-4; gradients 1e-3 of their tensor's largest."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.data.dataset import collate_batch as jax_collate
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.ops import masks as JMK
from yolo_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_tpu.utils import optim as JO
from yolo_tpu.utils.metrics import mask_iou as jax_mask_iou
from yolo_tpu.utils.loss import v8SegmentationLoss as JaxSegLoss
from yolo_tpu_torch.data.dataset import collate_batch
from yolo_tpu_torch.engine.trainer import DetectionTrainer
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.nn.torch_export import flatten_tree
from yolo_tpu_torch.ops import masks as PMK
from yolo_tpu_torch.ops.nms import non_max_suppression
from yolo_tpu_torch.utils.loss import v8SegmentationLoss
from yolo_tpu_torch.utils.metrics import mask_iou

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)
SEG_KEYS = ("cls", "bboxes", "mask_gt", "masks")


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _ellipse(rng, w, h, near=None):
    """A 20-point polygon of a random ellipse (pixels), placed over `near` when given."""
    ax, ay = (int(v) for v in rng.uniform(0.1, 0.25, 2) * [w, h])
    c = near + rng.uniform(-4, 4, 2) if near is not None else rng.uniform(0.3, 0.7, 2) * [w, h]
    pts = cv2.ellipse2Poly((int(c[0]), int(c[1])), (ax, ay), int(rng.uniform(0, 180)), 0, 360, 18)[:-1]
    return pts.astype(np.float32) + rng.uniform(-0.5, 0.5, (len(pts), 2)).astype(np.float32)


def _samples(seed, n=(3, 2), h=64, w=64):
    """Letterboxed samples as the transforms give them: BGR image, pixel xyxy boxes, pixel polygons;
    each image's second instance lies over its first."""
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        segs = []
        for j in range(k):
            segs.append(_ellipse(rng, w, h, segs[0].mean(0) if j == 1 else None))
        boxes = np.array([[*s.min(0), *s.max(0)] for s in segs], np.float32)
        out.append({"img": rng.integers(0, 255, (h, w, 3), np.uint8), "cls": rng.integers(0, 2, k).astype(np.float32),
                    "bboxes": boxes, "segments": segs})
    return out


def _write_seg_split(root, n, seed, w=64, h=64):
    """n seeded IR-like frames with 1-3 bright filled ellipses each, polygon labels (nc 1) → the yaml."""
    rng = np.random.default_rng(seed)
    for d in ("images/val", "labels/val"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            pts = _ellipse(rng, w, h).round().astype(np.int32)
            cv2.fillPoly(img, [pts], float(rng.uniform(150, 230)))
            lines.append("0 " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts))
        cv2.imwrite(str(root / f"images/val/{i}.png"), cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
        (root / f"labels/val/{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames:\n  0: target\n")
    return str(root / "data.yaml")


def _tuned(params, nc):
    """init(0)'s tree with the head's last convs set so that an untrained model finds the ellipses: box bins 1
    and 2 raised (boxes of about 3 strides), class logits near 0, coefficients and prototypes positive (each
    mask fills its box's crop), the random weights of those convs scaled down but kept (varied scores)."""
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    head = p["model"]["22"]
    for l in range(3):
        box, cls, coef = head["cv2"][str(l)]["2"], head["cv3"][str(l)]["2"], head["cv4"][str(l)]["2"]
        for conv in (box, cls, coef):
            conv["weight"] *= 0.05
        box["bias"] = np.tile(np.array([0, 6, 6] + [0] * 13, np.float32), 4)
        cls["bias"] = np.zeros(nc, np.float32)
        coef["bias"] = np.ones_like(coef["bias"])
    head["proto"]["cv3"]["bn"]["bias"] = np.full_like(head["proto"]["cv3"]["bn"]["bias"], 3.0)
    return p


# --- (a) the model --------------------------------------------------------------------------------


def test_segmentation_model_init_and_routing_match_jax():
    """SegmentationModel("yolov8n-seg.yaml").init(0) is the JAX package's tree bit for bit (3,421,264
    values, npr 64, nm 32); YOLO("yolov8n-seg.yaml") is a segment model; the task helpers route `-seg`
    yamls and Segment heads as JAX's do; yolov8n-seg-p6 (C2 since the seventeenth slice) is a four-level segment model
    with JAX's strides, and yolo11n-seg (C3k2 since the eighteenth slice) is a segment model with JAX's strides and the
    non-legacy class branch, while a YOLOE segment head routes to YOLOEModel, as JAX's does (its task guessed segment in
    both)."""
    pm, jm = PT.SegmentationModel("yolov8n-seg.yaml", device="cpu"), JT.SegmentationModel("yolov8n-seg.yaml")
    got, want = _flat(pm.init(0)), _flat(jm.init(0))
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert PT.param_count(pm.init(0)) == jm.param_count(jm.init(0)) == 3_421_264
    assert (pm.head.nm, pm.head.npr, pm.head.proto.upsample.c1, pm.stride) == (32, 64, 64, [8, 16, 32])
    py = yolo_tpu_torch.YOLO("yolov8n-seg.yaml", device="cpu")
    assert py.task == "segment" and isinstance(py.model, PT.SegmentationModel)
    d = JT.yaml_model_load("yolov8n-seg.yaml")
    assert PT.model_class_for(d) is PT.SegmentationModel and PT.guess_model_task(d) == JT.guess_model_task(d) == "segment"
    p6 = PT.SegmentationModel("yolov8n-seg-p6.yaml", device="cpu")
    assert p6.stride == JT.SegmentationModel("yolov8n-seg-p6.yaml").stride == [8, 16, 32, 64] and p6.head.nl == 4
    y11 = PT.SegmentationModel("yolo11n-seg.yaml", device="cpu")
    assert y11.stride == JT.SegmentationModel("yolo11n-seg.yaml").stride == [8, 16, 32] and y11.head.legacy is False
    d = JT.yaml_model_load("yoloe-11-seg.yaml")
    assert PT.model_class_for(d) is PT.YOLOEModel and JT.model_class_for(d).__name__ == "YOLOEModel"
    assert PT.guess_model_task(d) == JT.guess_model_task(d) == "segment"


# --- (b) ConvTranspose ----------------------------------------------------------------------------


@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_transpose_matches_jax(bn, dtype):
    """ConvTranspose(8 → 5, k 2, s 2) with BN and SiLU, and without either (Proto's form): the inference form
    on the tree the port's `fuse` folds against JAX's eval call on the unfused tree, and the train form in
    training mode (with its BN batch moments) against JAX's train call. c1 ≠ c2, so a swapped kernel axis
    cannot pass. f32 within 1e-5; bf16 within 2e-2 (the folded BN rounds into the bf16 kernel)."""
    jc, pc = JM.ConvTranspose(8, 5, bn=bn, act=bn), PM.ConvTranspose(8, 5, bn=bn, act=bn)
    p = jc.init(np.random.default_rng(1))
    assert _flat(pc.init(np.random.default_rng(1))).keys() == _flat(p).keys()
    if bn:
        rng = np.random.default_rng(2)
        p["bn"] = {k: rng.uniform(0.5, 1.5, 5).astype(np.float32) for k in ("weight", "running_var")} | \
                  {k: rng.normal(0, 0.3, 5).astype(np.float32) for k in ("bias", "running_mean")}
    x = np.random.default_rng(3).normal(0, 1, (2, 6, 7, 8)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jc(p, jnp.asarray(x), JM.Ctx(train=False, dtype=jdt)), np.float32)
    pc.load_jax(PT.fuse(p), "cpu", tdt)
    got = pc(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 12, 14, 5)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    ctx = JM.Ctx(train=True)
    want_t = np.asarray(jc(p, jnp.asarray(x), ctx, "ct"))
    for path, t in pc.train_leaves().items():
        node = p
        for k in path.split("/"):
            node = node[k]
        t.data = torch.from_numpy(np.ascontiguousarray(np.asarray(node).transpose(3, 2, 0, 1) if node.ndim == 4 else node))
    pc.train()
    np.testing.assert_allclose(pc.forward_train(torch.from_numpy(x)).detach().numpy(), want_t, rtol=0, atol=1e-5)
    if bn:
        mean, var, n = ctx.stats["ct/bn"]
        np.testing.assert_allclose(pc.batch_stats[0].numpy(), np.asarray(mean), atol=1e-6)
        np.testing.assert_allclose(pc.batch_stats[1].numpy(), np.asarray(var), atol=1e-6)
        assert pc.batch_stats[2] == n


# --- (c) the forward --------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_forward_matches_jax(dtype, two_threads):
    """yolov8n-seg (nc 80, init(0)) on two seeded 64x64 images: preds (2, 116, 84) and protos (2, 16, 16, 32)
    of the port (the neck folded, and not) against JAX's `SegmentationModel.predict`. f32: preds within 1e-4,
    protos 1e-5; bf16: boxes 0.5 px, scores 5e-3, coefficients and protos 2e-2."""
    jm, pm = JT.SegmentationModel("yolov8n-seg.yaml"), PT.SegmentationModel("yolov8n-seg.yaml", device="cpu")
    params = jm.init(0)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    wp, wpr = (np.asarray(a, np.float32) for a in jax.jit(lambda p, v: jm.predict(p, v, dtype=jdt))(params, jnp.asarray(x)))
    PT.params_from_jax(pm, params, tdt)
    for neck_opt in (True, False):
        gp, gpr = pm.predict(torch.from_numpy(x).to(tdt), neck_opt=neck_opt)
        assert gp.dtype == torch.float32 and gpr.dtype == tdt and gp.shape == (2, 116, 84) and gpr.shape == (2, 16, 16, 32)
        gp, gpr = gp.numpy(), gpr.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-4)
            np.testing.assert_allclose(gpr, wpr, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(gp[:, :4], wp[:, :4], rtol=0, atol=0.5)
            np.testing.assert_allclose(gp[:, 4:84], wp[:, 4:84], rtol=0, atol=5e-3)
            np.testing.assert_allclose(gp[:, 84:], wp[:, 84:], rtol=0, atol=2e-2)
            np.testing.assert_allclose(gpr, wpr, rtol=0, atol=2e-2)


# --- (d) NMS with extras ----------------------------------------------------------------------------


@pytest.mark.parametrize("agnostic", [False, True])
def test_nms_with_extra_columns_matches_jax(agnostic):
    """(2, 4 + 3 + 32, 500) predictions with overlapping boxes: with nc given, the 32 rows after the scores
    ride through NMS as extras; boxes, scores, classes, valid and extras equal JAX's through the kernel's
    route and the select-max twin (exactly: a gather of the same slots), extras zero where not valid.
    Without nc every row after the boxes is a class, in both packages, and no extras come out."""
    rng = np.random.default_rng(4)
    B, nc, nm, A = 2, 3, 32, 500
    xy = rng.uniform(20, 100, (B, 2, A))
    wh = rng.uniform(5, 40, (B, 2, A))
    scores = rng.uniform(0, 1, (B, nc, A)) ** 3
    preds = np.concatenate([xy, wh, scores, rng.normal(0, 1, (B, nm, A))], 1).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jax_nms(jnp.asarray(preds), conf_thres=0.2, iou_thres=0.5, agnostic=agnostic,
                                                  max_det=100, nc=nc).items()}
    assert want["valid"].sum() > 20 and want["extra"].shape == (B, 100, nm)
    for plain in (False, True):
        got = non_max_suppression(torch.from_numpy(preds), conf_thres=0.2, iou_thres=0.5, agnostic=agnostic, max_det=100,
                                  nc=nc, plain=plain)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert not np.abs(want["extra"][~want["valid"]]).any()
    plain = non_max_suppression(torch.from_numpy(preds[:, : 4 + nc]), conf_thres=0.2, max_det=100)
    assert "extra" not in plain and "extra" not in jax_nms(jnp.asarray(preds[:, : 4 + nc]), conf_thres=0.2, max_det=100)


# --- (e) mask ops ------------------------------------------------------------------------------------


def test_mask_ops_match_jax():
    """process_mask with and without the upsample (JAX's bilinear resize weights), on one image and on a
    batch, within 1e-6; crop_mask equal JAX's crop_mask_np; scale_masks_np equal, from the
    sizes and with an explicit ratio_pad; mask_iou equal."""
    rng = np.random.default_rng(0)
    protos = rng.normal(0, 1, (2, 16, 16, 32)).astype(np.float32)
    coefs = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    boxes = np.array([[8, 8, 40, 40], [0, 0, 64, 64], [50.5, 50, 60, 60.3]], np.float32)[None].repeat(2, 0)
    for up in (True, False):
        batch = PMK.process_mask(*map(torch.from_numpy, (protos, coefs, boxes)), (64, 64), upsample=up).numpy()
        for i in range(2):
            want = np.asarray(JMK.process_mask(*map(jnp.asarray, (protos[i], coefs[i], boxes[i])), (64, 64), upsample=up))
            one = PMK.process_mask(*map(torch.from_numpy, (protos[i], coefs[i], boxes[i])), (64, 64), upsample=up).numpy()
            np.testing.assert_allclose(one, want, rtol=0, atol=1e-6)
            np.testing.assert_allclose(batch[i], want, rtol=0, atol=1e-6)
    m = rng.uniform(0, 1, (3, 20, 24)).astype(np.float32)
    np.testing.assert_array_equal(PMK.crop_mask(torch.from_numpy(m), torch.from_numpy(boxes[0] / 4)).numpy(),
                                  JMK.crop_mask_np(m, boxes[0] / 4))
    for ratio_pad in (None, ((0.5, 0.5), (1.0, 2.5))):
        np.testing.assert_array_equal(PMK.scale_masks_np(m, (37, 43), (20, 24), ratio_pad),
                                      JMK.scale_masks_np(m, (37, 43), (20, 24), ratio_pad))
    assert PMK.scale_masks_np(m[:0], (37, 43), (20, 24)).shape == (0, 37, 43)
    gt, pred = rng.uniform(0, 1, (4, 300)) > 0.5, rng.uniform(0, 1, (6, 300)) > 0.6
    np.testing.assert_array_equal(mask_iou(gt, pred), jax_mask_iou(gt, pred))


# --- (f, k) predict, Results, checkpoints -----------------------------------------------------------


@pytest.fixture(scope="module")
def seg_pair():
    """The JAX and the port YOLO("yolov8n-seg.yaml") holding the same tuned tree (nc 80), and two BGR frames."""
    jy, py = yolo_tpu.YOLO("yolov8n-seg.yaml"), yolo_tpu_torch.YOLO("yolov8n-seg.yaml", device="cpu")
    jy.params = _tuned(jy.params, 80)
    py.params = _tuned(py.params, 80)
    rng = np.random.default_rng(9)
    frames = []
    for h, w in ((96, 128), (120, 100)):
        img = rng.normal(40, 6, (h, w)).clip(0, 255).astype(np.float32)
        for _ in range(3):
            cv2.fillPoly(img, [_ellipse(rng, w, h).round().astype(np.int32)], float(rng.uniform(150, 230)))
        frames.append(cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    return jy, py, frames


@pytest.mark.parametrize("retina", [False, True])
def test_predict_masks_match_jax(seg_pair, retina):
    """`predict` (f32, imgsz 64, max_det 30) with retina_masks off and on, against JAX's SegmentationPredictor:
    equal detection counts, boxes within 1e-3 px, conf 1e-5, boolean masks at the original size equal pixel for
    pixel (no probability of these inputs lies within 1e-4 of 0.5)."""
    jy, py, frames = seg_pair
    kw = dict(imgsz=64, compute_dtype="float32", retina_masks=retina, max_det=30, verbose=False)
    for rj, rp in zip(jy.predict(frames, **kw), py.predict(frames, **kw)):
        assert len(rj) == len(rp) > 0 and rp.masks.data.shape == rj.masks.data.shape == (len(rp), *rp.orig_shape)
        np.testing.assert_allclose(rp.boxes.xyxy, rj.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(rp.boxes.conf, rj.boxes.conf, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(rp.boxes.cls, rj.boxes.cls)
        np.testing.assert_array_equal(rp.masks.data, rj.masks.data)
        assert rp.masks.data.dtype == bool and rp.masks.data.any()


def test_results_masks_match_jax(seg_pair):
    """Masks / Results of a predict against JAX's: xy and xyn (the contours), len, __getitem__ (rows with their
    masks), new (no masks), summary with segments (pixels and normalized), plot's mask blend."""
    jy, py, frames = seg_pair
    kw = dict(imgsz=64, compute_dtype="float32", retina_masks=False, max_det=30, verbose=False)  # a reused predictor keeps its settings
    rj, rp = jy.predict(frames[0], **kw)[0], py.predict(frames[0], **kw)[0]
    assert len(rp.masks) == len(rj.masks) > 1
    for a, b in ((rp.masks.xy, rj.masks.xy), (rp.masks.xyn, rj.masks.xyn)):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    sub_p, sub_j = rp[[1, 0]], rj[[1, 0]]
    np.testing.assert_array_equal(sub_p.masks.data, sub_j.masks.data)
    assert rp[0].masks.data.shape == rj[0].masks.data.shape and rp.new().masks is None
    for normalize in (False, True):  # boxes 1e-3 (of pixels, or of a normalized side), conf 1e-5, segments equal
        got, want = rp.summary(normalize=normalize), rj.summary(normalize=normalize)
        assert len(got) == len(want) and all(g.keys() == w.keys() == {"name", "class", "confidence", "box", "segments"}
                                             for g, w in zip(got, want))
        for g, w in zip(got, want):
            assert (g["name"], g["class"], g["segments"]) == (w["name"], w["class"], w["segments"])
            assert abs(g["confidence"] - w["confidence"]) <= 1e-5
            np.testing.assert_allclose(list(g["box"].values()), list(w["box"].values()), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(rp.plot(), rj.plot())
    no_masks = rp.plot(masks=False)
    assert not np.array_equal(no_masks, rp.plot())


def test_segment_checkpoints_cross_between_packages(seg_pair, tmp_path):
    """A segment .npz that JAX writes loads in the port as a SegmentationModel with JAX's tree and gives JAX's
    predictions (boxes 1e-3 px, masks equal); the port's .pt (proto.* and cv4.* in torch layout, the
    ConvTranspose kernel (c1, c2, kh, kw)) reads back to the same tree in both packages."""
    jy, py, frames = seg_pair
    path = jy.save(str(tmp_path / "seg.npz"))
    y = yolo_tpu_torch.YOLO(str(path), device="cpu")
    assert y.task == "segment" and isinstance(y.model, PT.SegmentationModel)
    got, want = _flat(y.params), _flat(jy.params)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    kw = dict(imgsz=64, compute_dtype="float32", retina_masks=False, max_det=30, verbose=False)  # a reused predictor keeps its settings
    rp, rj = y.predict(frames[1], **kw)[0], jy.predict(frames[1], **kw)[0]
    np.testing.assert_allclose(rp.boxes.data, rj.boxes.data, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(rp.masks.data, rj.masks.data)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)  # the export writes into the working directory
        pt = py.export(format="pt")
    sd = torch.load(str(tmp_path / pt), weights_only=True)["state_dict"]
    assert tuple(sd["model.22.proto.upsample.weight"].shape) == (64, 64, 2, 2) and "model.22.cv4.2.2.weight" in sd
    back = yolo_tpu_torch.YOLO(str(tmp_path / pt), device="cpu")
    jback = yolo_tpu.YOLO(str(tmp_path / pt))
    assert back.task == "segment" and jback.task == "segment"
    want = _flat(py.params)
    for tree in (back.params, jback.params):
        got = _flat(tree)
        assert got.keys() == want.keys() and all(np.allclose(got[k], want[k], atol=0) for k in want)


# --- (g) the collate's masks ------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("ratio", [4, 2])
def test_collate_masks_match_jax(overlap, ratio):
    """collate_batch's masks (64x64 images, overlapping ellipses, a box row without polygon too) equal JAX's
    bit for bit: the overlap-index map (f32, the largest instance drawn first) or the per-instance uint8 masks,
    at 1/ratio of the image; a smaller instance keeps its pixels where it overlaps a larger one."""
    samples = _samples(0)
    samples[1]["segments"] = [samples[1]["segments"][0], None]  # a box row among polygon rows
    got, want = collate_batch(samples, 8, overlap=overlap, mask_ratio=ratio), jax_collate(samples, 8, overlap=overlap, mask_ratio=ratio)
    assert got["masks"].dtype == want["masks"].dtype and got["masks"].shape == want["masks"].shape
    np.testing.assert_array_equal(got["masks"], want["masks"])
    for k in ("img", "cls", "bboxes", "mask_gt"):
        np.testing.assert_array_equal(got[k], want[k])
    if overlap:
        assert set(np.unique(got["masks"][0])) == {0.0, 1.0, 2.0, 3.0}
    assert "masks" not in collate_batch([{k: v for k, v in s.items() if k != "segments"} for s in samples], 8)


# --- (h) the loss -------------------------------------------------------------------------------------


@pytest.mark.parametrize("overlap,n_boxes", [(True, 8), (False, 8), (True, 16), (True, 3)])
def test_segmentation_loss_matches_jax(overlap, n_boxes, two_threads):
    """v8SegmentationLoss on seeded raw outputs (64² input: 84 anchors, nc 2) and the collate's masks: the four
    items (box, seg, cls, dfl) within 1e-5 relative of JAX's, with overlap maps and per-instance masks, through
    JAX's compact path (topk · N < 84) and its all-anchor path (N = 16)."""
    jm, pm = JT.SegmentationModel("yolov8n-seg.yaml", nc=2), PT.SegmentationModel("yolov8n-seg.yaml", nc=2, device="cpu")
    rng = np.random.default_rng(1)
    feats = [rng.normal(0, 1, (2, h, h, 64 + 2)).astype(np.float32) for h in (8, 4, 2)]
    mcs = [rng.normal(0, 1, (2, h, h, 32)).astype(np.float32) for h in (8, 4, 2)]
    protos = rng.normal(0, 1, (2, 16, 16, 32)).astype(np.float32)
    batch = collate_batch(_samples(0), n_boxes, overlap=overlap)
    _, want = jax.jit(lambda *a: JaxSegLoss(jm, HYP)(a[:3], a[3]))(feats, mcs, protos, {k: jnp.asarray(batch[k]) for k in SEG_KEYS})
    total, got = v8SegmentationLoss(pm, HYP)(([torch.from_numpy(f) for f in feats], [torch.from_numpy(m) for m in mcs],
                                               torch.from_numpy(protos)), {k: torch.from_numpy(batch[k]) for k in SEG_KEYS})
    assert got.shape == (4,) and float(got[1]) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(total), float(got.sum()) * 2, rtol=1e-6)


# --- (i) the validator ----------------------------------------------------------------------------------


@pytest.mark.parametrize("overlap_mask", [True, False])
def test_segment_validator_matches_jax(tmp_path, overlap_mask, two_threads):
    """SegmentationValidator on 8 seeded 64x64 frames with 1-3 ellipses each (each package on its own copy of
    the split) with the tuned tree: every box and mask key within 1e-4 of JAX's, the mask mAP above 0."""
    data = {pkg: _write_seg_split(tmp_path / pkg, 8, 21) for pkg in ("jax", "torch")}
    jy, py = yolo_tpu.YOLO("yolov8n-seg.yaml"), yolo_tpu_torch.YOLO("yolov8n-seg.yaml", device="cpu")
    jy.model, py.model = JT.SegmentationModel("yolov8n-seg.yaml", nc=1), PT.SegmentationModel("yolov8n-seg.yaml", nc=1, device="cpu")
    jy.params = _tuned(jy.model.init(0), 1)
    py.params = _tuned(py.model.init(0), 1)
    kw = dict(imgsz=64, batch=4, workers=1, plots=False, overlap_mask=overlap_mask)
    want = jy.val(data=data["jax"], **kw)
    got = py.val(data=data["torch"], **kw)
    assert set(got) == set(want) and "mask_mAP50-95" in got and got["mask_mAP50"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


# --- (j) one train step ----------------------------------------------------------------------------------


def test_train_step_matches_jax(two_threads):
    """One step of yolov8n-seg at nc 2 on two seeded 64x64 images with the collate's masks: JAX's value_and_grad
    of forward_features + v8SegmentationLoss against the port's train forward and backward (the four items 1e-5
    relative, every BN's batch moments 1e-4, every gradient 1e-3 of its tensor's largest), then the trainer's
    AdamW update with the BN running moments against JAX's optimizer and `apply_bn_stats` (every leaf 1e-5)."""
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    batch = collate_batch(_samples(0), 8)
    jm = JT.SegmentationModel("yolov8n-seg.yaml", nc=2)
    jp = jm.init(0)

    def forward_loss(params):
        ctx = JM.Ctx(train=True)
        total, comps = JaxSegLoss(jm, HYP)(jm.forward_features(params, jnp.asarray(x), ctx), {k: jnp.asarray(batch[k]) for k in SEG_KEYS})
        return total, (comps, ctx.stats)

    (_, (jcomps, jstats)), jg = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(jp)
    t = DetectionTrainer(overrides=dict(model="yolov8n-seg.yaml", device="cpu", optimizer="AdamW", batch=2, box=7.5, cls=0.5, dfl=1.5),
                         model=PT.SegmentationModel("yolov8n-seg.yaml", nc=2, device="cpu"))
    t._build_state(iterations=1)
    assert isinstance(t.loss_fn, v8SegmentationLoss)
    total, comps = t.loss_fn(t.model.forward_features(torch.from_numpy(x)), {k: torch.from_numpy(batch[k]) for k in SEG_KEYS})
    total.backward()
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5, atol=1e-5)
    bns = [(n, m) for n, m in t.model.named_modules() if getattr(m, "batch_stats", None) is not None]
    assert len(bns) == len(jstats) == 66
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
    # the update, from JAX's gradient in both packages
    lr, mom = 1e-3, 0.9
    jopt = JO.build_optimizer("AdamW", t.args.weight_decay * 2 * 32 / 64)
    new = jax.jit(lambda g, p: jopt.update(g, jopt.init(p), p, lr, mom, lr_bias=lr)[0])(jg, jp)  # one compile, not one an op
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


# --- the trainer end to end and what is left out -----------------------------------------------------------


def test_segment_train_writes_its_losses_and_metrics(tmp_path, two_threads):
    """YOLO("yolov8n-seg.yaml").train for one epoch on 8 frames (imgsz 64, batch 4, f32): the model rebuilt at
    the dataset's nc 1 stays a segment model, results.csv has the box / seg / cls / dfl losses and the mask
    metrics, last.npz and best.npz are segment checkpoints, and the trained model predicts masks."""
    data = _write_seg_split(tmp_path / "d", 8, 5)
    (tmp_path / "d" / "data.yaml").write_text((tmp_path / "d" / "data.yaml").read_text().replace("val:", "train: images/val\nval:"))
    y = yolo_tpu_torch.YOLO("yolov8n-seg.yaml", device="cpu")
    m = y.train(data=data, epochs=1, imgsz=64, batch=4, workers=1, amp=False, plots=False, project=str(tmp_path / "runs"),
                name="t", exist_ok=True)
    assert y.model.nc == 1 and y.task == "segment" and "mask_mAP50-95" in m
    header = (tmp_path / "runs" / "t" / "results.csv").read_text().splitlines()[0].split(",")
    assert {f"train/{k}_loss" for k in ("box", "seg", "cls", "dfl")} <= set(header) and "metrics/mask_mAP50" in header
    for name in ("last.npz", "best.npz"):
        assert yolo_tpu_torch.YOLO(str(tmp_path / "runs" / "t" / "weights" / name), device="cpu").task == "segment"
    r = y.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, conf=0.0, max_det=5, verbose=False)[0]
    assert r.masks is not None and r.masks.data.shape == (len(r), 64, 64)


def test_segment_entry_points_left_out_raise(seg_pair):
    """What stays refused for a segment model names itself with NotImplementedError: FusedDetectTrack (the JAX package
    asserts a plain Detect head) and ensembles (JAX's raises TypeError). benchmark, tune, tiled inference, int8 predict
    and a server lane run since the seventeenth slice (tests/test_torch_task_entry_points.py holds them against JAX)."""
    from yolo_tpu_torch.pipeline.fused import FusedDetectTrack

    _, py, _ = seg_pair
    for call, what in ((lambda: FusedDetectTrack(py.model, py.params, device="cpu"), "FusedDetectTrack"),
                       (lambda: yolo_tpu_torch.YOLO(["yolov8n-seg.yaml", "yolov8n-seg.yaml"], device="cpu"), "ensemble")):
        with pytest.raises(NotImplementedError, match=what):
            call()
