"""FastSAM and the CLIP vision tower of the port against the JAX package's on the CPU.

FastSAM-s (yolov8s-seg, nc 1) at imgsz 128 predicts in f32 in both packages on a tuned init(0) tree (the segment
tests' `_tuned`: boxes of a few strides, scores spread near 0.5, masks that fill their boxes), so that everything
mode keeps real masks and the prompts choose among them. The CLIP towers are narrow (vision width 64, 2 layers at
64²; JAX's seeded full text tower, as JAX's `CLIPModel` always builds it). Tolerances, stated again at each test:
rows and masks equal, boxes 1e-3 px, scores 1e-5; CLIP features 1e-5."""

import numpy as np
import pytest
import torch

from yolo_tpu.models import fastsam as JFS
from yolo_tpu.nn import text_model as JTM
from yolo_tpu_torch.models import fastsam as PFS
from yolo_tpu_torch.nn import text_model as PTM
from yolo_tpu_torch.nn.torch_export import flatten_tree

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_pose import _same_tree
from tests.test_torch_segment import _tuned

BOX = 1e-3
SCORE = 1e-5
FEAT = 1e-5
IMGSZ = 128
VISION = dict(image_size=64, patch=16, width=64, layers=2, heads=2, embed_dim=512)


@pytest.fixture(scope="module")
def pair():
    """JAX's and the port's FastSAM-s on the same tuned tree, and one narrow CLIPModel each."""
    jf, pf = JFS.FastSAM("FastSAM-s.yaml"), PFS.FastSAM("FastSAM-s.yaml", device="cpu")
    _same_tree(pf.params, jf.params)
    tree = _tuned(jf.params, 1)
    jf.params, pf.params = tree, tree
    return jf, pf, JTM.CLIPModel(**VISION), PTM.CLIPModel(device="cpu", **VISION)


def _frame(seed):
    """A 96x128 BGR frame: dark noise with three bright ellipses."""
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, (96, 128, 3), np.uint8)
    for c, a in (((30, 30), (14, 10)), ((85, 60), (20, 14)), ((110, 20), (9, 9))):
        cv2.ellipse(img, c, a, 0, 0, 360, tuple(int(v) for v in rng.integers(150, 255, 3)), -1)
    return img


def _same_results(rp, rj, what):
    assert len(rp) == len(rj), (what, len(rp), len(rj))
    if not len(rj):
        return
    np.testing.assert_allclose(rp.boxes.xyxy, np.asarray(rj.boxes.xyxy), atol=BOX, err_msg=what)
    np.testing.assert_allclose(rp.boxes.conf, np.asarray(rj.boxes.conf), atol=SCORE, err_msg=what)
    assert np.array_equal(rp.boxes.cls, np.asarray(rj.boxes.cls)), what
    assert np.array_equal(rp.masks.data, np.asarray(rj.masks.data)), what


PROMPTS = {
    "everything": {},
    "bbox": dict(bboxes=[[10, 10, 60, 60]]),
    "bboxes": dict(bboxes=[[10, 10, 60, 60], [60, 40, 120, 90]]),
    "point": dict(points=[[30, 30]], labels=[1]),
    "points_bg": dict(points=[[30, 30], [85, 60]], labels=[0, 0]),
    "bbox_point": dict(bboxes=[[60, 40, 120, 90]], points=[[30, 30]]),
    "text": dict(texts="a bright object"),
    "texts": dict(texts=["an ellipse", "dark noise"]),
}


@pytest.mark.parametrize("kind", list(PROMPTS))
def test_fastsam_predict_matches_jax(pair, kind):
    """`FastSAM("FastSAM-s.yaml").predict` in everything mode and under bbox, point (foreground, background only),
    bbox + point and text prompts (the seeded CLIPs passed as `clip_model`): the same rows (boxes 1e-3 px,
    scores 1e-5, classes) and masks (equal) as JAX's, f32, imgsz 128, conf 1e-4."""
    jf, pf, jc, pc = pair
    kw = dict(PROMPTS[kind])
    img = _frame(len(kind))
    common = dict(conf=1e-4, imgsz=IMGSZ, compute_dtype="float32", verbose=False)
    rj = jf.predict(img, **common, **kw, **({"clip_model": jc} if "texts" in kw else {}))[0]
    rp = pf.predict(img, **common, **kw, **({"clip_model": pc} if "texts" in kw else {}))[0]
    _same_results(rp, rj, kind)
    assert len(rp) > 0 and pf.model.names == {0: "object"} and pf.model.nc == 1
    if kind == "everything":
        assert rp.masks.data.any(1).any(1).sum() > len(rp) // 2  # most kept masks cover pixels


def test_full_image_snap_matches_jax():
    """A box covering nearly the whole frame snaps to it (IoU > 0.9 after the 20 px border snap), as JAX's: the
    same rows on a frame that one large ellipse fills."""
    import cv2

    img = np.full((96, 128, 3), 30, np.uint8)
    cv2.ellipse(img, (64, 48), (70, 52), 0, 0, 360, (220, 220, 220), -1)
    jf, pf = JFS.FastSAM("FastSAM-s.yaml"), PFS.FastSAM("FastSAM-s.yaml", device="cpu")
    tree = _tuned(jf.params, 1)
    jf.params, pf.params = tree, tree
    kw = dict(conf=1e-4, imgsz=IMGSZ, compute_dtype="float32", verbose=False)
    _same_results(pf.predict(img, **kw)[0], jf.predict(img, **kw)[0], "snap")


def test_adjust_bboxes_to_image_border_matches_jax():
    """Boxes near the border snap onto it (threshold 20), exactly as JAX's."""
    b = np.array([[5, 5, 100, 100], [30, 30, 118, 90], [19, 21, 109, 77]], np.float32)
    for thr in (20, 10):
        assert np.array_equal(PFS.adjust_bboxes_to_image_border(b, (96, 128), thr),
                              JFS.adjust_bboxes_to_image_border(b, (96, 128), thr))


def test_fastsam_facades_build_and_refuse_as_jax():
    """FastSAM-x builds yolov8x-seg with nc 1 and names {0: "object"}, on JAX's init(0) tree; a missing `.pt`
    raises FileNotFoundError in both packages."""
    for cls in (JFS.FastSAM, lambda m: PFS.FastSAM(m, device="cpu")):
        with pytest.raises(FileNotFoundError):
            cls("FastSAM-missing.pt")
    px = PFS.FastSAM("FastSAM-x.yaml", device="cpu")
    assert px.model.nc == 1 and px.model.names == {0: "object"} and px.task == "segment"
    assert px.overrides == {"model": "FastSAM-x.yaml", "task": "segment"}


def test_clip_vision_tower_matches_jax():
    """The vision tower's seeded tree is JAX's bit for bit; its features on four 64² images within 1e-5 (narrow
    tower), and `CLIPModel.encode_image` on crops of three sizes (the short side bicubic to 64, centre crop) too."""
    jv, pv = JTM.CLIPVisionEncoder(**VISION), PTM.CLIPVisionEncoder(**VISION)
    _same_tree(pv.init(3), jv.init(3))
    ims = np.random.default_rng(0).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    got = pv.encode_image(PTM._vision_to_device(pv.init(3), "cpu"), torch.from_numpy(ims)).numpy()
    assert np.abs(got - np.asarray(jv.encode_image(jv.init(3), ims))).max() < FEAT
    jc, pc = JTM.CLIPModel(**VISION), PTM.CLIPModel(device="cpu", **VISION)
    rng = np.random.default_rng(1)
    crops = [rng.integers(0, 255, s, np.uint8) for s in ((30, 50, 3), (64, 64, 3), (90, 40, 3))]
    assert np.abs(pc.encode_image(crops).numpy() - np.asarray(jc.encode_image(crops))).max() < FEAT
    assert np.abs(pc.encode_text(["a cat", "a dog"]).numpy() - np.asarray(jc.encode_text(["a cat", "a dog"]))).max() < FEAT


def test_clip_model_load_torch_matches_jax(tmp_path):
    """`CLIPModel.load_torch` of an OpenAI-layout state dict the test writes (text keys and `visual.*`, conv1 in
    OIHW): both packages read the same trees and give the same image features (1e-5)."""
    jc, pc = JTM.CLIPModel(**VISION), PTM.CLIPModel(device="cpu", **VISION)
    rng = np.random.default_rng(2)
    sd = {}
    for k, v in flatten_tree(pc.text.params).items():
        sd[k] = torch.from_numpy(np.asarray(v) + rng.normal(0, 0.01, np.shape(v)).astype(np.float32))
    for k, v in flatten_tree(pc.vision_params).items():
        a = np.asarray(v) + rng.normal(0, 0.01, np.shape(v)).astype(np.float32)
        sd["visual." + k] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    jc.load_torch(path)
    pc.load_torch(path)
    _same_tree(pc.vision_params, jc.vision_params)
    crops = [rng.integers(0, 255, (40, 70, 3), np.uint8)]
    assert np.abs(pc.encode_image(crops).numpy() - np.asarray(jc.encode_image(crops))).max() < FEAT
