"""`YOLO(best.npz, device="cpu").val` of the port against the JAX package's validator on a
hard fixture: 8 seeded 320x256 IR frames with faint, small targets and unlabeled clutter
(demos/ir_end_to_end.py::_write_split, seed 777), where a matching or NMS divergence moves
the mAP (the JAX validator gives mAP50 0.8246, mAP50-95 0.5020 at imgsz 320). Each package
reads its own copy of the split. imgsz 320 letterboxes by padding only, 256 by a cv2 resize.
The port runs the kernels' plain twins on the CPU."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from demos.ir_end_to_end import _write_split
from yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_tpu_torch.engine import validator as PV

from tests.conftest import ROOT
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)

WEIGHTS = str(ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz")
KEYS = ("precision", "recall", "mAP50", "mAP50-95", "fitness")


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """Two copies of the hard split → {"jax": yaml, "torch": yaml}."""
    out = {}
    for pkg in ("jax", "torch"):
        root = tmp_path_factory.mktemp(f"hard_{pkg}")
        _write_split(root, "val", 8, 320, 256, seed=777, amp=(40.0, 90.0), radius=(1.5, 4.0), distractors=3)
        (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames:\n  0: aircraft\n")
        out[pkg] = str(root / "data.yaml")
    return out


def _jax_val(splits, fused=False, **kw):
    """The JAX validator as the JAX `YOLO.val` builds it → (results, validator)."""
    jy = yolo_tpu.YOLO(WEIGHTS)
    if fused:
        jy.fuse()
    v = JaxValidator(args={**jy.overrides, "data": splits["jax"], "plots": False, **kw, "mode": "val"})
    return v(model=jy.model, params=jy.params), v


def _port_val(splits, **kw):
    py = yolo_tpu_torch.YOLO(WEIGHTS, device="cpu")
    return py.val(data=splits["torch"], **{"plots": False, **kw}), py


@pytest.mark.parametrize("imgsz", [320, 256])
def test_val_f32_matches_jax(splits, two_threads, imgsz):
    """f32 (the default): every result key within 1e-4, equal confusion matrices."""
    want, jv = _jax_val(splits, imgsz=imgsz)
    got, py = _port_val(splits, imgsz=imgsz)
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    np.testing.assert_array_equal(py.validator.confusion_matrix.matrix, jv.confusion_matrix.matrix)
    assert py.validator.args.conf == 0.001 and py.validator.args.half is False
    assert py.model.held[1:] == (torch.device("cpu"), torch.float32)
    assert [t["loader"] >= 0 for t in py.validator.timings] == [True]  # one batch of 8 at the default batch 16
    if imgsz == 320:  # the JAX package's own numbers on this split, so the fixture stays hard
        assert abs(want["mAP50"] - 0.8246) < 1e-3 and abs(want["mAP50-95"] - 0.5020) < 1e-3


# bf16 against bf16 at imgsz 320: the port always computes on the fused tree (BN folded
# into the conv, the bias added in bf16), so its like-for-like reference is the JAX
# validator on the fused tree (`YOLO.fuse()`). Measured on this split: the port's bf16 is
# at most 1.8e-3 from it (P 0.9751 / 0.9733, R 0.8 / 0.8, mAP50 0.8877 / 0.8869,
# mAP50-95 0.5095 / 0.5083), while the port's f32 is 0.070 from it (R 0.7300, mAP50
# 0.8246): bf16 moves the scores by up to ~0.02 and on these faint targets that moves
# whole detections across IoU 0.5. The limit sits between the two readings, so a run
# that computed in f32 fails. The JAX validator on the unfused tree runs BN and SiLU in
# f32 after each bf16 conv and lands several hundredths from both.
BF16_TOL = 5e-3


def test_val_bf16_matches_jax_on_the_fused_tree(splits, two_threads):
    want, _ = _jax_val(splits, fused=True, imgsz=320, half=True)
    got, py = _port_val(splits, imgsz=320, half=True)
    assert py.model.held[2] == torch.bfloat16
    diff = {k: abs(got[k] - want[k]) for k in KEYS}
    assert max(diff.values()) <= BF16_TOL, (diff, got, want)
    f32, _ = _port_val(splits, imgsz=320)  # what was computed, not only what was installed, is bf16
    assert max(abs(got[k] - f32[k]) for k in KEYS) > BF16_TOL, (got, f32)


def test_val_save_json_matches_jax(splits, two_threads, tmp_path):
    """The COCO-style rows: image ids and classes equal, boxes (original pixels) within
    1e-2 px, scores within 1e-4, in the same order; written under project/val."""
    kw = dict(imgsz=256, save_json=True, exist_ok=True)
    _, jv = _jax_val(splits, project=str(tmp_path / "jax"), **kw)
    got, py = _port_val(splits, project=str(tmp_path / "torch"), **kw)
    rows = json.loads((tmp_path / "torch" / "val" / "predictions.json").read_text())
    want = jv._json_dets
    assert rows == py.validator._json_dets and len(rows) == len(want) > 0
    for r, w in zip(rows, want):
        assert (r["image_id"], r["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(r["bbox"], w["bbox"], rtol=0, atol=1e-2)
        assert abs(r["score"] - w["score"]) <= 1e-4


def test_predict_val_predict_gives_the_same_detections(splits, two_threads):
    """val installs f32 weights into the model predict shares; the next predict (bf16,
    its default) reinstalls its own and returns the first predict's detections."""
    py = yolo_tpu_torch.YOLO(WEIGHTS, device="cpu")
    frame = np.random.default_rng(3).integers(0, 60, (256, 320, 3), np.uint8)
    frame[100:108, 150:158] = 230
    kw = dict(imgsz=320, conf=0.05, verbose=False)
    first = py.predict(frame, **kw)[0].boxes.data
    assert py.model.held[2] == torch.bfloat16
    metrics = py.val(data=splits["torch"], imgsz=320, plots=False)
    assert py.validator.args.conf == 0.001 and py.model.held[2] == torch.float32  # not predict's conf 0.25, nor bf16
    again = py.predict(frame, **kw)[0].boxes.data
    assert len(first) > 0
    np.testing.assert_array_equal(again, first)
    assert metrics is py.metrics and metrics["mAP50"] > 0


def test_val_plots_and_a_failing_plot(splits, two_threads, tmp_path, monkeypatch):
    got, _ = _port_val(splits, imgsz=256, project=str(tmp_path))
    _, py = _port_val(splits, imgsz=256, plots=True, project=str(tmp_path))
    assert (tmp_path / "val" / "confusion_matrix.png").stat().st_size > 0

    def broken(*a, **k):
        raise RuntimeError("no backend")

    monkeypatch.setattr("yolo_tpu_torch.utils.plotting.plot_confusion_matrix", broken)
    assert py.val(data=splits["torch"], imgsz=256, plots=True, project=str(tmp_path)) == got  # a warning, the metrics stand


def test_unported_tasks_and_the_coco_cross_check_raise(tmp_path):
    """The tasks without a validator raise naming themselves; classify, segment, pose and obb have their own
    validators. The COCOeval cross-check no longer raises: tests/test_torch_coco_eval.py holds it
    against JAX."""
    from yolo_tpu_torch.engine.classify import ClassificationValidator

    assert PV.validator_for(SimpleNamespace(task="segment")) is PV.SegmentationValidator
    assert PV.validator_for(SimpleNamespace(task="pose")) is PV.PoseValidator
    assert PV.validator_for(SimpleNamespace(task="obb")) is PV.OBBValidator
    for model, task in ((SimpleNamespace(is_rtdetr=True), "rtdetr"),):
        with pytest.raises(NotImplementedError, match=task):
            PV.validator_for(model)
    assert PV.validator_for(SimpleNamespace()) is PV.DetectionValidator
    assert PV.validator_for(SimpleNamespace(task="classify")) is ClassificationValidator
    assert PV.DetectionValidator(args={"conf": None, "unknown_key": 1}).args.conf == 0.001  # cfg keys only, as in JAX
