"""The port's COCOeval protocol (yolo_tpu_torch/utils/coco_eval.py) against the JAX package's copy on
the scenarios of tests/test_coco_eval.py and a seeded multi-image, multi-category one (every key
within 1e-12), and the validator's `save_json` cross-check through `YOLO(best.npz).val` against the
JAX validator on a split that carries annotations/instances_val2017.json."""

import json

import numpy as np
import pytest

import yolo_tpu
import yolo_tpu_torch
from demos.ir_end_to_end import _write_split
from yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_tpu.utils import coco_eval as J
from yolo_tpu_torch.utils import coco_eval as P

from tests.conftest import ROOT
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = str(ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz")


def _gt(anns, n_imgs=1, cats=(1,)):
    return {
        "images": [{"id": i} for i in range(n_imgs)],
        "categories": [{"id": c} for c in cats],
        "annotations": [{"id": j, **a} for j, a in enumerate(anns)],
    }


def _a(i, box, crowd=0, c=1):
    return {"image_id": i, "category_id": c, "bbox": box, "iscrowd": crowd}


def _d(i, box, score, c=1):
    return {"image_id": i, "category_id": c, "bbox": box, "score": score}


def _seeded_case(seed=0, n_imgs=6, cats=(1, 2, 3)):
    """Jittered copies of the ground truth, misses, false positives, crowds and all three area ranges."""
    rng = np.random.default_rng(seed)
    anns, dts = [], []
    for i in range(n_imgs):
        for _ in range(rng.integers(0, 6)):
            wh = rng.choice([6.0, 20.0, 50.0, 140.0]) * rng.uniform(0.7, 1.3, 2)
            box = [*rng.uniform(0, 400, 2), *wh]
            c = int(rng.choice(cats))
            anns.append(_a(i, [float(v) for v in box], crowd=int(rng.random() < 0.1), c=c))
            if rng.random() < 0.8:
                jit = np.asarray(box) + np.concatenate([rng.normal(0, 0.08, 2) * wh, rng.normal(0, 0.08, 2) * wh])
                dts.append(_d(i, [float(v) for v in jit], float(rng.uniform(0.05, 1.0)), c))
        for _ in range(rng.integers(0, 4)):
            dts.append(_d(i, [float(v) for v in [*rng.uniform(0, 400, 2), *rng.uniform(5, 120, 2)]], float(rng.uniform(0.01, 0.9)),
                          int(rng.choice(cats))))
    return _gt(anns, n_imgs, cats), dts


CASES = {  # the scenarios of tests/test_coco_eval.py, then a seeded one
    "perfect": (_gt([_a(0, [10, 10, 40, 40]), _a(0, [100, 100, 50, 50])]),
                [_d(0, [10, 10, 40, 40], 0.9), _d(0, [100, 100, 50, 50], 0.8)]),
    "trailing_fp": (_gt([_a(0, [10, 10, 40, 40])]), [_d(0, [10, 10, 40, 40], 0.9), _d(0, [300, 300, 40, 40], 0.8)]),
    "missed_gt": (_gt([_a(0, [10, 10, 40, 40]), _a(0, [200, 200, 40, 40])]), [_d(0, [10, 10, 40, 40], 0.9)]),
    "crowd": (_gt([_a(0, [10, 10, 40, 40], crowd=1), _a(0, [200, 200, 40, 40])]),
              [_d(0, [12, 12, 20, 20], 0.9), _d(0, [200, 200, 40, 40], 0.8)]),
    "iou_sweep": (_gt([_a(0, [0, 0, 100, 60])]), [_d(0, [0, 0, 100, 100], 0.9)]),
    "area_ranges": (_gt([_a(0, [0, 0, 10, 10]), _a(0, [50, 50, 200, 200])]),
                    [_d(0, [0, 0, 10, 10], 0.9), _d(0, [50, 50, 200, 200], 0.8)]),
    "multi_image": (_gt([_a(0, [0, 0, 40, 40]), _a(1, [0, 0, 40, 40])], n_imgs=2),
                    [_d(0, [500, 500, 40, 40], 0.95), _d(0, [0, 0, 40, 40], 0.9), _d(1, [0, 0, 40, 40], 0.8)]),
    "fp_on_empty_category": ({"images": [{"id": 1}], "categories": [{"id": 1}, {"id": 2}],
                              "annotations": [{"id": 1, "image_id": 1, "category_id": 1, "bbox": [10, 10, 20, 20], "iscrowd": 0,
                                               "area": 400}]},
                             [_d(1, [10, 10, 20, 20], 0.9), _d(1, [50, 50, 10, 10], 0.8, c=2)]),
    "seeded": _seeded_case(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coco_evaluate_matches_jax(case, tmp_path):
    """Every key of the port's result within 1e-12 of the JAX package's (the same float64 numpy
    code), from dicts and from json files alike."""
    gt, dt = CASES[case]
    want = J.coco_evaluate(gt, dt)
    got = P.coco_evaluate(gt, dt)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "dt.json").write_text(json.dumps(dt))
    assert P.coco_evaluate(str(tmp_path / "gt.json"), tmp_path / "dt.json") == got
    assert P.coco80_to_coco91_class() == J.coco80_to_coco91_class()


def _split_with_annotations(root):
    """test_torch_val.py's hard split (8 seeded 320x256 frames) with a COCO annotations file of its
    labels: image ids the numeric file stems, boxes in pixels (ltwh), category 0."""
    _write_split(root, "val", 8, 320, 256, seed=777, amp=(40.0, 90.0), radius=(1.5, 4.0), distractors=3)
    images, anns = [], []
    for f in sorted((root / "labels" / "val").glob("*.txt")):
        images.append({"id": int(f.stem), "width": 320, "height": 256})
        for line in f.read_text().split("\n"):
            if line.strip():
                c, x, y, w, h = (float(v) for v in line.split())
                anns.append({"id": len(anns), "image_id": int(f.stem), "category_id": int(c), "iscrowd": 0,
                             "bbox": [(x - w / 2) * 320, (y - h / 2) * 256, w * 320, h * 256], "area": w * 320 * h * 256})
    (root / "annotations").mkdir()
    (root / "annotations" / "instances_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns, "categories": [{"id": 0, "name": "aircraft"}]}))
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames:\n  0: aircraft\n")
    return root / "data.yaml"


def test_val_save_json_coco_cross_check_matches_jax(tmp_path, two_threads):
    """`YOLO(best.npz).val(save_json=True)` where the split has annotations/instances_val2017.json
    (f32, imgsz 256): predictions.json under project/val holds the validator's rows (image ids and
    classes equal to JAX's, boxes 1e-2 px, scores 1e-4, in the same order); the results gain the
    JAX validator's coco/* keys, each within 1e-4 of its value, and each equal to the port's
    coco_evaluate rerun on the written files."""
    data = {pkg: _split_with_annotations(tmp_path / pkg) for pkg in ("jax", "torch")}
    kw = dict(imgsz=256, save_json=True, exist_ok=True, plots=False)
    jy = yolo_tpu.YOLO(WEIGHTS)
    want = JaxValidator(args={**jy.overrides, "data": str(data["jax"]), "project": str(tmp_path / "jout"), **kw, "mode": "val"})(
        model=jy.model, params=jy.params)
    py = yolo_tpu_torch.YOLO(WEIGHTS, device="cpu")
    got = py.val(data=str(data["torch"]), project=str(tmp_path / "tout"), **kw)
    coco = sorted(k for k in want if k.startswith("coco/"))
    assert coco and sorted(k for k in got if k.startswith("coco/")) == coco and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    written = tmp_path / "tout" / "val" / "predictions.json"
    rows, jrows = json.loads(written.read_text()), json.loads((tmp_path / "jout" / "val" / "predictions.json").read_text())
    assert rows == py.validator._json_dets and len(rows) == len(jrows) > 0
    for r, w in zip(rows, jrows):
        assert (r["image_id"], r["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(r["bbox"], w["bbox"], rtol=0, atol=1e-2)
        assert abs(r["score"] - w["score"]) <= 1e-4
    again = P.coco_evaluate(str(tmp_path / "torch" / "annotations" / "instances_val2017.json"), str(written))
    assert {f"coco/{k}": v for k, v in again.items()} == {k: got[k] for k in coco}
    assert got["coco/mAP50"] > 0
