"""The port's data path (yolo_tpu_torch/data/, cfg/, utils/files.py) against the JAX
package's: dataset yamls, label paths and parsing, the validation letterbox, the
training augmentations one by one and composed under the IR recipe, the demo's and a
recipe that turns every one on, the collate, and the threaded loaders (in order, and
shuffled with per-worker augmentation RNGs over epochs and close_mosaic). The
fixture's images are seeded numpy noise written as PNGs; both packages read them with
the label cache off (`cache=False`) unless a test is about the cache, so neither reads
the other's. The same `random.Random` seeds drive both packages' augmentations, which
must give the same pixels and labels, bit for bit."""

import copy
import json
import random
import threading

import cv2
import numpy as np
import pytest

from yolo_tpu.cfg import get_cfg as jax_get_cfg
from yolo_tpu.data import augment as JA
from yolo_tpu.data import build as JBd
from yolo_tpu.data import dataset as JD
from yolo_tpu_torch import cfg as PC
from yolo_tpu_torch.data import augment as PA
from yolo_tpu_torch.data import build as PBd
from yolo_tpu_torch.data import dataset as PD
from yolo_tpu_torch.utils import files as PF
from yolo_tpu_torch.utils.coco_eval import coco80_to_coco91_class

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

LABELS = {  # image stem → label file text (None: no file)
    "a": "0 0.5 0.5 0.2 0.3\n1 0.25 0.3 0.1 0.1\n",
    "b": "2 0.1 0.1 0.4 0.1 0.4 0.5 0.1 0.5\n0 0.7 0.7 0.05 0.08\n",  # a polygon row, then a box row
    "c": None,  # no label file: background
    "d": "",  # an empty label file
    "e": "1 0.5 0.5 0.3\n0 0.6 0.4 0.2 0.2 extra\n",  # a short row (skipped), a long box row
    "f": "1 0.2 0.2 0.1 0.1 0.3 0.1 0.3 0.2 0.2 0.2\n",  # a four-point polygon
    "g": "0 0.45 0.55 0.5 0.4\n",
}
SHAPES = {"a": (48, 64), "b": (64, 48), "c": (40, 40), "d": (48, 64), "e": (80, 100), "f": (32, 64), "g": (48, 64)}


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for stem, text in LABELS.items():
        cv2.imwrite(str(root / "images" / "val" / f"{stem}.png"), rng.integers(0, 255, (*SHAPES[stem], 3), np.uint8))
        if text is not None:
            (root / "labels" / "val" / f"{stem}.txt").write_text(text)
    (root / "data.yaml").write_text("path: .\nval: images/val\nnames: [plane, bird, drone]\n")
    return root


def _datasets(img_path, **kw):
    return PD.YOLODataset(img_path, cache=False, **kw), JD.YOLODataset(img_path, cache=False, **kw)


def _same_labels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["cls"], w["cls"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])


def test_check_det_dataset_matches_jax(dataset_root, tmp_path, monkeypatch):
    yaml_path = dataset_root / "data.yaml"
    monkeypatch.chdir(dataset_root)  # `path: .` resolves against the process directory in both packages
    for data in (str(yaml_path), {"path": str(dataset_root), "val": "images/val", "names": ["x", "y"]},
                 {"val": str(dataset_root / "images" / "val")}, {"path": "/abs", "train": "t", "test": "/elsewhere/x"}):
        assert PD.check_det_dataset(data) == JD.check_det_dataset(data)
    monkeypatch.chdir(tmp_path)  # the bare name of a shipped yaml
    got, want = PD.check_det_dataset("ir-small-target.yaml"), JD.check_det_dataset("ir-small-target.yaml")
    assert {k: v for k, v in got.items() if k != "yaml_file"} == {k: v for k, v in want.items() if k != "yaml_file"}
    assert got["names"] == {0: "aircraft"} and got["nc"] == 1


@pytest.mark.parametrize("path", [
    "/d/images/val/x.jpg", "/d/images/val/sub/x.png", "/images/d/images/x.jpg", "/d/imgs/x.jpg", "x.png", "/d/images/x.tar.jpg",
])
def test_img2label_path_matches_jax(path):
    assert PD.img2label_path(path) == JD.img2label_path(path)


@pytest.mark.parametrize("single_cls", [False, True])
def test_labels_match_jax(dataset_root, single_cls):
    got, want = _datasets(str(dataset_root / "images" / "val"), single_cls=single_cls)
    assert got.im_files == want.im_files and len(got) == len(LABELS)
    _same_labels(got.labels, want.labels)
    by_stem = dict(zip(sorted(LABELS), got.labels))
    assert len(by_stem["b"]["cls"]) == 2 and len(by_stem["c"]["cls"]) == 0 and len(by_stem["d"]["cls"]) == 0
    assert len(by_stem["e"]["cls"]) == 1 and len(by_stem["f"]["cls"]) == 1
    if single_cls:
        assert all((lb["cls"] == 0).all() for lb in got.labels)


@pytest.mark.parametrize("source,fraction", [("glob", 1.0), ("list", 1.0), ("dir", 0.5), ("dir", 0.01)])
def test_image_lists_and_fraction_match_jax(dataset_root, tmp_path, source, fraction):
    if source == "glob":
        img_path = str(dataset_root / "images" / "val" / "[a-e].png")
    elif source == "list":  # relative entries resolve against the list file's folder
        lst = dataset_root / "val_list.txt"
        lst.write_text("images/val/g.png\n\n" + str(dataset_root / "images" / "val" / "a.png") + "\nimages/val/e.png\n")
        img_path = str(lst)
    else:
        img_path = str(dataset_root / "images" / "val")
    got, want = _datasets(img_path, fraction=fraction)
    assert got.im_files == want.im_files
    _same_labels(got.labels, want.labels)
    with pytest.raises(FileNotFoundError):
        PD.YOLODataset(str(tmp_path / "nothing_here"), cache=False)


def test_label_cache_is_the_ports_own(dataset_root):
    img_dir = dataset_root / "images" / "val"
    first = PD.YOLODataset(str(img_dir))
    caches = sorted(p.name for p in img_dir.glob(".labels_*.json"))
    assert len(caches) == 1 and caches[0].endswith(".torch.cache.json")
    JD.YOLODataset(str(img_dir))  # the JAX package writes its own file beside it
    assert len(list(img_dir.glob(".labels_*.json"))) == 2
    (img_dir / caches[0]).write_text(json.dumps([{"cls": [5.0], "bboxes": [[0.5, 0.5, 0.1, 0.1]]}] * len(LABELS)))
    assert all(lb["cls"].tolist() == [5.0] for lb in PD.YOLODataset(str(img_dir)).labels)  # it is read
    (img_dir / caches[0]).write_text("{not json")
    _same_labels(PD.YOLODataset(str(img_dir)).labels, first.labels)  # an unreadable cache is parsed again
    for p in img_dir.glob(".labels_*.json"):
        p.unlink()


@pytest.mark.parametrize("cache", ["ram", True])
def test_ram_cache_matches_jax(dataset_root, cache):
    """cache='ram' (or True) keeps each decoded image after its first read: load_raw gives the JAX
    dataset's images and labels, each read a copy (an augmentation writing into it leaves the cache
    as it was), and the labels cache beside the images stays on."""
    img_path = str(dataset_root / "images" / "val")
    got, want = PD.YOLODataset(img_path, cache=cache), JD.YOLODataset(img_path, cache=cache)
    for i in range(len(got)):
        a, b = got.load_raw(i), want.load_raw(i)
        _same_sample(a, b, f"image {i}")
        a["img"][...] = 0
        np.testing.assert_array_equal(got.load_raw(i)["img"], b["img"])
    assert sorted(got._im_cache) == list(range(len(got))) and PD.YOLODataset(img_path, cache=False)._im_cache is None
    rp, rj = random.Random(3), random.Random(3)
    hyp = dict(mosaic=1.0, cutmix=0.5)
    pt, jt = PA.TrainTransforms(got, 64, PC.get_cfg(hyp)), JA.TrainTransforms(want, 64, jax_get_cfg(overrides=hyp))
    for i in list(range(len(got))) * 2:
        _same_sample(pt(got.load_raw(i), rp), jt(want.load_raw(i), rj), f"augmented image {i}")


@pytest.mark.parametrize("imgsz", [64, 48])  # pad only, and cv2 resizes
def test_val_transforms_and_items_match_jax(dataset_root, imgsz):
    got, want = _datasets(str(dataset_root / "images" / "val"), imgsz=imgsz)
    for i in range(len(got)):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["bboxes"], b["bboxes"])
        np.testing.assert_array_equal(a["cls"], b["cls"])
        assert a["ratio_pad"] == b["ratio_pad"] and a["shape"] == b["shape"] and a["im_file"] == b["im_file"]
        assert a["img"].shape == (imgsz, imgsz, 3)
    raw = got.load_raw(4)  # the 80x100 image: a resize at both sizes
    a, b = PA.ValTransforms(imgsz)(dict(raw)), JA.ValTransforms(imgsz)(dict(raw))
    np.testing.assert_array_equal(a["img"], b["img"])
    np.testing.assert_array_equal(a["bboxes"], b["bboxes"])
    assert a["ratio_pad"] == b["ratio_pad"]


@pytest.mark.parametrize("max_boxes", [64, 1])
def test_collate_matches_jax(dataset_root, max_boxes):
    got, _ = _datasets(str(dataset_root / "images" / "val"), imgsz=64)
    samples = [got[i] for i in range(len(got))]
    a, b = PD.collate_batch(samples, max_boxes), JD.collate_batch(samples, max_boxes)
    assert set(a) == set(b) == {"img", "cls", "bboxes", "mask_gt", "meta", "masks"}  # the polygon rows draw masks
    for k in ("img", "cls", "bboxes", "mask_gt", "masks"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["meta"] == b["meta"]
    np.testing.assert_array_equal(a["img"][0], samples[0]["img"][..., ::-1])  # RGB


@pytest.mark.parametrize("batch,workers", [(3, 1), (3, 4), (2, 3), (16, 2)])
def test_dataloader_order_matches_jax(dataset_root, batch, workers):
    got, want = _datasets(str(dataset_root / "images" / "val"), imgsz=64)
    assert PBd._derive_max_boxes(got) == JBd._derive_max_boxes(want) == 64
    pl = PBd.build_dataloader(got, batch, workers=workers)
    jl = JBd.build_dataloader(want, batch, workers=workers, shuffle=False, drop_last=False)
    pb, jb = list(pl), list(jl)
    assert len(pl) == len(jl) == len(pb) == len(jb) == -(-len(LABELS) // batch)
    assert [len(x["meta"]) for x in pb][-1] == len(LABELS) - batch * (len(pb) - 1)  # the partial last batch
    for x, y in zip(pb, jb):
        for k in ("img", "cls", "bboxes", "mask_gt"):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert x["meta"] == y["meta"]


def test_dataloader_raises_a_workers_error_and_stops_its_threads(dataset_root, tmp_path):
    bad = tmp_path / "images"
    bad.mkdir()
    for i in range(6):
        cv2.imwrite(str(bad / f"{i}.png"), np.full((16, 16, 3), i, np.uint8))
    (bad / "3.png").write_bytes(b"not a png")
    for loader in (PBd.build_dataloader(PD.YOLODataset(str(bad), imgsz=16, cache=False), 2, workers=3),
                   JBd.build_dataloader(JD.YOLODataset(str(bad), imgsz=16, cache=False), 2, workers=3, shuffle=False, drop_last=False)):
        with pytest.raises(RuntimeError, match="worker failed") as e:
            list(loader)
        assert isinstance(e.value.__cause__, FileNotFoundError)
    got = PBd.build_dataloader(PD.YOLODataset(str(dataset_root / "images" / "val"), imgsz=64, cache=False), 1, workers=2)
    before = set(threading.enumerate())
    it = iter(got)
    next(it)
    waiting = [t for t in set(threading.enumerate()) - before if t.is_alive()]  # six batches, room for four
    it.close()  # a consumer that stops after one of seven batches: the workers leave, none waits on the queue
    for t in waiting:
        t.join(timeout=5.0)
    assert waiting and not any(t.is_alive() for t in waiting)


def test_cfg_matches_jax(tmp_path):
    over = dict(conf=0.2, imgsz=320, batch=8, half=True, name=7, project=str(tmp_path))
    assert vars(PC.get_cfg(overrides=over)) == vars(jax_get_cfg(overrides=over))
    for bad, exc in ((dict(conf=2.0), ValueError), (dict(half="yes"), TypeError), (dict(max_det=1.5), TypeError),
                     (dict(confidence=0.2), SyntaxError)):
        with pytest.raises(exc):
            PC.get_cfg(overrides=bad)
        with pytest.raises(exc):
            jax_get_cfg(overrides=bad)
    args = PC.get_cfg(overrides=dict(project=str(tmp_path), mode="val"))
    assert PC.get_save_dir(args, name="val") == tmp_path / "val"
    (tmp_path / "val").mkdir()
    assert PC.get_save_dir(args, name="val") == tmp_path / "val2"
    assert PC.get_save_dir(PC.get_cfg(overrides=dict(mode="val"))) == PF.increment_path("runs/detect/val")


def test_files_and_coco_ids_match_jax(tmp_path):
    from yolo_tpu.utils import files as JF
    from yolo_tpu.utils.coco_eval import coco80_to_coco91_class as jax_coco

    img = np.random.default_rng(1).integers(0, 255, (12, 10, 3), np.uint8)
    path = tmp_path / "vidéo ñ.png"  # a path cv2.imread cannot open
    cv2.imencode(".png", img)[1].tofile(str(path))
    np.testing.assert_array_equal(PF.imread(path), JF.imread(path))
    np.testing.assert_array_equal(PF.imread(path), img)
    assert PF.imread(tmp_path / "missing.png") is None and JF.imread(tmp_path / "missing.png") is None
    (tmp_path / "empty.png").write_bytes(b"")
    assert PF.imread(tmp_path / "empty.png") is None
    for p in (tmp_path / "run", path):
        assert PF.increment_path(p) == JF.increment_path(p)
    assert PF.increment_path(tmp_path / "run", mkdir=True).is_dir()
    assert PF.increment_path(tmp_path / "run") == JF.increment_path(tmp_path / "run") == tmp_path / "run2"
    assert coco80_to_coco91_class() == jax_coco() and len(coco80_to_coco91_class()) == 80


# --- the training augmentations ---------------------------------------------------------------

IR_RECIPE = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.3, degrees=0.0, translate=0.05, scale=0.2, shear=0.0, perspective=0.0,
                 flipud=0.1, fliplr=0.5, mosaic=0.3, mixup=0.0, copy_paste=0.15)  # train_small_targets.py:16-45
DEMO_RECIPE = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.3, degrees=0.0, translate=0.05, scale=0.2, mosaic=0.3, copy_paste=0.0,
                   fliplr=0.5, flipud=0.1)  # demos/ir_end_to_end.py:120-125
ALL_ON = dict(degrees=10.0, shear=2.0, perspective=0.0005, mosaic=0.8, mixup=0.5, copy_paste=0.6, copy_paste_mode="mixup",
              bgr=0.5, augment_photometric=0.3)  # every augmentation, with the cfg's HSV gains
CUTMIX = dict(mosaic=0.8, mixup=0.3, cutmix=0.5, copy_paste=0.3)  # cutmix beside the other mixers
RECIPES = {"ir": IR_RECIPE, "demo": DEMO_RECIPE, "all_on": ALL_ON, "cutmix": CUTMIX}


def _same_sample(a, b, what=""):
    for k in ("img", "bboxes", "cls"):
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _raw(ds, i):
    return copy.deepcopy(ds.load_raw(i))


STEPS = {
    "hsv": lambda m, ds, rng: {"img": m.random_hsv(_raw(ds, 0)["img"], 0.015, 0.7, 0.4, rng=rng), "bboxes": np.zeros(0), "cls": np.zeros(0)},
    "flip": lambda m, ds, rng: m.random_flip(_raw(ds, 1), lr_p=0.5, ud_p=0.5, rng=rng),
    "perspective": lambda m, ds, rng: m.random_perspective(_raw(ds, 0), degrees=10, translate=0.1, scale=0.5, shear=2,
                                                             perspective=0.0005, border=(-8, -8), rng=rng),
    "affine": lambda m, ds, rng: m.random_perspective(_raw(ds, 4), translate=0.05, scale=0.2, rng=rng),
    "mosaic4": lambda m, ds, rng: m.mosaic4([_raw(ds, i) for i in (0, 1, 4, 6)], 64, rng=rng),
    "copy_paste": lambda m, ds, rng: m.copy_paste(_raw(ds, 4), _raw(ds, 0), p=0.9, rng=rng),
    "mixup": lambda m, ds, rng: m.mixup(_raw(ds, 0), _raw(ds, 3), rng=rng),
    "photometric": lambda m, ds, rng: {"img": m.random_photometric(_raw(ds, 1)["img"], p=1.0, rng=rng), "bboxes": np.zeros(0),
                                       "cls": np.zeros(0)},
    "mosaic9": lambda m, ds, rng: m.mosaic9([_raw(ds, i) for i in (0, 1, 4, 6, 2, 3, 5, 0, 4)], 64, rng=rng),
    "cutmix": lambda m, ds, rng: m.cutmix(_raw(ds, 0), m.mosaic4([_raw(ds, i) for i in (4, 6, 4, 6)], 32, rng=rng), rng=rng),
}


@pytest.mark.parametrize("step", list(STEPS))
def test_train_augmentations_match_jax(dataset_root, step):
    """Each augmentation on the fixture's images, eight draws from one `random.Random(seed)` per
    package: the same images, boxes and classes; the RNGs end in the same state."""
    got, _ = _datasets(str(dataset_root / "images" / "val"), imgsz=64)
    for seed in range(8):
        rp, rj = random.Random(seed), random.Random(seed)
        _same_sample(STEPS[step](PA, got, rp), STEPS[step](JA, got, rj), f"{step} seed {seed}")
        assert rp.random() == rj.random()


def test_box_clip_and_filter_match_jax():
    rng = np.random.default_rng(5)
    b = rng.uniform(-20, 90, (40, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(0, 30, (40, 2))
    cls = np.arange(40, dtype=np.float32)
    np.testing.assert_array_equal(PA._clip_bboxes(b.copy(), 64, 48), JA._clip_bboxes(b.copy(), 64, 48))
    for kw in ({}, {"area_thr": 0.3, "orig_boxes": b * 1.2}):
        for g, w in zip(PA._filter_boxes(b.copy(), cls, **kw), JA._filter_boxes(b.copy(), cls, **kw)):
            np.testing.assert_array_equal(g, w)


def _train_datasets(root, recipe, imgsz=64):
    p = PD.YOLODataset(str(root / "images" / "val"), imgsz=imgsz, augment=True, hyp=PC.get_cfg(recipe), cache=False)
    j = JD.YOLODataset(str(root / "images" / "val"), imgsz=imgsz, augment=True, hyp=jax_get_cfg(overrides=recipe), cache=False)
    assert isinstance(p.transforms, PA.TrainTransforms) and isinstance(j.transforms, JA.TrainTransforms)
    return p, j


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_transforms_match_jax(dataset_root, recipe):
    """TrainTransforms under a recipe, every image three times from one RNG per package, then again
    after close_mosaic: the same images, boxes and classes, bit for bit."""
    got, want = _train_datasets(dataset_root, RECIPES[recipe])
    for closed in (False, True):
        if closed:
            got.close_mosaic(), want.close_mosaic()
        rp, rj = random.Random(7), random.Random(7)
        for i in list(range(len(got))) * 3:
            a, b = got.transforms(got.load_raw(i), rp), want.transforms(want.load_raw(i), rj)
            _same_sample(a, b, f"{recipe} image {i} closed={closed}")
            assert a["img"].shape == (64, 64, 3)


def test_mosaic9_transforms_match_jax(dataset_root):
    """TrainTransforms with mosaic_n = 9 (the 3x3 mosaic) under the all-on recipe, every image twice from
    one RNG per package: the same images, boxes and classes, bit for bit."""
    got, want = _train_datasets(dataset_root, ALL_ON)
    got.transforms.mosaic_n = want.transforms.mosaic_n = 9
    rp, rj = random.Random(11), random.Random(11)
    for i in list(range(len(got))) * 2:
        a, b = got.transforms(got.load_raw(i), rp), want.transforms(want.load_raw(i), rj)
        _same_sample(a, b, f"mosaic9 image {i}")
        assert a["img"].shape == (64, 64, 3)


@pytest.mark.parametrize("recipe", [dict(cutmix=1.0), dict(mosaic=1.0, mixup=1.0)], ids=["cutmix", "mixup"])
def test_mixers_that_never_end_are_refused(dataset_root, recipe):
    """cutmix >= 1, or mixup >= 1 with mosaic >= 1, draws a donor for every donor: the port refuses the
    dataset with a ValueError naming the setting, where the JAX package recurses until RecursionError."""
    import sys

    with pytest.raises(ValueError, match=next(iter(k for k in recipe if k != "mosaic"))):
        _train_datasets(dataset_root, {**IR_RECIPE, **recipe})
    j = JD.YOLODataset(str(dataset_root / "images" / "val"), imgsz=64, augment=True,
                       hyp=jax_get_cfg(overrides={**IR_RECIPE, **recipe}), cache=False)
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(300)
    try:
        with pytest.raises(RecursionError):
            j.transforms(j.load_raw(0), random.Random(0))
    finally:
        sys.setrecursionlimit(limit)


@pytest.mark.parametrize("recipe,workers", [("ir", 2), ("all_on", 3)])
def test_train_loader_matches_jax(dataset_root, recipe, workers):
    """The training loaders (shuffled by seed and epoch, one augmentation RNG per worker, the short
    last batch dropped) over two epochs, close_mosaic before the second: the same batches."""
    got, want = _train_datasets(dataset_root, RECIPES[recipe])
    pl = PBd.build_dataloader(got, 2, workers=workers, shuffle=True, seed=3, drop_last=True)
    jl = JBd.build_dataloader(want, 2, workers=workers, shuffle=True, seed=3, drop_last=True)
    assert len(pl) == len(jl) == len(LABELS) // 2
    for epoch in (0, 1):
        if epoch:
            got.close_mosaic(), want.close_mosaic()
        pl.set_epoch(epoch), jl.set_epoch(epoch)
        pb, jb = list(pl), list(jl)
        assert len(pb) == len(jb) == len(LABELS) // 2
        for x, y in zip(pb, jb):
            for k in ("img", "cls", "bboxes", "mask_gt"):
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"epoch {epoch} {k}")
            assert x["meta"] == y["meta"]
