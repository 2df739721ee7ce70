"""The classify task of the port (yolov8-cls) against the JAX package's on the CPU: the Classify head
and ClassificationModel, `YOLO("yolov8n-cls.yaml")`'s initial tree, the task routing, `rand_augment`,
ClassificationDataset's batches, a 2-epoch `YOLO.train`, `val`, `predict`'s Results and the
checkpoints. Inputs come from seeded numpy generators; the JAX side runs as its own tests run it.

Tolerances: the initial tree, rand_augment and the dataset's uint8 batches exact; f32 logits and
probabilities 1e-5 (the port folds BN into the conv, JAX runs it after); top-1 / top-5 and the
metrics equal; the trained tree as the comment at `test_classify_train_matches_jax` says."""

import json

import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.data.augment import rand_augment as jax_rand_augment
from yolo_tpu.engine import classify as JC
from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu_torch.data.augment import rand_augment
from yolo_tpu_torch.engine import classify as PC
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.nn.torch_export import flatten_tree

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)

SHAPES = ("bright_circle", "dark_square")
TOY = dict(epochs=2, imgsz=64, batch=8, lr0=1e-4, amp=False, dropout=0.0, exist_ok=True, verbose=False,
           auto_augment="", erasing=0.0, fliplr=0.0)


@pytest.fixture(scope="module")
def cls_dataset(tmp_path_factory):
    """tests/test_classify.py's toy set: 8 dark squares and 8 bright circles, 64x64, under train/."""
    import cv2

    root = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(0)
    for cname in SHAPES[::-1]:
        d = root / "train" / cname
        d.mkdir(parents=True)
        for i in range(8):
            img = rng.normal(120, 10, (64, 64, 3)).clip(0, 255).astype(np.uint8)
            if cname == "dark_square":
                cv2.rectangle(img, (16, 16), (48, 48), (10, 10, 10), -1)
            else:
                cv2.circle(img, (32, 32), 16, (250, 250, 250), -1)
            cv2.imwrite(str(d / f"{i}.png"), img)
    return root


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _record_epochs(monkeypatch, trainer_cls):
    """Each epoch's validation metrics of `trainer_cls.validate`, as a list that fills during train."""
    seen, orig = [], trainer_cls.validate

    def validate(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append((float(out["top1"]), float(out["top5"])))
        return out

    monkeypatch.setattr(trainer_cls, "validate", validate)
    return seen


@pytest.fixture(scope="module")
def trained(cls_dataset, tmp_path_factory):
    """YOLO("yolov8n-cls.yaml").train(TOY) in each package from np.random.seed(0), f32, no dropout and
    no augmentation, recording each epoch's validation."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as the `two_threads` fixture: a thread per core in each parallel worker crawls
    try:
        with pytest.MonkeyPatch.context() as mp:
            for pkg, make, trainer_cls in (("jax", lambda: yolo_tpu.YOLO("yolov8n-cls.yaml", task="classify"), JC.ClassificationTrainer),
                                           ("torch", lambda: yolo_tpu_torch.YOLO("yolov8n-cls.yaml", device="cpu"), PC.ClassificationTrainer)):
                epochs = _record_epochs(mp, trainer_cls)
                np.random.seed(0)
                y = make()
                metrics = y.train(data=str(cls_dataset), project=str(root), name=pkg, **TOY)
                out[pkg] = (y, metrics, epochs)
    finally:
        torch.set_num_threads(threads)
    out["root"] = root
    return out


def test_classify_head_and_model_match_jax(two_threads):
    """The Classify head alone (fused conv, mean, f32 linear) and yolov8n-cls at nc 5: logits and
    probabilities within 1e-5 of JAX's on its unfused tree, at batch 2, 64x64."""
    rng = np.random.default_rng(0)
    jh, ph = JM.Classify(32, 7), PM.Classify(32, 7)
    p = jh.init(np.random.default_rng(1))
    x = rng.uniform(-1, 1, (2, 8, 8, 32)).astype(np.float32)
    want = np.asarray(jh(p, x, JM.Ctx(train=False)))
    ph.load_jax(PT.fuse(p), "cpu", torch.float32)
    np.testing.assert_allclose(ph(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-5)

    jm, pm = JT.ClassificationModel("yolov8n-cls.yaml", nc=5), PT.ClassificationModel("yolov8n-cls.yaml", nc=5, device="cpu")
    params = jm.init(0)
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.predict(params, imgs))
    got = PT.params_from_jax(pm, params).predict(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 5) and got.dtype == np.float32 and pm.stride == [1] and pm.task == "classify"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_yolo_cls_yaml_matches_jax_init_and_routing():
    """YOLO("yolov8n-cls.yaml") holds JAX's initial tree bit for bit (scale n, nc 1000, 1280-wide head);
    the task comes from the name or `task=`; -seg, -pose and -obb build a segment, a pose and an obb
    model since those tasks were ported, an RT-DETR head names itself, a ResNet backbone names its
    module; guess_model_task and model_class_for follow JAX's."""
    py, jy = yolo_tpu_torch.YOLO("yolov8n-cls.yaml", device="cpu"), yolo_tpu.YOLO("yolov8n-cls.yaml")
    got, want = _flat(py.params), _flat(jy.params)
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert want["model.9.linear.weight"].shape == (1280, 1000)
    assert py.task == jy.task == "classify" and py.info(verbose=False) == jy.info(verbose=False)
    assert yolo_tpu_torch.YOLO("yolov8n-cls.yaml", task="classify", device="cpu").overrides == {"model": "yolov8n-cls.yaml", "task": "classify"}
    assert yolo_tpu_torch.YOLO("yolov8n-obb.yaml", device="cpu").task == "obb"
    assert yolo_tpu_torch.YOLO("yolov8n-seg.yaml", device="cpu").task == "segment"
    assert yolo_tpu_torch.YOLO("yolov8n-pose.yaml", device="cpu").task == "pose"
    with pytest.raises(NotImplementedError, match="ResNetLayer"):
        yolo_tpu_torch.YOLO("yolov8n-cls-resnet50.yaml", device="cpu")
    for cfg in ("yolov8n-cls.yaml", "yolov8n.yaml", "yolov8n-seg.yaml", "yolov8n-pose.yaml", "yolov8n-obb.yaml"):
        d = JT.yaml_model_load(cfg)
        assert PT.guess_model_task(d) == JT.guess_model_task(d)
    assert PT.model_class_for(JT.yaml_model_load("yolov8n-cls.yaml")) is PT.ClassificationModel
    assert PT.model_class_for(JT.yaml_model_load("yolov8n.yaml")) is PT.DetectionModel
    assert PT.model_class_for(JT.yaml_model_load("yolov8n-seg.yaml")) is PT.SegmentationModel
    assert PT.model_class_for(JT.yaml_model_load("yolov8n-pose.yaml")) is PT.PoseModel
    assert PT.model_class_for(JT.yaml_model_load("yolov8n-obb.yaml")) is PT.OBBModel
    with pytest.raises(NotImplementedError, match="RTDETRDecoder"):
        PT.model_class_for(JT.yaml_model_load("rtdetr-l.yaml"))


@pytest.mark.parametrize("k", range(8))
def test_rand_augment_matches_jax(k):
    """The same uint8 image under np.random.seed(k): two ops of twelve, signs and magnitudes drawn alike."""
    img = np.random.default_rng(100 + k).integers(0, 255, (48, 40, 3), np.uint8)
    np.random.seed(k)
    want = jax_rand_augment(img.copy())
    np.random.seed(k)
    got = rand_augment(img.copy())
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_dataset_batches_match_jax(cls_dataset):
    """ClassificationDataset with RandAugment, flips and erasing on numpy's global RNG: the same
    uint8 batches and labels from the same seed; validation's padded tail labelled -1."""
    kw = dict(imgsz=40, augment=True, fliplr=0.5, erasing=0.4, auto_augment="randaugment")
    jd, pd = JC.ClassificationDataset(cls_dataset / "train", **kw), PC.ClassificationDataset(cls_dataset / "train", **kw)
    assert pd.names == jd.names and pd.samples == jd.samples
    for epoch in (0, 1):
        np.random.seed(epoch)
        want = list(jd.batches(6, seed=3, epoch=epoch))
        np.random.seed(epoch)
        got = list(pd.batches(6, seed=3, epoch=epoch))
        assert len(got) == len(want) == 2
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    jv, pv = JC.ClassificationDataset(cls_dataset / "train", imgsz=40), PC.ClassificationDataset(cls_dataset / "train", imgsz=40)
    got, want = list(pv.batches(6, shuffle=False, drop_last=False)), list(jv.batches(6, shuffle=False, drop_last=False))
    assert [g[1].tolist() for g in got] == [w[1].tolist() for w in want] and got[-1][1].tolist()[-2:] == [-1, -1]
    for (gi, _), (wi, _) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)


def test_classify_train_matches_jax(trained):
    """A 2-epoch f32 train on the toy set: each epoch's top1 / top5 and the final metrics equal to the
    JAX trainer's; the last tree within the relative bound `test_yolo_train_matches_jax` holds the
    losses to (rtol 1e-3, atol 1e-6) in at least 99.9% of its values. The rest may differ by up to
    2 lr a step: AdamW moves a weight whose gradient is zero up to float noise by about ±lr, its sign
    set by that noise, so a few weights go their own way in each package (measured on this set: 44 of
    1,447,666 values, at most 1.95e-4 apart; at lr0 1e-3 it was 14,013)."""
    jy, jm, jepochs = trained["jax"]
    py, pm, pepochs = trained["torch"]
    assert len(pepochs) == len(jepochs) == TOY["epochs"] and pepochs == jepochs
    assert set(pm) == set(jm) == {"top1", "top5", "fitness"} and all(float(pm[k]) == float(jm[k]) for k in jm)
    got, want = _flat(py.trainer.params), _flat(jy.trainer.params)
    assert sorted(got) == sorted(want)
    steps = TOY["epochs"] * (16 // TOY["batch"])
    off = total = 0
    for k, w in want.items():
        g = got[k]
        off += int((np.abs(g - w) > 1e-6 + 1e-3 * np.abs(w)).sum())
        total += w.size
        assert np.abs(g - w).max() <= 2 * TOY["lr0"] * steps + 1e-6, k
    assert off <= 1e-3 * total, (off, total)
    assert py.model.nc == 2 and py.model.names == {0: "bright_circle", 1: "dark_square"} and py.predictor is None
    assert py.params is py.trainer.best_params
    assert (trained["root"] / "torch" / "weights" / "best.npz").exists() and (trained["root"] / "torch" / "args.yaml").exists()


def test_classify_val_predict_and_checkpoints_match_jax(trained, cls_dataset, tmp_path, two_threads):
    """The JAX-trained best.npz in both packages: `val` metrics equal; `predict` (imgsz 64, f32, a square
    resize, no NMS) Results with probs: top1 / top5 equal, data 1e-5, and verbose(), summary() and the
    save_txt lines equal; the plot draws. A .pt export of the port reads back in JAX as the same tree."""
    best = str(trained["root"] / "jax" / "weights" / "best.npz")
    jy, py = yolo_tpu.YOLO(best), yolo_tpu_torch.YOLO(best, device="cpu")
    assert py.task == jy.task == "classify" and type(py.model) is PT.ClassificationModel and py.names == jy.names
    assert py.val(data=str(cls_dataset), imgsz=64, batch=8) == jy.val(data=str(cls_dataset), imgsz=64, batch=8)

    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 255, (70, 90, 3), np.uint8), np.full((64, 80, 3), 120, np.uint8)]
    imgs[1][20:44, 28:52] = 10
    kw = dict(imgsz=64, compute_dtype="float32", verbose=False)
    got, want = py.predict(imgs, **kw), jy.predict(imgs, **kw)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g.boxes) == 0 and g.probs.data.shape == (2,)
        assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
        np.testing.assert_allclose(g.probs.data, w.probs.data, rtol=0, atol=1e-5)
        assert abs(g.probs.top1conf - w.probs.top1conf) <= 1e-5 and g.probs.cpu().numpy() is g.probs
        assert g.verbose() == w.verbose() and g.summary() == w.summary() and g.to_json() == json.dumps(w.summary(), indent=2)
        g.save_txt(tmp_path / f"torch{i}.txt")
        w.save_txt(tmp_path / f"jax{i}.txt")
        assert (tmp_path / f"torch{i}.txt").read_text() == (tmp_path / f"jax{i}.txt").read_text() != ""
        np.testing.assert_array_equal(g.plot(), w.plot())  # the top-5 block

    pt = py.export(format="pt")
    try:
        from yolo_tpu.nn.torch_import import load_pt

        jm, jp, _ = load_pt(pt)
        assert type(jm).__name__ == "ClassificationModel"
        back, orig = _flat(jp), _flat(py.params)
        assert sorted(back) == sorted(orig) and all(np.array_equal(back[k], orig[k]) for k in orig)
        assert yolo_tpu_torch.YOLO(str(pt), device="cpu").task == "classify"
    finally:
        pt.unlink()


def test_classify_dropout_keeps_its_rate_and_scale():
    """Dropout on the pooled features in training only: each kept feature is the pooled value / (1 - rate)
    and the rest 0, the kept share within 5 sigma of 1 - rate; a rate of 0 and eval mode change nothing.
    (JAX draws its mask with jax.random, which torch cannot reproduce; the rate and scale are what the
    two share.) The linear layer is the identity here, so the logits are the features."""
    head = PM.Classify(16, PM.Classify.c_)
    with torch.no_grad():
        head.conv.conv_weight.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
        head.linear_weight.copy_(torch.eye(PM.Classify.c_))
        head.linear_bias.zero_()
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (16, 4, 4, 16)).astype(np.float32))
    head.train()
    with torch.no_grad():
        pooled = head.conv.forward_train(x).mean(dim=(1, 2))
        assert torch.equal(head.forward_train(x), pooled)
        rate = 0.25
        head.drop = (rate, torch.Generator().manual_seed(7))
        out = head.forward_train(x)
        kept = out != 0
        assert bool((pooled != 0).all())
        np.testing.assert_allclose(out[kept].numpy(), (pooled[kept] / (1 - rate)).numpy(), rtol=1e-6, atol=0)
        share, n = float(kept.float().mean()), kept.numel()
        assert abs(share - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n), share
        head.drop = (rate, torch.Generator().manual_seed(7))
        assert torch.equal(head.forward_train(x), out)  # the generator's seed fixes the mask
        head.drop = (0.0, torch.Generator().manual_seed(7))
        assert torch.equal(head.forward_train(x), pooled)
        head.drop = (rate, torch.Generator().manual_seed(8))
        head.eval()
        assert torch.equal(head.forward_train(x), head.forward_train(x))
