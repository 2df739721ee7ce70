"""RT-DETR training in the port against the JAX package's on the CPU: the host Hungarian match, DETRLoss (focal and
varifocal) and RTDETRDetectionLoss (every layer matched on its own, the denoising terms under their fixed match) with
their gradients, the denoising attention mask and noise, one train step of a narrow RT-DETR (its loss items and
gradient) and the trainer's epoch.

Tolerances, stated again at each test: match indices exact; DETRLoss's items 1e-9 relative and their gradients 1e-9
of their largest in f64 on both sides (JAX under enable_x64), RTDETRDetectionLoss's 1e-5 in f32 (JAX's casts its
inputs to f32); the cdn mask exact and its noise 1e-6 from the same numpy Generator; the narrow model's step in f64:
total and items 1e-4 relative, every leaf's gradient 1e-3 of its own largest; in f32: total and items 1e-4 relative,
the gradient's direction (leaves scaled by their largest) cosine > 0.999."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import modules as JM
from yolo_tpu.nn import tasks as JT
from yolo_tpu.nn import transformer as JTr
from yolo_tpu.utils import cdn as JC
from yolo_tpu.utils import detr_loss as JL
from yolo_tpu_torch.nn import tasks as PT
from yolo_tpu_torch.utils import cdn as PC
from yolo_tpu_torch.utils import detr_loss as PL

from tests.test_rtdetr_train import _case, _mini_rtdetr_cfg
from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)
from tests.test_torch_rtdetr import _jitter
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_hungarian_match_matches_jax(seed):
    """The host match of 20 random queries (5 classes) against 3 and 2 labels (padded to 3), and against a batch with
    an empty image: the same query for every label row and the same validity as JAX's."""
    pb, ps, gb, gc, m = _case(seed=seed)
    for mask in (m, m * np.array([[1], [0]], np.float32)):
        want = JL.hungarian_match(pb, ps, gb, gc, mask)
        got = PL.hungarian_match(pb, ps, gb, gc, mask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _t(*arrays, grad=False):
    return [torch.tensor(np.asarray(a, np.float64), requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("vfl", [False, True], ids=["focal", "varifocal"])
def test_detr_loss_and_gradient_match_jax(vfl):
    """One layer's DETRLoss (focal, or varifocal with the matched IoU as target) on random queries and JAX's match: its
    three items 1e-9 relative and their summed gradient with respect to the boxes and the logits 1e-9 of the largest,
    f64 on both sides."""
    pb, ps, gb, gc, m = _case(seed=5)
    src, val = JL.hungarian_match(pb, ps, gb, gc, m)
    with jax.enable_x64(True):
        def f(pb_, ps_):
            d = JL.DETRLoss(nc=5, use_vfl=vfl)(pb_, ps_, jnp.asarray(gb, jnp.float64), jnp.asarray(gc),
                                               jnp.asarray(m, jnp.float64), jnp.asarray(src), jnp.asarray(val, jnp.float64))
            return d["loss_class"] + d["loss_bbox"] + d["loss_giou"], d

        (_, want), (gwb, gws) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(pb, jnp.float64), jnp.asarray(ps, jnp.float64))
        want = {k: float(v) for k, v in want.items()}
    tpb, tps = _t(pb, ps, grad=True)
    tgb, tgc, tm, tval = _t(gb, gc, m, val)
    got = PL.DETRLoss(nc=5, use_vfl=vfl)(tpb, tps, tgb, tgc, tm, torch.from_numpy(src), tval)
    sum(got.values()).backward()
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-9)
    for g, w in ((tpb.grad, gwb), (tps.grad, gws)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-9 * max(np.abs(np.asarray(w)).max(), 1.0))


def _preds(rng, L=2, B=2, Nq=20, nc=5, D=0):
    """Random decoder train outputs: boxes (L, B, D + Nq, 4) in (0, 1), logits, the encoder's (B, Nq, 4) and logits."""
    boxes = rng.uniform(0.2, 0.8, (L, B, D + Nq, 4))
    boxes[..., 2:] = rng.uniform(0.05, 0.3, (L, B, D + Nq, 2))
    enc = rng.uniform(0.2, 0.8, (B, Nq, 4))
    enc[..., 2:] = rng.uniform(0.05, 0.3, (B, Nq, 2))
    return boxes, rng.normal(0, 1, (L, B, D + Nq, nc)), enc, rng.normal(0, 1, (B, Nq, nc))


@pytest.mark.parametrize("dn", [False, True], ids=["plain", "denoising"])
def test_rtdetr_loss_and_gradient_match_jax(dn):
    """RTDETRDetectionLoss of two decoder layers and the encoder's queries (20 each, nc 5) against 3 / 2 labels: the
    total and the (giou, cls, l1) items of the last layer 1e-5 relative and the gradient of the total with respect to
    every output 1e-5 of its largest, in f32 on both sides (JAX's loss casts its inputs to f32); with `dn` the
    denoising prefix (JAX's make_cdn_batch at num_dn 6: two groups) scored under the fixed match, each group's terms
    over G."""
    pb, ps, gb, gc, m = _case(seed=2)
    batch = {"cls": gc, "bboxes": gb, "mask_gt": m}
    D = 0
    if dn:
        extra = JC.make_cdn_batch(batch, 5, num_dn=6, rng=np.random.default_rng(0))
        D = extra["dn_cls"].shape[1]
        batch["dn_cls"] = extra["dn_cls"]
    preds = _preds(np.random.default_rng(1), D=D)
    model = type("M", (), {"nc": 5})()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, comps), grads = jax.value_and_grad(lambda *p: JL.RTDETRDetectionLoss(model)(p, jbatch), argnums=(0, 1, 2, 3),
                                               has_aux=True)(*(jnp.asarray(a, jnp.float32) for a in preds))
    tp = [torch.tensor(np.asarray(a, np.float32), requires_grad=True) for a in preds]
    got_total, got_comps = PL.RTDETRDetectionLoss(model)(tp, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    got_total.backward()
    np.testing.assert_allclose(float(got_total.detach()), float(total), rtol=1e-5)
    np.testing.assert_allclose(got_comps.numpy(), np.asarray(comps), rtol=1e-5)
    for g, w in zip((t.grad for t in tp), grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0))
    if dn:
        assert np.abs(tp[0].grad[:, :, :D].numpy()).max() > 0  # the denoising queries are scored


@pytest.mark.parametrize("groups,n,nq", [(1, 4, 10), (3, 8, 30), (12, 2, 300)])
def test_cdn_attn_mask_matches_jax(groups, n, nq):
    """The denoising attention mask: JAX's, bit for bit (the reference's consecutive-pair blocks included)."""
    np.testing.assert_array_equal(PC.cdn_attn_mask(groups, n, nq), JC.cdn_attn_mask(groups, n, nq))


def test_make_cdn_batch_matches_jax():
    """The denoising entries from the same seeded numpy Generator as JAX's: classes and validity equal, box logits within
    1e-6 (padded slots 0), the negative copies farther from their labels than the positive ones."""
    rng = np.random.default_rng(0)
    batch = {"cls": rng.integers(0, 5, (2, 8)).astype(np.float32), "bboxes": (rng.random((2, 8, 4)) * 0.3 + 0.35).astype(np.float32),
             "mask_gt": np.ones((2, 8), np.float32)}
    batch["mask_gt"][0, 5:] = 0
    want = JC.make_cdn_batch(batch, 5, num_dn=24, rng=np.random.default_rng(1))
    got = PC.make_cdn_batch(batch, 5, np.random.default_rng(1), num_dn=24)
    assert got["dn_num_group"] == want["dn_num_group"] == 3
    np.testing.assert_array_equal(got["dn_cls"], want["dn_cls"])
    np.testing.assert_array_equal(got["dn_valid"], want["dn_valid"])
    np.testing.assert_allclose(got["dn_bbox"], want["dn_bbox"], rtol=0, atol=1e-6)
    G, N = 3, 8
    dev = np.abs(1 / (1 + np.exp(-got["dn_bbox"])) - np.tile(batch["bboxes"], (1, 2 * G, 1)))[..., :2]
    assert dev[:, G * N :].mean() > dev[:, : G * N].mean() and (got["dn_bbox"][0, 5:8] == 0).all()


class _WideJnp(types.ModuleType):
    """`jax.numpy` with `float32` read as `float64`: set as the `jnp` of JAX's modules, it widens the casts that pin
    f32 (the transformer's products and norms, the BN moments, the loss's inputs) for a true f64 step."""

    def __init__(self):
        super().__init__("jax.numpy")

    def __getattr__(self, key):
        return jnp.float64 if key == "float32" else getattr(jnp, key)


def test_narrow_train_step_matches_jax(two_threads, monkeypatch):
    """One train step of a narrow RT-DETR (JAX's test model: five stride-2 convs, the decoder at hd 64, nq 32, two
    layers, nc 3) from init(0) with the decoder's weights moved by N(0, 0.05) (so that its zero-initialised box layers
    pass a gradient to the layers before them) on two seeded 64² images and four labels each, with JAX's denoising entries (num_dn 8)
    handed to both packages: JAX's value_and_grad against the port's train forward and backward. In f64 on both sides
    (JAX's modules read a `jnp` whose float32 is float64; the port's `.float()` leaves an f64 tensor as it is): the
    total and its (giou, cls, l1) items 1e-4 relative, the port's trained leaves exactly JAX's (every leaf but the BN
    running moments), none without a gradient, and every leaf's gradient within 1e-3 of its own largest (at least
    1e-9), and each of JAX's nonzero (the denoising class embedding's included). In f32: the total and items 1e-4 relative and the
    gradient's direction (each leaf scaled by its largest, cosine > 0.999)."""
    rng = np.random.default_rng(0)
    B, N = 2, 4
    batch = {"cls": rng.integers(0, 3, (B, N)).astype(np.float32), "bboxes": (rng.random((B, N, 4)) * 0.3 + 0.3).astype(np.float32),
             "mask_gt": np.ones((B, N), np.float32)}
    img = rng.integers(0, 255, (B, 64, 64, 3)).astype(np.uint8)
    dn = JC.make_cdn_batch(batch, 3, num_dn=8, rng=rng)
    G = dn["dn_num_group"]
    batch.update({k: dn[k] for k in ("dn_cls", "dn_bbox", "dn_valid")})
    cfg = _mini_rtdetr_cfg(nc=3)
    jm = JT.RTDETRDetectionModel(dict(cfg))
    tree = jax.tree_util.tree_map(np.asarray, jm.init(0))
    tree["model"]["5"] = _jitter(tree["model"]["5"], np.random.default_rng(1), 0.05)  # the zero-initialised box layers
    mask = JC.cdn_attn_mask(G, N, jm.head.nq)

    def jax_step(dtype):
        def fl(params):
            ctx = JM.Ctx(train=True, dtype=dtype)
            ctx.dn = {k: jnp.asarray(batch[k]) for k in ("dn_cls", "dn_bbox", "dn_valid")} | {"attn_mask": mask}
            feats = jm.forward_features(params, jnp.asarray(img, dtype) / 255.0, ctx)
            return JL.RTDETRDetectionLoss(jm)(feats, {k: jnp.asarray(v) for k, v in batch.items()})

        p = jax.tree.map(lambda a: np.asarray(a, dtype), tree)
        (jt, jcomps), jg = jax.jit(jax.value_and_grad(fl, has_aux=True))(p)
        flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(jg)}
        return float(jt), np.asarray(jcomps), flat

    def port_step(dtype):
        pm = PT.RTDETRDetectionModel(dict(cfg), device="cpu").to(dtype)
        PT.load_train_params(pm, tree)
        pm.train()
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        pdn = {k: tb[k] for k in ("dn_cls", "dn_bbox", "dn_valid")} | {"attn_mask": torch.from_numpy(mask)}
        feats = pm.forward_features(torch.from_numpy(img).to(dtype) / 255.0, dn=pdn)
        total, comps = PL.RTDETRDetectionLoss(pm)(feats, tb)
        total.backward()
        params = {k: t for k, t in PT.train_leaves(pm).items() if isinstance(t, torch.nn.Parameter)}
        grads = {}
        for k, t in params.items():
            assert t.grad is not None, f"{k}: no gradient"
            g = PT.tree_from_leaves(pm, {k: t.grad})
            for part in k.split("/"):
                g = g[part]
            grads[k] = np.asarray(g)
        return float(total.detach()), comps.detach().numpy(), grads

    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (JM, JT, JTr):
            mp.setattr(mod, "jnp", _WideJnp())
        mp.setattr(jax, "numpy", _WideJnp())  # the loss imports jax.numpy inside its calls
        callback = jax.pure_callback  # the host match's validity (0 / 1) stays declared f32, as its thread returns it
        mp.setattr(jax, "pure_callback", lambda fn, shapes, *a, **k: callback(fn, tuple(
            jax.ShapeDtypeStruct(s.shape, np.float32 if s.dtype == np.float64 else s.dtype) for s in shapes), *a, **k))
        narrow = torch.Tensor.float
        mp.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64 else narrow(t, *a, **k))
        jt, jcomps, flat = jax_step(np.float64)
        total, comps, grads = port_step(torch.float64)
    assert all(v.dtype == np.float64 for v in flat.values()) and all(v.dtype == np.float64 for v in grads.values())
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    trained = {k for k in flat if not k.endswith(("running_mean", "running_var"))}
    assert set(grads) == trained, (sorted(set(grads) ^ trained))[:10]
    for k in sorted(grads):
        np.testing.assert_allclose(grads[k], flat[k], rtol=0, atol=max(1e-3 * np.abs(flat[k]).max(), 1e-9), err_msg=k)
    for k in set(flat) - trained:
        assert not np.abs(flat[k]).any(), k
    assert all(np.abs(flat[k]).any() for k in trained)  # every leaf carries a gradient: none is held trivially

    jt, jcomps, flat = jax_step(np.float32)
    total, comps, grads = port_step(torch.float32)
    np.testing.assert_allclose(total, jt, rtol=1e-4)
    np.testing.assert_allclose(comps, jcomps, rtol=1e-4)
    scale = {k: max(np.abs(flat[k]).max(), 1e-9) for k in grads}
    g = np.concatenate([np.ravel(grads[k]) / scale[k] for k in sorted(grads)])
    w = np.concatenate([np.ravel(flat[k]) / scale[k] for k in sorted(grads)])
    assert float(g @ w / np.linalg.norm(g) / np.linalg.norm(w)) > 0.999


def test_trainer_epoch(tiny_dataset, tmp_path, two_threads):
    """The port's trainer on the narrow RT-DETR (one epoch of the 8-image fixture at 160², batch 4, f32): the loss items
    named giou / cls / l1 (results.csv), finite; the host match timed; the epoch's validation by RTDETRValidator; its
    best.npz loads as an RTDETRDetectionModel; two runs with one seed draw the same denoising noise (equal trees)."""
    import csv

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.engine.trainer import DetectionTrainer

    trees = []
    for run in ("a", "b"):
        m = PT.RTDETRDetectionModel(_mini_rtdetr_cfg(nc=1), device="cpu")
        tr = DetectionTrainer(overrides=dict(data=tiny_dataset, epochs=1, imgsz=160, batch=4, workers=1, amp=False, plots=False,
                                             mosaic=0.0, project=str(tmp_path), name=run, device="cpu", seed=0), model=m, params=m.init(0))
        metrics = tr.train()
        trees.append(tr.params)
    assert set(metrics) >= {"precision", "recall", "mAP50", "mAP50-95", "fitness"}
    assert tr.loss_fn.match_s > 0
    rows = list(csv.DictReader(open(tmp_path / "b" / "results.csv")))
    items = [float(rows[0][f"train/{k}_loss"]) for k in ("giou", "cls", "l1")]
    assert all(np.isfinite(items)) and all(v > 0 for v in items)
    y = YOLO(str(tmp_path / "b" / "weights" / "best.npz"), device="cpu")
    assert type(y.model) is PT.RTDETRDetectionModel
    for k, v in jax.tree_util.tree_leaves_with_path(trees[0]):
        node = trees[1]
        for p in k:
            node = node[p.key]
        np.testing.assert_array_equal(node, v)
