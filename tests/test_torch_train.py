"""The port's detect training against the JAX package's, on the CPU in f32: the train-form
forward with its BN moments, every parameter's gradient, one update of AdamW and of SGD
(warmup lr, bias lr and momentum, the clip, a frozen layer, the BN running moments, the
EMA), and a 2-epoch `YOLO(yaml).train` on tests/test_train.py's 8-image fixture (per-epoch
losses and val metrics, results.csv, best.npz read across the packages both ways, resume).
Inputs come from seeded numpy generators; tolerances are stated at each comparison."""

import csv
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine.exporter import load_npz as jax_load_npz
from yolo_tpu.nn.modules import Ctx
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.utils import optim as JO
from yolo_tpu.utils.loss import v8DetectionLoss as JaxLoss
from yolo_tpu_torch.engine.exporter import load_npz
from yolo_tpu_torch.engine.trainer import DetectionTrainer
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.nn.tasks import DetectionModel, load_train_params, train_leaves, tree_from_leaves
from yolo_tpu_torch.utils.loss import v8DetectionLoss

from tests.test_loss import _random_case
from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

HYP = SimpleNamespace(box=7.5, cls=0.5, dfl=1.5)


def _bn_paths(model):
    """(JAX stats key 'model/<layer>/.../bn', ConvBNAct) of every BN of the port's model."""
    return [("/".join(["model", *name.split(".")[1:]]) + "/bn", m) for name, m in model.named_modules() if isinstance(m, PM.ConvBNAct)]


@pytest.fixture(scope="module")
def step_case():
    """yolov8n at nc = 3 from init(0), two 64x64 images and `_random_case`'s targets: the JAX
    package's train forward, loss and gradient (value_and_grad), and the port's model in the train form."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _, cls, boxes, mask, _ = _random_case(seed=0)
    batch = {"cls": cls, "bboxes": boxes, "mask_gt": mask}
    jm = JaxDetectionModel("yolov8n.yaml", nc=3)
    jp = jm.init(0)

    def forward_loss(params):
        ctx = Ctx(train=True)
        feats = jm.forward_features(params, jnp.asarray(x), ctx)
        total, comps = JaxLoss(jm, HYP)(feats, {k: jnp.asarray(v) for k, v in batch.items()})
        return total, (feats, comps, ctx.stats)

    (jt, (jfeats, jcomps, jstats)), jg = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(jp)
    pm = DetectionModel("yolov8n.yaml", nc=3, device="cpu")
    load_train_params(pm, pm.init(0))
    pm.train()
    feats = pm.forward_features(torch.from_numpy(x))
    total, comps = v8DetectionLoss(pm, HYP)(feats, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    return SimpleNamespace(jt=jt, jfeats=jfeats, jcomps=jcomps, jstats=jstats, jg=jg, pm=pm, feats=feats, total=total, comps=comps)


def test_train_forward_and_bn_moments_match_jax(step_case):
    """Each level's raw output within 1e-4 of its largest; every BN's batch mean and biased
    variance within 1e-4, with the same count, against forward_features(Ctx(train=True))."""
    c = step_case
    for j, p in zip(c.jfeats, c.feats):
        j = np.asarray(j)
        np.testing.assert_allclose(p.detach().numpy(), j, rtol=0, atol=1e-4 * np.abs(j).max())
    bns = _bn_paths(c.pm)
    assert len(bns) == len(c.jstats) == 57
    for key, m in bns:
        mean, var, n = c.jstats[key]
        assert m.batch_stats[2] == n
        np.testing.assert_allclose(m.batch_stats[0].numpy(), np.asarray(mean), rtol=0, atol=1e-4)
        np.testing.assert_allclose(m.batch_stats[1].numpy(), np.asarray(var), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(c.total.detach()), float(c.jt), rtol=1e-4)
    np.testing.assert_allclose(c.comps.numpy(), np.asarray(c.jcomps), rtol=1e-4)


def test_train_gradients_match_jax(step_case):
    """The gradient of every parameter (conv kernels, BN γ and β, head biases) within 1e-3 of
    its tensor's largest; the frozen leaves (DFL, running moments) get none in either package."""
    c = step_case
    flat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(c.jg)}
    params = {k: t for k, t in train_leaves(c.pm).items() if isinstance(t, torch.nn.Parameter)}
    assert len(params) == 57 * 3 + 6 * 2 and set(params) < set(flat)  # 57 ConvBNAct (w, γ, β), 6 head Conv2d (w, b)
    for k, t in params.items():
        want = flat[k]
        got = tree_from_leaves(c.pm, {k: t.grad})
        for part in k.split("/"):
            got = got[part]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * max(np.abs(want).max(), 1e-12), err_msg=k)
    for k in set(flat) - set(params):  # the DFL projection and the running moments
        assert not np.abs(flat[k]).any(), k


def _grads_and_stats(model, rng):
    """Seeded gradients for every leaf of the JAX tree (zero on the frozen ones, as JAX's grad gives
    them; large enough that the global-norm clip acts) and BN batch moments for every ConvBNAct."""
    grads = {k: (np.zeros if JO.is_frozen_param(k.split("/")) else lambda s: rng.normal(0, 0.05, s))(tuple(
        np.shape(v))).astype(np.float32) for k, v in _flat(tree_from_leaves(model, train_leaves(model))).items()}
    stats = {key: (rng.normal(0, 1, m.c2).astype(np.float32), rng.uniform(0.1, 2, m.c2).astype(np.float32), int(rng.integers(50, 500)))
             for key, m in _bn_paths(model)}
    return grads, stats


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("optimizer", ["AdamW", "SGD"])
def test_optimizer_update_matches_jax(optimizer):
    """Two updates of the trainer (`_update`: the optimizer with the clip at 10, layer 1 frozen and
    put back, the BN running moments, the EMA) against the JAX train step's, at warmup values of
    lr, bias lr and momentum: every parameter, running moment and EMA leaf within 1e-6 (absolute, and
    relative: the class-logit priors near -11 differ by an ulp)."""
    rng = np.random.default_rng(11)
    args = dict(model="yolov8n.yaml", device="cpu", optimizer=optimizer, weight_decay=5e-4, batch=16, freeze=[1])
    t = DetectionTrainer(overrides=args)
    t._build_state(iterations=1)
    model = t.model
    params = t.params  # the JAX package's init(0) tree, bit for bit
    jopt = JO.build_optimizer(optimizer, 5e-4 * 16 * 4 / 64)
    jstate = jopt.init(params)
    jema, updates = jax.tree_util.tree_map(jnp.asarray, params), 0.0
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    @jax.jit
    def jax_update(grads, jstate, jparams, lr, mom, lr_bias):
        """The JAX trainer's update after value_and_grad (yolo_tpu/engine/trainer.py train_step), jitted: op by op,
        each of the tree's few hundred leaf shapes compiles every primitive of the update on its own."""
        new, jstate = jopt.update(grads, jstate, jparams, lr, mom, lr_bias=lr_bias)
        return {**new, "model": {k: (jparams["model"][k] if k == "1" else v) for k, v in new["model"].items()}}, jstate

    jax_ema = jax.jit(lambda jema, jparams, d: jax.tree_util.tree_map(lambda e, p: d * e + (1 - d) * p, jema, jparams))
    for lr, mom, lr_bias in ((1e-3, 0.8, 0.09), (2e-3, 0.85, 0.05)):
        grads, stats = _grads_and_stats(model, rng)
        new, jstate = jax_update(_unflat(grads), jstate, jparams, jnp.float32(lr), jnp.float32(mom), jnp.float32(lr_bias))
        jparams = JO.apply_bn_stats(new, stats)
        updates += 1.0
        d = 0.9999 * (1 - jnp.exp(-jnp.float32(updates) / 2000.0))
        jema = jax_ema(jema, jparams, d)
        # the port's
        leaves = train_leaves(model)
        for k, p in leaves.items():
            if isinstance(p, torch.nn.Parameter):
                g = grads[k]  # a copy: the clip scales the gradient in place, and JAX may still read the array
                p.grad = torch.from_numpy((g.transpose(3, 2, 0, 1) if g.ndim == 4 else g).copy())  # HWIO → OIHW
        for key, m in _bn_paths(model):
            m.batch_stats = tuple(torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in stats[key])
        t._update(lr, mom, lr_bias)
    got, got_ema = _flat(tree_from_leaves(model, t.leaves)), _flat(tree_from_leaves(model, dict(zip(t.leaves, t.ema_list))))
    want, want_ema = _flat(jparams), _flat(jema)
    assert set(got) == set(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got_ema[k], np.asarray(want_ema[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        moved += not np.array_equal(np.asarray(want[k]), _flat(params)[k])
    assert all(np.array_equal(got[k], _flat(params)[k]) for k in got if k.startswith("model/1/") and "running" not in k)
    assert moved > 100


# --- YOLO.train end to end --------------------------------------------------------------------

# imgsz 64: the smallest side at which the 8-image fixture's targets (4-10% of a 160x128 frame) still get assigned
# anchors; 160 ran the same comparisons at six times the pixels
TINY = dict(epochs=2, imgsz=64, batch=4, workers=1, mosaic=0.5, close_mosaic=1, amp=False, plots=False, exist_ok=True)


def _rows(run_dir):
    with open(run_dir / "results.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def trained(tiny_dataset, tmp_path_factory):  # noqa: F811 (the fixture imported above)
    """YOLO("yolov8n.yaml").train for 2 epochs on the 8-image fixture (imgsz 64, batch 4, one worker,
    mosaic 0.5 closed for the last epoch, f32), in each package."""
    root = tmp_path_factory.mktemp("runs")
    jy, py = yolo_tpu.YOLO("yolov8n.yaml"), yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
    jm = jy.train(data=tiny_dataset, project=str(root), name="jax", **TINY)
    pm = py.train(data=tiny_dataset, project=str(root), name="torch", device="cpu", **TINY)
    return SimpleNamespace(root=root, jy=jy, py=py, jm=jm, pm=pm)


def test_yolo_train_matches_jax(trained):
    """results.csv has the JAX columns; each epoch's box, cls and dfl loss within 1e-3 (relative;
    1e-6 absolute) and each val metric within 1e-3 of the JAX trainer's, with foreground assigned."""
    got, want = _rows(trained.root / "torch"), _rows(trained.root / "jax")
    assert list(got[0]) == list(want[0]) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"] and float(g["lr"]) == float(w["lr"])
        assert float(g["train/box_loss"]) > 0
        for k in w:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3, atol=1e-6, err_msg=k)
            elif k.startswith("metrics/"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-3, k
    assert set(trained.pm) == set(trained.jm)
    assert trained.py.predictor is None and trained.py.model.nc == 1 and trained.py.params is trained.py.trainer.best_params


def test_checkpoints_cross_between_packages(trained):
    """best.npz of either package loads in the other: the same model config and nc, the same tree."""
    for writer, reader in (("torch", jax_load_npz), ("jax", lambda p: load_npz(p, device="cpu"))):
        path = trained.root / writer / "weights" / "best.npz"
        model, params, meta = reader(path)
        want = trained.py.params if writer == "torch" else jax.tree_util.tree_map(np.asarray, trained.jy.params)
        assert model.nc == 1 and meta["epoch"] if "epoch" in meta else model.nc == 1
        got_l, want_l = jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        for (_, a), (_, b) in zip(got_l, want_l):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in ("last.npz", "train_state/state.pt"):
        assert (trained.root / "torch" / "weights" / name).exists()
    assert (trained.root / "torch" / "args.yaml").exists()


class _Interrupted(DetectionTrainer):
    """A trainer stopped, as by Ctrl-C, once its second epoch is saved."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.callbacks["on_fit_epoch_end"].append(self._stop)

    @staticmethod
    def _stop(t):
        if t.epoch == 1:
            raise KeyboardInterrupt


def test_resume_goes_on_at_the_next_epoch(tiny_dataset, tmp_path):  # noqa: F811
    """A 3-epoch run stopped after its second epoch, then `resume`d: it goes on at epoch 2 from
    last.npz and the full train state (parameters, moments, EMA), and that epoch equals the one of an
    unbroken run (losses and metrics within 1e-6). The unbroken run also draws the plots."""
    kw = dict(TINY, epochs=3, device="cpu", project=str(tmp_path))
    yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu").train(data=tiny_dataset, name="full", **{**kw, "plots": True})
    with pytest.raises(KeyboardInterrupt):
        yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu").train(trainer=_Interrupted, data=tiny_dataset, name="rs", **kw)
    yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu").train(
        data=tiny_dataset, name="rs", resume=str(tmp_path / "rs" / "weights" / "last.npz"), **kw)
    full, resumed = _rows(tmp_path / "full"), _rows(tmp_path / "rs")
    assert [r["epoch"] for r in resumed] == ["2"]
    for k in full[2]:
        if k.startswith(("train/", "metrics/")):
            np.testing.assert_allclose(float(resumed[0][k]), float(full[2][k]), rtol=1e-6, atol=1e-6, err_msg=k)
    for name in ("labels.png", "train_batch0.jpg", "train_batch1.jpg"):
        assert (tmp_path / "full" / name).stat().st_size > 0


@pytest.mark.parametrize("kw, what", [pytest.param({"n_devices": 2}, "n_devices", id="kw2-n_devices")])
def test_unported_training_settings_raise(tiny_dataset, tmp_path, monkeypatch, kw, what):  # noqa: F811
    """Each setting that asks for something unported raises NotImplementedError naming it: the mesh
    (n_devices > 1, ROADMAP item 3) is the one left."""
    with pytest.raises(NotImplementedError, match=what):
        DetectionTrainer(overrides={"data": tiny_dataset, "device": "cpu", "project": str(tmp_path), **kw}).train()
