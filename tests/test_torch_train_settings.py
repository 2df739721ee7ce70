"""The detect trainer's last settings against the JAX trainer's, on the CPU in f32: a one-epoch
`YOLO("yolov8n.yaml").train` on tests/test_train.py's 8-image fixture in each package with
multi_scale, cache='ram', mosaic9 and cutmix together, and another with remat and the s2d train
stem setting (YOLO_TPU_TRAIN_S2D=4: JAX's packed stem, the port's standard one); the losses and val
metrics within the tolerances of test_yolo_train_matches_jax (1e-3). Also: the TensorBoard scalars
both trainers write (the same tags and steps), the integration callbacks and the settings file both
packages share, remat's BN moments recorded once, autobatch's pick, and `batch=-1` with the
trainer's own step as autobatch's probe."""

import csv
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.data import augment as JA
from yolo_tpu_torch.data import augment as PA

from tests.test_train import tiny_dataset  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

# imgsz 64 (multi_scale's 1.5 draw: 96), the smallest side at which the fixture's targets still get assigned anchors
ONE_EPOCH = dict(epochs=1, imgsz=64, batch=4, workers=1, mosaic=0.5, close_mosaic=0, amp=False, plots=False, exist_ok=True)
RUNS = {
    # multi_scale draws 1.5 then 1.0 for the two steps (np.random.default_rng(ni)): two image sizes
    "mixers": dict(multi_scale=True, cache="ram", mosaic=1.0, cutmix=0.5),
    "memory": dict(remat=True),
}


def _rows(run_dir):
    with open(run_dir / "results.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def trained(tiny_dataset, tmp_path_factory):  # noqa: F811 (the fixture imported above)
    """name → one epoch of each package's YOLO.train with a group of settings, trained at the first
    ask: "mixers" (multi_scale, cache='ram', mosaic 1.0 with mosaic_n = 9, cutmix 0.5) or "memory"
    (remat, the s2d train stem)."""
    return functools.lru_cache(None)(functools.partial(_train_both, tiny_dataset, tmp_path_factory))


@pytest.fixture(params=list(RUNS))
def runs(request, trained):
    return trained(request.param)


def _train_both(tiny_dataset, tmp_path_factory, name):  # noqa: F811
    root = tmp_path_factory.mktemp(f"runs_{name}")
    mp = pytest.MonkeyPatch()
    if name == "mixers":
        mp.setattr(JA.TrainTransforms, "mosaic_n", 9, raising=False)
        mp.setattr(PA.TrainTransforms, "mosaic_n", 9)
    else:
        mp.setenv("YOLO_TPU_TRAIN_S2D", "4")
    kw = {**ONE_EPOCH, **RUNS[name]}
    try:
        yolo_tpu.YOLO("yolov8n.yaml").train(data=tiny_dataset, project=str(root), name="jax", **kw)
        py = yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
        py.train(data=tiny_dataset, project=str(root), name="torch", device="cpu", **kw)
    finally:
        mp.undo()
    return SimpleNamespace(name=name, root=root, trainer=py.trainer)


def test_train_settings_match_jax(runs):
    """Each epoch's box, cls and dfl loss within 1e-3 (relative; 1e-6 absolute) and each val metric within
    1e-3 of the JAX trainer's, with the settings on: the RAM cache filled, multi_scale resized."""
    got, want = _rows(runs.root / "torch"), _rows(runs.root / "jax")
    assert list(got[0]) == list(want[0]) and len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert float(g["train/box_loss"]) > 0
        for k in w:
            if k.startswith("train/"):
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3, atol=1e-6, err_msg=k)
            elif k.startswith("metrics/"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-3, k
    t = runs.trainer
    if runs.name == "mixers":
        assert t.train_loader.dataset._im_cache and t.args.multi_scale


def _scalars(tb_dir):
    """{tag: [steps]} of the event files (or the JSONL log) under a tb directory."""
    jsonl = tb_dir / "events.jsonl"
    if jsonl.exists():
        import json

        out = {}
        for line in jsonl.read_text().splitlines():
            r = json.loads(line)
            out.setdefault(r["tag"], []).append(r["step"])
        return out
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {tag: [e.step for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax(trained):
    """Both trainers attach the integration callbacks at construction: save_dir/tb holds the same scalar
    tags (metrics/precision ... metrics/fitness) at the same steps."""
    root = trained("mixers").root
    got, want = _scalars(root / "torch" / "tb"), _scalars(root / "jax" / "tb")
    assert got == want and "metrics/fitness" in got and got["metrics/fitness"] == [0]


def test_integration_callbacks_and_settings_match_jax(tmp_path, monkeypatch):
    """add_integration_callbacks attaches what the JAX package's does (here TensorBoard only: no tracker
    SDK imports, and the platform logger is off by default), and both packages read and write one
    settings file: the same defaults, a flag set by one seen by the other."""
    from yolo_tpu.utils import callbacks as JC
    from yolo_tpu.utils import settings as JSet
    from yolo_tpu_torch.utils import callbacks as PC
    from yolo_tpu_torch.utils import settings as PSet

    monkeypatch.setenv("YOLO_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.setattr(PSet, "_SETTINGS", None)
    got, want = PC.add_integration_callbacks(PC.default_callbacks()), JC.add_integration_callbacks(JC.default_callbacks())
    assert {k: [f.__name__ for f in v] for k, v in got.items()} == {k: [f.__name__ for f in v] for k, v in want.items()}
    assert [f.__name__ for f in got["on_fit_epoch_end"]] == ["on_fit_epoch_end"]
    port = PSet.get_settings()
    assert port.file == tmp_path / "cfg" / "settings.json" and port.file.exists()
    jax_side = JSet.SettingsManager(tmp_path / "cfg" / "settings.json")
    assert dict(jax_side) == dict(port)
    jax_side.update(wandb=True)
    assert PSet.SettingsManager()["wandb"] is True
    with pytest.raises(KeyError, match="unknown settings key"):
        port.update(no_such_flag=1)


def test_remat_records_bn_moments_once():
    """Under remat the backward recomputes each layer's forward; the moments the first forward kept stay
    (a recompute records none), and they, the loss and the gradients equal those of the plain walk."""
    from yolo_tpu_torch.nn import modules as M
    from yolo_tpu_torch.nn.tasks import DetectionModel, load_train_params, train_leaves

    pm = DetectionModel("yolov8n.yaml", device="cpu")
    load_train_params(pm, pm.init(0))
    pm.train()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    convs = [m for m in pm.modules() if isinstance(m, M.ConvBNAct)]
    results = []
    for remat in (False, True):
        for p in train_leaves(pm).values():
            p.grad = None
        loss = sum(o.square().mean() for o in pm.forward_features(x, remat=remat))
        kept = [m.batch_stats for m in convs]
        for m in convs:
            m.batch_stats = None
        loss.backward()
        assert all(m.batch_stats is None for m in convs)  # the recompute recorded nothing
        grads = [p.grad.clone() for p in train_leaves(pm).values() if isinstance(p, torch.nn.Parameter)]
        results.append((float(loss.detach()), kept, grads))
    (l0, k0, g0), (l1, k1, g1) = results
    assert l0 == l1 and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2] for a, b in zip(k0, k1))
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    pm.eval()


def test_autobatch_matches_jax(tiny_dataset, tmp_path, monkeypatch):  # noqa: F811
    """autobatch doubles from 8 while its probe runs, up to max_batch: with JAX's probe, an f32 predict, at imgsz
    32 both packages pick 32 of (8, 16, 32). `batch=-1` probes with the trainer's own step (forward, loss over
    the loader's label capacity, backward, at the train size) and trains at the pick (capped at 8 here, a
    short search): one step of 8."""
    from yolo_tpu.utils.profilers import autobatch as jax_autobatch
    from yolo_tpu_torch.nn.tasks import install_params
    from yolo_tpu_torch.utils import profilers as PP

    jy, py = yolo_tpu.YOLO("yolov8n.yaml"), yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
    install_params(py.model, py.params, py.model.device, torch.float32)

    def predict(b):
        with torch.no_grad():
            py.model.predict(torch.zeros((b, 32, 32, 3)))

    assert PP.autobatch(predict, "cpu", max_batch=32) == jax_autobatch(jy.model, jy.params, imgsz=32, max_batch=32) == 32
    probed = []
    real = PP.autobatch

    def capped(probe, device, **kw):
        model = py.trainer.model

        def spy(b):
            probe(b)
            probed.append((b, all(p.grad is not None for p in model.parameters() if p.requires_grad)))

        return real(spy, device, max_batch=8)

    monkeypatch.setattr(PP, "autobatch", capped)
    py.train(data=tiny_dataset, project=str(tmp_path), name="auto", device="cpu", **{**ONE_EPOCH, "batch": -1})
    assert probed == [(8, True)]
    assert py.trainer.args.batch == 8 and len(py.trainer.train_loader) == 1 and len(py.trainer.timings) == 1


def test_autobatch_stops_where_the_probe_runs_out_of_memory():
    """A probe that runs out of memory at 64 ends the search there: the pick is 32; none that runs gives
    `start`, as in the JAX package."""
    from yolo_tpu_torch.utils.profilers import autobatch

    seen = []

    def probe(b):
        seen.append(b)
        if b >= 64:
            raise torch.cuda.OutOfMemoryError("probe")

    assert autobatch(probe, "cpu") == 32 and seen == [8, 16, 32, 64]
    assert autobatch(lambda b: probe(64), "cpu") == 8
