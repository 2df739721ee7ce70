"""`YOLO.benchmark` (utils/benchmarks.py) and `YOLO.tune` (engine/tuner.py) of the port against the
JAX package's on the CPU: the rows' keys, formats and order; the mutation draw for draw under a
fixed clock; a tuning run's CSV columns, iteration-0 and iteration-1 hyperparameters and the files
it writes. Timings are the CPU's and are only checked to be positive numbers.

JAX's trainings cost a compile each (55 s for two tune iterations here), so the JAX tuner runs with
its `YOLO.train` replaced by one that returns a fixed fitness: its CSV, its mutation and its files
do not depend on the training. The port's tuner trains for real."""

import csv
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine import tuner as JTN
from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.utils import benchmarks as JB
from yolo_tpu_torch.engine import tuner as PTN
from yolo_tpu_torch.nn.tasks import DetectionModel
from yolo_tpu_torch.utils import benchmarks as PB

from tests.test_torch_grayscale import two_threads  # noqa: F401 (a fixture)
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

TINY = {  # tests/test_profilers.py's per-layer model: a compile JAX makes in seconds
    "nc": 1, "scale": "n",
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "C2f", [32, True]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "SPPF", [64, 5]]],
    "head": [[[2, 4], 1, "Detect", ["nc"]]],
}
ROW_KEYS = ["batch", "dtype", "latency_ms", "std_ms", "fps"]
FORMAT_KEYS = ["format", "status", "size_MB", "latency_ms", "fps"]


def _untimed(fn, args, **kw):
    """JAX's `_time_fn` without its compile and runs: the rows' structure is what is compared."""
    return 1e-3, 0.0


def test_profile_model_rows_match_jax(monkeypatch, two_threads):
    """profile_model at imgsz 64, batches (1, 2), both dtypes, 2 runs: JAX's row keys in its order
    (dtype outer, batch inner), positive latencies and fps = batch / latency."""
    monkeypatch.setattr(JB, "_time_fn", _untimed)
    jm = JaxDetectionModel(dict(TINY))
    pm = DetectionModel(dict(TINY), device="cpu")
    kw = dict(imgsz=64, batches=(1, 2), dtypes=("bfloat16", "float32"), n_runs=2)
    want = JB.profile_model(jm, jm.init(0), **kw)
    got = PB.profile_model(pm, pm.init(0), **kw)
    assert [list(r) for r in got] == [list(r) for r in want] == [ROW_KEYS] * 4
    assert [(r["batch"], r["dtype"]) for r in got] == [(r["batch"], r["dtype"]) for r in want]
    for r in got:
        assert r["latency_ms"] > 0 and r["std_ms"] >= 0 and r["fps"] > 0
        assert abs(r["fps"] - r["batch"] / (r["latency_ms"] / 1e3)) <= 0.01 * r["fps"] + 0.1


def test_benchmark_formats_rows_match_jax(tmp_path, monkeypatch, two_threads):
    """benchmark_formats at imgsz 64, batch 1: JAX's formats in its order with its keys (JAX exports and
    reloads each, untimed); the port's native-jit and npz rows time its model, orbax and stablehlo (not
    ported) read the JAX package's broken-exporter row."""
    monkeypatch.setattr(JB, "_time_fn", _untimed)
    jm, pm = JaxDetectionModel(dict(TINY)), DetectionModel(dict(TINY), device="cpu")
    want = JB.benchmark_formats(jm, jm.init(0), imgsz=64, workdir=tmp_path / "jax")
    got = PB.benchmark_formats(pm, pm.init(0), imgsz=64, workdir=tmp_path / "torch")
    assert [r["format"] for r in got] == [r["format"] for r in want] == ["native-jit", "npz", "orbax", "stablehlo"]
    assert [list(r) for r in got] == [list(r) for r in want] == [FORMAT_KEYS] * 4
    assert [r["status"] for r in want] == ["✅"] * 4
    assert [r["status"] for r in got] == ["✅", "✅", "❌ NotImplementedError", "❌ NotImplementedError"]
    assert got[1]["size_MB"] == want[1]["size_MB"] and got[0]["fps"] > 0 and got[1]["fps"] > 0
    assert [(r["size_MB"], r["latency_ms"], r["fps"]) for r in got[2:]] == [(0, 0, 0)] * 2


def test_yolo_benchmark_facade(monkeypatch):
    """YOLO(...).benchmark(imgsz) profiles the YOLO's own model and tree at batch 1, 8 and 32 in bf16
    (`half=False`: f32) and returns profile_model's rows, as JAX's facade does (profile_model itself is
    held above; here a stub records what it is asked)."""
    asked = []

    def stub(model, params, imgsz, dtypes):
        asked.append((model, params, imgsz, dtypes))
        return [{"batch": b, "dtype": dtypes[0], "latency_ms": 1.0, "std_ms": 0.0, "fps": b * 1e3} for b in (1, 8, 32)]

    monkeypatch.setattr(PB, "profile_model", stub)
    y = yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
    rows = y.benchmark(imgsz=32)
    assert rows[-1]["batch"] == 32 and y.benchmark(imgsz=48, half=False)[0]["dtype"] == "float32"
    assert asked == [(y.model, y.params, 32, ("bfloat16",)), (y.model, y.params, 48, ("float32",))]


@pytest.mark.parametrize("now", [1_700_000_000.0, 1_712_345_678.901, 1_800_000_000.5])
def test_tuner_mutate_matches_jax(monkeypatch, tmp_path, now):
    """_mutate of the default settings and of a mutated parent under one clock: equal dicts (the same
    default_rng seed, draw order, clipping and rounding)."""
    clock = SimpleNamespace(time=lambda: now)
    monkeypatch.setattr(JTN, "time", clock)
    monkeypatch.setattr(PTN, "time", clock)
    jt = JTN.Tuner(args={"project": str(tmp_path / "j")})
    pt = PTN.Tuner(args={"project": str(tmp_path / "p")})
    assert pt.space == jt.space and list(pt.space) == list(jt.space)
    base = {k: getattr(jt.args, k) for k in jt.space}
    assert base == {k: getattr(pt.args, k) for k in pt.space}
    got, want = pt._mutate(base), jt._mutate(base)
    assert got == want and got != base
    assert pt._mutate(got, mutation=0.3, sigma=0.5) == jt._mutate(want, mutation=0.3, sigma=0.5)


@pytest.fixture(scope="module")
def micro_dataset(tmp_path_factory):
    """tests/test_nas.py's 4-image set (64x64, one box each), train and val the same images."""
    import cv2

    root = tmp_path_factory.mktemp("ds")
    for split in ("images", "labels"):
        (root / split / "train").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(root / "images" / "train" / f"{i}.jpg"), rng.integers(0, 255, (64, 64, 3), np.uint8))
        (root / "labels" / "train" / f"{i}.txt").write_text("0 0.5 0.5 0.3 0.3\n")
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images/train\nval: images/train\nnames:\n  0: t\n")
    return data


def _csv(path: Path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_yolo_tune_matches_jax(micro_dataset, tmp_path, monkeypatch, two_threads):
    """YOLO("yolov8n.yaml").tune(iterations=2, epochs=1, imgsz=64) on the 4-image set under one clock:
    the same tune_results.csv columns, iteration-0 hyperparameters (the settings as given) and
    iteration-1 hyperparameters (the mutation of the best) as the JAX tuner's; a finite fitness per
    iteration; best_hyperparameters.yaml and best.npz written; a searched key passed to tune is
    dropped. The port trains each iteration on the CPU; JAX's `train` returns fitness 0.25."""
    clock = SimpleNamespace(time=lambda: 1_700_000_123.456)
    monkeypatch.setattr(JTN, "time", clock)
    monkeypatch.setattr(PTN, "time", clock)
    calls = []

    def fake_train(self, **kw):
        calls.append(kw)
        return {"fitness": 0.25}

    monkeypatch.setattr(yolo_tpu.YOLO, "train", fake_train)
    kw = dict(iterations=2, data=str(micro_dataset), epochs=1, imgsz=64, batch=2, workers=0, plots=False, val=True, mosaic=0.5,
              amp=False)
    want = yolo_tpu.YOLO("yolov8n.yaml").tune(project=str(tmp_path / "jax"), **kw)
    got = yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu").tune(project=str(tmp_path / "torch"), **kw)
    jrows, prows = _csv(tmp_path / "jax" / "tune" / "tune_results.csv"), _csv(tmp_path / "torch" / "tune" / "tune_results.csv")
    assert list(prows[0]) == list(jrows[0]) == ["iteration", "fitness", *JTN.DEFAULT_SPACE]
    assert [r["iteration"] for r in prows] == ["0", "1"] and float(prows[0]["mosaic"]) == 0.5
    assert [c["mosaic"] for c in calls] == [float(r["mosaic"]) for r in jrows]  # the search's value, not the fixed one
    for p, j in zip(prows, jrows):
        assert {k: float(v) for k, v in p.items() if k in JTN.DEFAULT_SPACE} == {k: float(v) for k, v in j.items() if k in JTN.DEFAULT_SPACE}
        assert np.isfinite(float(p["fitness"]))
    assert set(got) == set(want) == {"best_fitness", "best_hyperparameters", "best_iteration"}
    best = yaml.safe_load((tmp_path / "torch" / "tune" / "best_hyperparameters.yaml").read_text())
    assert best == got["best_hyperparameters"] and list(best) == list(JTN.DEFAULT_SPACE)
    assert (tmp_path / "torch" / "tune" / "best.npz").exists()
    assert (tmp_path / "torch" / "tune" / f"iter{got['best_iteration']}" / "weights" / "best.npz").exists()


def test_ray_tune_needs_ray(monkeypatch):
    """Without ray, `tune(use_ray=True)` raises the JAX package's ModuleNotFoundError text."""
    import sys

    monkeypatch.setitem(sys.modules, "ray", None)  # `import ray` raises ImportError
    with pytest.raises(ModuleNotFoundError, match="Ray Tune required"):
        yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu").tune(use_ray=True, iterations=1)
