"""Benchmark helpers (counterpart of yolo_tpu/utils/benchmarks.py): `YOLO.benchmark`'s
latency / throughput table and the export-format matrix.

    rows = YOLO("best.npz").benchmark(imgsz=640)              # bf16 rows at batch 1, 8, 32
    rows = YOLO("best.npz").benchmark(imgsz=640, half=False)  # f32 rows
    rows = profile_model(model, params, imgsz=640, batches=(1, 8), dtypes=("float32",))
    rows = benchmark_formats(model, params, imgsz=640)        # native-jit, npz, orbax, stablehlo

Each timing is the model's `predict` on a uint8 zero batch cast to the compute
dtype and divided by 255, on the model's device (the card unless the model was
built on the CPU), ended by `torch.cuda.synchronize` there: two warm-up calls,
then the runs, their mean and spread after a 2-sigma clip, as the JAX package
times its jitted program. For a detect model that is the decoded forward
through the kernels, without NMS; for a classify model the probabilities.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yolo_tpu_torch.nn.tasks import install_params
from yolo_tpu_torch.utils import LOGGER

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _block(out) -> None:
    """Wait for the device that computed `out` (a tensor or a tuple of them)."""
    t = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _time_fn(fn, args, n_warmup: int = 2, n_runs: int = 10, sigma_clip: float = 2.0):
    """(mean, std) seconds of `fn(*args)` over `n_runs` calls after `n_warmup`, each waited for,
    the runs farther than `sigma_clip` standard deviations from the mean left out."""
    for _ in range(n_warmup):
        _block(fn(*args))
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    t = np.array(times)
    mu, sd = t.mean(), t.std()
    keep = t[np.abs(t - mu) <= sigma_clip * sd] if sd > 0 else t
    return float(keep.mean()), float(keep.std())


def _predict_fn(model, params, dtype: torch.dtype):
    """`model.predict` of a uint8 NHWC batch in `dtype`, with `params` installed on the model's device."""
    install_params(model, params, model.device, dtype)

    def fn(x):
        return model.predict(x.to(dtype) / 255.0)

    return fn


def profile_model(model, params, imgsz=(640, 640), batches=(1, 8, 32), dtypes=("bfloat16", "float32"), n_runs: int = 10):
    """Latency / throughput rows {batch, dtype, latency_ms, std_ms, fps} over dtype x batch."""
    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    rows = []
    for dtype_name in dtypes:
        for b in batches:
            fn = _predict_fn(model, params, DTYPES[dtype_name])
            x = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=model.device)
            mean_t, std_t = _time_fn(fn, (x,), n_runs=n_runs)
            rows.append(
                {
                    "batch": b,
                    "dtype": dtype_name,
                    "latency_ms": round(mean_t * 1e3, 2),
                    "std_ms": round(std_t * 1e3, 2),
                    "fps": round(b / mean_t, 1),
                }
            )
            LOGGER.info(f"profile: batch={b} {dtype_name}: {mean_t * 1e3:.2f}±{std_t * 1e3:.2f} ms ({b / mean_t:.1f} fps)")
    return rows


def benchmark(model, imgsz: int = 640, half: bool = True, device=None, **kwargs):
    """`YOLO.benchmark`: `profile_model` of the YOLO's model at batch 1, 8 and 32 in bf16 (`half`) or
    f32, on the YOLO's device (`device` and other keys are taken and unused, as in the JAX package)."""
    rows = profile_model(model.model, model.params, imgsz=imgsz, dtypes=("bfloat16",) if half else ("float32",))
    best = max(rows, key=lambda r: r["fps"])
    LOGGER.info(f"best: batch={best['batch']} {best['dtype']} {best['fps']} fps")
    return rows


def benchmark_formats(model, params, imgsz: int = 640, batch: int = 1, workdir=None):
    """The export-format matrix: for each format, export → reload → time the f32 `predict` at
    `batch` → rows [{format, status, size_MB, latency_ms, fps}] in the JAX package's order:
    `native-jit` (the row keeps the JAX package's name so the tables line up: here it is the
    model as it is, no export), `npz` (save_npz → load_npz on the model's device), `orbax` and
    `stablehlo`. The port has no orbax or stablehlo export (ROADMAP item 4): their rows read
    '❌ NotImplementedError', as a broken exporter's row does in the JAX package."""
    import tempfile
    from pathlib import Path

    workdir = Path(workdir or tempfile.mkdtemp(prefix="yolo_bench_"))
    h = w = imgsz if isinstance(imgsz, int) else max(imgsz)
    x = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=model.device)
    rows = []

    def _try(fmt, export_reload):
        try:
            fn, size = export_reload()
            mean_t, _ = _time_fn(fn, (x,), n_runs=5)
            rows.append({"format": fmt, "status": "✅", "size_MB": round(size / 1e6, 1),
                         "latency_ms": round(mean_t * 1e3, 2), "fps": round(batch / mean_t, 1)})
        except Exception as e:  # a broken exporter shows up in the table, not as a crash
            rows.append({"format": fmt, "status": f"❌ {type(e).__name__}", "size_MB": 0, "latency_ms": 0, "fps": 0})
            LOGGER.warning(f"benchmark {fmt} failed: {e}")

    def _native():
        return _predict_fn(model, params, torch.float32), 0

    def _npz():
        from yolo_tpu_torch.engine.exporter import load_npz, save_npz

        f = save_npz(model, params, workdir / "bench.npz")
        m2, p2, _ = load_npz(f, device=model.device)
        return _predict_fn(m2, p2, torch.float32), f.stat().st_size

    def _unported(fmt):
        def export_reload():
            from yolo_tpu_torch.engine.exporter import Exporter

            return Exporter(args={"format": fmt})(model=model, params=params)  # raises NotImplementedError

        return export_reload

    for fmt, maker in [("native-jit", _native), ("npz", _npz), ("orbax", _unported("orbax")), ("stablehlo", _unported("stablehlo"))]:
        _try(fmt, maker)
    width = max(len(r["format"]) for r in rows)
    for r in rows:
        LOGGER.info(f"{r['format']:<{width}}  {r['status']:<6} {r['size_MB']:>8} MB  {r['latency_ms']:>8} ms  {r['fps']:>8} fps")
    return rows
