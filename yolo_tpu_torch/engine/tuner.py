"""Mutation-based hyperparameter evolution (counterpart of yolo_tpu/engine/tuner.py).

    YOLO("yolov8-small.yaml").tune(data="data.yaml", iterations=10, epochs=30, imgsz=640)

The JAX package's strategy, draw for draw: iteration 0 trains the settings as
they are; each later one gaussian-mutates the best-so-far hyperparameters
within per-key (gain, min, max) bounds (`DEFAULT_SPACE`, the port's own copy),
from `np.random.default_rng` seeded by the clock in milliseconds, then trains a
fresh `YOLO(model)` briefly through `YOLO.train` (the task's trainer and its
validation, on the card unless the settings name another device).
<tune_dir>/tune_results.csv holds the fitness and hyperparameters of every
iteration, best_hyperparameters.yaml and best.npz (the best iteration's
weights/best.npz) the best so far.
"""

from __future__ import annotations

import csv
import shutil
import time

import numpy as np

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from yolo_tpu_torch.utils import LOGGER, yaml_save

# search space: key -> (mutation gain, min, max)
DEFAULT_SPACE = {
    "lr0": (1.0, 1e-5, 1e-1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "warmup_momentum": (1.0, 0.0, 0.95),
    "box": (1.0, 0.02, 0.2),
    "cls": (1.0, 0.2, 4.0),
    "dfl": (1.0, 0.4, 6.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "degrees": (1.0, 0.0, 45.0),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "shear": (1.0, 0.0, 10.0),
    "perspective": (1.0, 0.0, 0.001),
    "flipud": (1.0, 0.0, 1.0),
    "fliplr": (1.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
    "copy_paste": (1.0, 0.0, 1.0),
}


class Tuner:
    """Evolve hyperparameters over repeated short trainings."""

    def __init__(self, args: dict, space: dict | None = None):
        self.space = space or DEFAULT_SPACE
        self.args = get_cfg(overrides={k: v for k, v in args.items() if k in DEFAULT_CFG_DICT})
        self.tune_dir = get_save_dir(self.args, name="tune")
        self.results_csv = self.tune_dir / "tune_results.csv"
        LOGGER.info(f"tuner: {len(self.space)} hyperparameters, results -> {self.tune_dir}")

    def _mutate(self, parent: dict, mutation: float = 0.8, sigma: float = 0.2) -> dict:
        """Multiply about `mutation` of the keys by N(1, sigma) ** gain (at least one, and not all
        factors 1), clip each key to its bounds and round to 5 decimals."""
        rng = np.random.default_rng(int(time.time() * 1e3) % (2**32))
        hyp = dict(parent)
        keys = list(self.space)
        while True:
            mask = rng.random(len(keys)) < mutation
            factors = rng.normal(1.0, sigma, len(keys))
            if mask.any() and not np.allclose(factors[mask], 1.0):
                break
        for k, m, f in zip(keys, mask, factors):
            if m:
                gain, lo, hi = self.space[k]
                hyp[k] = float(np.clip(hyp[k] * f**gain, lo, hi))
        for k in keys:
            hyp[k] = round(float(np.clip(hyp[k], self.space[k][1], self.space[k][2])), 5)
        return hyp

    def __call__(self, model=None, iterations: int = 10, **train_kwargs):
        """Run `iterations` trainings → {best_fitness, best_hyperparameters, best_iteration}. `model`
        (a YOLO) names the model each iteration builds anew; `train_kwargs` go to every `train` but
        the searched keys (dropped with a warning: the search controls them) and project, name,
        exist_ok, verbose and data (the tuner sets those). A failed training scores fitness 0."""
        from yolo_tpu_torch.engine.model import YOLO

        self.tune_dir.mkdir(parents=True, exist_ok=True)
        best_fitness, best_hyp, best_idx = -1.0, None, -1
        base = {k: getattr(self.args, k) for k in self.space}
        rows = []
        train_kwargs = dict(train_kwargs)
        for k in ("project", "name", "exist_ok", "verbose", "data"):
            train_kwargs.pop(k, None)
        frozen = set(train_kwargs) & set(self.space)
        if frozen:
            LOGGER.warning(f"tune: dropping fixed overrides for searched keys {sorted(frozen)} — the search controls them")
            for k in frozen:
                train_kwargs.pop(k)
        model_src = (model.overrides.get("model") if model is not None else None) or self.args.model or "yolov8n.yaml"
        for i in range(iterations):
            hyp = self._mutate(best_hyp or base) if i > 0 else dict(base)
            LOGGER.info(f"tune iter {i + 1}/{iterations}: {hyp}")
            # a fresh model every iteration: each candidate trains from the same initial weights
            m = YOLO(model_src, device=self.args.device or None)
            try:
                metrics = m.train(
                    data=self.args.data,
                    project=str(self.tune_dir),
                    name=f"iter{i}",
                    exist_ok=True,
                    verbose=False,
                    **{**train_kwargs, **hyp},
                )
                fitness = (metrics or {}).get("fitness", 0.0)
            except Exception as e:  # one failed candidate scores 0; the search goes on
                LOGGER.warning(f"tune iter {i} failed: {e}")
                fitness = 0.0
            rows.append({"iteration": i, "fitness": fitness, **hyp})
            with open(self.results_csv, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
            if fitness > best_fitness:
                best_fitness, best_hyp, best_idx = fitness, hyp, i
                best_weights = self.tune_dir / f"iter{i}" / "weights" / "best.npz"
                if best_weights.exists():
                    shutil.copy2(best_weights, self.tune_dir / "best.npz")
                yaml_save(self.tune_dir / "best_hyperparameters.yaml", hyp)
        LOGGER.info(f"tuning done: best fitness {best_fitness:.4f} at iter {best_idx}")
        return {"best_fitness": best_fitness, "best_hyperparameters": best_hyp, "best_iteration": best_idx}


def run_ray_tune(model, space: dict | None = None, grace_period: int = 10, max_samples: int = 10, **train_args):
    """Hyperparameter search with Ray Tune (JAX `run_ray_tune`): ASHA over uniform draws from the
    bounds of `DEFAULT_SPACE`, each trial a fresh `YOLO(model)` trained on the model's device, its
    metrics reported by the `raytune` callback of utils/integrations.py. Needs `ray[tune]`, which is
    not a dependency: without it this raises the JAX package's ModuleNotFoundError. The Ray path
    is unverified: ray is installed neither where the tests run nor on the card's machine."""
    try:
        import ray
        from ray import tune
        from ray.tune.schedulers import ASHAScheduler
    except ImportError as e:
        raise ModuleNotFoundError(
            'Ray Tune required but not found. To install run: pip install "ray[tune]"'
        ) from e
    try:  # moved across Ray versions; its absence only loses the run name
        from ray.tune import RunConfig
    except ImportError:
        try:
            from ray.air import RunConfig
        except ImportError:
            RunConfig = None

    space = space or {k: tune.uniform(lo, hi) for k, (_, lo, hi) in DEFAULT_SPACE.items()}
    data = train_args.pop("data", None) or model.overrides.get("data")
    epochs = int(train_args.pop("epochs", 10))
    model_src = model.overrides.get("model") or "yolov8n.yaml"
    device = str(model.device) if getattr(model, "device", None) is not None else None

    def _trainable(config):
        from yolo_tpu_torch.engine.model import YOLO

        m = YOLO(model_src, device=device)  # fresh weights per trial
        m.train(data=data, epochs=epochs, **{**train_args, **config})

    scheduler = ASHAScheduler(
        time_attr="epoch",
        metric=train_args.pop("metric", "metrics/fitness"),
        mode="max",
        max_t=epochs,
        grace_period=min(grace_period, epochs),
        reduction_factor=3,
    )
    tuner = tune.Tuner(
        _trainable,
        param_space=space,
        tune_config=tune.TuneConfig(scheduler=scheduler, num_samples=max_samples),
        **({"run_config": RunConfig(name="yolo_tpu_tune")} if RunConfig is not None else {}),
    )
    results = tuner.fit()
    ray.shutdown()
    return results
