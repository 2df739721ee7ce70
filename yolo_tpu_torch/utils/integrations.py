"""Experiment-tracker callback integrations (counterpart of yolo_tpu/utils/integrations.py):
W&B, MLflow, ClearML, Comet, DVC, Neptune, Ray Tune and the platform logger.

Each factory imports its SDK and returns {hook: function}; `attach` registers every one
whose SDK imports and whose settings flag (utils/settings.py) is on. An SDK that does
not import attaches nothing, as in the JAX package. The platform logger is off unless
its flag is set, which the settings schema has no key for; its console and system
loggers (yolo_tpu/utils/logger.py) are not ported, so its factory raises ImportError.

Every writer consumes the same trainer attributes the CSV/TensorBoard writers
use: `trainer.epoch`, the per-epoch loss components in `trainer._last_row`
(written by save-metrics), and `trainer.metrics`.
"""

from __future__ import annotations

from yolo_tpu_torch.utils import LOGGER


def _trainer_scalars(trainer) -> dict:
    out = {}
    row = getattr(trainer, "_last_row", None) or {}
    for k, v in row.items():
        if isinstance(v, (int, float)) and k != "epoch":
            out[k] = float(v)
    for k, v in (getattr(trainer, "metrics", None) or {}).items():
        if isinstance(v, (int, float)):
            out[f"metrics/{k}"] = float(v)
    return out


# --------------------------------------------------------------------------- #
# Weights & Biases (ref: callbacks/wb.py)
# --------------------------------------------------------------------------- #
def _wandb_callbacks():
    import wandb  # noqa: F401 — guarded by caller

    state = {}

    def on_pretrain_routine_start(trainer):
        import wandb

        state["run"] = wandb.run or wandb.init(
            project=str(getattr(trainer.args, "project", None) or "yolo_tpu"),
            name=str(n) if (n := getattr(trainer.args, "name", None)) else None,  # None lets wandb auto-name
            config=vars(trainer.args),
        )

    def on_fit_epoch_end(trainer):
        import wandb

        if wandb.run:
            wandb.run.log(_trainer_scalars(trainer), step=trainer.epoch + 1)

    def on_train_end(trainer):
        import wandb

        if wandb.run:
            best = trainer.wdir / "best.npz"
            if best.exists():
                art = wandb.Artifact(f"run_{wandb.run.id}_model", type="model")
                art.add_file(str(best))
                wandb.run.log_artifact(art, aliases=["best"])
            wandb.run.finish()

    return {
        "on_pretrain_routine_start": on_pretrain_routine_start,
        "on_fit_epoch_end": on_fit_epoch_end,
        "on_train_end": on_train_end,
    }


# --------------------------------------------------------------------------- #
# MLflow (ref: callbacks/mlflow.py)
# --------------------------------------------------------------------------- #
def _mlflow_callbacks():
    import mlflow  # noqa: F401

    def on_pretrain_routine_start(trainer):
        import mlflow

        mlflow.set_experiment(str(getattr(trainer.args, "project", None) or "/yolo_tpu"))
        mlflow.start_run(run_name=str(getattr(trainer.args, "name", None) or "train"))
        mlflow.log_params({k: str(v) for k, v in vars(trainer.args).items()})

    def on_fit_epoch_end(trainer):
        import mlflow

        mlflow.log_metrics(
            {k.replace("(", "").replace(")", ""): v for k, v in _trainer_scalars(trainer).items()},
            step=trainer.epoch + 1,
        )

    def on_train_end(trainer):
        import mlflow

        best = trainer.wdir / "best.npz"
        if best.exists():
            mlflow.log_artifact(str(best))
        mlflow.end_run()

    return {
        "on_pretrain_routine_start": on_pretrain_routine_start,
        "on_fit_epoch_end": on_fit_epoch_end,
        "on_train_end": on_train_end,
    }


# --------------------------------------------------------------------------- #
# ClearML (ref: callbacks/clearml.py)
# --------------------------------------------------------------------------- #
def _clearml_callbacks():
    from clearml import Task  # noqa: F401

    def on_pretrain_routine_start(trainer):
        from clearml import Task

        Task.init(
            project_name=str(getattr(trainer.args, "project", None) or "yolo_tpu"),
            task_name=str(getattr(trainer.args, "name", None) or "train"),
        ).connect(vars(trainer.args))

    def on_fit_epoch_end(trainer):
        from clearml import Task

        task = Task.current_task()
        if task:
            for k, v in _trainer_scalars(trainer).items():
                task.get_logger().report_scalar("train", k, v, iteration=trainer.epoch + 1)

    return {"on_pretrain_routine_start": on_pretrain_routine_start, "on_fit_epoch_end": on_fit_epoch_end}


# --------------------------------------------------------------------------- #
# Comet (ref: callbacks/comet.py)
# --------------------------------------------------------------------------- #
def _comet_callbacks():
    import comet_ml  # noqa: F401

    state = {}

    def on_pretrain_routine_start(trainer):
        import comet_ml

        state["exp"] = comet_ml.Experiment(project_name=str(getattr(trainer.args, "project", None) or "yolo_tpu"))
        state["exp"].log_parameters(vars(trainer.args))

    def on_fit_epoch_end(trainer):
        if "exp" in state:
            state["exp"].log_metrics(_trainer_scalars(trainer), epoch=trainer.epoch + 1)

    def on_train_end(trainer):
        if "exp" in state:
            state["exp"].end()

    return {
        "on_pretrain_routine_start": on_pretrain_routine_start,
        "on_fit_epoch_end": on_fit_epoch_end,
        "on_train_end": on_train_end,
    }


# --------------------------------------------------------------------------- #
# DVCLive (ref: callbacks/dvc.py)
# --------------------------------------------------------------------------- #
def _dvc_callbacks():
    import dvclive  # noqa: F401

    state = {}

    def on_pretrain_routine_start(trainer):
        import dvclive

        state["live"] = dvclive.Live(save_dvc_exp=True)

    def on_fit_epoch_end(trainer):
        live = state.get("live")
        if live:
            for k, v in _trainer_scalars(trainer).items():
                live.log_metric(k, v)
            live.next_step()

    def on_train_end(trainer):
        if state.get("live"):
            state["live"].end()

    return {
        "on_pretrain_routine_start": on_pretrain_routine_start,
        "on_fit_epoch_end": on_fit_epoch_end,
        "on_train_end": on_train_end,
    }


# --------------------------------------------------------------------------- #
# NeptuneAI (ref: callbacks/neptune.py)
# --------------------------------------------------------------------------- #
def _neptune_callbacks():
    import neptune  # noqa: F401

    state = {}

    def on_pretrain_routine_start(trainer):
        import neptune

        state["run"] = neptune.init_run(
            project=str(getattr(trainer.args, "project", None) or "yolo_tpu"),
            name=str(getattr(trainer.args, "name", None) or "train"),
            tags=["yolo_tpu"],
        )
        state["run"]["Configuration/Hyperparameters"] = {
            k: "" if v is None else str(v) for k, v in vars(trainer.args).items()
        }

    def on_fit_epoch_end(trainer):
        run = state.get("run")
        if run:
            for k, v in _trainer_scalars(trainer).items():
                run[k].append(value=v, step=trainer.epoch + 1)

    def on_train_end(trainer):
        run = state.get("run")
        if run:
            best = trainer.wdir / "best.npz"
            if best.exists():
                run["weights/best"].upload(str(best))
            run.stop()

    return {
        "on_pretrain_routine_start": on_pretrain_routine_start,
        "on_fit_epoch_end": on_fit_epoch_end,
        "on_train_end": on_train_end,
    }


# --------------------------------------------------------------------------- #
# Ray Tune (ref: callbacks/raytune.py — reports metrics into an active tune
# session so Ray's schedulers can early-stop/evolve trials; also the hook the
# reference's utils/tuner.py run_ray_tune path depends on)
# --------------------------------------------------------------------------- #
def _raytune_callbacks():
    import ray  # noqa: F401
    from ray import tune  # noqa: F401

    def on_fit_epoch_end(trainer):
        from ray import tune

        metrics = {**_trainer_scalars(trainer), "epoch": trainer.epoch + 1}
        # tune.report raises outside a trial on old Ray and no-ops/raises
        # depending on version — probe for an active session across the API
        # generations (ray.tune.is_session_enabled was removed; ray.train
        # context is the 2.x signal) and swallow the no-session case only.
        try:
            from ray import train

            if train.get_context().get_trial_id() is None:  # not in a trial
                return
        except Exception:
            pass
        try:
            tune.report(metrics)  # classic + 2.38+ API
        except (AttributeError, RuntimeError):
            from ray.air import session  # 2.x era API

            session.report(metrics)

    return {"on_fit_epoch_end": on_fit_epoch_end}


# --------------------------------------------------------------------------- #
# The platform logger: off by default (its settings flag must be set explicitly).
# --------------------------------------------------------------------------- #
def _platform_callbacks():
    raise ImportError("the platform integration's console and system loggers (utils/logger.py) are not ported")


_FACTORIES = {
    "wandb": _wandb_callbacks,
    "mlflow": _mlflow_callbacks,
    "clearml": _clearml_callbacks,
    "comet": _comet_callbacks,
    "dvc": _dvc_callbacks,
    "neptune": _neptune_callbacks,
    "raytune": _raytune_callbacks,
    "platform": _platform_callbacks,
}

# integrations whose settings flag must be EXPLICITLY enabled (the reference
# ships platform.py behind `SETTINGS.get("platform", False) is True`)
_DEFAULT_OFF = {"platform"}


def attach(callbacks: dict) -> dict:
    """Register every integration whose SDK imports AND whose persisted
    settings flag is on (ref: base.py add_integration_callbacks:~190; each
    reference callback module gates on SETTINGS[name] is True)."""
    try:
        from yolo_tpu_torch.utils.settings import get_settings

        flags = get_settings()
    except Exception:
        flags = {}
    for name, factory in _FACTORIES.items():
        if not flags.get(name, name not in _DEFAULT_OFF):
            continue
        try:
            for hook, fn in factory().items():
                callbacks.setdefault(hook, []).append(fn)
            LOGGER.info(f"callback integration attached: {name}")
        except ImportError:
            pass
        except Exception as e:
            LOGGER.warning(f"callback integration {name} failed to attach: {e}")
    return callbacks
