"""The trainer's event hooks (counterpart of yolo_tpu/utils/callbacks.py): the same
hook names, each a list of functions called with the trainer. `add_integration_callbacks`
attaches TensorBoard (utils/tb_logger.py) and the experiment trackers whose SDK imports
(utils/integrations.py), as the JAX trainer does at its construction."""

from __future__ import annotations

from yolo_tpu_torch.utils import LOGGER

HOOKS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    "on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end",
    "on_predict_batch_end", "on_predict_end",
    "on_export_start", "on_export_end",
]


def default_callbacks() -> dict:
    return {h: [] for h in HOOKS}


def add_integration_callbacks(callbacks: dict) -> dict:
    """Attach the TensorBoard writer and every tracker integration that imports → `callbacks`."""
    from yolo_tpu_torch.utils.integrations import attach
    from yolo_tpu_torch.utils.tb_logger import callbacks as tb

    for k, v in tb.items():
        callbacks.setdefault(k, []).append(v)
    return attach(callbacks)


def run_callbacks(callbacks: dict, hook: str, obj) -> None:
    """Call the hook's functions with `obj`; a failing one is a warning, never the end of training."""
    for fn in callbacks.get(hook, []):
        try:
            fn(obj)
        except Exception as e:
            LOGGER.warning(f"callback {hook}/{getattr(fn, '__name__', fn)} failed: {e}")
