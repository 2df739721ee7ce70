"""The optimizers of the trainer, with the learning rate and momentum given at each step
(counterpart of yolo_tpu/utils/optim.py), and the BN running-moment update.

Warmup moves lr, the bias lr and momentum every step, so they are arguments of
`step`, not state. The groups follow the JAX package: weight decay only on the
conv kernels (leaves named `weight` of two or more dimensions outside `bn` and
`dfl`), the bias lr on every `bias`, nothing on the DFL projection and the BN
running moments (frozen: buffers here, never in the parameter list). Both
optimizers clip the gradients to a global norm of 10 first. They are plain
tensor code over lists of the model's parameters (`torch._foreach_*`, a few
launches a step), and read nothing back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def is_decay_param(path: str, p=None) -> bool:
    """The decay group: conv and linear kernels (1-D `weight` leaves, the norm gains, are not).
    `path` is a leaf's path in the JAX tree, 'model/<layer>/.../weight'."""
    keys = path.split("/")
    if keys[-1] != "weight" or "bn" in keys or "dfl" in keys:
        return False
    return p is None or getattr(p, "ndim", 2) >= 2


def is_bias_param(path: str) -> bool:
    """Every bias: warmup starts these at `warmup_bias_lr` instead of 0."""
    return path.split("/")[-1] == "bias"


def is_frozen_param(path: str) -> bool:
    keys = path.split("/")
    return "dfl" in keys or keys[-1] in ("running_mean", "running_var")


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale the gradients in place by min(1, max_norm / (‖g‖ + 1e-6)) → the norm (a device scalar)."""
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))
    torch._foreach_mul_(grads, torch.clamp(max_norm / (gnorm + 1e-6), max=1.0))
    return gnorm


class _Optimizer:
    """The parameters (path, tensor) not frozen, split into the decay, bias and other groups."""

    def __init__(self, named_params, weight_decay: float = 0.0, clip_norm: float = 10.0):
        self.named = [(k, p) for k, p in named_params if not is_frozen_param(k)]
        self.params = [p for _, p in self.named]
        self.decay = [p for k, p in self.named if is_decay_param(k, p)]
        self.is_bias = [is_bias_param(k) for k, _ in self.named]
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def _grads(self) -> list:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        clip_by_global_norm(grads, self.clip_norm)
        return grads

    def _apply(self, steps: list, lr: float, lr_bias: float) -> None:
        """p -= (lr_bias for a bias, else lr) · step."""
        bias = [s for s, b in zip(steps, self.is_bias) if b]
        rest = [s for s, b in zip(steps, self.is_bias) if not b]
        torch._foreach_add_([p for p, b in zip(self.params, self.is_bias) if b], bias, alpha=-lr_bias)
        torch._foreach_add_([p for p, b in zip(self.params, self.is_bias) if not b], rest, alpha=-lr)

    def _decayed(self, steps: list) -> None:
        """step += wd · p on the decay group."""
        if self.weight_decay and self.decay:
            ids = {id(p) for p in self.decay}
            sel = [(s, p) for s, p in zip(steps, self.params) if id(p) in ids]
            torch._foreach_add_([s for s, _ in sel], [p for _, p in sel], alpha=self.weight_decay)


class SGD(_Optimizer):
    """SGD with (Nesterov) momentum; the weight decay is added to the gradient of the decay group."""

    def __init__(self, named_params, weight_decay: float = 0.0, nesterov: bool = True, clip_norm: float = 10.0):
        super().__init__(named_params, weight_decay, clip_norm)
        self.nesterov = nesterov
        self.mu = [torch.zeros_like(p) for p in self.params]

    def state(self) -> dict:
        return {"mu": self.mu}

    def load_state(self, st: dict) -> None:
        torch._foreach_copy_(self.mu, st["mu"])

    @torch.no_grad()
    def step(self, lr: float, momentum: float, lr_bias: float | None = None) -> None:
        g = self._grads()
        self._decayed(g)
        torch._foreach_mul_(self.mu, momentum)
        torch._foreach_add_(self.mu, g)  # mu = momentum·mu + g
        steps = torch._foreach_add(g, self.mu, alpha=momentum) if self.nesterov else [m.clone() for m in self.mu]
        self._apply(steps, lr, lr if lr_bias is None else lr_bias)


class AdamW(_Optimizer):
    """Adam with betas (0.9, 0.999) and decoupled weight decay on the decay group: p -= lr · (m̂ / (√v̂ + eps) + wd · p).
    The `momentum` of `step` is ignored, as in the JAX package: warmup moves only SGD's momentum."""

    def __init__(self, named_params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float = 10.0):
        super().__init__(named_params, weight_decay, clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def state(self) -> dict:
        return {"m": self.m, "v": self.v, "t": self.t}

    def load_state(self, st: dict) -> None:
        torch._foreach_copy_(self.m, st["m"])
        torch._foreach_copy_(self.v, st["v"])
        self.t = int(st["t"])

    @torch.no_grad()
    def step(self, lr: float, momentum: float | None = None, lr_bias: float | None = None) -> None:
        del momentum
        g = self._grads()
        self.t += 1
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, g, alpha=1 - self.b1)  # m = b1·m + (1 - b1)·g
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, g, g, 1 - self.b2)
        # the bias corrections in f32, as the JAX package takes them (its step count is an f32 array)
        t = np.float32(self.t)
        mhat = torch._foreach_div(self.m, float(np.float32(1) - np.float32(self.b1) ** t))
        denom = torch._foreach_div(self.v, float(np.float32(1) - np.float32(self.b2) ** t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        steps = torch._foreach_div(mhat, denom)
        self._decayed(steps)
        self._apply(steps, lr, lr if lr_bias is None else lr_bias)


def build_optimizer(name: str, named_params, weight_decay: float):
    """SGD for SGD / RMSProp, AdamW for the Adam family, as the JAX package maps them."""
    if name in ("Adam", "AdamW", "NAdam", "RAdam"):
        return AdamW(named_params, weight_decay=weight_decay)
    if name in ("SGD", "RMSProp"):
        return SGD(named_params, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name}")


@torch.no_grad()
def apply_bn_stats(model, bn_momentum: float = 0.03) -> None:
    """Fold the batch moments of the last training forward into every BN's running ones
    (momentum 0.03, the unbiased variance), the JAX trainer's update after the optimizer."""
    convs = [m for m in model.modules() if getattr(m, "batch_stats", None) is not None]  # ConvBNAct, ConvTranspose
    if not convs:
        return
    means = [m.bn.running_mean for m in convs]
    varis = [m.bn.running_var for m in convs]
    torch._foreach_mul_(means, 1 - bn_momentum)
    torch._foreach_add_(means, [m.batch_stats[0] for m in convs], alpha=bn_momentum)
    torch._foreach_mul_(varis, 1 - bn_momentum)
    ub = torch._foreach_mul([m.batch_stats[1] for m in convs], [m.batch_stats[2] / max(m.batch_stats[2] - 1, 1) for m in convs])
    torch._foreach_add_(varis, ub, alpha=bn_momentum)
    for m in convs:
        m.batch_stats = None
