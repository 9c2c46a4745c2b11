"""AdamW with global-norm clipping, and the LR schedules the driver steps.

Counterpart of ``pytorch_distributedtraining_tpu/optim.py``: the ``adamw``
chain (clip by global norm, Adam, decoupled weight decay on every
parameter; ``optim.py:224``) as the facade drives it, with the learning
rate applied after the chain from an :class:`OptimizerHandle`. The update
runs on ``torch._foreach`` ops, a few launches per step for the whole
parameter list, and reads nothing back to the host.

``OneCycleLR`` and ``ReduceLROnPlateau`` stay pure-Python closed forms, not
``torch.optim.lr_scheduler``, so their values match the JAX twins step for
step. ``FusedAdamW`` is not ported yet.
"""

from __future__ import annotations

import math

import torch


class AdamW:
    """``clip_by_global_norm -> adam -> add_decayed_weights``, then ``* -lr``.

    The optax chain's arithmetic: ``u = m̂/(√v̂ + eps) + wd·p`` with bias
    correction by step count, scaled by ``min(1, max_norm/‖g‖)`` first when
    clipping is on; ``p -= lr·u``.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, clip_grad_norm: float | None = None):
        self.params = [p for p in params if p.requires_grad]
        self.lr = float(lr)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def grads(self) -> list[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: float | None = None) -> torch.Tensor | None:
        """Apply one update from ``grads`` (f32, already unscaled). Returns
        the pre-clip global norm (a device scalar) when clipping is on, so a
        caller need not compute it twice; else None."""
        lr = self.lr if lr is None else float(lr)
        gnorm = None
        if self.clip_grad_norm is not None:
            gnorm = self.global_norm(grads)
            scale = torch.where(
                gnorm > self.clip_grad_norm,
                self.clip_grad_norm / torch.clamp(gnorm, min=1e-38),
                torch.ones_like(gnorm),
            )
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return gnorm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}


def adamw(params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, clip_grad_norm: float | None = None) -> AdamW:
    """AdamW with torch-parity argument names (the JAX ``adamw`` factory)."""
    return AdamW(params, lr, betas, eps, weight_decay, clip_grad_norm)


OPTIMIZERS = {"adamw": adamw}


class OptimizerHandle:
    """What ``stoke_model.optimizer`` returns: a mutable lr cell that the
    schedulers write and the facade reads at each step."""

    def __init__(self, base_lr: float):
        self.lr = float(base_lr)
        self.initial_lr = float(base_lr)

    def __repr__(self):
        return f"OptimizerHandle(lr={self.lr})"


class OneCycleLR:
    """OneCycle (cosine) schedule; per-batch ``.step()`` writes the handle.

    ``lr_scale`` multiplies every value, so a plateau cut routed through it
    persists instead of being overwritten on the next batch.
    """

    def __init__(self, optimizer: OptimizerHandle, max_lr: float,
                 total_steps: int | None = None, epochs: int | None = None,
                 steps_per_epoch: int | None = None, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4):
        if total_steps is None:
            if epochs is None or steps_per_epoch is None:
                raise ValueError("need total_steps or epochs+steps_per_epoch")
            total_steps = epochs * steps_per_epoch
        self.optimizer = optimizer
        self._max_lr = max_lr
        self._initial = max_lr / div_factor
        self._final = self._initial / final_div_factor
        self._total = total_steps
        self._warm = max(1, int(total_steps * pct_start))
        self._t = 0
        self.lr_scale = 1.0
        optimizer.lr = self._lr_at(0)

    def _lr_at(self, step: int) -> float:
        step = min(step, self._total)
        if step < self._warm:
            up = 0.5 * (1 + math.cos(math.pi * (1 - step / self._warm)))
            lr = self._initial + (self._max_lr - self._initial) * up
        else:
            t = min(max((step - self._warm) / max(1, self._total - self._warm), 0.0), 1.0)
            down = 0.5 * (1 + math.cos(math.pi * t))
            lr = self._final + (self._max_lr - self._final) * down
        return lr * self.lr_scale

    def step(self) -> float:
        self._t += 1
        self.optimizer.lr = self._lr_at(self._t)
        return self.optimizer.lr


class ReduceLROnPlateau:
    """Plateau scheduler on the host, in two modes: with a handle, a cut
    multiplies its lr by ``factor`` (floored at ``min_lr``); without one,
    :meth:`step` returns a cumulative factor, floored at ``min_factor``."""

    def __init__(self, optimizer: OptimizerHandle | None = None, mode: str = "min",
                 factor: float = 0.1, patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0, min_factor: float = 0.0,
                 verbose: bool = False):
        self.optimizer = optimizer
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.min_factor = min_factor
        self.verbose = verbose
        self.current = 1.0
        self._best: float | None = None
        self._bad = 0
        self._cool = 0

    def _is_better(self, metric: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return metric < self._best * (1 - self.threshold)
        return metric > self._best * (1 + self.threshold)

    def step(self, metric: float) -> float:
        metric = float(metric)
        if self._is_better(metric):
            self._best = metric
            self._bad = 0
        elif self._cool > 0:
            self._cool -= 1
        else:
            self._bad += 1
            if self._bad > self.patience:
                self.current = max(self.current * self.factor, self.min_factor)
                if self.optimizer is not None:
                    self.optimizer.lr = max(self.optimizer.lr * self.factor, self.min_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {self.optimizer.lr:.3e}")
                elif self.verbose:
                    print(f"ReduceLROnPlateau: lr_factor -> {self.current:.3e}")
                self._bad = 0
                self._cool = self.cooldown
        return self.current

    def state_dict(self) -> dict:
        return {
            "current": self.current, "best": self._best, "bad": self._bad,
            "cool": self._cool,
            "lr": None if self.optimizer is None else self.optimizer.lr,
        }
