"""The train step on one device.

Counterpart of ``TrainStep`` in ``pytorch_distributedtraining_tpu/parallel/
step.py``, the subset the ladder and the ESPCN driver use: ``loss_fn(model,
batch) -> (loss, aux)``, gradients averaged over ``grad_accum_steps``
micro-batches (the batch's leading dimension split evenly, as
``_split_microbatches`` does), one update of the port's optimizer, scaled
by ``lr_factor``, and metrics that stay on the device: ``loss`` (mean over
micro-batches), ``grad_norm`` (the global norm before clipping) and the
mean of each aux value. The JAX step's state is the model and optimizer
here, updated in place.

With a per-leaf optimizer (``optim.adamw``, ``optim.sgd``) the step hands
it the parameters' grads; with ``optim.FusedAdamW`` the grads already lie
in its flat buffer, which the step zeroes in place and averages there
(JAX ``parallel/step.py:140-158,289-310``).

Not ported yet (the distributed-runtime slice): sharding policies and the
mesh, remat, the loss scaler, the numerics probe and ``MultiStep``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..optim import FusedAdamW


def _split_microbatches(batch, n: int) -> list:
    """A ``[B, ...]`` tensor, or a tuple of them -> ``n`` batches of ``[B/n, ...]``."""

    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum_steps {n}")
        return x.chunk(n)

    if isinstance(batch, torch.Tensor):
        return list(split(batch))
    return list(zip(*(split(x) for x in batch)))


class TrainStep:
    """``step(batch, lr_factor=1.0) -> metrics``: one optimizer step of ``model``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, tx, *,
                 grad_accum_steps: int = 1):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.model = model
        self.loss_fn = loss_fn
        self.tx = tx
        self.fused = tx if isinstance(tx, FusedAdamW) else None
        self.grad_accum_steps = int(grad_accum_steps)

    def __call__(self, batch, lr_factor: float = 1.0) -> dict[str, torch.Tensor]:
        n = self.grad_accum_steps
        self.tx.zero_grad()
        losses, auxs = [], []
        for mb in _split_microbatches(batch, n) if n > 1 else [batch]:
            loss, aux = self.loss_fn(self.model, mb)
            loss.backward()
            losses.append(loss.detach())
            auxs.append(aux)
        if self.fused is not None:
            if n > 1:
                self.fused.flat_grad.div_(n)
            gnorm, _ = self.fused.apply_tree(lr_factor)
        else:
            grads = self.tx.grads()
            if n > 1:
                torch._foreach_div_(grads, float(n))
            gnorm = self.tx.step(grads, lr_factor=lr_factor)
            if gnorm is None:
                gnorm = self.tx.global_norm(grads)
        metrics = {"loss": torch.stack(losses).float().mean(), "grad_norm": gnorm}
        for k in auxs[0]:
            metrics[k] = torch.stack([a[k].detach().float() for a in auxs]).mean(0)
        return metrics
