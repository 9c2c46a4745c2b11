"""The train step on one device.

Counterpart of ``TrainStep`` in ``pytorch_distributedtraining_tpu/parallel/
step.py``, the subset the ladder uses: ``loss_fn(model, batch) -> (loss,
aux)``, gradients averaged over ``grad_accum_steps`` micro-batches (the
batch's leading dimension split evenly, as ``_split_microbatches`` does),
one update of the port's ``optim.AdamW`` (clip by global norm inside it),
and metrics that stay on the device: ``loss`` (mean over micro-batches),
``grad_norm`` (the global norm before clipping) and the mean of each aux
value. The JAX step's state is the model and optimizer here, updated in
place.

Not ported yet (ROADMAP A.4, A.10): sharding policies and the mesh,
remat, the loss scaler, the numerics probe and ``MultiStep``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..optim import AdamW


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
    """``step(batch) -> metrics``: one optimizer step of ``model``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, tx: AdamW, *,
                 grad_accum_steps: int = 1):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.model = model
        self.loss_fn = loss_fn
        self.tx = tx
        self.grad_accum_steps = int(grad_accum_steps)

    def __call__(self, batch) -> dict[str, torch.Tensor]:
        n = self.grad_accum_steps
        for p in self.tx.params:
            p.grad = None
        losses, auxs = [], []
        for mb in _split_microbatches(batch, n) if n > 1 else [batch]:
            loss, aux = self.loss_fn(self.model, mb)
            loss.backward()
            losses.append(loss.detach())
            auxs.append(aux)
        grads = self.tx.grads()
        if n > 1:
            torch._foreach_div_(grads, float(n))
        gnorm = self.tx.step(grads)
        if gnorm is None:
            gnorm = self.tx.global_norm(grads)
        metrics = {"loss": torch.stack(losses).float().mean(), "grad_norm": gnorm}
        for k in auxs[0]:
            metrics[k] = torch.stack([a[k].detach().float() for a in auxs]).mean(0)
        return metrics
