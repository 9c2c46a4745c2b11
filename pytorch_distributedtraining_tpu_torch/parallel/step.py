"""The train step and the eval step, on one device or under a policy.

Counterpart of ``TrainStep`` and ``EvalStep`` in
``pytorch_distributedtraining_tpu/parallel/step.py``: ``loss_fn(model,
batch) -> (loss, aux)``, gradients averaged over ``grad_accum_steps``
micro-batches (the batch's leading dimension split evenly, as
``_split_microbatches`` does), one update of the port's optimizer, scaled
by ``lr_factor``, and metrics that stay on the device: ``loss`` (mean over
micro-batches and ranks), ``grad_norm`` (the global norm before clipping)
and the mean of each aux value. The JAX step's state is the model and
optimizer here, updated in place.

With a mesh, each rank runs its own shard of the global batch and the
gradients are made the global batch's by the policy
(:func:`reduce_gradients`); the model and optimizer come from
:func:`.state.create_train_state`:

- ``DDP``: per-leaf, ``DistributedDataParallel`` all-reduces, with the
  first ``n-1`` micro-batches under ``no_sync``; ``FusedAdamW``, one
  all-reduce of the flat gradient after the last micro-batch;
- ``ZeRO1``: the gradients all-reduced once, the update on this rank's
  shards (or ``FusedAdamW``'s flat slice), the shards all-gathered;
- ``ZeRO2``: as ZeRO-1, with the sharded leaves reduce-scattered;
- ``ZeRO3``: FSDP2 reduce-scatters each micro-batch; the update runs on
  the local shards.

In every policy the numbers are the one-device step's on the global
batch, as in JAX, up to summation order. ``remat`` (default: the
policy's) checkpoints ``loss_fn`` (:mod:`.remat`).

Model state (BatchNorm running statistics, updated in place by a
training forward) follows JAX's step, which keeps it in
``TrainState.model_state``: every micro-batch runs from the step's
starting state and the last micro-batch's update is kept (JAX's "state:
keep last"), so ``grad_accum_steps`` micro-batches update it once, not n
times in a row. A forward that ``remat`` recomputes in backward does not
update it twice.

Not ported yet: ``MultiStep`` (a CUDA-graph twin, the CUDA-graph step
slice), the numerics probe and ``detect_anomaly`` (the numerics slice),
host offload (the offload slice) and the loss scaler inside the step
(the facade has it).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as tdist

from ..optim import FusedAdamW
from ..runtime.mesh import data_group
from .policy import Policy
from .remat import apply_remat, resolve_remat
from .spec import all_reduce_sum_, all_reduce_tensors
from .state import check_fused
from .sync_bn import batch_norm_state


def _split_microbatches(batch, n: int) -> list:
    """A ``[B, ...]`` tensor, or a tuple of them -> ``n`` batches of ``[B/n, ...]``."""

    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum_steps {n}")
        return x.chunk(n)

    if isinstance(batch, torch.Tensor):
        return list(split(batch))
    return list(zip(*(split(x) for x in batch)))


def _is_ddp(model) -> bool:
    from torch.nn.parallel import DistributedDataParallel

    return isinstance(model, DistributedDataParallel)


def check_layout(model, tx, mesh, policy: Policy) -> None:
    """Refuse a model and optimizer that were not built for ``policy`` on
    ``mesh`` (by :func:`.state.create_train_state`)."""
    if mesh is None:
        return
    fused = isinstance(tx, FusedAdamW)
    if fused:
        check_fused(policy)
        if policy.shard_opt_state and tx.shard_group is None:
            raise ValueError("FusedAdamW under ZeRO-1 needs its shard_group: build it with "
                             "parallel.create_train_state")
        return
    shard = getattr(tx, "shard", None)
    want = ("the FSDP2-sharded model and a dtensor ShardPlan" if policy.shard_params else
            "a ShardPlan of leaf_spec dims" if policy.shard_opt_state else
            "a DistributedDataParallel model")
    ok = (shard is not None and shard.dtensor if policy.shard_params else
          shard is not None and not shard.dtensor if policy.shard_opt_state else
          _is_ddp(model) and shard is None)
    if not ok:
        raise ValueError(f"{policy.name} with a per-leaf optimizer needs {want}: build the "
                         "model and optimizer with parallel.create_train_state")


def reduce_gradients(tx, policy: Policy, group, accum: int = 1) -> list[torch.Tensor] | None:
    """After the last backward of a step, make the gradients the global
    batch's mean: summed over ``group`` as ``policy`` says and divided by
    ranks times ``accum``. Returns this rank's share of the grads for a
    per-leaf ``tx.step``; None for ``FusedAdamW``, whose flat gradient is
    reduced in place. Without a group, only the division by ``accum``."""
    world = 1 if group is None else tdist.get_world_size(group)
    if isinstance(tx, FusedAdamW):
        if group is not None:
            all_reduce_sum_(tx.flat_grad, group)
        if world * accum > 1:
            tx.flat_grad.div_(world * accum)
        return None
    shard = tx.shard
    if shard is None or shard.dtensor:
        # one process, DDP's own all-reduce, or FSDP2's reduce-scatter: the
        # ranks are averaged already
        grads = tx.grads() if shard is None else shard.local(tx.grads())
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        return grads
    return shard.reduce_grads(tx.grads(), scatter=policy.shard_grads,
                              scale=1.0 / (world * accum))


def mean_over_ranks(values: dict, group) -> dict:
    """Each value (f32) averaged over the ranks of ``group`` by one
    all-reduce (as they are without a group)."""
    if group is None or not values:
        return values
    means = all_reduce_tensors([v.float() for v in values.values()], group,
                               1.0 / tdist.get_world_size(group))
    return dict(zip(values, means))


class TrainStep:
    """``step(batch, lr_factor=1.0) -> metrics``: one optimizer step of ``model``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, tx, mesh=None,
                 policy: Policy | None = None, *, grad_accum_steps: int = 1, remat=None):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.model = model
        self.policy = policy or Policy()
        self.mesh = mesh
        check_layout(model, tx, mesh, self.policy)
        self.group = None if mesh is None else data_group(mesh)
        remat = self.policy.remat if remat is None else remat
        self.loss_fn = apply_remat(loss_fn, remat)
        self.tx = tx
        self.model_state = batch_norm_state(model)
        self._recomputes = resolve_remat(remat) in ("full", "dots")
        self.fused = tx if isinstance(tx, FusedAdamW) else None
        self.grad_accum_steps = int(grad_accum_steps)

    def __call__(self, batch, lr_factor: float = 1.0) -> dict[str, torch.Tensor]:
        n = self.grad_accum_steps
        self.tx.zero_grad()
        losses, auxs = [], []
        micro = _split_microbatches(batch, n) if n > 1 else [batch]
        start = [t.clone() for t in self.model_state] if self.model_state and n > 1 else None
        for i, mb in enumerate(micro):
            if start is not None and i > 0:  # every micro-batch from the step's state
                torch._foreach_copy_(self.model_state, start)
            quiet = _is_ddp(self.model) and i < n - 1
            with self.model.no_sync() if quiet else contextlib.nullcontext():
                loss, aux = self.loss_fn(self.model, mb)
                kept = ([t.clone() for t in self.model_state]
                        if self.model_state and self._recomputes else None)
                loss.backward()
            if kept is not None:  # the forward's update, not the recompute's
                torch._foreach_copy_(self.model_state, kept)
            losses.append(loss.detach())
            auxs.append(aux)
        grads = reduce_gradients(self.tx, self.policy, self.group, n)
        if self.fused is not None:
            gnorm, _ = self.fused.apply_tree(lr_factor)
        else:
            gnorm = self.tx.step(grads, lr_factor=lr_factor)
            if gnorm is None:
                gnorm = self.tx.norm(grads)
        metrics = {"loss": torch.stack(losses).float().mean()}
        for k in auxs[0]:
            metrics[k] = torch.stack([a[k].detach().float() for a in auxs]).mean(0)
        metrics = mean_over_ranks(metrics, self.group)
        metrics["grad_norm"] = gnorm
        return metrics


class EvalStep:
    """``step(batch) -> metrics``: ``eval_fn(model, batch) -> {name:
    scalar}`` without a graph, each value averaged over the ranks of the
    mesh's data axis (each rank evaluates its own shard of the batch)."""

    def __init__(self, model: torch.nn.Module, eval_fn: Callable, mesh=None):
        self.model = model
        self.eval_fn = eval_fn
        self.mesh = mesh
        self.group = None if mesh is None else data_group(mesh)

    @torch.no_grad()
    def __call__(self, batch) -> dict[str, torch.Tensor]:
        return mean_over_ranks(dict(self.eval_fn(self.model, batch)), self.group)
