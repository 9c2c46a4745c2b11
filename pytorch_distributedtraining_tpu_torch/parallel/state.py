"""The train state for a policy: the model placed, replicated or sharded,
and the optimizer over this rank's share.

Counterpart of ``create_train_state`` in ``pytorch_distributedtraining_
tpu/parallel/state.py``. JAX initialises straight into the policy's
sharded layout; PyTorch builds the module first, so
:func:`create_train_state` does, in order:

1. put the model on the rank's device (``cuda:LOCAL_RANK`` by default);
2. make its parameters and buffers equal on every rank: the caller builds
   it from a seed, and rank 0's values are broadcast, as DDP does; and
   hand the mesh's data group to every ``sync_bn.BatchNorm``, whose
   statistics are then the global batch's, as under JAX's ``jit``;
3. wrap it as the policy asks: ``DistributedDataParallel`` for ``DDP``
   with a per-leaf optimizer; FSDP2 ``fully_shard`` (parameters sharded
   along their first dimension, ``reshard_after_forward=True``, no mixed
   precision) over each of ``model.fsdp_blocks()`` and then the root for
   ``ZeRO3``; nothing otherwise;
4. build the optimizer from ``tx``, a factory of ``(name, parameter)``
   pairs such as ``functools.partial(optim.adamw, lr=1e-3)``, over this
   rank's share: a ``ShardPlan`` of ``leaf_spec`` dimensions for ZeRO-1/2,
   of FSDP2's local shards for ZeRO-3, or ``FusedAdamW``'s flat slice
   (``shard_group``) for ZeRO-1.

``FusedAdamW`` gets no DDP wrapper: the step all-reduces its flat
gradient once, which keeps the gradient views bound to the flat buffer.
Without a mesh the state is the model on its device and the optimizer
over its parameters, the one-process layout.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, NamedTuple

import torch
import torch.distributed as tdist

from ..optim import FusedAdamW
from ..runtime.dist import resolve_device
from ..runtime.mesh import data_group, mesh_axis_size
from .policy import Policy
from .spec import ShardPlan
from .sync_bn import sync_batch_norm


class TrainState(NamedTuple):
    model: torch.nn.Module  # what the step calls: DDP-wrapped, FSDP2-sharded or as built
    module: torch.nn.Module  # the module itself: names, state_dict
    tx: object  # the port's optimizer over this rank's share
    mesh: object  # the DeviceMesh, or None for one process
    policy: Policy


def _factory(tx: Callable):
    return tx.func if isinstance(tx, functools.partial) else tx


def makes_fused(tx: Callable) -> bool:
    """Does the optimizer factory ``tx`` build a ``FusedAdamW``?"""
    f = _factory(tx)
    return isinstance(f, type) and issubclass(f, FusedAdamW)


def fully_shard_fn():
    """FSDP2's ``fully_shard`` (moved out of ``_composable`` in torch 2.6)."""
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:
        from torch.distributed._composable.fsdp import fully_shard
    return fully_shard


def check_fused(policy: Policy) -> None:
    if policy.shard_grads or policy.shard_params:
        raise ValueError(
            "FusedAdamW composes with replicated (DDP) and ZeRO-1 layouts only: ZeRO-2/3 "
            "shard grads/params per leaf, which a flat vector cannot express; use optim.adamw "
            "for those")


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, group) -> None:
    """Rank 0's parameters and buffers onto every rank of ``group``."""
    src = tdist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        tdist.broadcast(t.data, src=src, group=group)


def create_train_state(model: torch.nn.Module, tx: Callable, mesh=None,
                       policy: Policy | None = None, *, device: str | torch.device = "cuda",
                       find_unused_parameters: bool = False) -> TrainState:
    """Place, replicate or shard ``model`` as ``policy`` asks on ``mesh``
    and build the optimizer ``tx(named_parameters, ...)`` over this rank's
    share (see the module docstring)."""
    policy = policy or Policy()
    device = resolve_device(device)
    model = model.to(device)
    fused = makes_fused(tx)
    if mesh is None:
        return TrainState(model, model, tx(model.named_parameters()), None, policy)
    if fused:
        check_fused(policy)
    group = data_group(mesh)
    broadcast_module(model, group)
    sync_batch_norm(model, group)

    if policy.shard_params:
        axis = "dp" if mesh_axis_size(mesh, "dp") > 1 else "fsdp"
        fully_shard = fully_shard_fn()
        blocks = model.fsdp_blocks() if hasattr(model, "fsdp_blocks") else []
        for block in blocks:
            fully_shard(block, mesh=mesh[axis], reshard_after_forward=True)
        fully_shard(model, mesh=mesh[axis], reshard_after_forward=True)
        opt = tx(model.named_parameters(), shard=ShardPlan(group=group, dtensor=True))
        return TrainState(model, model, opt, mesh, policy)
    if fused:
        shard_group = group if policy.shard_opt_state else None
        return TrainState(model, model, tx(model.named_parameters(), shard_group=shard_group),
                          mesh, policy)
    if policy.shard_opt_state:
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        dims = policy.opt_specs(named, mesh)
        opt = tx(named, shard=ShardPlan([dims[n] for n, _ in named], group))
        return TrainState(model, model, opt, mesh, policy)
    from torch.nn.parallel import DistributedDataParallel

    # no buffer sync a forward: the buffers are equal from the broadcast
    # above and stay so, being either derived constants (index tables,
    # masks) or BatchNorm running statistics, which every rank updates
    # from the same global-batch statistics (sync_batch_norm)
    quiet = ("forward_sync_buffers" if "forward_sync_buffers" in
             inspect.signature(DistributedDataParallel).parameters else "broadcast_buffers")
    wrapped = DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group, find_unused_parameters=find_unused_parameters, **{quiet: False})
    return TrainState(wrapped, model, tx(model.named_parameters()), mesh, policy)
