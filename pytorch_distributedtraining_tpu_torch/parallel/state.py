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

5. place the offloaded fields (JAX ``state.py:90-111``): with
   ``policy.offload_opt_state`` the optimizer's state, with
   ``offload_params`` the parameters, go to pinned host memory
   (``optim``'s ``offload``), on a card; where the device has no host
   placement (the CPU) they stay in place and JAX's warning is logged. On
   the card a failed pin raises. Offloaded parameters are refused under
   ZeRO-3, whose shards FSDP2 owns, and under ``DDP`` they go without the
   ``DistributedDataParallel`` wrapper (its reducer hooks the parameters'
   accumulators, which a move between host and device replaces):
   :func:`.step.reduce_gradients` all-reduces their grads instead.

``FusedAdamW`` gets no DDP wrapper: the step all-reduces its flat
gradient once, which keeps the gradient views bound to the flat buffer.
Without a mesh the state is the model on its device and the optimizer
over its parameters, the one-process layout.

:meth:`TrainState.state_dict` is the state in the layout of a run on one
rank (the module's state dict without a DDP ``module.`` prefix, FSDP2
shards gathered; the optimizer's ``full_state_dict``; the step stream
``rng``, a :class:`~.rng.StepRng`; the caller's metadata), a collective
under a sharded policy; :meth:`TrainState.
load_state_dict` puts such a state back into a train state of any policy
and world size, each rank taking its share. ``torch.save`` of it is what
``checkpoint.save_checkpoint`` writes; the portable and sharded formats
(``checkpoint_sharded``) keep the same state rank by rank.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import logging
from typing import Callable, NamedTuple

import torch
import torch.distributed as tdist

from ..optim import FusedAdamW
from ..runtime.dist import resolve_device
from ..runtime.mesh import data_group, mesh_axis_size
from .policy import Policy
from .rng import StepRng
from .spec import ShardPlan, dim0_chunk, host_offload_supported, is_dtensor
from .sync_bn import sync_batch_norm

logger = logging.getLogger(__name__)


class TrainState(NamedTuple):
    model: torch.nn.Module  # what the step calls: DDP-wrapped, FSDP2-sharded or as built
    module: torch.nn.Module  # the module itself: names, state_dict
    tx: object  # the port's optimizer over this rank's share
    mesh: object  # the DeviceMesh, or None for one process
    policy: Policy
    rng: StepRng | None = None  # the step's random stream (TrainStep(rng=state.rng))

    def state_dict(self, meta: dict | None = None) -> dict:
        """``{"params", "opt_state", "rng", "meta"}`` in the layout of a run
        on one rank: the module's state (FSDP2 shards gathered), the
        optimizer's ``full_state_dict``, the step stream's seed and step,
        and the caller's ``meta`` (the facade's holds the step, lr, loss
        scaler and generators). Every rank calls it (the gathers are
        collectives)."""
        self.tx.settle()
        out = {"params": full_module_state(self.module),
               "opt_state": self.tx.full_state_dict(), "meta": dict(meta or {})}
        if self.rng is not None:
            out["rng"] = self.rng.state_dict()
        return out

    def load_state_dict(self, state: dict) -> dict:
        """Restore :meth:`state_dict` output (saved at any world size or
        policy) into this train state: the module's state (each FSDP2 rank
        its chunk), the optimizer's (re-sliced onto this rank's share) and
        the step stream. Returns the ``meta`` dict, which the caller puts
        back."""
        self.tx.settle()  # the load goes into the master parameters (host ones if offloaded)
        load_module_state(self.module, state["params"])
        self.tx.load_state_dict(state["opt_state"])
        if self.rng is not None and state.get("rng") is not None:
            self.rng.load_state_dict(state["rng"])
        return dict(state.get("meta") or {})


def full_module_state(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with each FSDP2 ``DTensor`` gathered whole
    (a collective: every rank calls it)."""
    return {k: v.full_tensor() if is_dtensor(v) else v for k, v in module.state_dict().items()}


@torch.no_grad()
def load_module_state(module: torch.nn.Module, state: dict, strict: bool = True) -> None:
    """Copy whole tensors ``state`` (a state dict, or one nested under
    ``"params"``) into ``module`` in place, after ``checkpoint.
    load_params_dict``'s key and shape checks (strict by default): an FSDP2
    ``DTensor`` takes this rank's first-dimension chunk. The tensors keep
    their storage, so views into them (``FusedAdamW``'s flat buffer) stay
    bound."""
    from ..checkpoint import load_params_dict

    template = module.state_dict()
    matched, _ = load_params_dict(state, template, strict=strict)
    for k, v in matched.items():
        t = template[k]
        v = torch.as_tensor(v)
        if is_dtensor(t):
            local, mesh = t.to_local(), t.device_mesh
            local.copy_(dim0_chunk(v, mesh.get_local_rank(), mesh.size()).to(local.dtype))
        else:
            t.copy_(v)


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
                       find_unused_parameters: bool = False, seed: int = 0) -> TrainState:
    """Place, replicate or shard ``model`` as ``policy`` asks on ``mesh``
    and build the optimizer ``tx(named_parameters, ...)`` over this rank's
    share, its offloaded fields in host memory (see the module docstring);
    the step stream starts at ``seed``, step 0."""
    policy = policy or Policy()
    device = resolve_device(device)
    offload = offload_placed(policy, device)
    state = _laid_out(model.to(device), tx, mesh, policy, device, find_unused_parameters,
                      StepRng(seed), ddp_wrapper=not offload[1])
    if any(offload):
        state.tx.offload(opt_state=offload[0], params=offload[1])
    return state


def _laid_out(model, tx, mesh, policy: Policy, device: torch.device,
              find_unused_parameters: bool, rng: StepRng, ddp_wrapper: bool) -> TrainState:
    """Steps 1-4 of the module docstring; without ``ddp_wrapper`` a DDP
    layout keeps the bare module (offloaded parameters)."""
    fused = makes_fused(tx)
    if mesh is None:
        return TrainState(model, model, tx(model.named_parameters()), None, policy, rng)
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
        return TrainState(model, model, opt, mesh, policy, rng)
    if fused:
        shard_group = group if policy.shard_opt_state else None
        return TrainState(model, model, tx(model.named_parameters(), shard_group=shard_group),
                          mesh, policy, rng)
    if policy.shard_opt_state:
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        dims = policy.opt_specs(named, mesh)
        opt = tx(named, shard=ShardPlan([dims[n] for n, _ in named], group))
        return TrainState(model, model, opt, mesh, policy, rng)
    if not ddp_wrapper:  # reduce_gradients all-reduces the grads
        return TrainState(model, model, tx(model.named_parameters()), mesh, policy, rng)
    from torch.nn.parallel import DistributedDataParallel

    # no buffer sync a forward: the buffers are equal from the broadcast
    # above and stay so, being either derived constants (index tables,
    # masks) or BatchNorm running statistics, which every rank updates
    # from the same global-batch statistics (sync_batch_norm)
    quiet = ("forward_sync_buffers" if "forward_sync_buffers" in
             inspect.signature(DistributedDataParallel).parameters else "broadcast_buffers")
    # on a card, built under a side stream: the reducer keeps each
    # parameter's AccumulateGrad node, whose stream is the one current at
    # its creation, and a node of the default stream cannot join a captured
    # backward (PyTorch's recipe for DDP under CUDA graphs)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        wrapped = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=group, find_unused_parameters=find_unused_parameters, **{quiet: False})
    if side is not None:
        torch.cuda.current_stream(device).wait_stream(side)
    return TrainState(wrapped, model, tx(model.named_parameters()), mesh, policy, rng)


def _fsdp_module_type():
    try:
        from torch.distributed.fsdp import FSDPModule
    except ImportError:
        from torch.distributed._composable.fsdp import FSDPModule
    return FSDPModule


def reshard(module: torch.nn.Module) -> None:
    """Free the unsharded parameters an FSDP2 ``module`` keeps after a
    forward that no backward followed (the root keeps its own, FSDP2's
    training default), so the next forward gathers from the shards again:
    a program captured later must not read copies another program made
    before an update. A no-op for any other module."""
    if isinstance(module, _fsdp_module_type()):
        module.reshard()


def offload_placed(policy: Policy, device: torch.device) -> tuple[bool, bool]:
    """Which of (optimizer state, parameters) go to host memory under
    ``policy`` on ``device``: the policy's flags on a card, nothing where
    the device has no host placement, with JAX's warning for each flag it
    keeps in device memory."""
    if not (policy.offload_opt_state or policy.offload_params):
        return False, False
    if not host_offload_supported(device):
        for on, what in ((policy.offload_opt_state, "optimizer-state"),
                         (policy.offload_params, "parameter")):
            if on:
                logger.warning("%s host offload requested but the %s backend has no "
                               "host-placement support; keeping %s in device memory",
                               what, device.type, what)
        return False, False
    if policy.offload_params and policy.shard_params:
        raise ValueError(
            "offload_params under ZeRO-3: FSDP2 owns the parameter shards' storage, which "
            "cannot move to host memory between steps here; use ZeRO-2 with offload_params, "
            "or ZeRO-3 with offload_opt_state")
    return bool(policy.offload_opt_state), bool(policy.offload_params)
