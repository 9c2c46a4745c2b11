"""Sharding policies: DDP, ZeRO-1 (OSS), ZeRO-2 (ShardedDDP), ZeRO-3 (FSDP).

Counterpart of ``pytorch_distributedtraining_tpu/parallel/policy.py``, the
same frozen dataclasses with the same fields and defaults. Each policy
says whether **params**, **optimizer state** and **grads** shard over the
mesh's ZeRO axis; :mod:`.state` and :mod:`.step` turn that into PyTorch:

- ``DDP``: ``DistributedDataParallel`` (gradients all-reduced);
- ``ZeRO1``/``OSS``: gradients all-reduced, moments kept for this rank's
  :func:`.spec.leaf_spec` shard of each leaf, the updated shards
  all-gathered;
- ``ZeRO2``/``ShardedDDP``: as ZeRO-1, with gradients reduce-scattered;
- ``ZeRO3``/``FSDP``: FSDP2 ``fully_shard`` over the model's blocks and
  its root, the optimizer on the local shards.

The spec builders answer per parameter name with a dimension or None
(:func:`.spec.tree_specs`), where JAX answers with PartitionSpecs.

``offload_opt_state`` (DeepSpeed's ``offload_optimizer``) keeps the
optimizer's moments, and ``offload_params`` (``offload_param``) the master
parameters, in pinned host memory between steps: the step streams them to
the card, updates them there and writes them back (``optim``,
``parallel.state``). Where the device cannot hold host state (the CPU)
they stay in place with a warning, as JAX's do on its CPU backend.
"""

from __future__ import annotations

from dataclasses import dataclass

from .spec import shard_axis, tree_specs


@dataclass(frozen=True)
class Policy:
    """Base sharding policy (DDP semantics: everything replicated)."""

    shard_params: bool = False
    shard_opt_state: bool = False
    shard_grads: bool = False
    min_shard_size: int = 1024
    # activation rematerialisation: a bool (True == "full") or a name from
    # parallel.remat: "none" | "full" | "dots" | "names" | "offload"
    remat: bool | str = False
    # DeepSpeed offload_optimizer twin: the optimizer's moments in pinned
    # host memory, streamed to the card for the update
    offload_opt_state: bool = False
    # DeepSpeed offload_param twin: the master parameters in pinned host
    # memory, streamed in before the forward, written back after the update
    offload_params: bool = False

    def __post_init__(self):
        from .remat import resolve_remat

        resolve_remat(self.remat)  # fail at construction, not first step

    @property
    def remat_policy(self) -> str:
        """Canonical remat policy name ("none"/"full"/"dots"/...)."""
        from .remat import resolve_remat

        return resolve_remat(self.remat)

    # -- spec builders ({name: dim or None}) -------------------------------

    def _specs(self, on: bool, tree, mesh) -> dict:
        items = tree.items() if isinstance(tree, dict) else tree
        if not on or mesh is None:
            return {name: None for name, _ in items}
        from ..runtime.mesh import mesh_axis_size

        size = mesh_axis_size(mesh, "fsdp") * mesh_axis_size(mesh, "dp")
        return tree_specs(items, shard_axis(mesh), size, self.min_shard_size)

    def params_specs(self, params, mesh) -> dict:
        return self._specs(self.shard_params, params, mesh)

    def opt_specs(self, params, mesh) -> dict:
        """Per parameter, the dimension its optimizer state shards along."""
        return self._specs(self.shard_opt_state, params, mesh)

    def grads_specs(self, params, mesh) -> dict | None:
        """None when gradients are all-reduced whole; else their dims."""
        if not self.shard_grads:
            return None
        return self._specs(True, params, mesh)

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class DDP(Policy):
    """Replicated params and state, gradient all-reduce: the DDP twin."""


@dataclass(frozen=True)
class ZeRO1(Policy):
    """Optimizer-state sharding: the Fairscale OSS twin."""

    shard_opt_state: bool = True


@dataclass(frozen=True)
class ZeRO2(ZeRO1):
    """+ gradient reduce-scatter: the ShardedDDP twin."""

    shard_grads: bool = True


@dataclass(frozen=True)
class ZeRO3(ZeRO2):
    """+ parameter sharding: the FSDP twin (Stoke's ``fairscale_fsdp``).
    ``remat=True`` trades FLOPs for memory like FSDP's activation
    checkpointing."""

    shard_params: bool = True


# reference vocabulary
OSS = ZeRO1
ShardedDDP = ZeRO2
FSDP = ZeRO3


def policy_from_flags(distributed: str | None = None, fairscale_oss: bool = False,
                      fairscale_sddp: bool = False, fairscale_fsdp: bool = False,
                      **kwargs) -> Policy:
    """Map Stoke's flag surface onto a policy (JAX ``policy.py:124-138``):
    the Fairscale flags pick the ZeRO stage; ``distributed`` (``ddp``,
    ``deepspeed`` or ``horovod``) is the launch backend and leaves the
    policy replicated when no flag is set."""
    if fairscale_fsdp:
        return ZeRO3(**kwargs)
    if fairscale_sddp:
        return ZeRO2(**kwargs)
    if fairscale_oss:
        return ZeRO1(**kwargs)
    return DDP(**kwargs)
