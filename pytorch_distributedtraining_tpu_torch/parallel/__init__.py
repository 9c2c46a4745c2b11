"""Sharding policies, the train state for a policy and the train steps."""

from .policy import DDP, FSDP, OSS, Policy, ShardedDDP, ZeRO1, ZeRO2, ZeRO3, policy_from_flags
from .remat import apply_remat, resolve_remat
from .spec import ShardPlan, leaf_spec, shard_axis, tree_specs
from .state import TrainState, create_train_state
from .step import EvalStep, TrainStep

__all__ = [
    "DDP", "EvalStep", "FSDP", "OSS", "Policy", "ShardPlan", "ShardedDDP", "TrainState",
    "TrainStep", "ZeRO1", "ZeRO2", "ZeRO3", "apply_remat", "create_train_state", "leaf_spec",
    "policy_from_flags", "resolve_remat", "shard_axis", "tree_specs",
]
