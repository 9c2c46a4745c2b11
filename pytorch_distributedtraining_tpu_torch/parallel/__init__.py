"""Sharding policies, the train state for a policy, the train steps
(``MultiStep``: K steps as one captured CUDA graph) and their random stream
(``rng``)."""

from .policy import DDP, FSDP, OSS, Policy, ShardedDDP, ZeRO1, ZeRO2, ZeRO3, policy_from_flags
from .remat import apply_remat, resolve_remat
from .rng import DropoutKey, StepRng
from .spec import ShardPlan, leaf_spec, shard_axis, tree_specs
from .state import TrainState, create_train_state, load_module_state
from .graph import StepGraph
from .step import EvalStep, MultiStep, TrainStep, tune_multi_step_k

__all__ = [
    "DDP", "DropoutKey", "EvalStep", "FSDP", "MultiStep", "OSS", "Policy", "ShardPlan",
    "ShardedDDP", "StepGraph", "StepRng", "TrainState", "TrainStep", "ZeRO1", "ZeRO2", "ZeRO3",
    "apply_remat", "create_train_state", "leaf_spec", "load_module_state", "policy_from_flags",
    "resolve_remat", "shard_axis", "tree_specs", "tune_multi_step_k",
]
