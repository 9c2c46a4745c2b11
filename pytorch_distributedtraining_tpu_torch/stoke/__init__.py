"""The Stoke facade and its config surface, as ``drivers/stoke_ddp.py`` uses them."""

from .config import (
    AMPConfig,
    ClipGradConfig,
    ClipGradNormConfig,
    DDPConfig,
    DistributedOptions,
    FairscaleOSSConfig,
    FP16Options,
)
from .facade import Stoke
from .optimizer import StokeOptimizer

__all__ = [
    "AMPConfig", "ClipGradConfig", "ClipGradNormConfig", "DDPConfig", "DistributedOptions",
    "FP16Options", "FairscaleOSSConfig", "Stoke", "StokeOptimizer",
]
