"""The Stoke facade and its config surface, as ``drivers/stoke_ddp.py`` uses them."""

from .config import (
    AMPConfig,
    ClipGradNormConfig,
    DDPConfig,
    DistributedOptions,
    FairscaleOSSConfig,
)
from .facade import Stoke
from .optimizer import StokeOptimizer

__all__ = [
    "AMPConfig", "ClipGradNormConfig", "DDPConfig", "DistributedOptions",
    "FairscaleOSSConfig", "Stoke", "StokeOptimizer",
]
