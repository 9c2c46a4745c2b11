"""The Stoke facade and its config surface, as ``drivers/stoke_ddp.py`` uses them."""

from .config import (
    AMPConfig,
    ClipGradConfig,
    ClipGradNormConfig,
    DDPConfig,
    DeepspeedAIOConfig,
    DeepspeedConfig,
    DeepspeedOffloadOptimizerConfig,
    DeepspeedOffloadParamConfig,
    DeepspeedZeROConfig,
    DistributedOptions,
    FairscaleFSDPConfig,
    FairscaleOSSConfig,
    FairscaleSDDPConfig,
    FP16Options,
    TPUConfig,
)
from .facade import Stoke
from .optimizer import StokeOptimizer

__all__ = [
    "AMPConfig", "ClipGradConfig", "ClipGradNormConfig", "DDPConfig", "DeepspeedAIOConfig",
    "DeepspeedConfig", "DeepspeedOffloadOptimizerConfig", "DeepspeedOffloadParamConfig",
    "DeepspeedZeROConfig", "DistributedOptions", "FP16Options", "FairscaleFSDPConfig",
    "FairscaleOSSConfig", "FairscaleSDDPConfig", "Stoke", "StokeOptimizer", "TPUConfig",
]
