"""Config dataclasses and option enums of the Stoke surface.

Counterpart of ``pytorch_distributedtraining_tpu/stoke/config.py`` for the
configs ``drivers/stoke_ddp.py`` passes. The facade reads
``DDPConfig.find_unused_parameters`` (for the DDP wrapper) and
``FairscaleOSSConfig.broadcast_fp16`` (the bf16 update wire over more
than one rank); ``local_rank``, ``convert_to_sync_batch_norm`` and
``backend`` (NCCL on the card, gloo on the CPU, by ``runtime.dist``) are
recorded only. ``convert_to_sync_batch_norm`` has nothing to convert: the
port's BatchNorm (``parallel.sync_bn.BatchNorm``) is synchronous over the
data group whenever there is one, as JAX's always is (its ``jit`` sees the
global batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class DistributedOptions(Enum):
    ddp = "ddp"
    deepspeed = "deepspeed"
    horovod = "horovod"


@dataclass
class AMPConfig:
    """GradScaler knobs for ``fp16='amp'``."""

    init_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class ClipGradNormConfig:
    """Global-norm clip; only the L2 norm is supported."""

    max_norm: float
    norm_type: float = 2.0

    def __post_init__(self):
        if self.norm_type != 2.0:
            raise ValueError("only norm_type=2.0 is supported")


@dataclass
class DDPConfig:
    """DDP knobs. ``convert_to_sync_batch_norm`` is recorded only: BatchNorm
    is synchronous over the data group whenever there is one."""

    local_rank: int | None = None
    convert_to_sync_batch_norm: bool = False
    find_unused_parameters: bool = False
    backend: str | None = None


@dataclass
class FairscaleOSSConfig:
    broadcast_fp16: bool = False
