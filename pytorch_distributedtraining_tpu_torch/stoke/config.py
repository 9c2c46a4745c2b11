"""Config dataclasses and option enums of the Stoke surface.

Counterpart of ``pytorch_distributedtraining_tpu/stoke/config.py`` for the
configs ``drivers/stoke_ddp.py`` passes, the ``FP16Options`` enum and the
clip-by-value ``ClipGradConfig``. The facade reads
``DDPConfig.find_unused_parameters`` (for the DDP wrapper) and
``FairscaleOSSConfig.broadcast_fp16`` (the bf16 update wire over more
than one rank); ``local_rank``, ``convert_to_sync_batch_norm`` and
``backend`` (NCCL on the card, gloo on the CPU, by ``runtime.dist``) are
recorded only. ``convert_to_sync_batch_norm`` has nothing to convert: the
port's BatchNorm (``parallel.sync_bn.BatchNorm``) is synchronous over the
data group whenever there is one, as JAX's always is (its ``jit`` sees the
global batch). JAX's ``TPUConfig`` has no twin yet: its knobs that matter
on a GPU come with the CUDA-graph step slice. Its telemetry and numerics
fields are the facade's constructor arguments here, resolved against
their env twins by ``observe.trace.telemetry_from_env`` and
``observe.numerics.numerics_from_env`` (JAX's ``_telemetry_from_env`` and
``_numerics_from_env``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class DistributedOptions(Enum):
    ddp = "ddp"
    deepspeed = "deepspeed"
    horovod = "horovod"


class FP16Options(Enum):
    """``amp`` (and the ``apex_O1``/``apex_O2``/``deepspeed`` spellings of
    it) is fp16 autocast with the loss scaler, ``bf16`` bf16 autocast."""

    amp = "amp"
    apex_O1 = "apex_O1"
    apex_O2 = "apex_O2"
    deepspeed = "deepspeed"
    bf16 = "bf16"


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
class ClipGradConfig:
    """Clip each gradient element to ``[-clip, clip]`` (the optimizers'
    ``clip_grad_value``)."""

    clip: float


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
