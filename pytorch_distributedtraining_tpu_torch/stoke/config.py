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
global batch).

The Fairscale and DeepSpeed configs are JAX's (``stoke/config.py:
170-235``), field for field with its defaults. The facade reads
``FairscaleFSDPConfig.cpu_offload`` and ``DeepspeedConfig``'s ZeRO stage
(onto the Fairscale flags), ``offload_optimizer``/``offload_param``
(``device="cpu"``: the policy's host offload of optimizer state or
parameters), ``bf16_enabled``/``fp16_enabled`` (the precision, where
``fp16`` is not given) and ``gradient_clipping`` (the global-norm clip,
where ``grad_clip`` is not given); ``aio`` and an offload device other than
``cpu`` warn, as in JAX. The other fields (bucket sizes, ``pin_memory``:
the port always pins) are recorded only.

``TPUConfig`` is JAX's (``stoke/config.py:80-175``), field for field. The
facade reads the fields that mean something on this card, each against
its env twin with JAX's precedence: ``dp`` and ``fsdp`` (the data and
sharded-data widths of the facade's mesh; no env twin, as in JAX),
``remat`` (the config's when set, else ``GRAFT_REMAT``; it reaches the
train step ``Stoke.fused_step`` runs), ``telemetry``/``trace_dir``
(``GRAFT_TELEMETRY``/``GRAFT_TRACE``), ``numerics``/``numerics_action``
(``GRAFT_NUMERICS``/``GRAFT_NUMERICS_ACTION``), ``opcost``
(``GRAFT_OPCOST``), ``capture``/``capture_dir`` (``GRAFT_CAPTURE``) and
``serve_spec_k`` (``Stoke.serve``'s draft depth: a keyword wins, then
``GRAFT_SERVE_SPEC_K``, then the field). The facade's keyword arguments of
the same names stay, and a keyword away from its default beats the
config's field. ``donate_state`` is recorded: the port updates its state
in place either way. Each field that waits for another slice raises when
set away from its default (:meth:`TPUConfig.check`), naming the slice.
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


@dataclass
class FairscaleSDDPConfig:
    reduce_buffer_size: int = 0  # recorded: the collectives are bucketed by the step
    auto_refresh_trainable: bool = True  # recorded


@dataclass
class FairscaleFSDPConfig:
    reshard_after_forward: bool = True  # recorded: FSDP2 reshards after forward
    flatten_parameters: bool = False  # recorded: per-leaf sharding
    cpu_offload: bool = False  # -> Policy.offload_opt_state (pinned host memory)


@dataclass
class DeepspeedZeROConfig:
    """The ZeRO stage: 1, 2, 3 are the Fairscale flags' ZeRO-1/2/3."""

    stage: int = 0
    contiguous_gradients: bool = True
    overlap_comm: bool = True
    allgather_bucket_size: int = 5e8  # recorded
    reduce_bucket_size: int = 5e8  # recorded


@dataclass
class DeepspeedAIOConfig:
    """NVMe async-IO knobs: recorded, inert (no NVMe tier; the facade warns)."""

    block_size: int = 1048576
    queue_depth: int = 8
    single_submit: bool = False
    overlap_events: bool = True
    thread_count: int = 1


@dataclass
class DeepspeedOffloadOptimizerConfig:
    """``device="cpu"``: the optimizer state in pinned host memory
    (``Policy.offload_opt_state``)."""

    device: str = "cpu"
    pin_memory: bool = False


@dataclass
class DeepspeedOffloadParamConfig:
    """``device="cpu"``: the parameters in pinned host memory
    (``Policy.offload_params``), streamed to the card for each step."""

    device: str = "cpu"
    pin_memory: bool = False


@dataclass
class DeepspeedConfig:
    zero_optimization: DeepspeedZeROConfig | None = None
    aio: DeepspeedAIOConfig | None = None
    offload_optimizer: DeepspeedOffloadOptimizerConfig | None = None
    offload_param: DeepspeedOffloadParamConfig | None = None
    gradient_clipping: float | None = None
    fp16_enabled: bool = False
    bf16_enabled: bool = False


# fields of TPUConfig that wait for another slice, and the slice's subject
_DEFERRED = {
    "tp": "the advanced-parallelism slice", "sp": "the advanced-parallelism slice",
    "pp": "the advanced-parallelism slice", "pp_schedule": "the advanced-parallelism slice",
    "pp_micro": "the advanced-parallelism slice", "wire": "the advanced-parallelism slice",
    "fp8": "the fp8 matmul slice", "hier": "the hierarchical-mesh slice",
    "serve_kv_wire": "the quantized-KV slice", "plan": "the analyze slice",
}


@dataclass
class TPUConfig:
    """JAX's mesh, policy and observability knobs (the module docstring
    says which the port reads and how)."""

    dp: int | None = None  # data-parallel width; None = every rank
    fsdp: int = 1  # sharded-data width
    tp: int = 1
    sp: int = 1
    pp: int = 1
    pp_schedule: str = "1f1b"
    pp_micro: int = 0
    remat: bool | str = False  # the fused step's remat; unset: GRAFT_REMAT
    donate_state: bool = True  # recorded: the state updates in place either way
    wire: str | None = None
    hier: bool = False
    fp8: str | None = None
    telemetry: bool = False
    trace_dir: str | None = None
    numerics: bool = False
    numerics_action: str = "halt"
    opcost: bool = False
    capture: bool = False
    capture_dir: str | None = None
    serve_spec_k: int = 0
    serve_kv_wire: str | None = None
    plan: str | None = None

    def check(self) -> "TPUConfig":
        """Raise ``NotImplementedError`` for a field set away from its
        default that waits for another slice; ``dp`` and ``fsdp`` both above
        1 (a two-level mesh) too."""
        defaults = TPUConfig.__dataclass_fields__
        for name, subject in _DEFERRED.items():
            if getattr(self, name) != defaults[name].default:
                raise NotImplementedError(
                    f"TPUConfig.{name}={getattr(self, name)!r} waits for {subject}; leave it at "
                    f"{defaults[name].default!r}")
        if (self.dp or 1) > 1 and self.fsdp > 1:
            raise NotImplementedError(
                f"TPUConfig(dp={self.dp}, fsdp={self.fsdp}): a two-level data mesh waits for "
                "the hierarchical-mesh slice; set one of them")
        return self
