"""The Stoke facade: one object owning model, optimizer, loss, precision,
grad accumulation and clipping, data loading, checkpoints and rank I/O.

Counterpart of ``pytorch_distributedtraining_tpu/stoke/facade.py`` for the
surface ``drivers/stoke_ddp.py`` drives: ``.model``, ``.loss``,
``.backward``, ``.step``, ``.zero_grad``, ``.DataLoader``,
``.print_ema_loss``, ``.detach_and_sync_loss``, ``.eval_step``, ``.init``,
``.load_model_state``, ``.model_access``, ``.print_on_devices``,
``.barrier``, ``.optimizer``, ``.state``, ``.ema_params``,
``.export_trace`` and ``.serve`` (a serving engine over the live weights),
and the checkpoints: ``.save``/``.load`` (one consolidated file, the resume
path), ``.save_sharded``/``.load_sharded`` (every rank its shards, through
``torch.distributed.checkpoint``) and ``.save_portable``/``.load_resharded``
(the portable format, which restores at another world size or policy).

The Stoke-style loop is deferred, as the JAX facade's
(``facade.py:1249-1521`` there; ``fuse_eager_step=True``, the default):
``.model`` in training mode copies its inputs into a tensor of the
facade's own and returns a handle (``_LazyOutput``), ``.loss`` on it
another (``_LazyLoss``), ``.backward`` records the micro-batch, and on
every ``grad_accum_steps``-th call ``.step`` runs the whole window as one
program: each micro-batch's forward under the precision policy's
autocast, its f32 loss, ``(loss / grad_accum_steps · scale).backward()``
into ``.grad`` and the 0.98-decay loss monitor folded on the device, then
the update (Stoke semantics; the lr read from :attr:`optimizer` at that
moment). The handles take their values from the program's outputs; any
other use materializes one (``torch.*`` calls, tensor methods, arithmetic,
``float``, ``numpy.asarray``...), so deferral never changes a value the
caller sees. A loss read inside its window (the driver's loop reads each
one right after ``.step()``), a window with micro-batches already run, and
``fuse_eager_step=False`` take the split path: a program for the first
micro-batch of a window (``.grad`` zeroed, then written), one that
accumulates, and the update alone (JAX's ``_jit_acc_first``, ``_jit_acc``
and ``_jit_apply``). On the card every program is a captured CUDA graph
(``parallel.graph.StepGraph``, one per program and input signature, the
capture billed as the telemetry span's ``compile``), replayed once a
call; the lr factor and the step counter are written before each. The
cold programs are graphs too, one per input signature: the forward of a
handle read alone and the loss of a loss read before ``.backward()``
(JAX's ``_jit_fwd`` and ``_jit_loss``), eval-mode ``.model`` and
:meth:`eval_step`. Every layout captures: ZeRO-3 keeps FSDP2's hooks,
copies and streams inside the capture, and a ``DistributedDataParallel``
model's programs run the bare module (``parallel.step.unwrapped``), the
update all-reducing the grads once. The one layout whose programs run
uncaptured is a per-leaf optimizer's offloaded parameters, decided at
construction (the reason on :attr:`graph_refusal`, printed once under
``verbose``); on the CPU every program runs uncaptured, the same code;
:meth:`uncaptured` runs them uncaptured on the card, the graphs' twin. A
capture that fails raises. Nothing in the hot loop waits for the device
except an explicit read of a loss. ``.model`` runs in the module's mode: a BatchNorm model trains on batch statistics and updates
its running statistics in place from one micro-batch to the next, as the
JAX facade threads ``model_state``; after ``model_access.eval()``, and
always in :meth:`eval_step`, it reads the running statistics.

Device and ranks: the facade runs on ``device`` (``"cuda"`` by default,
the process's card under a launcher; it raises when no CUDA device exists
unless ``device="cpu"`` was asked for). The flags map onto a policy
through ``parallel.policy_from_flags``, as in JAX: ``fairscale_fsdp`` is
ZeRO-3, ``fairscale_sddp`` ZeRO-2, ``fairscale_oss`` ZeRO-1, else DDP;
``distributed`` (``ddp``, ``deepspeed``, ``horovod``) names the launch
backend and leaves the policy to the flags. The configs are read as JAX
reads them (``facade.py:568``, ``:670-742``, ``:837-842``, ``:883-886``):
``DeepspeedConfig``'s ZeRO stage sets the Fairscale flags, its
``offload_optimizer``/``offload_param`` on ``cpu`` and
``FairscaleFSDPConfig(cpu_offload=True)`` set the policy's host offload
(``offload_opt_state``/``offload_params``; on the CPU the state stays in
place with a warning), ``aio`` and another offload device warn, and
``bf16_enabled``/``fp16_enabled`` and ``gradient_clipping`` stand for
``fp16`` and ``grad_clip`` when those are not given. Offloaded parameters
are streamed to the card by each program that runs a forward (and by the
eval paths) and written back by the update; with a per-leaf optimizer the
programs then run uncaptured (:attr:`graph_refusal`).
With a process group (``runtime.dist.initialize()``, which the drivers
call) or a ``mesh=``, ``parallel.create_train_state`` replicates or shards
the model and optimizer and :meth:`step` syncs the gradients as the
policy says; every rank runs its own shard of the data. Without a group
the facade trains one process, and ``WORLD_SIZE > 1`` then raises.
``fp16`` takes the string or ``FP16Options`` (``amp``, and the
``apex_O1``/``apex_O2``/``deepspeed`` spellings of it, run fp16 autocast
with the loss scaler; ``bf16`` bf16 autocast); ``grad_clip`` a
``ClipGradNormConfig`` (global norm) or a ``ClipGradConfig`` (by value).
``FairscaleOSSConfig(broadcast_fp16=True)`` narrows the update to bf16
before it is gathered, on a sharded-optimizer policy over more than one
rank (JAX's rule: at one rank there is no fan-out to narrow). Losses and
eval metrics are averaged over ranks; prints come from rank 0 by default,
as Stoke's; :meth:`save` gathers the sharded state and writes on rank 0
alone, in the layout of a one-rank run.

Telemetry and numerics (JAX ``facade.py:231-243``, ``:179-200``,
``:610-635``, ``:1730-1750``): ``telemetry=``/``trace_dir=`` (env twins
``GRAFT_TELEMETRY``/``GRAFT_TRACE``) turn the span tracer on at
construction, with spans around the facade's forward, backward and
optimizer step (the first of each billed as ``compile``) and the loader's
input waits, and :meth:`export_trace` writes under ``trace_dir``.
``numerics=``/``numerics_action=`` (``GRAFT_NUMERICS``/
``GRAFT_NUMERICS_ACTION``) build an ``observe.numerics.NumericsProbe`` and
``NumericsWatchdog``; every ``GRAFT_NUMERICS_EVERY``-th optimizer step
(default 1) takes the probe's aux of that step's gradients and decodes it
(:attr:`numerics_summary`): a ``halt`` verdict raises
``NumericsDivergence`` out of :meth:`step`, ``rollback`` and ``degrade``
verdicts stay on ``numerics_watchdog.tripped`` for the training loop.
``GRAFT_NUMERICS_INJECT`` poisons its leaf at its optimizer step (0-based)
before the update. Dropout follows JAX's facade: the forward passes
``train=`` only to a model whose ``forward`` takes it, and nothing turns a
model's ``deterministic`` off, so GPT-2's and ViT's dropout stay off here
as they do there.

Op-cost attribution and the anomaly-triggered capture (JAX
``facade.py:205-227``, ``:636-662``): ``opcost=`` and ``capture=``/
``capture_dir=`` (env twins ``GRAFT_OPCOST`` and ``GRAFT_CAPTURE``; a
``GRAFT_CAPTURE`` that is not a boolean spelling is the capture directory)
stand in for JAX's ``TPUConfig`` fields until its twin. With capture on,
the facade arms an ``observe.capture.OnDemandProfiler``
(:attr:`capture`), and with opcost on too, a landed capture is parsed by
``observe.opcost.ingest_trace`` with the mesh's axes (the result on
:attr:`opcost_result`); under a process group each rank captures into
its own ``rank<r>`` directory. The profiler is polled by ``capture.note_step()``
right after the numerics plane decodes a step, on every optimizer step
:meth:`step` or :meth:`fused_step` takes, so a numerics trip fires the
capture on the step that saw it.

``fused_step(inputs, targets)`` is JAX's one-call step: forward, backward,
accumulation (the batch split into ``grad_accum_steps`` micro-batches),
the loss scaler, clipping and the update as one ``parallel.TrainStep`` over
the facade's model, loss, optimizer, policy and precision, run on the card
as a captured CUDA graph (``parallel.graph.StepGraph``) and on the CPU
directly; it returns the metrics dict, notes the loss, decodes numerics and
polls the capture as :meth:`step` does. It shares the state with the
Stoke-style path, so the two mix: the graph binds each parameter's
``.grad`` back to its own buffers before every replay, and leaves the grads
zeroed (or dropped) afterwards, as :meth:`step` does. It captures on every
layout: ZeRO-3 (``fairscale_fsdp``) and a DDP layout with a per-leaf
optimizer (``fused_optimizer=False``: a ``DistributedDataParallel`` model,
which the program runs without its wrapper, ``TrainStep.program``) too.
``TPUConfig`` (``configs=[TPUConfig(...)]``, ``stoke/config.py``) carries
JAX's mesh and observability knobs; the keywords above stand for its
fields.

Both paths share the loss scaler (``fp16='amp'``), whose scale and growth
count live on the device: the update's skip on a non-finite gradient is a
select on the device flag (all ranks' through one all-reduce), never a
branch on the host.

The optimizer follows the JAX facade's rule (``facade.py:889-930`` there):
AdamW on a layout where a flat update fits (DDP, or ZeRO-1/OSS:
``fairscale_oss`` without ``fairscale_sddp`` or ``fairscale_fsdp``) runs as
``optim.FusedAdamW`` unless ``fused_optimizer=False``; ZeRO-2/3 layouts keep
the per-leaf chain, and ``fused_optimizer=True`` on one of them raises.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import weakref
from typing import Callable

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import optim as optim_mod
from ..data import DataLoader as _DataLoader
from ..parallel.policy import policy_from_flags
from ..parallel.spec import is_dtensor, shard_axis
from ..observe import trace as _telemetry
from ..observe import numerics as _numerics
from ..observe import opcost as _opcost
from ..observe import capture as _capture
from ..parallel.state import TrainState, create_train_state, load_module_state, reshard
from ..parallel.graph import StepGraph, signature
from ..parallel.rng import StepRng
from ..parallel.step import TrainStep, all_finite, mean_over_ranks, reduce_gradients
from ..parallel.sync_bn import batch_norm_state
from ..precision import DynamicLossScaler, Policy
from ..runtime import dist
from ..runtime.mesh import MeshSpec, data_group, make_mesh, mesh_shape
from .config import (AMPConfig, ClipGradConfig, ClipGradNormConfig, DDPConfig, DeepspeedConfig,
                     DistributedOptions, FairscaleFSDPConfig, FairscaleOSSConfig, FP16Options,
                     TPUConfig)
from .optimizer import StokeOptimizer

# fp16 options that run fp16 autocast with the loss scaler (JAX's set)
_SCALED_FP16 = ("amp", "apex_O1", "apex_O2", "deepspeed")


def _remat_from_env(configured):
    """The fused step's remat: ``TPUConfig.remat`` when set, else
    ``GRAFT_REMAT``, else off (JAX's ``_remat_from_env``), checked here."""
    if configured:
        return configured
    env = os.environ.get("GRAFT_REMAT")
    if env is None:
        return configured
    from ..parallel.remat import resolve_remat

    return resolve_remat(env)


def _offload_knobs(fsdp_config, ds_config) -> tuple[bool, bool]:
    """``(offload_opt_state, offload_params)`` from the Fairscale FSDP and
    DeepSpeed configs (JAX ``facade.py:703-737``): ``cpu_offload`` and an
    ``offload_optimizer`` on ``cpu`` offload the optimizer state, an
    ``offload_param`` on ``cpu`` the parameters. Knobs the port has no
    counterpart for warn instead of passing silently: the AIO config (no
    NVMe tier) and an offload device other than ``cpu`` (or ``none``)."""
    import warnings

    offload_opt = bool(fsdp_config is not None and fsdp_config.cpu_offload)
    if ds_config is None:
        return offload_opt, False
    if ds_config.offload_optimizer is not None:
        offload_opt = offload_opt or ds_config.offload_optimizer.device == "cpu"
    offload_par = (ds_config.offload_param is not None
                   and ds_config.offload_param.device == "cpu")
    if ds_config.aio is not None:
        warnings.warn("DeepspeedAIOConfig is inert here (no NVMe tier); use "
                      "offload_optimizer/offload_param(device='cpu') for the host-memory "
                      "offload", stacklevel=3)
    for label, oc in (("offload_optimizer", ds_config.offload_optimizer),
                      ("offload_param", ds_config.offload_param)):
        if oc is not None and oc.device not in ("cpu", "none"):
            warnings.warn(f"Deepspeed {label} device={oc.device!r} has no counterpart here (only "
                          "'cpu' = pinned host memory maps); ignoring", stacklevel=3)
    return offload_opt, offload_par


def _serve_fastpath_overrides(cfg: TPUConfig, overrides: dict) -> dict:
    """``overrides`` with ``spec_k`` from ``cfg.serve_spec_k`` where neither
    the caller nor ``$GRAFT_SERVE_SPEC_K`` set it (JAX's precedence)."""
    out = dict(overrides)
    if ("spec_k" not in out and not (os.environ.get("GRAFT_SERVE_SPEC_K") or "").strip()
            and cfg.serve_spec_k):
        out["spec_k"] = int(cfg.serve_spec_k)
    return out


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, non_blocking=True)


def _owned(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` in a tensor of the facade's own: a recorded
    micro-batch must not change when the caller writes its tensor later."""
    t = _as_tensor(x, device)
    shared = t is x or (isinstance(x, np.ndarray) and t.device.type == "cpu")
    return t.clone() if shared else t


def _materialized(tree):
    if isinstance(tree, _LazyBase):
        return tree.materialize()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_materialized(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _materialized(v) for k, v in tree.items()}
    return tree


def _forward_op(name):
    def op(self, *args):
        return getattr(self.materialize(), name)(*args)

    op.__name__ = name
    return op


class _LazyBase:
    """A deferred value (JAX ``facade.py:387-430``): any use outside the
    deferred ``.loss -> .backward -> .step`` flow materializes it, so a
    handle behaves like the tensor it stands for: ``torch.*`` calls and
    tensor methods (``__torch_function__``, attribute access), arithmetic,
    comparisons, indexing, iteration, ``numpy.asarray`` and ``float``."""

    __slots__ = ("_facade", "_value", "__weakref__")

    def materialize(self) -> torch.Tensor:  # overridden
        raise NotImplementedError

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_materialized(args), **_materialized(kwargs or {}))

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize().detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __len__(self):
        return len(self.materialize())

    def __iter__(self):
        return iter(self.materialize())

    def __float__(self):
        return float(self.materialize())

    def __bool__(self):
        return bool(self.materialize())

    def __format__(self, spec):
        return format(float(self), spec) if spec else repr(self)

    def detach(self) -> torch.Tensor:
        return self.materialize().detach()

    def __getattr__(self, name):
        return getattr(self.materialize(), name)

    def __repr__(self):
        state = "pending" if self._value is None else "materialized"
        return f"{type(self).__name__}<{state}>"


for _name in (
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__pow__", "__neg__", "__abs__",
    "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__",
    "__matmul__", "__rmatmul__", "__mod__",
):
    setattr(_LazyBase, _name, _forward_op(_name))
_LazyBase.__hash__ = object.__hash__  # __eq__ above would otherwise drop it


class _LazyOutput(_LazyBase):
    """The deferred forward of ``.model()`` in training mode (JAX
    ``_LazyOutput``). It holds the facade's own copy of the inputs; the
    parameters in effect at the ``.model()`` call are the live ones until
    an update, and ``.step()`` materializes every handle from outside its
    window before it updates them in place. Materialized alone, it runs
    the forward uncaptured with the BatchNorm statistics put back (JAX
    discards the state of its ``_jit_fwd``); inside a window it takes its
    value from the program's output. ``.shape``/``.dtype``/``.ndim``/
    ``.size`` come from a per-signature cache once any program has seen
    the input signature, without a forward."""

    __slots__ = ("_inputs",)

    def __init__(self, facade, inputs: torch.Tensor):
        self._facade = facade
        self._inputs = inputs
        self._value = None

    def materialize(self) -> torch.Tensor:
        if self._value is None:
            self._value = self._facade._forward_now(self._inputs)
        return self._value

    def __getattr__(self, name):
        if self._value is None and name in ("shape", "dtype", "ndim", "size"):
            meta = self._facade._out_meta.get(signature(self._inputs))
            if meta is not None:
                shape, dtype = meta
                return {"shape": shape, "dtype": dtype, "ndim": len(shape),
                        "size": lambda dim=None: shape if dim is None else shape[dim]}[name]
        return getattr(self.materialize(), name)


class _LazyLoss(_LazyBase):
    """The deferred loss of ``.loss()`` on a pending output (JAX
    ``_LazyLoss``): resolved by the program that runs its micro-batch, or,
    read early, by a flush of its window through the split path (or, before
    ``.backward()``, by the forward and the loss run uncaptured)."""

    __slots__ = ("_output", "_targets")

    def __init__(self, facade, output: _LazyOutput, targets: torch.Tensor):
        self._facade = facade
        self._output = output
        self._targets = targets
        self._value = None

    def materialize(self) -> torch.Tensor:
        if self._value is None:
            self._value = self._facade._materialize_lazy_loss(self)
        return self._value


class Stoke:
    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: StokeOptimizer | dict,
        loss: Callable,
        batch_size_per_device: int = 1,
        verbose: bool = False,
        gpu: bool = False,  # parity no-op: `device` decides
        fp16: str | FP16Options | None = None,
        distributed: str | DistributedOptions | None = None,
        fairscale_oss: bool = False,
        fairscale_sddp: bool = False,
        fairscale_fsdp: bool = False,
        grad_accum_steps: int = 1,
        configs: list | None = None,
        grad_clip: ClipGradNormConfig | ClipGradConfig | None = None,
        fused_optimizer: bool | None = None,
        *,
        device: str | torch.device = "cuda",
        mesh=None,
        telemetry: bool = False,
        trace_dir: str | None = None,
        numerics: bool = False,
        numerics_action: str = "halt",
        opcost: bool = False,
        capture: bool = False,
        capture_dir: str | None = None,
        fuse_eager_step: bool = True,
    ):
        distributed = distributed.value if isinstance(distributed, DistributedOptions) else distributed
        self._configs = list(configs or [])
        self.tpu_config = tpu = (self._find_config(TPUConfig) or TPUConfig()).check()
        ds_config = self._find_config(DeepspeedConfig)
        if ds_config is not None and ds_config.zero_optimization is not None:
            # the ZeRO stage onto the Fairscale flags (JAX facade.py:670-674)
            stage = ds_config.zero_optimization.stage
            fairscale_oss = fairscale_oss or stage >= 1
            fairscale_sddp = fairscale_sddp or stage >= 2
            fairscale_fsdp = fairscale_fsdp or stage >= 3
        offload_opt, offload_par = _offload_knobs(self._find_config(FairscaleFSDPConfig),
                                                  ds_config)
        self.policy = policy_from_flags(distributed, fairscale_oss, fairscale_sddp,
                                        fairscale_fsdp, remat=_remat_from_env(tpu.remat),
                                        offload_opt_state=offload_opt,
                                        offload_params=offload_par)
        zero = fairscale_oss or fairscale_sddp or fairscale_fsdp
        spec = None
        if tpu.dp is not None or tpu.fsdp > 1:  # the config's widths (JAX's rule)
            spec = MeshSpec(dp=tpu.dp or 1, fsdp=tpu.fsdp)
            if spec.size != dist.world_size():
                raise ValueError(f"TPUConfig(dp={tpu.dp}, fsdp={tpu.fsdp}) spans {spec.size} "
                                 f"ranks; this run has {dist.world_size()}")
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(spec or (MeshSpec.zero() if zero else MeshSpec.ddp()))
        if mesh is None and dist.world_size() > 1:
            raise RuntimeError(
                f"WORLD_SIZE={dist.world_size()} but no process group: call "
                "runtime.dist.initialize() before building the facade (the drivers do)")
        self.mesh = mesh
        self._group = None if mesh is None else data_group(mesh)
        self.device = dist.resolve_device(device)
        self._loss_callable = loss
        self.batch_size_per_device = int(batch_size_per_device)
        self.verbose = bool(verbose)
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.grad_clip = grad_clip
        # the reference loop's .backward()/.step() pair as one program per
        # accumulation window (JAX's fuse_eager_step); False: the split path
        self.fuse_eager_step = bool(fuse_eager_step)
        amp_config = self._find_config(AMPConfig) or AMPConfig()

        fp16 = fp16.value if isinstance(fp16, FP16Options) else fp16
        if fp16 is None and ds_config is not None:
            # DeepSpeed's precision switches, where the argument leaves it open
            fp16 = "bf16" if ds_config.bf16_enabled else "amp" if ds_config.fp16_enabled else None
        self.fp16 = fp16
        self.loss_scaler = None
        if fp16 in _SCALED_FP16:
            self.precision = Policy.from_name("fp16")
            if amp_config.enabled:
                self.loss_scaler = DynamicLossScaler(
                    init_scale=amp_config.init_scale,
                    growth_factor=amp_config.growth_factor,
                    backoff_factor=amp_config.backoff_factor,
                    growth_interval=amp_config.growth_interval,
                    device=self.device,
                )
        elif fp16 in (None, "bf16"):
            self.precision = Policy.from_name(fp16)
        else:
            raise ValueError(f"unknown fp16 option {fp16!r}")

        factory, kwargs = StokeOptimizer.resolve(optimizer)
        base_lr = float(kwargs.pop("lr", 1e-3))
        if isinstance(grad_clip, ClipGradNormConfig):
            kwargs.setdefault("clip_grad_norm", grad_clip.max_norm)
        elif isinstance(grad_clip, ClipGradConfig):
            kwargs.setdefault("clip_grad_value", grad_clip.clip)
        elif grad_clip is not None:
            raise TypeError(
                "grad_clip must be a ClipGradNormConfig or a ClipGradConfig, got "
                f"{type(grad_clip).__name__}"
            )
        elif ds_config is not None and ds_config.gradient_clipping:
            # DeepSpeed's global-norm clip, where no grad_clip argument is given
            kwargs.setdefault("clip_grad_norm", ds_config.gradient_clipping)
        fused_eligible = factory is optim_mod.adamw and optim_mod.fused_adamw_eligible(
            self.policy)
        if fused_optimizer is True and not fused_eligible:
            raise ValueError(
                "fused_optimizer=True needs AdamW on a replicated (DDP) or ZeRO-1/OSS "
                "layout; ZeRO-2/3 (fairscale_sddp, fairscale_fsdp) shard grads or params "
                "per leaf and keep the per-leaf chain"
            )
        # lr=1: the handle's lr enters each step as the optimizer's lr factor
        if fused_eligible and fused_optimizer is not False:
            tx = functools.partial(optim_mod.FusedAdamW, lr=1.0, **kwargs)
        else:
            tx = functools.partial(factory, lr=1.0, **kwargs)
        ddp_config = self._find_config(DDPConfig) or DDPConfig()
        state = create_train_state(model, tx, mesh, self.policy, device=self.device,
                                   find_unused_parameters=ddp_config.find_unused_parameters)
        self._state = state
        self._module, self._wrapped, self._opt = state.module, state.model, state.tx
        self._accepts_train = "train" in inspect.signature(self._module.forward).parameters
        oss_config = self._find_config(FairscaleOSSConfig) or FairscaleOSSConfig()
        if (oss_config.broadcast_fp16 and self.policy.shard_opt_state
                and shard_axis(mesh) is not None):
            # OSS broadcast_fp16 (JAX facade._update_wire_dtype): the
            # sharded update fans out to every rank in bf16
            self._opt.update_wire_dtype = torch.bfloat16
        self._opt_handle = optim_mod.OptimizerHandle(base_lr)

        # the TPUConfig fields the keywords leave at their defaults
        telemetry, trace_dir = telemetry or tpu.telemetry, trace_dir or tpu.trace_dir
        numerics = numerics or tpu.numerics
        numerics_action = numerics_action if numerics_action != "halt" else tpu.numerics_action
        opcost, capture = opcost or tpu.opcost, capture or tpu.capture
        capture_dir = capture_dir or tpu.capture_dir
        # span telemetry (env > arguments); export_trace() writes the trace
        self.telemetry, self.trace_dir = _telemetry.telemetry_from_env(telemetry, trace_dir)
        if self.telemetry:
            _telemetry.enable()
        # the numerics plane (env > arguments): the probe's aux of a step's
        # gradients, decoded at the GRAFT_NUMERICS_EVERY cadence
        numerics_on, action = _numerics.numerics_from_env(numerics, numerics_action)
        self.numerics_probe = self.numerics_watchdog = self.numerics_summary = None
        if numerics_on:
            self.numerics_probe = _numerics.NumericsProbe()
            self.numerics_watchdog = _numerics.NumericsWatchdog(action=action)
            self._numerics_layout = _numerics.probe_layout(self._module, self._opt)
            if not isinstance(self._opt, optim_mod.FusedAdamW):
                self._opt.track_updates = True
        self._numerics_every = max(1, int(os.environ.get("GRAFT_NUMERICS_EVERY", "1") or 1))
        self._last_loss = None
        # op-cost attribution and the armed capture (env > arguments)
        self.opcost = _opcost.opcost_from_env(opcost)
        capture_on, capture_dir = _capture.capture_from_env(capture, capture_dir)
        self.capture = self.opcost_result = None
        if capture_on:
            self.capture = _capture.armed(capture_dir, self._ingest if self.opcost else None)

        self._fused = self._fused_graph = None  # fused_step's TrainStep and graph, at first use
        self._backward_count = 0
        self._step_count = 0
        # the deferred window (JAX facade.py:941-953): recorded micro-batches
        # (inputs, targets, loss handle, output handle), the handles not yet
        # materialized, and whether a split-path micro-batch has written .grad
        self._pending_micro: list = []
        self._pending_lazies: list = []
        self._accumulated = 0
        self._lazy_output = self._lazy_loss = None
        self._last_inputs = self._last_targets = None
        self._out_meta: dict = {}  # input signature -> the forward's (shape, dtype)
        # the programs' device scalars: the step counter (the probe's
        # injection) and the 0.98-decay loss monitor with its "has a value"
        # flag, updated in place by every program
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._ema = torch.zeros((), dtype=torch.float32, device=self.device)
        self._has_ema = torch.zeros((), dtype=torch.bool, device=self.device)
        self._ema_seen = False
        # the one layout whose programs run uncaptured
        self.graph_refusal = None
        per_leaf = not isinstance(self._opt, optim_mod.FusedAdamW)
        if per_leaf and self._opt.offloaded_params:
            self.graph_refusal = (
                "a per-leaf optimizer's offloaded parameters live on the host between "
                "programs, where the graphs' device grad buffers cannot be bound to them; "
                "FusedAdamW keeps its grads bound and captures")
        # per-leaf grads in buffers of the facade's own, bound before every
        # program, so the window and the split path's graphs write the same
        # ones (the optimizer drops .grad between steps)
        self._grad_bufs = ([torch.zeros_like(p) for p in self._opt.params]
                           if per_leaf and self.graph_refusal is None else None)
        self._graphs: dict = {}  # (program, input signature) -> StepGraph
        self._pool = None  # the graphs' shared memory pool (StepGraph's rule holds)
        self._uncaptured = False
        self._ema_host = None
        self._ema_event = None
        self._ema_shown: float | None = None
        self._loaders: list = []  # weak references to the loaders built here, in order
        self._loader_epochs: list[int] = []  # restored epochs, for loaders built later
        if self.verbose:
            n = sum(p.numel() for p in self._module.parameters())
            self.print_on_devices(
                f"Stoke[{self.device.type}]: {type(self._module).__name__} {n / 1e6:.2f}M "
                f"params, precision={self.fp16 or 'fp32'}, accum={self.grad_accum_steps}"
            )
            if self.graph_refusal is not None and self.device.type == "cuda":
                self.print_on_devices(f"the deferred window runs uncaptured: {self.graph_refusal}")

    def _find_config(self, cls):
        return next((c for c in self._configs if isinstance(c, cls)), None)

    def init(self, sample_input=None) -> "Stoke":
        """Parity with the JAX facade, which builds params from a sample; a
        torch module has its parameters from construction."""
        return self

    # -- training surface --------------------------------------------------

    def _autocast(self):
        return self.precision.autocast(self.device)

    def model(self, inputs):
        """The forward under the precision policy; f32 outputs. In training
        mode it is deferred (JAX ``facade.py:1249-1269``): the inputs are
        copied into a tensor of the facade's own and a handle comes back,
        which the program of its micro-batch resolves, or which runs the
        forward program when used before that. In eval mode
        (``model_access.eval()``) its own program runs now (JAX's
        ``_jit_fwd(train=False)``), a graph on the card as every program."""
        if not self._module.training:
            x = self._last_inputs = _as_tensor(inputs, self.device)
            return self._run("Stoke.model", "eval_forward", x)
        with _telemetry.bucket_dispatch_span(self, "Stoke.model", None):
            x = self._last_inputs = _owned(inputs, self.device)
            lazy = self._lazy_output = _LazyOutput(self, x)
            self._pending_lazies.append(weakref.ref(lazy))
            return lazy

    def loss(self, outputs, targets):
        """The loss in f32, outside autocast; feeds the EMA monitor.
        Deferred on a pending output: ``.backward()`` records it and its
        micro-batch's program computes it."""
        y = self._last_targets = _owned(targets, self.device)
        if isinstance(outputs, _LazyOutput) and outputs._value is None:
            lazy = self._lazy_loss = _LazyLoss(self, outputs, y)
            return lazy
        return self._materialize_loss(outputs, y)

    def backward(self, loss=None):
        """Record the micro-batch of the last ``.model()``/``.loss()`` for
        the window's program (``fuse_eager_step``), or run its forward,
        loss and backward now through the split path, which accumulates
        ``loss / grad_accum_steps`` (times the loss scale under
        ``fp16='amp'``) into ``.grad``. The gradients come from the
        programs, as in JAX (``facade.py:1315-1351``): ``loss`` is taken
        for parity and comes back when it is not the deferred one."""
        if self._last_inputs is None or self._last_targets is None:
            raise RuntimeError(
                "backward() needs a preceding model(inputs) and loss(outputs, targets)")
        lazy_loss = loss if isinstance(loss, _LazyLoss) else self._lazy_loss
        record = (self._last_inputs, self._last_targets, lazy_loss, self._lazy_output)
        self._lazy_loss = self._lazy_output = None
        with _telemetry.bucket_dispatch_span(self, "Stoke.backward", None):
            if self.fuse_eager_step:
                self._pending_micro.append(record)
                value = lazy_loss if lazy_loss is not None else loss
            else:
                value = self._backward_now(*record)
        self._backward_count += 1
        return value

    def zero_grad(self):
        """Drop the accumulated gradients and the deferred micro-batches
        and restart the accumulation window (the raw loop's
        ``optimizer.zero_grad()``, ``Fairscale-DDP.py:97``); a dropped
        handle still materializes."""
        self._opt.zero_grad()
        self._backward_count = self._accumulated = 0
        self._pending_micro = []

    def step(self):
        """Optimizer step on every ``grad_accum_steps``-th call. A window
        whose micro-batches are all deferred runs as one program (forward,
        loss and backward of each, then the update); otherwise the pending
        ones go through the split path and the update runs alone (JAX
        ``facade.py:1399-1435``). On the card each program is a captured
        CUDA graph. Under ``fp16='amp'`` a non-finite gradient skips the
        update, gated on the device (no read of the flag on the host)."""
        if self._backward_count == 0 or self._backward_count % self.grad_accum_steps:
            return
        window = (self._pending_micro and not self._accumulated
                  and len(self._pending_micro) == self.grad_accum_steps)
        if window:
            out = self._step_window()
        else:
            self._flush_pending_micros()
            self._materialize_pending()
            out = self._run("Stoke.step", "apply", ())
        self._opt.zero_grad()
        self._backward_count = self._accumulated = 0
        self._step_count += 1
        if "aux" in out and self._step_count % self._numerics_every == 0:
            self._observe_numerics(out["aux"])
        if self.capture is not None:
            self.capture.note_step()

    # -- the deferred window's programs -----------------------------------------

    def _step_window(self) -> dict:
        """The whole window as one program (JAX ``_step_fused``); its
        handles take their values from the program's outputs."""
        window, self._pending_micro = self._pending_micro, []
        ids = {id(h) for rec in window for h in rec[2:] if h is not None}
        self._materialize_pending(skip=ids)
        out = self._run("Stoke.step", "window", tuple((x, y) for x, y, _, _ in window))
        for (x, _, lazy_loss, lazy_out), loss, pred in zip(window, out["losses"], out["outs"]):
            self._resolve(x, lazy_loss, lazy_out, loss, pred)
        return out

    def _backward_now(self, x, y, lazy_loss=None, lazy_out=None) -> torch.Tensor:
        """One micro-batch through the split path: the first program of a
        window (``.grad`` zeroed first) or the one that accumulates."""
        kind = "acc" if self._accumulated else "first"
        out = self._run("Stoke.backward", kind, (x, y))
        self._accumulated += 1
        self._resolve(x, lazy_loss, lazy_out, out["loss"], out["out"])
        self._pending_lazies = [r for r in self._pending_lazies
                                if r() is not None and r()._value is None]
        return out["loss"]

    def _resolve(self, x, lazy_loss, lazy_out, loss, pred) -> None:
        """Give a micro-batch's handles the program's values; one already
        read keeps its value."""
        self._out_meta[signature(x)] = (pred.shape, pred.dtype)
        if lazy_loss is not None and lazy_loss._value is None:
            lazy_loss._value = loss
        if lazy_out is not None and lazy_out._value is None:
            lazy_out._value = pred

    def _flush_pending_micros(self) -> None:
        """The deferred micro-batches through the split path (odd call
        patterns, a loss read inside its window)."""
        window, self._pending_micro = self._pending_micro, []
        for record in window:
            self._backward_now(*record)

    def _materialize_pending(self, skip=()) -> None:
        """Materialize every pending output handle but those of ``skip``
        (ids): the update is about to change the parameters in place."""
        for ref in self._pending_lazies:
            lazy = ref()
            if lazy is not None and lazy._value is None and id(lazy) not in skip:
                lazy.materialize()
        self._pending_lazies = []

    def _before_load(self) -> None:
        """A load writes the parameters (and the optimizer's state, maybe
        into new tensors): pending handles are materialized first, and the
        programs' graphs, which hold the old tensors' addresses, go (the
        next call captures anew)."""
        self._materialize_pending()
        self._graphs.clear()
        self._pool = self._fused = self._fused_graph = None

    def _materialize_lazy_loss(self, lazy: _LazyLoss) -> torch.Tensor:
        """A deferred loss read early (JAX ``facade.py:1285-1297``): inside
        a pending window, the window is flushed through the split path,
        which computes it on the way; else the forward program and the
        loss program run (JAX's ``_jit_fwd`` and ``_jit_loss``)."""
        if any(rec[2] is lazy for rec in self._pending_micro):
            self._flush_pending_micros()
            return lazy._value
        return self._materialize_loss(lazy._output, lazy._targets)

    def _materialize_loss(self, outputs, targets) -> torch.Tensor:
        """The loss program on a materialized output (JAX ``_jit_loss``)."""
        return self._run("Stoke.loss", "loss", (_materialized(outputs), targets))["loss"]

    def _forward_now(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward of a handle read alone: the forward
        program (JAX's ``_jit_fwd``)."""
        out = self._run("Stoke.model", "forward", x)
        self._out_meta[signature(x)] = (out.shape, out.dtype)
        return out

    def _run(self, span: str, kind, inputs, fn: Callable | None = None):
        """Program ``kind`` (``fn``, or the facade's program of that name)
        on ``inputs`` through its ``StepGraph`` (one per input signature): a
        replay on the card (the first call captures, billed as the span's
        ``compile``), the function itself on the CPU, on a layout
        :attr:`graph_refusal` names, and inside :meth:`uncaptured`."""
        key = (kind, signature(inputs))
        graph = self._graphs.get(key)
        if graph is None:
            fn = fn or {"window": self._window_program, "first": self._first_program,
                        "acc": self._micro_program, "apply": self._apply_program,
                        "forward": self._forward_program, "loss": self._loss_program,
                        "eval_forward": self._eval_forward_program}[kind]
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            graph = self._graphs[key] = StepGraph(self, fn, capture=self.graph_refusal is None,
                                                  pool=self._pool)
        with _telemetry.bucket_dispatch_span(self, span, key):
            out = graph.eager(inputs) if self._uncaptured else graph(inputs)
        if isinstance(out, dict) and "last" in out:  # a program that folds the loss monitor
            self._last_loss, self._ema_seen = out["last"], True
        return out

    @contextlib.contextmanager
    def uncaptured(self):
        """Run the facade's programs (the deferred window's, the early
        reads' and the eval ones) uncaptured on the card inside this
        block: the same functions the graphs captured, the graphs' eager
        twin for a bitwise check."""
        saved, self._uncaptured = self._uncaptured, True
        try:
            yield self
        finally:
            self._uncaptured = saved

    def _zero_grads(self) -> None:
        if self._grad_bufs is None:
            self._opt.zero_grad()
        else:
            torch._foreach_zero_(self._grad_bufs)

    def _micro(self, x, y) -> tuple:
        """A micro-batch's forward under autocast, its f32 loss outside
        it, ``(loss / accum · scale).backward()`` into ``.grad`` and the
        loss monitor's fold, as the eager loop ran them. The module runs
        without a ``DistributedDataParallel`` wrapper (``parallel.step.
        unwrapped``): the update all-reduces the grads once, so no
        micro-batch syncs."""
        kw = {"train": True} if self._accepts_train else {}
        self._opt.params_in()  # offloaded parameters: the update writes them back
        with torch.enable_grad():
            with self._autocast():
                out = self._module(x, **kw)
            out = out.float()
            loss = self._loss_callable(out, y)
            scaled = loss / self.grad_accum_steps
            if self.loss_scaler is not None:
                scaled = self.loss_scaler.scale_loss(scaled)
            scaled.backward()
        loss = loss.detach()
        return loss, out.detach(), self._fold_ema(loss)

    def _window_program(self, micros) -> dict:
        """JAX's ``eager_step``: every micro-batch's forward, loss and
        backward, then the update."""
        self._zero_grads()
        losses, outs, last = [], [], None
        for x, y in micros:
            loss, out, last = self._micro(x, y)
            losses.append(loss)
            outs.append(out)
        return {"losses": losses, "outs": outs, "last": last, **self._apply_program(())}

    def _first_program(self, batch) -> dict:
        """The split path's first micro-batch of a window (JAX
        ``_jit_loss_grad`` + ``_jit_acc_first``): ``.grad`` zeroed, then
        written."""
        self._zero_grads()
        return self._micro_program(batch)

    def _micro_program(self, batch) -> dict:
        """A micro-batch that accumulates into ``.grad`` (JAX ``_jit_acc``)."""
        loss, out, last32 = self._micro(batch[0], batch[1])
        self._opt.release_params()  # no update here: the next program streams them again
        return {"loss": loss, "out": out, "last": last32}

    def _apply_program(self, _inputs) -> dict:
        """The update (JAX ``_jit_apply``), with the probe's aux."""
        aux = self._update()
        return {} if aux is None else {"aux": aux}

    @torch.no_grad()
    def _forward_program(self, x) -> torch.Tensor:
        """The training forward of a handle read alone (JAX ``_jit_fwd``),
        its f32 output; BatchNorm's statistics are put back after it, since
        the micro-batch's program updates them (JAX discards the forward's
        state)."""
        state = batch_norm_state(self._module)
        kept = [t.clone() for t in state]
        kw = {"train": True} if self._accepts_train else {}
        with self._autocast(), self._opt.params_on_device():
            out = self._module(x, **kw).float()
        reshard(self._module)
        if state:
            torch._foreach_copy_(state, kept)
        return out

    @torch.no_grad()
    def _loss_program(self, batch) -> dict:
        """The loss of a materialized output (JAX ``_jit_loss``), folded
        into the loss monitor."""
        loss = self._loss_callable(batch[0], batch[1])
        return {"loss": loss, "last": self._fold_ema(loss.detach())}

    @torch.no_grad()
    def _eval_forward_program(self, x) -> torch.Tensor:
        """Eval-mode ``.model`` (JAX ``_jit_fwd(train=False)``): the
        running statistics are read, nothing is written."""
        kw = {"train": False} if self._accepts_train else {}
        with self._autocast(), self._opt.params_on_device():
            out = self._module(x, **kw).float()
        reshard(self._module)
        return out

    def _update(self) -> dict | None:
        """The optimizer update of one step (the lr factor and the step
        counter written by :meth:`prepare`); with the numerics probe, its
        aux of the step, every step (decoded at the probe's cadence)."""
        fused = isinstance(self._opt, optim_mod.FusedAdamW)
        scaler = self.loss_scaler
        # the global batch's gradient (backward already divided by accum; a
        # DDP layout's module ran without its wrapper)
        grads = reduce_gradients(self._opt, self.policy, self._group, all_reduce=True)
        probe = self.numerics_probe
        names = None if probe is None else self._numerics_layout["names"]
        if fused:
            # the scaler's flag gates the update on the device
            leaf_grads = [p.grad for p in self._opt.params]
            if probe is not None:
                probe.inject(leaf_grads, self._step_t, names)
            pnorm = _numerics.leaf_norms(self._opt.params) if probe is not None else None
            gnorm, finite = self._opt.apply_tree(scaler=scaler)
            shard, unorms = None, None
        else:
            finite = None
            if scaler is not None:
                grads = scaler.unscale(grads)
            if probe is not None:
                probe.inject(grads, self._step_t, names)
            if scaler is not None:  # every rank's shares: one overflow skips everywhere
                finite = all_finite(scaler.grads_finite(grads), self._group)
            pnorm = _numerics.leaf_norms(self._opt.local) if probe is not None else None
            self._opt.update_norms = None
            gnorm = self._opt.step(grads, gate=finite)
            leaf_grads, shard, unorms = grads, self._opt.shard, self._opt.update_norms
        if scaler is not None:
            scaler.update(finite)
        if probe is None:
            return None
        if gnorm is None:
            gnorm = self._opt.norm(grads)
        return probe.aux(leaf_grads, param_norms=pnorm, update_norms=unorms, grad_norm=gnorm,
                         shard=shard, **self._numerics_layout)

    # the StepGraph owner (parallel.graph.GraphOwner)

    def prepare(self) -> None:
        """The programs' host values, written before each call: the lr
        factor, the step counter and the per-leaf grad buffers' binding."""
        self._opt.set_lr_factor(self._opt_handle.lr)
        self._step_t.fill_(self._step_count)
        self._opt.release_params()
        if self._grad_bufs is not None:
            for p, g in zip(self._opt.params, self._grad_bufs):
                p.grad = g

    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a program writes: the parameters (``FusedAdamW``'s
        flat buffer), the model's buffers, the optimizer's and the loss
        scaler's state, the grads and the loss monitor."""
        fused = isinstance(self._opt, optim_mod.FusedAdamW)
        params = [] if fused else list(self._opt.params)
        grads = [self._opt.flat_grad] if fused else list(self._grad_bufs or [])
        scaler = [] if self.loss_scaler is None else self.loss_scaler.state_tensors()
        return (params + list(self._module.buffers()) + self._opt.state_tensors() + scaler
                + grads + [self._ema, self._has_ema])

    def state_snapshot(self) -> list[torch.Tensor]:
        self._opt.settle()
        with torch.no_grad():
            return [t.clone() for t in self._state_tensors()]

    def restore_state(self, snapshot: list) -> None:
        self._opt.settle()
        with torch.no_grad():
            for t, v in zip(self._state_tensors(), snapshot):
                t.copy_(v)

    def bound_grads(self) -> list:
        return []  # prepare binds the facade's own buffers

    def _observe_numerics(self, aux: dict) -> None:
        """Decode a step's numerics aux and feed the watchdog; a ``halt``
        verdict raises ``NumericsDivergence`` (JAX ``_observe_numerics``).
        ``rollback``/``degrade`` verdicts stay on ``numerics_watchdog.
        tripped``: the facade has no checkpoint manager to roll back through."""
        self.numerics_summary = summary = self.numerics_probe.observe(
            aux, step=self._step_count, loss=self._last_loss, watchdog=self.numerics_watchdog)
        verdict = summary.get("verdict")
        if verdict is not None and verdict.get("action") == "halt":
            self.numerics_watchdog.apply_action(verdict)

    def _ingest(self, cap_dir: str, source: str) -> None:
        """The capture's post-fire hook: the op table and, with a mesh, the
        per-axis collective bandwidth of the capture (on the card, a capture
        without device activity raises here; the capture swallows it)."""
        self.opcost_result = None
        self.opcost_result = _opcost.ingest_trace(
            cap_dir, mesh_axes=None if self.mesh is None else mesh_shape(self.mesh),
            steps=self.capture.capture_steps, device=self.device.type)

    # -- the one-call step ---------------------------------------------------

    def _fused_step_runner(self):
        """The ``TrainStep`` of :meth:`fused_step` and its graph runner,
        built at the first call."""
        if self._fused is None:
            kw = {"train": True} if self._accepts_train else {}

            def loss_fn(model, batch):
                x, y = batch
                with self._autocast():
                    out = model(x, **kw)
                return self._loss_callable(out.float(), y), {}

            step = TrainStep(self._wrapped, loss_fn, self._opt, self.mesh, self.policy,
                             grad_accum_steps=self.grad_accum_steps, rng=StepRng(0),
                             numerics=self.numerics_probe, loss_scaler=self.loss_scaler)
            self._fused = step
            self._fused_graph = StepGraph(step, step.program)
        return self._fused, self._fused_graph

    def fused_step(self, inputs, targets) -> dict:
        """One optimizer step of the batch ``(inputs, targets)`` (split into
        ``grad_accum_steps`` micro-batches) as one program: on the card a
        replay of the captured graph of forward, backward, accumulation,
        scaler, clip and update (JAX's ``fused_step``). Returns the metrics
        dict (``loss``, ``grad_norm``, ``loss_scale`` under ``fp16='amp'``,
        ``numerics`` with the probe), device tensors. Gradients of an open
        Stoke-style accumulation window are dropped first, and the step
        leaves none behind, as :meth:`step` does."""
        step, graph = self._fused_step_runner()
        batch = (_as_tensor(inputs, self.device), _as_tensor(targets, self.device))
        self.zero_grad()
        self._materialize_pending()  # the update changes the parameters in place
        step.rng.step = self._step_count  # the probe's injection counts optimizer steps
        with _telemetry.bucket_dispatch_span(self, "Stoke.fused_step", None):
            metrics = graph(batch, self._opt_handle.lr)
        self._opt.zero_grad()
        self._step_count += 1
        self._note_loss(metrics["loss"])
        if "numerics" in metrics and self._step_count % self._numerics_every == 0:
            self._observe_numerics(metrics["numerics"])
        if self.capture is not None:
            self.capture.note_step()
        return metrics

    def detach_and_sync_loss(self, loss):
        """The loss as a detached device scalar, averaged over ranks; a
        deferred loss is materialized (inside its window: the window goes
        through the split path)."""
        loss = _materialized(loss).detach()
        loss = loss.mean() if loss.dim() else loss
        return mean_over_ranks({"loss": loss}, self._group)["loss"]

    def eval_step(self, metric_fns: dict | None = None) -> Callable:
        """``step(inputs, targets) -> {"loss": ..., **metrics}`` of device
        scalars, computed in eval mode (BatchNorm reads its running
        statistics) by one program (JAX's compiled ``EvalStep``; on the
        card a graph per input signature, so a last partial batch is one
        more capture) and averaged over ranks outside it; sum them across
        batches and read once per epoch."""
        metric_fns = dict(metric_fns or {})
        kind = ("eval", tuple((name, id(fn)) for name, fn in metric_fns.items()))

        @torch.no_grad()
        def program(batch) -> dict:
            x, y = batch
            with self._autocast(), self._opt.params_on_device():
                out = self._module(x)
            reshard(self._module)
            out = out.float()
            result = {"loss": self._loss_callable(out, y)}
            for name, fn in metric_fns.items():
                result[name] = fn(out, y)
            return result

        def step(inputs, targets):
            batch = (_as_tensor(inputs, self.device), _as_tensor(targets, self.device))
            training = self._module.training
            self._module.eval()  # JAX's eval step runs train=False: running statistics
            try:
                result = self._run("Stoke.eval_step", kind, batch, program)
            finally:
                self._module.train(training)
            return mean_over_ranks(result, self._group)

        return step

    # -- loss monitor --------------------------------------------------------

    @torch.no_grad()
    def _fold_ema(self, loss: torch.Tensor) -> torch.Tensor:
        """Fold ``loss``'s f32 mean into the 0.98-decay monitor in place, on
        the device (JAX ``facade.py:1204-1210``: the flag tells "no value
        yet" from a NaN one); returns the mean."""
        val = loss.float().mean()
        self._ema.copy_(torch.where(self._has_ema, 0.98 * self._ema + 0.02 * val, val))
        self._has_ema.fill_(True)
        return val

    def _note_loss(self, loss) -> None:
        self._last_loss = self._fold_ema(loss.detach())
        self._ema_seen = True

    def _ema_value(self) -> float:
        """The freshest EMA the device has finished computing. On CUDA the
        copy to the host is asynchronous, so a per-step print never stalls
        the launch queue; the value shown may be one call old. The first
        call waits once."""
        if self.device.type != "cuda":
            return float(self._ema)
        if self._ema_host is None:
            self._ema_host = torch.empty((), dtype=torch.float32, pin_memory=True)
        if self._ema_event is None or self._ema_event.query():
            if self._ema_event is not None:
                self._ema_shown = float(self._ema_host)
            self._ema_host.copy_(self._ema, non_blocking=True)
            self._ema_event = torch.cuda.Event()
            self._ema_event.record()
        if self._ema_shown is None:
            self._ema_event.synchronize()
            self._ema_shown = float(self._ema_host)
        return self._ema_shown

    def print_ema_loss(self, prepend_msg: str = "EMA Loss", rank: int | list | None = 0):
        """This rank's smoothed loss, printed on ``rank`` (Stoke's default,
        rank 0; a list of ranks, or None for all). A deferred loss enters
        the monitor when its program runs, so between ``.loss()`` and
        ``.backward()`` the value is one window behind (JAX
        ``facade.py:2156-2180``)."""
        if self._ema_seen and self.verbose and self._prints(rank):
            print(f"{prepend_msg}: {self._ema_value():.6f}", flush=True)

    # -- data ----------------------------------------------------------------

    def DataLoader(self, dataset, batch_size: int | None = None, sampler=None,
                   num_workers: int = 0, drop_last: bool = True,
                   device_prefetch: int | None = None, **kwargs):
        """Loader bound to the facade's batch size and device; ``drop_last``
        defaults True like the JAX facade's. ``device_prefetch`` batches are
        copied to the device ahead of the step on a side stream (default:
        ``$GRAFT_DEVICE_PREFETCH``, else 2, as in the JAX facade; 0 copies
        each batch when it is taken)."""
        if device_prefetch is None:
            device_prefetch = int(os.environ.get("GRAFT_DEVICE_PREFETCH", "2") or 0)
        loader = _DataLoader(
            dataset,
            batch_size=batch_size or self.batch_size_per_device,
            sampler=sampler,
            num_workers=num_workers,
            drop_last=drop_last,
            device=self.device,
            device_prefetch=device_prefetch,
            **kwargs,
        )
        if len(self._loaders) < len(self._loader_epochs):  # a resume came first
            epoch = self._loader_epochs[len(self._loaders)]
            if epoch >= 0:
                loader.set_epoch(epoch)
        self._loaders.append(weakref.ref(loader))
        return loader

    # -- checkpoints -----------------------------------------------------------

    def _meta(self, extras: dict | None = None) -> dict:
        """What a checkpoint keeps besides the train state: the step, the
        micro-batches of an open accumulation window, the lr, the loss
        scaler, the loss monitor's EMA, the generators (:meth:`load` says
        which) and the loaders' epochs."""
        rng = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {
            "step": self._step_count,
            "lr": self._opt_handle.lr,
            "backward_count": self._backward_count,
            "scaler": None if self.loss_scaler is None else self.loss_scaler.state_dict(),
            "ema_loss": float(self._ema) if self._ema_seen else None,
            "rng": rng,
            "loader_epochs": [-1 if (dl := ref()) is None else dl.epoch
                              for ref in self._loaders],
            **(extras or {}),
        }

    def _restore_meta(self, meta: dict) -> dict:
        """Put :meth:`_meta`'s values back; returns ``meta``."""
        self._step_count = int(meta.get("step", 0))
        self._backward_count = int(meta.get("backward_count", 0))
        self._opt_handle.lr = float(meta.get("lr", self._opt_handle.lr))
        if self.loss_scaler is not None and meta.get("scaler") is not None:
            self.loss_scaler.load_state_dict(meta["scaler"])
        ema = meta.get("ema_loss")
        self._ema_seen = ema is not None
        self._ema.fill_(0.0 if ema is None else float(ema))
        self._has_ema.fill_(self._ema_seen)
        self._ema_event = self._ema_shown = None
        rng = meta.get("rng") or {}
        if "cpu" in rng:
            torch.set_rng_state(torch.as_tensor(rng["cpu"], dtype=torch.uint8))
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(torch.as_tensor(rng["cuda"], dtype=torch.uint8),
                                     self.device)
        epochs = meta.get("loader_epochs")
        self._loader_epochs = ([] if epochs is None else
                               [int(e) for e in torch.as_tensor(epochs).reshape(-1)])
        for ref, epoch in zip(self._loaders, self._loader_epochs):
            if (dl := ref()) is not None and epoch >= 0:
                dl.set_epoch(epoch)
        if self.verbose:
            self.print_on_devices(f"restored checkpoint @ step {self._step_count}")
        return meta

    def save(self, path: str = "./", name: str = "checkpoint", extras: dict | None = None):
        """Write ``{path}/{name}.pt`` -> ``(full_path, tag)``: params and
        buffers (BatchNorm statistics), optimizer state (``FusedAdamW``'s
        with its flat layout), the metadata :meth:`load` restores, and
        ``extras``. Every rank calls it: sharded parameters and state are
        gathered into the layout of a one-rank run, rank 0 writes, and all
        wait for the file at a barrier, so a checkpoint loads at any world
        size. Save at a step boundary: the gradients of an open
        accumulation window are not kept."""
        trees = self._state.state_dict(self._meta(extras))
        if self.rank == 0:
            out = ckpt.save_checkpoint(path, name, trees)
        else:
            out = os.path.join(path, f"{name}.pt"), f"{name}.pt"
        dist.coordination_barrier(f"save {name}")
        return out

    def load(self, path: str) -> dict:
        """Restore everything :meth:`save` wrote (the resume path): the
        parameters and buffers, the optimizer state (re-sliced onto this
        rank's share, at any world size), the step, the micro-batch count,
        the lr, the loss scaler, the 0.98-EMA loss monitor, the generators
        and the loaders' epochs. The generators are the process's default
        CPU generator (``torch.get_rng_state``) and the facade device's
        CUDA generator, which augmentations drawn with ``torch.rand*``
        consume; the port's own data order and ``PairedRandomAug`` draws
        follow from each loader's epoch (with the sampler's seed), which
        comes back for every loader built through :meth:`DataLoader`, in
        the order they were built, also for those built after the load.
        Every rank calls it. Returns the metadata, ``extras`` included."""
        self._before_load()
        meta = self._state.load_state_dict(ckpt.load_file(path))
        return self._restore_meta(meta)

    def save_sharded(self, path: str) -> str:
        """Every rank writes its own shards of the whole train state into
        the directory ``path`` (``checkpoint_sharded.save_sharded``, over
        ``torch.distributed.checkpoint``): nothing is gathered onto one
        rank."""
        from ..checkpoint_sharded import save_sharded

        return save_sharded(path, self._state, self._meta())

    def load_sharded(self, path: str) -> dict:
        """Restore a :meth:`save_sharded` checkpoint into the live state, in
        place, under this policy (the optimizer must be of the kind that
        saved it). Returns the metadata."""
        self._before_load()
        from ..checkpoint_sharded import restore_sharded

        return self._restore_meta(restore_sharded(path, self._state))

    def save_portable(self, path: str, *, step: int | None = None,
                      extras: dict | None = None) -> str:
        """The whole train state in the portable format (a manifest, one
        payload a rank, a commit marker), which :meth:`load_resharded`
        restores under another policy or world size. Every rank calls it."""
        from ..checkpoint_sharded import save_portable

        return save_portable(path, self._state, self._meta(extras),
                             step=self._step_count if step is None else step)

    def load_resharded(self, path: str) -> dict:
        """Restore a :meth:`save_portable` checkpoint into the live state,
        re-placing every leaf (parameters and optimizer moments) onto this
        run's layout: the N-to-M resume. Returns the metadata."""
        self._before_load()
        from ..checkpoint_sharded import restore_portable

        return self._restore_meta(restore_portable(path, self._state))

    def load_model_state(self, source, strict: bool = True, param_key: str = "params"):
        """Load weights from a ``.pt``/``.pth``/``.safetensors`` path or a
        state dict, optionally nested under ``param_key``; strict matching
        by default. A ``.pth`` or ``.safetensors`` file is read as
        ``interop.load_torch_checkpoint`` reads it (a state dict, or one
        under ``param_key`` or a usual wrapper key), so official SwinIR
        files of all three tails load as they are: the port's module names
        are the official ones. Under FSDP2 each rank copies its own
        first-dimension chunk."""
        self._before_load()
        if isinstance(source, str):
            if source.endswith((".pth", ".safetensors")):
                from ..interop import load_torch_checkpoint

                source = load_torch_checkpoint(source, key=param_key)
            else:
                source = ckpt.load_file(source)
        load_module_state(self._module, source[param_key] if param_key in source else source,
                          strict=strict)

    def serve(self, **overrides):
        """A serving engine over the live parameters (``serve/``): GPT-2
        gets the continuous-batching ``ServeEngine``, SwinIR the
        ``SwinIRTileServer`` (its forward under the facade's precision).
        The parameters are snapshotted (gathered from their shards), so
        later training steps do not reach the engine. The ``GRAFT_SERVE_*``
        env knobs fill what ``overrides`` leaves out, then
        ``TPUConfig.serve_spec_k`` (JAX's ``_serve_fastpath_overrides``);
        the engine runs on the facade's device unless ``device=`` says
        otherwise."""
        from ..models.swinir import SwinIR
        from ..serve import build_engine

        sharded = any(is_dtensor(v) for v in self._module.state_dict().values())
        if sharded and isinstance(self._module, SwinIR):
            raise NotImplementedError(
                "Stoke.serve of a ZeRO-3 (fairscale_fsdp) SwinIR is not ported yet: serve "
                "the checkpoint Stoke.save writes through serve.build_engine")
        params = {k: (v.full_tensor() if is_dtensor(v) else v).detach().clone()
                  for k, v in self._module.state_dict().items()}
        overrides = _serve_fastpath_overrides(self.tpu_config, overrides)
        overrides.setdefault("device", self.device)
        if isinstance(self._module, SwinIR):
            overrides.setdefault("compute_dtype", self.precision.compute_dtype)
        return build_engine(self._module, params, **overrides)

    # -- introspection and rank I/O ---------------------------------------------

    @property
    def world_size(self) -> int:
        return dist.world_size()

    @property
    def rank(self) -> int:
        return dist.rank()

    @property
    def optimizer(self) -> optim_mod.OptimizerHandle:
        return self._opt_handle

    @property
    def model_access(self) -> torch.nn.Module:
        return self._module

    @property
    def step_count(self) -> int:
        return self._step_count

    @property
    def state(self) -> TrainState:
        """The train state: the model as the step calls it, the module, the
        optimizer, the mesh and the policy (``state.state_dict()`` is what
        :meth:`save` writes, without the facade's metadata)."""
        return self._state

    @property
    def ema_params(self) -> dict[str, torch.Tensor] | None:
        """The params EMA as ``{name: tensor}`` in each parameter's dtype
        (load it with ``model_access.load_state_dict(ema, strict=False)``),
        or None when no EMA is kept; ``optimizer_kwargs={"ema_decay":
        0.999}`` turns it on, for the fused and the per-leaf optimizer
        alike. A sharded EMA is gathered whole: every rank calls it."""
        ema = optim_mod.ema_params(self._opt, self._opt.params)
        return None if ema is None else dict(zip(self._opt.names, ema))

    def barrier(self):
        """Every rank waits here (a no-op without a process group)."""
        dist.coordination_barrier("stoke")

    def export_trace(self, path: str | None = None) -> str | None:
        """Write the recorded telemetry spans (``observe.trace``) as Chrome
        trace-event JSON. Destination: ``path``, else ``trace_dir`` (from
        the constructor or ``GRAFT_TRACE``; a ``.json`` path is the file
        itself), else the run dir, as ``telemetry-<pid>.trace.json``.
        Returns the path, or None when telemetry was never enabled (nothing
        to export is not an error)."""
        if not _telemetry.enabled() and not _telemetry.records():
            return None
        return _telemetry.export_chrome_trace(path or _telemetry.trace_path(self.trace_dir))

    def _prints(self, rank) -> bool:
        return rank is None or self.rank in (rank if isinstance(rank, (list, tuple)) else [rank])

    def print_on_devices(self, msg: str = "", rank: int | list | None = 0):
        """Rank-stamped print on ``rank`` (Stoke's default, rank 0; a list
        of ranks, or None for all)."""
        if self._prints(rank):
            print(f"[rank {self.rank}/{self.world_size}] {msg}", flush=True)

