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

The Stoke-style loop runs eagerly: the JAX facade's deferred handles,
which fuse a ``.model -> .loss -> .backward -> .step`` window into one
program, wait for the graphed-window slice. ``.model`` runs the forward
under the precision policy's autocast, ``.backward`` accumulates ``loss /
grad_accum_steps`` into ``.grad``, and ``.step`` fires the optimizer on
every ``grad_accum_steps``-th call (Stoke semantics; ``facade.py:1399-1435``
in the JAX package), with the lr read from :attr:`optimizer` at that
moment. Nothing in the hot loop waits for the device except an explicit
read of a loss. ``.model`` runs in the module's mode: a BatchNorm model
trains on batch statistics and updates its running statistics in place
from one micro-batch to the next, as the JAX facade threads
``model_state``; after ``model_access.eval()``, and always in
:meth:`eval_step`, it reads the running statistics.

Device and ranks: the facade runs on ``device`` (``"cuda"`` by default,
the process's card under a launcher; it raises when no CUDA device exists
unless ``device="cpu"`` was asked for). The flags map onto a policy
through ``parallel.policy_from_flags``, as in JAX: ``fairscale_fsdp`` is
ZeRO-3, ``fairscale_sddp`` ZeRO-2, ``fairscale_oss`` ZeRO-1, else DDP.
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
zeroed (or dropped) afterwards, as :meth:`step` does. Under ZeRO-3
(``fairscale_fsdp``), and on a DDP layout with a per-leaf optimizer
(``fused_optimizer=False``: a ``DistributedDataParallel`` wrapper), it
raises (``parallel.step.refuse_capture`` says why).
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
from ..parallel.state import TrainState, create_train_state, load_module_state
from ..parallel.graph import StepGraph
from ..parallel.rng import StepRng
from ..parallel.step import (TrainStep, all_finite, mean_over_ranks, reduce_gradients,
                             refuse_capture)
from ..precision import DynamicLossScaler, Policy
from ..runtime import dist
from ..runtime.mesh import MeshSpec, data_group, make_mesh, mesh_shape
from .config import (AMPConfig, ClipGradConfig, ClipGradNormConfig, DDPConfig,
                     DistributedOptions, FairscaleOSSConfig, FP16Options, TPUConfig)
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
    ):
        distributed = distributed.value if isinstance(distributed, DistributedOptions) else distributed
        if distributed not in (None, "ddp"):
            raise NotImplementedError(
                f"distributed={distributed!r} is not ported (DeepSpeed and Horovod have no "
                "counterpart in the port); use 'ddp'")
        self._configs = list(configs or [])
        self.tpu_config = tpu = (self._find_config(TPUConfig) or TPUConfig()).check()
        self.policy = policy_from_flags(distributed, fairscale_oss, fairscale_sddp,
                                        fairscale_fsdp, remat=_remat_from_env(tpu.remat))
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
        amp_config = self._find_config(AMPConfig) or AMPConfig()

        fp16 = fp16.value if isinstance(fp16, FP16Options) else fp16
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
        self._ema = None  # 0.98-decay loss monitor, a device scalar
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
        """Forward pass under the precision policy; f32 outputs. In eval
        mode (``model_access.eval()``) no graph is kept."""
        x = _as_tensor(inputs, self.device)
        training = self._module.training
        if training and hasattr(self._wrapped, "require_backward_grad_sync"):
            # DDP's no_sync for all but the last micro-batch of a step
            last = (self._backward_count + 1) % self.grad_accum_steps == 0
            self._wrapped.require_backward_grad_sync = last
        grad = torch.enable_grad() if training else torch.no_grad()
        kw = {"train": training} if self._accepts_train else {}
        with _telemetry.bucket_dispatch_span(self, "Stoke.model", None), grad, self._autocast():
            out = self._wrapped(x, **kw)
        return out.float()

    def loss(self, outputs, targets):
        """The loss in f32, outside autocast; feeds the EMA monitor."""
        loss = self._loss_callable(outputs, _as_tensor(targets, self.device))
        self._note_loss(loss)
        return loss

    def backward(self, loss):
        """Accumulate ``loss / grad_accum_steps`` (times the loss scale under
        ``fp16='amp'``) into the parameters' ``.grad``."""
        scaled = loss / self.grad_accum_steps
        if self.loss_scaler is not None:
            scaled = self.loss_scaler.scale_loss(scaled)
        with _telemetry.bucket_dispatch_span(self, "Stoke.backward", None):
            scaled.backward()
        self._backward_count += 1
        return loss

    def zero_grad(self):
        """Drop the accumulated gradients and restart the accumulation
        window (the raw loop's ``optimizer.zero_grad()``,
        ``Fairscale-DDP.py:97``)."""
        self._opt.zero_grad()
        self._backward_count = 0

    def step(self):
        """Optimizer step on every ``grad_accum_steps``-th call. Under
        ``fp16='amp'`` a non-finite gradient skips the update, gated on the
        device (no read of the flag on the host)."""
        if self._backward_count == 0 or self._backward_count % self.grad_accum_steps:
            return
        with _telemetry.bucket_dispatch_span(self, "Stoke.step", None):
            aux = self._update()
        self._opt.zero_grad()
        self._backward_count = 0
        self._step_count += 1
        if aux is not None:
            self._observe_numerics(aux)
        if self.capture is not None:
            self.capture.note_step()

    def _update(self) -> dict | None:
        """The optimizer update of one step; the numerics probe's aux on a
        step it decodes, else None."""
        fused = isinstance(self._opt, optim_mod.FusedAdamW)
        scaler = self.loss_scaler
        # the global batch's gradient (backward already divided by accum)
        grads = reduce_gradients(self._opt, self.policy, self._group)
        probe = self.numerics_probe
        observe = probe is not None and (self._step_count + 1) % self._numerics_every == 0
        self._opt.set_lr_factor(self._opt_handle.lr)
        if fused:
            # the scaler's flag gates the update on the device
            leaf_grads = [p.grad for p in self._opt.params]
            if probe is not None:
                probe.inject(leaf_grads, self._step_count, self._numerics_layout["names"])
            pnorm = _numerics.leaf_norms(self._opt.params) if observe else None
            gnorm, finite = self._opt.apply_tree(scaler=scaler)
            shard, unorms = None, None
        else:
            finite = None
            if scaler is not None:
                grads = scaler.unscale(grads)
            if probe is not None:
                probe.inject(grads, self._step_count, self._numerics_layout["names"])
            if scaler is not None:  # every rank's shares: one overflow skips everywhere
                finite = all_finite(scaler.grads_finite(grads), self._group)
            pnorm = _numerics.leaf_norms(self._opt.local) if observe else None
            self._opt.update_norms = None
            gnorm = self._opt.step(grads, gate=finite)
            leaf_grads, shard, unorms = grads, self._opt.shard, self._opt.update_norms
        if scaler is not None:
            scaler.update(finite)
        if not observe:
            return None
        if gnorm is None:
            gnorm = self._opt.norm(grads)
        return probe.aux(leaf_grads, param_norms=pnorm, update_norms=unorms, grad_norm=gnorm,
                         shard=shard, **self._numerics_layout)

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
            refuse_capture(step, "Stoke.fused_step")
            self._fused = step
            self._fused_graph = StepGraph(step, step._step)
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
        self._opt.zero_grad()
        self._backward_count = 0
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
        """The loss as a detached device scalar, averaged over ranks."""
        loss = loss.detach()
        loss = loss.mean() if loss.dim() else loss
        return mean_over_ranks({"loss": loss}, self._group)["loss"]

    def eval_step(self, metric_fns: dict | None = None) -> Callable:
        """``step(inputs, targets) -> {"loss": ..., **metrics}`` of device
        scalars, computed in eval mode (BatchNorm reads its running
        statistics) without a graph and averaged over ranks; sum them
        across batches and read once per epoch."""
        metric_fns = dict(metric_fns or {})

        def step(inputs, targets):
            y = _as_tensor(targets, self.device)
            training = self._module.training
            self._module.eval()  # JAX's eval step runs train=False: running statistics
            try:
                with torch.no_grad():
                    with self._autocast():
                        out = self._wrapped(_as_tensor(inputs, self.device))
                    out = out.float()
                    result = {"loss": self._loss_callable(out, y)}
                    for name, fn in metric_fns.items():
                        result[name] = fn(out, y)
            finally:
                self._module.train(training)
            return mean_over_ranks(result, self._group)

        return step

    # -- loss monitor --------------------------------------------------------

    @torch.no_grad()
    def _note_loss(self, loss) -> None:
        val = loss.detach().float().mean()
        self._last_loss = val
        self._ema = val if self._ema is None else 0.98 * self._ema + 0.02 * val

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
        rank 0; a list of ranks, or None for all)."""
        if self._ema is not None and self.verbose and self._prints(rank):
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
            "ema_loss": None if self._ema is None else float(self._ema),
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
        self._ema = None if ema is None else torch.tensor(ema, dtype=torch.float32,
                                                          device=self.device)
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

