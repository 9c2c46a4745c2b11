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

PyTorch runs eagerly, so the JAX facade's deferred handles and compiled
programs have no counterpart: ``.model`` runs the forward under the
precision policy's autocast, ``.backward`` accumulates ``loss /
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

The optimizer follows the JAX facade's rule (``facade.py:889-930`` there):
AdamW on a layout where a flat update fits (DDP, or ZeRO-1/OSS:
``fairscale_oss`` without ``fairscale_sddp`` or ``fairscale_fsdp``) runs as
``optim.FusedAdamW`` unless ``fused_optimizer=False``; ZeRO-2/3 layouts keep
the per-leaf chain, and ``fused_optimizer=True`` on one of them raises.
"""

from __future__ import annotations

import functools
import os
import weakref
from typing import Callable

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import optim as optim_mod
from ..data import DataLoader as _DataLoader
from ..parallel.policy import policy_from_flags
from ..parallel.spec import all_reduce_sum_, is_dtensor, shard_axis
from ..parallel.state import TrainState, create_train_state, load_module_state
from ..parallel.step import mean_over_ranks, reduce_gradients
from ..precision import DynamicLossScaler, Policy
from ..runtime import dist
from ..runtime.mesh import MeshSpec, data_group, make_mesh
from .config import (AMPConfig, ClipGradConfig, ClipGradNormConfig, DDPConfig,
                     DistributedOptions, FairscaleOSSConfig, FP16Options)
from .optimizer import StokeOptimizer

# fp16 options that run fp16 autocast with the loss scaler (JAX's set)
_SCALED_FP16 = ("amp", "apex_O1", "apex_O2", "deepspeed")


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
    ):
        distributed = distributed.value if isinstance(distributed, DistributedOptions) else distributed
        if distributed not in (None, "ddp"):
            raise NotImplementedError(
                f"distributed={distributed!r} is not ported (DeepSpeed and Horovod have no "
                "counterpart in the port); use 'ddp'")
        self.policy = policy_from_flags(distributed, fairscale_oss, fairscale_sddp,
                                        fairscale_fsdp)
        zero = fairscale_oss or fairscale_sddp or fairscale_fsdp
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(MeshSpec.zero() if zero else MeshSpec.ddp())
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
        self._configs = list(configs or [])
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
        if fused_eligible and fused_optimizer is not False:
            # lr=1: the handle's lr enters each step as the lr factor
            tx = functools.partial(optim_mod.FusedAdamW, lr=1.0, **kwargs)
        else:
            tx = functools.partial(factory, lr=base_lr, **kwargs)
        ddp_config = self._find_config(DDPConfig) or DDPConfig()
        state = create_train_state(model, tx, mesh, self.policy, device=self.device,
                                   find_unused_parameters=ddp_config.find_unused_parameters)
        self._state = state
        self._module, self._wrapped, self._opt = state.module, state.model, state.tx
        oss_config = self._find_config(FairscaleOSSConfig) or FairscaleOSSConfig()
        if (oss_config.broadcast_fp16 and self.policy.shard_opt_state
                and shard_axis(mesh) is not None):
            # OSS broadcast_fp16 (JAX facade._update_wire_dtype): the
            # sharded update fans out to every rank in bf16
            self._opt.update_wire_dtype = torch.bfloat16
        self._opt_handle = optim_mod.OptimizerHandle(base_lr)

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
        with grad, self._autocast():
            out = self._wrapped(x)
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
        ``fp16='amp'`` a non-finite gradient skips the update; the scaler's
        host-side scale costs one read of the finite flag a step."""
        if self._backward_count == 0 or self._backward_count % self.grad_accum_steps:
            return
        # the global batch's gradient (backward already divided by accum)
        grads = reduce_gradients(self._opt, self.policy, self._group)
        if isinstance(self._opt, optim_mod.FusedAdamW):
            # the flag gates the update on the device; the host reads it after
            _, finite = self._opt.apply_tree(self._opt_handle.lr, scaler=self.loss_scaler)
            if finite is not None:
                self.loss_scaler.update(bool(finite))
        else:
            finite = True
            if self.loss_scaler is not None:
                grads = self.loss_scaler.unscale(grads)
                finite = self._all_ranks(self.loss_scaler.grads_finite(grads))
                self.loss_scaler.update(finite)
            if finite:
                self._opt.step(grads, lr=self._opt_handle.lr)
        self._opt.zero_grad()
        self._backward_count = 0
        self._step_count += 1

    def _all_ranks(self, flag: bool) -> bool:
        """``flag`` on every rank (one all-reduce with a group): a shard's
        overflow skips the step everywhere."""
        if self._group is None:
            return flag
        bad = torch.tensor(0.0 if flag else 1.0, device=self.device)
        return float(all_reduce_sum_(bad, self._group)) == 0.0

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
        env knobs fill what ``overrides`` leaves out; the engine runs on
        the facade's device unless ``device=`` says otherwise. The JAX
        facade's ``TPUConfig`` serve overrides wait for its twin, which
        comes with the CUDA-graph step slice."""
        from ..models.swinir import SwinIR
        from ..serve import build_engine

        sharded = any(is_dtensor(v) for v in self._module.state_dict().values())
        if sharded and isinstance(self._module, SwinIR):
            raise NotImplementedError(
                "Stoke.serve of a ZeRO-3 (fairscale_fsdp) SwinIR is not ported yet: serve "
                "the checkpoint Stoke.save writes through serve.build_engine")
        params = {k: (v.full_tensor() if is_dtensor(v) else v).detach().clone()
                  for k, v in self._module.state_dict().items()}
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
        trace-event JSON to ``path``, else to ``telemetry-<pid>.trace.json``
        under the run dir; returns the path, or None when telemetry was
        never enabled (nothing to export is not an error)."""
        from ..observe import trace

        if not trace.enabled() and not trace.records():
            return None
        return trace.export_chrome_trace(path)

    def _prints(self, rank) -> bool:
        return rank is None or self.rank in (rank if isinstance(rank, (list, tuple)) else [rank])

    def print_on_devices(self, msg: str = "", rank: int | list | None = 0):
        """Rank-stamped print on ``rank`` (Stoke's default, rank 0; a list
        of ranks, or None for all)."""
        if self._prints(rank):
            print(f"[rank {self.rank}/{self.world_size}] {msg}", flush=True)

