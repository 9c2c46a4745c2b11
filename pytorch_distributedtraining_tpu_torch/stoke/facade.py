"""The Stoke facade: one object owning model, optimizer, loss, precision,
grad accumulation and clipping, data loading, checkpoints and rank I/O.

Counterpart of ``pytorch_distributedtraining_tpu/stoke/facade.py`` for the
surface ``drivers/stoke_ddp.py`` drives: ``.model``, ``.loss``,
``.backward``, ``.step``, ``.DataLoader``, ``.print_ema_loss``,
``.detach_and_sync_loss``, ``.eval_step``, ``.save``, ``.init``,
``.load_model_state``, ``.model_access``, ``.print_on_devices`` and
``.optimizer``.

PyTorch runs eagerly, so the JAX facade's deferred handles and compiled
programs have no counterpart: ``.model`` runs the forward under the
precision policy's autocast, ``.backward`` accumulates ``loss /
grad_accum_steps`` into ``.grad``, and ``.step`` fires the optimizer on
every ``grad_accum_steps``-th call (Stoke semantics; ``facade.py:1399-1435``
in the JAX package), with the lr read from :attr:`optimizer` at that
moment. Nothing in the hot loop waits for the device except an explicit
read of a loss.

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
from typing import Callable

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import optim as optim_mod
from ..data import DataLoader as _DataLoader
from ..parallel.policy import policy_from_flags
from ..parallel.spec import all_reduce_sum_, is_dtensor, shard_axis
from ..parallel.state import create_train_state
from ..parallel.step import mean_over_ranks, reduce_gradients
from ..precision import DynamicLossScaler, Policy
from ..runtime import dist
from ..runtime.mesh import MeshSpec, data_group, make_mesh
from .config import (AMPConfig, ClipGradNormConfig, DDPConfig, DistributedOptions,
                     FairscaleOSSConfig)
from .optimizer import StokeOptimizer


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
        fp16: str | None = None,
        distributed: str | DistributedOptions | None = None,
        fairscale_oss: bool = False,
        fairscale_sddp: bool = False,
        fairscale_fsdp: bool = False,
        grad_accum_steps: int = 1,
        configs: list | None = None,
        grad_clip: ClipGradNormConfig | None = None,
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

        self.fp16 = fp16
        self.loss_scaler = None
        if fp16 == "amp":
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
        elif grad_clip is not None:
            raise TypeError(
                f"grad_clip must be a ClipGradNormConfig, got {type(grad_clip).__name__}"
            )
        fused_eligible = factory is optim_mod.adamw and optim_mod.fused_adamw_eligible(
            fairscale_sddp=fairscale_sddp, fairscale_fsdp=fairscale_fsdp)
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
        scalars, computed without a graph and averaged over ranks; sum
        them across batches and read once per epoch."""
        metric_fns = dict(metric_fns or {})

        def step(inputs, targets):
            y = _as_tensor(targets, self.device)
            with torch.no_grad():
                with self._autocast():
                    out = self._wrapped(_as_tensor(inputs, self.device))
                out = out.float()
                result = {"loss": self._loss_callable(out, y)}
                for name, fn in metric_fns.items():
                    result[name] = fn(out, y)
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
        return _DataLoader(
            dataset,
            batch_size=batch_size or self.batch_size_per_device,
            sampler=sampler,
            num_workers=num_workers,
            drop_last=drop_last,
            device=self.device,
            device_prefetch=device_prefetch,
            **kwargs,
        )

    # -- checkpoints -----------------------------------------------------------

    def save(self, path: str = "./", name: str = "checkpoint", extras: dict | None = None):
        """Write ``{path}/{name}.pt`` -> ``(full_path, tag)``: params,
        optimizer state (``FusedAdamW``'s with its flat layout) and the
        step/lr/scaler metadata. Every rank calls it: sharded parameters
        and state are gathered into the layout of a one-rank run, rank 0
        writes, and all wait for the file at a barrier, so a checkpoint
        loads at any world size."""
        meta = {
            "step": self._step_count,
            "lr": self._opt_handle.lr,
            "backward_count": self._backward_count,
            "scaler": None if self.loss_scaler is None else self.loss_scaler.state_dict(),
            **(extras or {}),
        }
        params = {k: v.full_tensor() if is_dtensor(v) else v
                  for k, v in self._module.state_dict().items()}
        trees = {"params": params, "opt_state": self._opt.full_state_dict(), "meta": meta}
        if self.rank == 0:
            out = ckpt.save_checkpoint(path, name, trees)
        else:
            out = os.path.join(path, f"{name}.pt"), f"{name}.pt"
        dist.coordination_barrier(f"save {name}")
        return out

    def load_model_state(self, source, strict: bool = True, param_key: str = "params"):
        """Load weights from a ``.pt``/``.pth`` path or a state dict,
        optionally nested under ``param_key``; strict matching by default.
        A ``.pth`` file is read as ``interop.load_torch_checkpoint`` reads
        it (a state dict, or one under ``param_key`` or a usual wrapper
        key), so official SwinIR files of all three tails load as they
        are: the port's module names are the official ones."""
        if isinstance(source, str):
            if source.endswith(".pth"):
                from ..interop import load_torch_checkpoint

                source = load_torch_checkpoint(source, key=param_key)
            else:
                source = ckpt.load_file(source)
        template = self._module.state_dict()
        matched, _ = ckpt.load_params_dict(source, template, strict=strict, param_key=param_key)
        if not any(is_dtensor(v) for v in template.values()):
            self._module.load_state_dict(matched, strict=strict)
            return
        # FSDP2: each rank copies its own first-dimension chunk into its shard
        with torch.no_grad():
            for k, v in matched.items():
                t = template[k]
                if is_dtensor(t):
                    local = t.to_local()
                    chunks = v.chunk(dist.world_size(), dim=0)
                    piece = chunks[self.rank] if self.rank < len(chunks) else v[:0]
                    local.copy_(piece.to(local.dtype))
                else:
                    t.copy_(v)

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

    def _prints(self, rank) -> bool:
        return rank is None or self.rank in (rank if isinstance(rank, (list, tuple)) else [rank])

    def print_on_devices(self, msg: str = "", rank: int | list | None = 0):
        """Rank-stamped print on ``rank`` (Stoke's default, rank 0; a list
        of ranks, or None for all)."""
        if self._prints(rank):
            print(f"[rank {self.rank}/{self.world_size}] {msg}", flush=True)

