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

One device: the facade runs on ``device`` (``"cuda"`` by default; it raises
when no CUDA device exists unless ``device="cpu"`` was asked for). At world
size 1, ``distributed="ddp"`` with ``fairscale_oss``/``fairscale_sddp`` is
exactly a single-device update; at ``WORLD_SIZE > 1`` it raises.

The optimizer follows the JAX facade's rule (``facade.py:889-930`` there):
AdamW on a layout where a flat update fits (DDP, or ZeRO-1/OSS:
``fairscale_oss`` without ``fairscale_sddp`` or ``fairscale_fsdp``) runs as
``optim.FusedAdamW`` unless ``fused_optimizer=False``; ZeRO-2/3 layouts keep
the per-leaf chain, and ``fused_optimizer=True`` on one of them raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import optim as optim_mod
from ..data import DataLoader as _DataLoader
from ..precision import DynamicLossScaler, Policy
from ..runtime import dist
from .config import AMPConfig, ClipGradNormConfig, DistributedOptions
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
    ):
        if dist.world_size() > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={dist.world_size()}: the port trains on one GPU so far; "
                "DDP/ZeRO across GPUs is the distributed-runtime slice"
            )
        distributed = distributed.value if isinstance(distributed, DistributedOptions) else distributed
        if distributed not in (None, "ddp"):
            raise NotImplementedError(f"distributed={distributed!r} is not ported; use 'ddp'")
        # fairscale_oss/sddp/fsdp shard state across ranks; with one rank
        # there is nothing to shard and the update is the plain one
        self.device = dist.resolve_device(device)
        self._module = model.to(self.device)
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
            self._opt = optim_mod.FusedAdamW(self._module.named_parameters(), lr=1.0, **kwargs)
        else:
            self._opt = factory(self._module.named_parameters(), lr=base_lr, **kwargs)
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
        grad = torch.enable_grad() if self._module.training else torch.no_grad()
        with grad, self._autocast():
            out = self._module(x)
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
        if isinstance(self._opt, optim_mod.FusedAdamW):
            # the flag gates the update on the device; the host reads it after
            _, finite = self._opt.apply_tree(self._opt_handle.lr, scaler=self.loss_scaler)
            if finite is not None:
                self.loss_scaler.update(bool(finite))
        else:
            grads = self._opt.grads()
            finite = True
            if self.loss_scaler is not None:
                grads = self.loss_scaler.unscale(grads)
                finite = self.loss_scaler.grads_finite(grads)
                self.loss_scaler.update(finite)
            if finite:
                self._opt.step(grads, lr=self._opt_handle.lr)
        self._opt.zero_grad()
        self._backward_count = 0
        self._step_count += 1

    def detach_and_sync_loss(self, loss):
        """The loss as a detached device scalar (mean over ranks: one rank)."""
        loss = loss.detach()
        return loss.mean() if loss.dim() else loss

    def eval_step(self, metric_fns: dict | None = None) -> Callable:
        """``step(inputs, targets) -> {"loss": ..., **metrics}`` of device
        scalars, computed without a graph; sum them across batches and read
        once per epoch."""
        metric_fns = dict(metric_fns or {})

        def step(inputs, targets):
            y = _as_tensor(targets, self.device)
            with torch.no_grad():
                with self._autocast():
                    out = self._module(_as_tensor(inputs, self.device))
                out = out.float()
                result = {"loss": self._loss_callable(out, y)}
                for name, fn in metric_fns.items():
                    result[name] = fn(out, y)
            return result

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

    def print_ema_loss(self, prepend_msg: str = "EMA Loss"):
        if self._ema is not None and self.verbose:
            print(f"{prepend_msg}: {self._ema_value():.6f}", flush=True)

    # -- data ----------------------------------------------------------------

    def DataLoader(self, dataset, batch_size: int | None = None, sampler=None,
                   num_workers: int = 0, drop_last: bool = True, **kwargs):
        """Loader bound to the facade's batch size and device; ``drop_last``
        defaults True like the JAX facade's."""
        return _DataLoader(
            dataset,
            batch_size=batch_size or self.batch_size_per_device,
            sampler=sampler,
            num_workers=num_workers,
            drop_last=drop_last,
            device=self.device,
            **kwargs,
        )

    # -- checkpoints -----------------------------------------------------------

    def save(self, path: str = "./", name: str = "checkpoint", extras: dict | None = None):
        """Write ``{path}/{name}.pt`` -> ``(full_path, tag)``: params,
        optimizer state (``FusedAdamW``'s with its flat layout) and the
        step/lr/scaler metadata."""
        meta = {
            "step": self._step_count,
            "lr": self._opt_handle.lr,
            "backward_count": self._backward_count,
            "scaler": None if self.loss_scaler is None else self.loss_scaler.state_dict(),
            **(extras or {}),
        }
        return ckpt.save_checkpoint(path, name, {
            "params": self._module.state_dict(),
            "opt_state": self._opt.state_dict(),
            "meta": meta,
        })

    def load_model_state(self, source, strict: bool = True, param_key: str = "params"):
        """Load weights from a ``.pt``/``.pth`` path or a state dict,
        optionally nested under ``param_key``; strict matching by default."""
        if isinstance(source, str):
            source = ckpt.load_file(source)
        matched, _ = ckpt.load_params_dict(
            source, self._module.state_dict(), strict=strict, param_key=param_key
        )
        self._module.load_state_dict(matched, strict=strict)

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

    def print_on_devices(self, msg: str = ""):
        print(f"[rank {self.rank}/{self.world_size}] {msg}", flush=True)

