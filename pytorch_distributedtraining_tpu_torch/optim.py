"""Optimizers and LR schedules: AdamW, SGD, the flat ``FusedAdamW``,
OneCycleLR and ReduceLROnPlateau.

Counterpart of ``pytorch_distributedtraining_tpu/optim.py``:

- ``adamw`` and ``sgd`` are the per-leaf optax chains (recorded global-norm
  clip, value clip, Adam or momentum SGD, decoupled weight decay, params
  EMA; ``optim.py:224-276``) on ``torch._foreach`` ops, a few launches per
  step for the whole parameter list. The lr is applied after the chain,
  from a float, a schedule of the step count, or the caller's
  :class:`OptimizerHandle`.
- ``FusedAdamW`` is the flat update (``optim.py:279-479``): parameters and
  gradients are views into one flat f32 buffer each, padded to a multiple
  of 1024, so the update is the JAX ``apply``'s arithmetic as full-width
  tensor ops on the same code path on the CPU and the card, with no ravel
  or unravel copy.
- Under a ZeRO policy both keep optimizer state for this rank's share
  only. The per-leaf chains take a ``parallel.spec.ShardPlan`` (``shard=``):
  moments, EMA and the update live on each leaf's shard (ZeRO-1/2, by the
  ``leaf_spec`` rule) or on each FSDP2 ``DTensor``'s local tensor (ZeRO-3),
  the global norm sums squares over shards with one all-reduce, and the
  updated shards are all-gathered. ``FusedAdamW(shard_group=...)`` updates
  this rank's slice of the flat buffer and all-gathers the flat
  parameters (ZeRO-1). ``update_wire_dtype`` (Fairscale OSS's
  ``broadcast_fp16``, bf16 as in JAX) casts the lr-scaled update before it
  is gathered and added. ``full_state_dict()`` gathers the state into the
  layout of a run on one rank, and ``load_state_dict`` takes either that
  or the optimizer's own ``state_dict()`` (or moments by parameter name)
  and re-slices each moment onto this rank's share, so a state saved at
  one world size or layout resumes at another.
- ``onecycle`` and ``cosine_with_warmup`` are schedules, functions of a
  step (an int or a 0-d tensor). ``OneCycleLR`` and ``ReduceLROnPlateau``
  stay pure-Python closed forms, not ``torch.optim.lr_scheduler``, so their
  values match the JAX twins step for step.

Nothing here reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


def _named(params) -> list[tuple[str, torch.Tensor]]:
    """``(name, parameter)`` pairs of the trainable parameters, each once:
    from ``module.named_parameters()`` or, named by position, from tensors."""
    out, seen = [], set()
    for i, item in enumerate(params):
        name, p = item if isinstance(item, tuple) else (str(i), item)
        if p.requires_grad and id(p) not in seen:
            seen.add(id(p))
            out.append((name, p))
    return out


def _lr_at(lr, count):
    """The lr at ``count`` (the step count before this update, optax's
    ``scale_by_schedule``): a float as it is, a schedule evaluated."""
    return lr(count) if callable(lr) else lr


def _by_name(saved, saved_names, names: list[str], key: str) -> list:
    """``saved`` (a list in the order of ``saved_names``, or of ``names``
    when that is None, or a dict by name) as a list in the order of
    ``names``."""
    if not isinstance(saved, dict):
        saved = list(saved)
        if saved_names is None:
            if len(saved) != len(names):
                raise ValueError(f"optimizer state {key!r} holds {len(saved)} tensors for "
                                 f"{len(names)} parameters")
            return saved
        saved = dict(zip(saved_names, saved))
    missing = [n for n in names if n not in saved]
    if missing:
        raise ValueError(f"optimizer state {key!r} lacks parameters {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}")
    return [saved[n] for n in names]


def _leaves_from_flat(flat: torch.Tensor, layout: dict) -> dict:
    """A whole flat ``FusedAdamW`` buffer as ``{name: view shaped like the
    parameter}``, by the ``layout`` its ``state_dict`` carries."""
    return {n: flat[o:o + math.prod(shape)].view(tuple(shape))
            for n, o, shape in zip(layout["names"], layout["offsets"], layout["shapes"])}


class RecordedClip(NamedTuple):
    """The pre-clip global norm and whether the clip fired this step
    (JAX ``RecordedClipState``), both device scalars."""

    gnorm: torch.Tensor  # f32
    clipped: torch.Tensor  # bool: the scale was < 1


class _LeafOptimizer:
    """What the per-leaf chains share: the parameter list, its grads, the
    recorded clip, the params EMA and, with a ``shard`` plan, this rank's
    shard of each (:attr:`local`), where the state and the update live.
    ``STATE`` names the per-leaf state lists (each ``None`` or one tensor
    per parameter, shaped like its share)."""

    STATE: tuple = ("ema",)

    def __init__(self, params, lr, clip_grad_norm, clip_grad_value, ema_decay=None,
                 shard=None, update_wire_dtype=None):
        named = _named(params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.shard = shard
        self.local = self.params if shard is None else shard.local(self.params)
        self.lr = lr
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.clip_grad_value = None if clip_grad_value is None else float(clip_grad_value)
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.update_wire_dtype = update_wire_dtype
        self.count = 0
        self.clip: RecordedClip | None = None
        self.ema = None
        if self.ema_decay is not None:
            self.ema = [p.detach().float().clone() for p in self.local]

    def grads(self) -> list[torch.Tensor]:
        """The parameters' grads as they lie (whole, or FSDP2 ``DTensor``s)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        """Drop the grads; the next backward writes fresh ones."""
        for p in self.params:
            p.grad = None

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    def norm(self, grads) -> torch.Tensor:
        """The global norm of this rank's share of the grads (``local``
        layout): over every rank's shards at once, by one all-reduce, when
        sharded."""
        if self.shard is None:
            return self.global_norm(grads)
        sq = torch.stack(torch._foreach_norm(grads)).square()
        return torch.sqrt(self.shard.norm_sq(sq))

    def _clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Clip by global norm (recorded in :attr:`clip`), then by value."""
        if self.clip_grad_norm is not None:
            gnorm = self.norm(grads)
            trigger = gnorm > self.clip_grad_norm
            scale = torch.where(trigger, self.clip_grad_norm / torch.clamp(gnorm, min=1e-38),
                                torch.ones_like(gnorm))
            grads = torch._foreach_mul(grads, scale)
            self.clip = RecordedClip(gnorm, trigger)
        if self.clip_grad_value is not None:
            v = self.clip_grad_value
            grads = torch._foreach_clamp_max(torch._foreach_clamp_min(grads, -v), v)
        return grads

    def _lr(self, lr, lr_factor) -> float:
        return float((_lr_at(self.lr, self.count) if lr is None else lr) * lr_factor)

    def _update_ema(self) -> None:
        """EMA of the new parameters (JAX ``refresh_params_ema``)."""
        if self.ema is not None:
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.local, alpha=1.0 - self.ema_decay)

    def _apply(self, upd: list[torch.Tensor], lr: float) -> None:
        """``p -= lr·u`` on this rank's share, then the sharded leaves
        gathered back whole. With :attr:`update_wire_dtype` the step
        ``-lr·u`` is cast to it first and it is the steps that are gathered
        (the narrow fan-out wire), then added, upcast."""
        if self.update_wire_dtype is None:
            torch._foreach_add_(self.local, upd, alpha=-lr)
            if self.shard is not None:
                self.shard.gather_(self.params)
            return
        steps = [u.to(self.update_wire_dtype) for u in torch._foreach_mul(upd, -lr)]
        if self.shard is not None:
            self.shard.gather_(self.params, steps)
        else:
            torch._foreach_add_(self.params, [s.to(p.dtype) for s, p in zip(steps, self.params)])

    def state_dict(self) -> dict:
        """The step count, the parameter names and each per-leaf state list
        (this rank's shares)."""
        return {"count": self.count, "names": list(self.names),
                **{k: getattr(self, k) for k in self.STATE}}

    def full_state_dict(self) -> dict:
        """:meth:`state_dict` with every sharded buffer gathered whole, the
        layout of a run on one rank (a collective when sharded: every rank
        calls it)."""
        sd = self.state_dict()
        if self.shard is None:
            return sd
        return {k: (self.shard.gather_state(self.params, v) if k in self.STATE and v is not None
                    else v)
                for k, v in sd.items()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` or :meth:`full_state_dict`, saved at
        this world size or any other: each state list holds one tensor per
        parameter, in the order of ``state["names"]`` (this optimizer's when
        absent), or is a dict by parameter name. A tensor shaped like the
        whole leaf is cut to this rank's share (a ZeRO-1/2 leaf along its
        ``leaf_spec`` dimension, an FSDP2 leaf's first-dimension chunk); one
        shaped like the share is copied as it is. A ``FusedAdamW``
        :meth:`~FusedAdamW.full_state_dict` loads too, by its layout."""
        if "layout" in state:  # a flat FusedAdamW state: by name from its layout
            if tuple(state["layout"]["slice"]) != (0, state["layout"]["padded"]):
                raise ValueError("a FusedAdamW state_dict() holds one rank's slice; load its "
                                 "full_state_dict() into a per-leaf optimizer")
            state = {k: (_leaves_from_flat(torch.as_tensor(v), state["layout"])
                         if k in ("mu", "nu", "ema") and v is not None else v)
                     for k, v in state.items() if k != "layout"}
        for key in self.STATE:
            mine, saved = getattr(self, key), state.get(key)
            if (mine is None) != (saved is None):
                raise ValueError(
                    f"optimizer state {key!r}: the checkpoint "
                    f"{'has none' if saved is None else 'has one'} but this optimizer "
                    f"{'keeps one' if mine is not None else 'keeps none'} (ema_decay, momentum "
                    "must match the run that saved it)")
            if mine is None:
                continue
            for i, (dst, src) in enumerate(zip(mine, _by_name(saved, state.get("names"),
                                                              self.names, key))):
                dst.copy_(self._share(i, torch.as_tensor(src), dst, key))
        self.count = int(state["count"])

    def _share(self, i: int, src: torch.Tensor, dst: torch.Tensor, key: str) -> torch.Tensor:
        """This rank's share of leaf ``i`` from ``src``, the whole leaf or
        the share itself."""
        whole = tuple(self.params[i].shape)
        if tuple(src.shape) != tuple(dst.shape) and tuple(src.shape) == whole \
                and self.shard is not None:
            src = self.shard.piece(i, src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"optimizer state {key}[{self.names[i]!r}]: shape {tuple(src.shape)} is neither "
                f"the whole leaf {whole} nor this rank's share {tuple(dst.shape)}")
        return src

    def ema_params(self) -> list[torch.Tensor] | None:
        """The params EMA of each leaf, whole (gathered from the shards when
        sharded, a collective: every rank calls it); None without
        ``ema_decay``."""
        if self.ema is None:
            return None
        return self.ema if self.shard is None else self.shard.gather_state(self.params, self.ema)


class AdamW(_LeafOptimizer):
    """``clip_by_global_norm -> clip -> adam -> add_decayed_weights``, then
    ``* -lr``, then the params EMA.

    The optax chain's arithmetic: ``u = m̂/(√v̂ + eps) + wd·p`` with bias
    correction by step count (in Python doubles), scaled by ``min(1,
    max_norm/‖g‖)`` first when clipping is on; ``p -= lr·u``.
    """

    STATE = ("mu", "nu", "ema")

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, clip_grad_norm: float | None = None,
                 clip_grad_value: float | None = None, ema_decay: float | None = None,
                 shard=None, update_wire_dtype=None):
        super().__init__(params, lr, clip_grad_norm, clip_grad_value, ema_decay, shard,
                         update_wire_dtype)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.mu = [torch.zeros_like(p) for p in self.local]
        self.nu = [torch.zeros_like(p) for p in self.local]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr=None, lr_factor=1.0) -> torch.Tensor | None:
        """Apply one update from ``grads`` (f32, already unscaled; this
        rank's share, as :attr:`local`) at ``lr`` (default: :attr:`lr` at
        the step count) times ``lr_factor``. Returns
        the pre-clip global norm (a device scalar) when clipping is on, so a
        caller need not compute it twice; else None."""
        lr = self._lr(lr, lr_factor)
        grads = self._clip(grads)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.local, alpha=self.weight_decay)
        self._apply(upd, lr)
        self._update_ema()
        return None if self.clip is None else self.clip.gnorm



class SGD(_LeafOptimizer):
    """``clip_by_global_norm -> clip -> add_decayed_weights -> trace``, then
    ``* -lr``: optax's ``sgd`` with momentum as a trace ``t = g + m·t``
    (Nesterov: the update is ``g + m·t``), no dampening."""

    STATE = ("trace",)

    def __init__(self, params, lr=1e-2, momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, clip_grad_norm: float | None = None,
                 clip_grad_value: float | None = None, shard=None, update_wire_dtype=None):
        super().__init__(params, lr, clip_grad_norm, clip_grad_value, None, shard,
                         update_wire_dtype)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.nesterov = bool(nesterov)
        self.trace = [torch.zeros_like(p) for p in self.local] if self.momentum else None

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr=None, lr_factor=1.0) -> torch.Tensor | None:
        """As :meth:`AdamW.step`."""
        lr = self._lr(lr, lr_factor)
        grads = self._clip(grads)
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.local, alpha=self.weight_decay)
        if self.trace is not None:
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            grads = (torch._foreach_add(grads, self.trace, alpha=self.momentum)
                     if self.nesterov else self.trace)
        self.count += 1
        self._apply(grads, lr)
        return None if self.clip is None else self.clip.gnorm



def adamw(params, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01,
          clip_grad_norm: float | None = None, clip_grad_value: float | None = None,
          ema_decay: float | None = None, shard=None, update_wire_dtype=None) -> AdamW:
    """AdamW with torch-parity argument names (the JAX ``adamw`` factory)."""
    return AdamW(params, lr, betas, eps, weight_decay, clip_grad_norm, clip_grad_value,
                 ema_decay, shard, update_wire_dtype)


def sgd(params, lr=1e-2, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False, clip_grad_norm: float | None = None,
        clip_grad_value: float | None = None, shard=None, update_wire_dtype=None) -> SGD:
    """SGD with torch-parity argument names (the JAX ``sgd`` factory)."""
    return SGD(params, lr, momentum, weight_decay, nesterov, clip_grad_norm, clip_grad_value,
               shard, update_wire_dtype)


class FusedAdamWState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: torch.Tensor  # f32 [N_pad] first moment, flat
    nu: torch.Tensor  # f32 [N_pad] second moment, flat
    ema: torch.Tensor | None = None  # f32 [N_pad] params EMA (ema_decay set)


class FusedAdamW:
    """Flat AdamW + clipping: the whole update as ~15 full-width tensor ops.

    At construction every parameter's ``.data`` and ``.grad`` become views
    into :attr:`flat_param` and :attr:`flat_grad` (DDP's
    ``gradient_as_bucket_view`` idea): backward accumulates into the flat
    gradient in place, and the update writes the flat parameters in place,
    so no step copies a parameter or gradient to ravel or unravel it. Each
    parameter starts at a multiple of ``_ALIGN = 64`` elements (256 bytes):
    cuBLAS, cuDNN and the vectorised elementwise kernels fall back to
    slower code on a pointer off 16 bytes, and packed views left most
    parameters there. The buffers are ``[N_pad]`` f32, the end rounded up
    to a multiple of ``_PAD = 1024`` so that a ZeRO-1 layout can shard
    them; every padding lane holds zeros throughout (zero grad, zero
    moments, zero update).

    Whatever rebinds a parameter's ``.data`` or ``.grad`` afterwards
    (``p.grad = None``, ``module.to(...)`` to another device or dtype,
    ``load_state_dict(assign=True)``) detaches it from the buffers; use
    :meth:`zero_grad`, which zeroes the flat gradient in place.

    Numerics are the JAX ``FusedAdamW``'s: the pre-clip norm is one
    reduction over the flat gradient, the clip is ``g · where(‖g‖ < c, 1,
    c/‖g‖)``, bias correction runs in f32 on the device at the incremented
    count, and a schedule ``lr`` is read at the count before it.

    ``lr`` may be a float or a schedule ``f(count) -> lr``; ``lr_factor``
    multiplies it (the facade feeds its whole lr that way, with ``lr=1``).
    ``update_wire_dtype`` casts the step vector (fairscale OSS's
    ``broadcast_fp16``), ``ema_decay`` keeps an EMA of the new parameters.
    """

    _PAD = 1024
    _ALIGN = 64

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, clip_grad_norm: float | None = None,
                 clip_grad_value: float | None = None, update_wire_dtype=None,
                 ema_decay: float | None = None, shard_group=None):
        named = _named(params)
        if not named:
            raise ValueError("FusedAdamW got no trainable parameters")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        device = self.params[0].device
        for name, p in named:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError(
                    f"FusedAdamW keeps one flat f32 buffer on one device: parameter {name!r} is "
                    f"{p.dtype} on {p.device}, the first is torch.float32 on {device}")
        self.lr = lr
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.clip_grad_value = None if clip_grad_value is None else float(clip_grad_value)
        self.update_wire_dtype = update_wire_dtype
        # f32 values: 1 - d is then exact in a double, as in JAX's f32 arithmetic
        self.ema_decay = None if ema_decay is None else float(np.float32(ema_decay))

        self.numel = sum(p.numel() for p in self.params)
        self.offsets, end = [], 0
        for p in self.params:
            self.offsets.append(end)
            end = -(-(end + p.numel()) // self._ALIGN) * self._ALIGN
        n_pad = -(-end // self._PAD) * self._PAD
        self.shard_group = shard_group
        self.slice = slice(0, n_pad)
        if shard_group is not None:
            import torch.distributed as tdist

            world, rank = tdist.get_world_size(shard_group), tdist.get_rank(shard_group)
            if n_pad % world:
                raise ValueError(
                    f"FusedAdamW under ZeRO-1: the padded flat length {n_pad} does not divide "
                    f"over {world} ranks, so the flat moments cannot shard; use a world size "
                    "that divides it, or the per-leaf optim.adamw")
            k = n_pad // world
            self.slice = slice(rank * k, (rank + 1) * k)
        self.flat_param = torch.zeros(n_pad, dtype=torch.float32, device=device)
        self.flat_grad = torch.zeros_like(self.flat_param)
        with torch.no_grad():
            for off, p in zip(self.offsets, self.params):
                k = p.numel()
                self.flat_param[off:off + k].copy_(p.reshape(-1))
                if p.grad is not None:
                    self.flat_grad[off:off + k].copy_(p.grad.reshape(-1))
                p.data = self.flat_param[off:off + k].view_as(p)
                p.grad = self.flat_grad[off:off + k].view_as(p)
        self.state = self.init()
        self.clip: RecordedClip | None = None

    def init(self) -> FusedAdamWState:
        """A fresh state for the current parameters (this rank's slice of
        the flat buffer under ZeRO-1)."""
        own = self.flat_param[self.slice]
        z = torch.zeros_like(own)
        return FusedAdamWState(
            count=torch.zeros((), dtype=torch.int32, device=z.device),
            mu=z, nu=z.clone(),
            ema=None if self.ema_decay is None else own.clone(),
        )

    def zero_grad(self) -> None:
        """Zero the flat gradient in place (the views stay bound)."""
        self.flat_grad.zero_()

    def _moments(self, g, state: FusedAdamWState, pflat, lr_factor, gnorm=None):
        """The clip, the moments and the step ``-lr·u`` (in
        :attr:`update_wire_dtype` when set) from flat grads ``g``; ``gnorm``,
        the pre-clip norm, is computed from ``g`` unless given."""
        # JAX's apply with each expression as one op where torch has one
        # (a * x + b * y as a mul and an in-place add): fewer passes over
        # [N_pad], rounding apart only where an op fuses a multiply-add
        if gnorm is None:
            # pre-clip, the metric's contract; vector_norm's CPU reduction is
            # ~1e-5 off for a million elements, a sum of squares is not
            gnorm = torch.sqrt(torch.sum(g * g))
        if self.clip_grad_norm is not None:
            c = self.clip_grad_norm
            # optax.clip_by_global_norm formula: rescale only above the cap
            g = g * torch.where(gnorm < c, 1.0, c / gnorm)
            self.clip = RecordedClip(gnorm, gnorm > c)
        if self.clip_grad_value is not None:  # chain order: norm clip first
            g = torch.clamp(g, -self.clip_grad_value, self.clip_grad_value)
        count = state.count + 1
        mu = torch.mul(state.mu, self.b1).add_(g, alpha=1.0 - self.b1)
        nu = torch.mul(state.nu, self.b2).addcmul_(g, g, value=1.0 - self.b2)
        t = count.float()
        lr_t = _lr_at(self.lr, state.count)
        if isinstance(lr_t, torch.Tensor) or isinstance(lr_factor, torch.Tensor):
            lr_t = torch.as_tensor(lr_t, dtype=torch.float32) * lr_factor
        else:  # f32 on the host: a tensor made from it would copy to the device
            lr_t = float(np.float32(np.float32(lr_t) * np.float32(lr_factor)))
        # upd = m̂ / (√v̂ + eps) + wd·p, then the step -lr·upd, in one buffer
        upd = torch.div(mu, 1.0 - self.b1**t)
        upd.div_(torch.div(nu, 1.0 - self.b2**t).sqrt_().add_(self.eps))
        if self.weight_decay:
            upd.add_(pflat, alpha=self.weight_decay)
        step_vec = upd.mul_(-lr_t)
        if self.update_wire_dtype is not None:
            # narrow the update's fan-out wire; the add upcasts back
            step_vec = step_vec.to(self.update_wire_dtype)
        return step_vec, count, mu, nu, gnorm

    def _finish(self, new_p, pflat, state: FusedAdamWState, count, mu, nu, gate):
        """The EMA of ``new_p`` and the gate: ``(new_p, new_state)``."""
        ema = state.ema
        if self.ema_decay is not None:
            if ema is None:
                raise ValueError(
                    "ema_decay is set but the state has no ema buffer: re-init the state "
                    "with this optimizer (or restore one written with ema_decay enabled)")
            d = self.ema_decay
            ema = d * ema + (1.0 - d) * new_p
        elif ema is not None:
            raise ValueError(
                "the state carries an ema buffer but this optimizer has ema_decay=None: "
                "construct FusedAdamW(ema_decay=...) to keep maintaining it (or re-init "
                "the state without EMA)")
        if gate is not None:
            new_p = torch.where(gate, new_p, pflat)
            mu = torch.where(gate, mu, state.mu)
            nu = torch.where(gate, nu, state.nu)
            count = torch.where(gate, count, state.count)
            if ema is not None:
                ema = torch.where(gate, ema, state.ema)
        return new_p, FusedAdamWState(count, mu, nu, ema)

    @torch.no_grad()
    def apply(self, gflat: torch.Tensor, state: FusedAdamWState, pflat: torch.Tensor,
              lr_factor=1.0, gate: torch.Tensor | None = None):
        """One update on flat f32 grads ``gflat`` and params ``pflat``
        (``[N_pad]``), out of place.

        Returns ``(new_pflat, new_state, grad_norm)``; ``grad_norm`` is the
        pre-clip global norm (with a norm clip also recorded in
        :attr:`clip`). ``gate`` (a device bool, optional) keeps
        params, moments, count and EMA as they were when False: the
        GradScaler overflow skip, with no read on the host.
        """
        step_vec, count, mu, nu, gnorm = self._moments(gflat, state, pflat, lr_factor)
        new_p, new_state = self._finish(pflat + step_vec.float(), pflat, state, count, mu, nu,
                                        gate)
        return new_p, new_state, gnorm

    @torch.no_grad()
    def apply_tree(self, lr_factor=1.0, scaler=None):
        """One update from the parameters' grads, in place: the shared hot
        path of ``TrainStep`` and the facade.

        The grads already lie in :attr:`flat_grad`, so the ravel costs
        nothing. With ``scaler`` (a ``DynamicLossScaler``), the flat grads
        are unscaled and their finiteness gates the whole update. Returns
        ``(grad_norm, finite)``: the pre-clip norm and, with a scaler, the
        finite flag as a device bool for the scaler's own update (None
        without one). Nothing is read back to the host here.

        Under ZeRO-1 (``shard_group``) the grads are the same on every rank
        (reduced by the step): the norm is taken over all of them, the
        moments and the update over this rank's slice, and then the flat
        parameters (or, with :attr:`update_wire_dtype`, the steps) are
        all-gathered.
        """
        gflat, gate = self.flat_grad, None
        if scaler is not None:
            gflat = gflat * (1.0 / scaler.scale)
            gate = torch.isfinite(gflat).all()
        if self.shard_group is None:
            new_p, self.state, gnorm = self.apply(gflat, self.state, self.flat_param,
                                                  lr_factor, gate)
            self.flat_param.copy_(new_p)
            return gnorm, gate
        from .parallel.spec import all_gather_flat

        own = self.flat_param[self.slice]
        step_vec, count, mu, nu, gnorm = self._moments(
            gflat[self.slice], self.state, own, lr_factor, torch.sqrt(torch.sum(gflat * gflat)))
        if self.update_wire_dtype is None:
            new_own, self.state = self._finish(own + step_vec, own, self.state, count, mu, nu,
                                               gate)
            all_gather_flat(self.flat_param, new_own, self.shard_group)
            return gnorm, gate
        if gate is not None:
            step_vec = torch.where(gate, step_vec, torch.zeros_like(step_vec))
        steps = torch.empty(self.flat_param.numel(), dtype=step_vec.dtype,
                            device=step_vec.device)
        all_gather_flat(steps, step_vec, self.shard_group)
        new_p = self.flat_param + steps.float()
        if gate is not None:
            new_p = torch.where(gate, new_p, self.flat_param)
        _, self.state = self._finish(new_p[self.slice], own, self.state, count, mu, nu, gate)
        self.flat_param.copy_(new_p)
        return gnorm, gate

    def ema_params(self, state: FusedAdamWState | None = None) -> list[torch.Tensor] | None:
        """The EMA of each parameter, shaped like it (views of the flat EMA);
        None when ``ema_decay`` was not set. Under ZeRO-1 the slices are
        gathered first, a collective: every rank calls it."""
        ema = (self.state if state is None else state).ema
        if ema is None:
            return None
        ema = self._gathered(ema)
        return [ema[o:o + p.numel()].view_as(p) for o, p in zip(self.offsets, self.params)]

    def _gathered(self, own: torch.Tensor) -> torch.Tensor:
        """A flat buffer from every rank's slice (``own`` as it is without
        a shard group)."""
        if self.shard_group is None:
            return own
        from .parallel.spec import all_gather_flat

        out = torch.empty_like(self.flat_param)
        all_gather_flat(out, own.contiguous(), self.shard_group)
        return out

    def state_dict(self) -> dict:
        """The state and the flat layout: each parameter's name, offset and
        shape in :attr:`flat_param`, in buffer order (the module's
        registration order, not JAX's ``ravel_pytree`` order). Under ZeRO-1
        the moments are this rank's slice (``layout["slice"]``)."""
        return {
            **self.state._asdict(),
            "layout": {"names": list(self.names), "offsets": list(self.offsets),
                       "shapes": [tuple(p.shape) for p in self.params],
                       "numel": self.numel, "padded": self.flat_param.numel(),
                       "slice": (self.slice.start, self.slice.stop)},
        }

    def full_state_dict(self) -> dict:
        """:meth:`state_dict` with the moments gathered whole, the layout of
        a run on one rank (a collective under ZeRO-1)."""
        sd = self.state_dict()
        for k in ("mu", "nu", "ema"):
            if sd[k] is not None:
                sd[k] = self._gathered(sd[k])
        sd["layout"]["slice"] = (0, self.flat_param.numel())
        return sd

    def leaf_state_dict(self) -> dict:
        """The state per parameter: ``{"count": int, "names": [...], "mu":
        {name: tensor shaped like it}, "nu": ..., "ema": ... or None}``,
        views of the whole flat moments (gathered first under ZeRO-1, a
        collective): the layout-free form a portable checkpoint keeps."""
        out = {"count": int(self.state.count), "names": list(self.names)}
        for k in ("mu", "nu", "ema"):
            flat = getattr(self.state, k)
            if flat is not None:
                flat = self._gathered(flat)
                flat = {n: flat[o:o + p.numel()].view_as(p)
                        for n, o, p in zip(self.names, self.offsets, self.params)}
            out[k] = flat
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore the moments, EMA and count from :meth:`state_dict`,
        :meth:`full_state_dict` or :meth:`leaf_state_dict` output (a
        per-leaf optimizer's ``full_state_dict`` too): a flat buffer is
        mapped onto this optimizer's layout by parameter name and offset
        (``state["layout"]``), per-leaf moments by name, and the result cut
        to this rank's slice. A flat buffer that is one rank's slice loads
        only into the same layout and slice."""
        has_ema = state.get("ema") is not None
        if has_ema != (self.ema_decay is not None):
            raise ValueError(
                f"the checkpoint {'carries' if has_ema else 'has no'} params EMA but this "
                f"FusedAdamW has ema_decay={self.ema_decay}: construct it as the run that "
                "saved the state was")
        moments = [self._live_slice(state[k], state, k) if state.get(k) is not None else None
                   for k in ("mu", "nu", "ema")]
        count = torch.tensor(int(state["count"]), dtype=torch.int32,
                             device=self.flat_param.device)
        self.state = FusedAdamWState(count, *moments)

    def _live_slice(self, saved, state: dict, key: str) -> torch.Tensor:
        """``saved`` (a flat buffer in ``state["layout"]``, or per-leaf
        tensors) as this rank's slice of the live flat layout."""
        device = self.flat_param.device
        layout = state.get("layout")
        if layout is not None and not isinstance(saved, (dict, list, tuple)):
            saved = torch.as_tensor(saved)
            start, stop = layout["slice"]
            if (start, stop) != (0, layout["padded"]):
                same = (list(layout["names"]) == self.names
                        and list(layout["offsets"]) == self.offsets
                        and layout["padded"] == self.flat_param.numel()
                        and (start, stop) == (self.slice.start, self.slice.stop))
                if not same:
                    raise ValueError(
                        f"FusedAdamW state {key!r} is one rank's slice {start}:{stop} of another "
                        "layout; load a full_state_dict() (or a portable checkpoint) instead")
                return saved.to(device, torch.float32).clone()
            saved = _leaves_from_flat(saved, layout)
        else:
            saved = dict(zip(self.names, _by_name(saved, state.get("names"), self.names, key)))
        out = torch.zeros_like(self.flat_param)
        for n, o, p in zip(self.names, self.offsets, self.params):
            src = torch.as_tensor(saved[n])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"FusedAdamW state {key}[{n!r}]: shape {tuple(src.shape)}, the "
                                 f"parameter is {tuple(p.shape)}")
            out[o:o + p.numel()].copy_(src.reshape(-1))
        return out[self.slice].clone()


def fused_adamw_eligible(policy) -> bool:
    """Can :class:`FusedAdamW` replace the per-leaf chain under this
    ``parallel`` policy? (JAX ``optim.fused_adamw_eligible``.) DDP and
    ZeRO-1/OSS qualify (flat moments shard over the data axis); ZeRO-2
    and ZeRO-3 shard grads or params per leaf, which a flat vector cannot
    express. The facade and the ladder both pick by it."""
    return not (policy.shard_params or policy.shard_grads)


def clip_stats(opt) -> RecordedClip | None:
    """The recorded clip of the last step (None without a norm clip)."""
    return opt.clip


def has_ema(opt) -> bool:
    """Is an EMA of the parameters being kept?"""
    if isinstance(opt, FusedAdamW):
        return opt.state.ema is not None
    return getattr(opt, "ema", None) is not None


def ema_params(opt, params=None) -> list[torch.Tensor] | None:
    """The EMA of each of ``opt``'s parameters, whole and in its order
    (gathered from the shards when sharded: every rank calls it), cast to
    the dtype of each of ``params`` when given (eval-ready), else f32. None
    when no EMA is kept."""
    ema = opt.ema_params()
    if ema is None:
        return None
    if params is not None:
        ema = [e.to(p.dtype) for e, p in zip(ema, params)]
    return ema


OPTIMIZERS = {"adamw": adamw, "sgd": sgd}


# -- schedules (functions of the step) ----------------------------------------


def onecycle(max_lr: float, total_steps: int, pct_start: float = 0.3, div_factor: float = 25.0,
             final_div_factor: float = 1e4) -> Callable:
    """OneCycleLR twin (cosine annealing strategy, torch defaults): warm up
    from ``max_lr/div_factor`` to ``max_lr`` over ``pct_start`` of training,
    then anneal to ``max_lr/final_div_factor``. The schedule takes an int or
    a 0-d tensor and returns a 0-d f32 tensor on its device."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm = max(1, int(total_steps * pct_start))

    def schedule(step):
        step = torch.clamp(torch.as_tensor(step), max=total_steps).float()
        up = 0.5 * (1 + torch.cos(math.pi * (1 - step / warm)))  # 0 -> 1
        lr_up = initial + (max_lr - initial) * up
        t = torch.clamp((step - warm) / max(1, total_steps - warm), 0.0, 1.0)
        down = 0.5 * (1 + torch.cos(math.pi * t))  # 1 -> 0
        lr_down = final + (max_lr - final) * down
        return torch.where(step < warm, lr_up, lr_down)

    return schedule


def cosine_with_warmup(max_lr: float, total_steps: int, warmup_steps: int = 0,
                       final_lr: float = 0.0) -> Callable:
    """Linear warm-up to ``max_lr`` over ``warmup_steps``, then a cosine
    down to ``final_lr`` at ``total_steps``; as :func:`onecycle`, of a step."""

    def schedule(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(1, warmup_steps), 0.0, 1.0)
        t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_lr + (max_lr - final_lr) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, max_lr * warm, cos)

    return schedule


class OptimizerHandle:
    """What ``stoke_model.optimizer`` returns: a mutable lr cell that the
    schedulers write and the facade reads at each step."""

    def __init__(self, base_lr: float):
        self.lr = float(base_lr)
        self.initial_lr = float(base_lr)

    def __repr__(self):
        return f"OptimizerHandle(lr={self.lr})"


class OneCycleLR:
    """OneCycle (cosine) schedule; per-batch ``.step()`` writes the handle.

    ``lr_scale`` multiplies every value, so a plateau cut routed through it
    persists instead of being overwritten on the next batch.
    """

    def __init__(self, optimizer: OptimizerHandle, max_lr: float,
                 total_steps: int | None = None, epochs: int | None = None,
                 steps_per_epoch: int | None = None, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4):
        if total_steps is None:
            if epochs is None or steps_per_epoch is None:
                raise ValueError("need total_steps or epochs+steps_per_epoch")
            total_steps = epochs * steps_per_epoch
        self.optimizer = optimizer
        self._max_lr = max_lr
        self._initial = max_lr / div_factor
        self._final = self._initial / final_div_factor
        self._total = total_steps
        self._warm = max(1, int(total_steps * pct_start))
        self._t = 0
        self.lr_scale = 1.0
        optimizer.lr = self._lr_at(0)

    def _lr_at(self, step: int) -> float:
        step = min(step, self._total)
        if step < self._warm:
            up = 0.5 * (1 + math.cos(math.pi * (1 - step / self._warm)))
            lr = self._initial + (self._max_lr - self._initial) * up
        else:
            t = min(max((step - self._warm) / max(1, self._total - self._warm), 0.0), 1.0)
            down = 0.5 * (1 + math.cos(math.pi * t))
            lr = self._final + (self._max_lr - self._final) * down
        return lr * self.lr_scale

    def step(self) -> float:
        self._t += 1
        self.optimizer.lr = self._lr_at(self._t)
        return self.optimizer.lr

    def state_dict(self) -> dict:
        return {"t": self._t, "lr_scale": self.lr_scale}

    def load_state_dict(self, d: dict) -> None:
        self._t = int(d["t"])
        self.lr_scale = float(d.get("lr_scale", 1.0))
        self.optimizer.lr = self._lr_at(self._t)


class ReduceLROnPlateau:
    """Plateau scheduler on the host, in two modes: with a handle, a cut
    multiplies its lr by ``factor`` (floored at ``min_lr``); without one,
    :meth:`step` returns a cumulative factor, floored at ``min_factor``."""

    def __init__(self, optimizer: OptimizerHandle | None = None, mode: str = "min",
                 factor: float = 0.1, patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0, min_factor: float = 0.0,
                 verbose: bool = False):
        self.optimizer = optimizer
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.min_factor = min_factor
        self.verbose = verbose
        self.current = 1.0
        self._best: float | None = None
        self._bad = 0
        self._cool = 0

    def _is_better(self, metric: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return metric < self._best * (1 - self.threshold)
        return metric > self._best * (1 + self.threshold)

    def step(self, metric: float) -> float:
        metric = float(metric)
        if self._is_better(metric):
            self._best = metric
            self._bad = 0
        elif self._cool > 0:
            self._cool -= 1
        else:
            self._bad += 1
            if self._bad > self.patience:
                self.current = max(self.current * self.factor, self.min_factor)
                if self.optimizer is not None:
                    self.optimizer.lr = max(self.optimizer.lr * self.factor, self.min_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {self.optimizer.lr:.3e}")
                elif self.verbose:
                    print(f"ReduceLROnPlateau: lr_factor -> {self.current:.3e}")
                self._bad = 0
                self._cool = self.cooldown
        return self.current

    @property
    def factor_value(self) -> float:
        return self.current

    def state_dict(self) -> dict:
        return {
            "current": self.current, "best": self._best, "bad": self._bad,
            "cool": self._cool,
            "lr": None if self.optimizer is None else self.optimizer.lr,
        }

    def load_state_dict(self, d: dict) -> None:
        self.current = d["current"]
        self._best = d.get("best")  # a checkpoint's meta drops None values
        self._bad = d["bad"]
        self._cool = d["cool"]
        if self.optimizer is not None and d.get("lr") is not None:
            self.optimizer.lr = d["lr"]
