"""The train step and the eval step, on one device or under a policy.

Counterpart of ``TrainStep`` and ``EvalStep`` in
``pytorch_distributedtraining_tpu/parallel/step.py``: ``loss_fn(model,
batch) -> (loss, aux)``, gradients averaged over ``grad_accum_steps``
micro-batches (the batch's leading dimension split evenly, as
``_split_microbatches`` does), one update of the port's optimizer, scaled
by ``lr_factor``, and metrics that stay on the device: ``loss`` (mean over
micro-batches and ranks), ``grad_norm`` (the global norm before clipping)
and the mean of each aux value. The JAX step's state is the model and
optimizer here, updated in place.

With a mesh, each rank runs its own shard of the global batch and the
gradients are made the global batch's by the policy
(:func:`reduce_gradients`); the model and optimizer come from
:func:`.state.create_train_state`:

- ``DDP``: per-leaf, ``DistributedDataParallel`` all-reduces, with the
  first ``n-1`` micro-batches under ``no_sync``; ``FusedAdamW``, one
  all-reduce of the flat gradient after the last micro-batch;
- ``ZeRO1``: the gradients all-reduced once, the update on this rank's
  shards (or ``FusedAdamW``'s flat slice), the shards all-gathered;
- ``ZeRO2``: as ZeRO-1, with the sharded leaves reduce-scattered;
- ``ZeRO3``: FSDP2 reduce-scatters each micro-batch; the update runs on
  the local shards.

In every policy the numbers are the one-device step's on the global
batch, as in JAX, up to summation order. ``remat`` (default: the
policy's) checkpoints ``loss_fn`` (:mod:`.remat`).

Model state (BatchNorm running statistics, updated in place by a
training forward) follows JAX's step, which keeps it in
``TrainState.model_state``: every micro-batch runs from the step's
starting state and the last micro-batch's update is kept (JAX's "state:
keep last"), so ``grad_accum_steps`` micro-batches update it once, not n
times in a row. A forward that ``remat`` recomputes in backward does not
update it twice.

The random stream: ``rng`` (a :class:`~.rng.StepRng`, pass the train
state's ``state.rng`` so that ``state.state_dict()`` carries it) fixes
each micro-batch's dropout key by ``(seed, step, micro-batch)``, in place
of JAX's ``fold_in(state.rng, step)`` and ``fold_in(rng, i)``, and
advances one step a call. A ``loss_fn`` that takes a third argument (or
an ``rng`` keyword) gets the key, ``loss_fn(model, batch, key)``, and
hands it to the model (``model(x, deterministic=False, generator=key)``);
``loss_fn(model, batch)`` callers are called as before.

``numerics`` (True or an ``observe.numerics.NumericsProbe``) adds
``metrics["numerics"]``, the probe's aux of the step's gradients (after
reduction, before the update), the pre-update parameters and, with a
per-leaf optimizer, each leaf's update; nothing is read back to the
host. Its ``GRAFT_NUMERICS_INJECT`` spec poisons the named gradient leaf
at its step before the update. ``detect_anomaly=True`` reads the
gradients' and the loss's finiteness back every step and raises
``FloatingPointError`` naming the non-finite leaves before the update,
with the parameters, optimizer state, BatchNorm statistics and the step
stream as they were before the step. Each call runs inside
``observe.trace.dispatch_span(self, "TrainStep")``: the first is billed
as ``compile`` (on the card that includes the first use's kernel build),
the rest as ``step``.

:meth:`TrainStep.comm_cost` is JAX's analytic bytes on the wire of a
step's gradient hop; :meth:`TrainStep.trace_comms` profiles one step and
returns the collectives it ran (``observe.comms``), in place of JAX's
``compiled_text`` and an HLO audit: eager torch has no compiled program to
read, so the port reads what the profiler recorded of each c10d call.

:meth:`TrainStep.memory_analysis` measures a step's peak device memory
for ``observe.memory.tune_batch_size``: JAX reads the compiled program's
plan without running a step; the port runs one forward and backward.

``loss_scaler`` (a ``precision.DynamicLossScaler``) is JAX's in-step
scaler: each micro-batch's loss is scaled before its backward, the
gradients are unscaled after the reduction, their finiteness (over every
rank's shares) gates the whole update on the device, and the scaler backs
off or grows by selects; ``metrics["loss_scale"]`` is the scale after the
step. Nothing of it is read back to the host.

The step's scalars are device tensors, so the step can be captured as a
CUDA graph: the optimizer's count and lr factor (``optim``), the scaler's
state, and the step counter that keys dropout and the numerics probe's
injection (a device copy of ``rng.step``, written before each call and
advanced on the device; ``rng.step`` stays the host's record, advanced
after the call). :class:`MultiStep` runs K steps as one captured graph
(``parallel.graph.StepGraph``) replayed by one launch, JAX's ``lax.scan``
of K steps in one dispatch; :func:`tune_multi_step_k` measures which K
pays. :meth:`TrainStep.state_snapshot` and :meth:`TrainStep.restore_state`
copy every tensor a step writes (the graph's warm-up runs between them).

Host offload (JAX ``step.py:230-243``, ``:733-735``): under
``Policy(offload_params=True)`` the step streams the parameters to the
card before the forward (``tx.params_in()``) and the optimizer writes them
back after the update; under ``offload_opt_state`` the optimizer streams
its state in and out around the update (``optim``). :class:`EvalStep`
streams the parameters in for its forward and drops the copies after.
Both run inside a captured graph: the copies fork from the current stream
and join it again. Under ``DDP`` with offloaded parameters there is no
``DistributedDataParallel`` wrapper (``parallel.state``):
:func:`reduce_gradients` all-reduces the grads itself.

A program a graph may capture (:meth:`TrainStep.program` under
``MultiStep`` and ``Stoke.fused_step``, the facade's programs,
:class:`EvalStep`) runs a ``DistributedDataParallel`` model without its
wrapper (:func:`unwrapped`): the reducer's bucketed all-reduces, its
``no_sync`` and its end-of-backward callback stay out of the capture, and
:func:`reduce_gradients` all-reduces the grads once after the last
micro-batch, as it does for offloaded parameters. The eager ``TrainStep``
call keeps the wrapper and its overlap of the all-reduce with the
backward. On the card the wrapper is built under a side stream
(``parallel.state``), so the AccumulateGrad nodes its reducer keeps can
join a captured backward.
"""

from __future__ import annotations

import contextlib
import inspect
import math
import time
from typing import Callable

import torch
import torch.distributed as tdist

from ..observe import trace as telemetry
from ..observe.numerics import leaf_norms, probe_layout
from ..optim import FusedAdamW
from ..runtime.mesh import data_group
from .policy import Policy
from .remat import apply_remat, resolve_remat
from .graph import StepGraph, signature
from .rng import DropoutKey, StepRng
from .spec import all_reduce_sum_, all_reduce_tensors
from .state import check_fused, reshard
from .sync_bn import batch_norm_state


def _split_microbatches(batch, n: int) -> list:
    """A ``[B, ...]`` tensor, or a tuple of them -> ``n`` batches of ``[B/n, ...]``."""

    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum_steps {n}")
        return x.chunk(n)

    if isinstance(batch, torch.Tensor):
        return list(split(batch))
    return list(zip(*(split(x) for x in batch)))


def takes_rng(fn: Callable) -> str | None:
    """How ``fn`` takes a key after ``(model, batch)``: ``"rng"`` for a
    parameter named ``rng`` (passed by keyword), ``"positional"`` for a third
    positional parameter without a default or ``*args``, else ``None``."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return None
    for p in params:
        if p.name == "rng" and p.kind not in (p.POSITIONAL_ONLY, p.VAR_POSITIONAL, p.VAR_KEYWORD):
            return "rng"
    positional = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if len(positional) >= 3 and positional[2].default is inspect.Parameter.empty:
        return "positional"
    if len(positional) < 3 and any(p.kind is p.VAR_POSITIONAL for p in params):
        return "positional"
    return None


def _is_ddp(model) -> bool:
    from torch.nn.parallel import DistributedDataParallel

    return isinstance(model, DistributedDataParallel)


def unwrapped(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` without its ``DistributedDataParallel`` wrapper: what a
    program that may be captured runs (the module docstring)."""
    return model.module if _is_ddp(model) else model


def check_layout(model, tx, mesh, policy: Policy) -> None:
    """Refuse a model and optimizer that were not built for ``policy`` on
    ``mesh`` (by :func:`.state.create_train_state`)."""
    if mesh is None:
        return
    fused = isinstance(tx, FusedAdamW)
    if fused:
        check_fused(policy)
        if policy.shard_opt_state and tx.shard_group is None:
            raise ValueError("FusedAdamW under ZeRO-1 needs its shard_group: build it with "
                             "parallel.create_train_state")
        return
    shard = getattr(tx, "shard", None)
    want = ("the FSDP2-sharded model and a dtensor ShardPlan" if policy.shard_params else
            "a ShardPlan of leaf_spec dims" if policy.shard_opt_state else
            "a DistributedDataParallel model")
    ok = (shard is not None and shard.dtensor if policy.shard_params else
          shard is not None and not shard.dtensor if policy.shard_opt_state else
          (_is_ddp(model) or tx.offloaded_params) and shard is None)
    if not ok:
        raise ValueError(f"{policy.name} with a per-leaf optimizer needs {want}: build the "
                         "model and optimizer with parallel.create_train_state")


def reduce_gradients(tx, policy: Policy, group, accum: int = 1, *,
                     all_reduce: bool = False) -> list[torch.Tensor] | None:
    """After the last backward of a step, make the gradients the global
    batch's mean: summed over ``group`` as ``policy`` says and divided by
    ranks times ``accum``. Returns this rank's share of the grads for a
    per-leaf ``tx.step``; None for ``FusedAdamW``, whose flat gradient is
    reduced in place. Without a group, only the division by ``accum``.
    ``all_reduce``: the backward ran without a ``DistributedDataParallel``
    wrapper that the layout has (a program, :func:`unwrapped`), so the
    replicated grads are all-reduced here, as with offloaded parameters."""
    world = 1 if group is None else tdist.get_world_size(group)
    if isinstance(tx, FusedAdamW):
        if group is not None:
            all_reduce_sum_(tx.flat_grad, group)
        if world * accum > 1:
            tx.flat_grad.div_(world * accum)
        return None
    shard = tx.shard
    if shard is None and group is not None and (all_reduce or tx.offloaded_params):
        # DDP's layout without its wrapper (a program, offloaded parameters): one all-reduce
        return all_reduce_tensors(tx.grads(), group, 1.0 / (world * accum))
    if shard is None or shard.dtensor:
        # one process, DDP's own all-reduce, or FSDP2's reduce-scatter: the
        # ranks are averaged already
        grads = tx.grads() if shard is None else shard.local(tx.grads())
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        return grads
    return shard.reduce_grads(tx.grads(), scatter=policy.shard_grads,
                              scale=1.0 / (world * accum))


def all_finite(finite: torch.Tensor, group) -> torch.Tensor:
    """``finite`` (a device bool) on every rank of ``group`` at once, by one
    all-reduce of the bad flag (as it is without a group): a shard's
    overflow skips the step everywhere. No host read."""
    if group is None:
        return finite
    bad = (~finite).float().reshape(1)
    all_reduce_sum_(bad, group)
    return bad[0] == 0


def mean_over_ranks(values: dict, group) -> dict:
    """Each value (f32) averaged over the ranks of ``group`` by one
    all-reduce (as they are without a group)."""
    if group is None or not values:
        return values
    means = all_reduce_tensors([v.float() for v in values.values()], group,
                               1.0 / tdist.get_world_size(group))
    return dict(zip(values, means))


class TrainStep:
    """``step(batch, lr_factor=1.0) -> metrics``: one optimizer step of ``model``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, tx, mesh=None,
                 policy: Policy | None = None, *, grad_accum_steps: int = 1, remat=None,
                 rng: StepRng | int | None = None, numerics=None, detect_anomaly: bool = False,
                 loss_scaler=None):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.model = model
        self.policy = policy or Policy()
        self.mesh = mesh
        check_layout(model, tx, mesh, self.policy)
        self.group = None if mesh is None else data_group(mesh)
        remat = self.policy.remat if remat is None else remat
        self._keyed = takes_rng(loss_fn)
        self.loss_fn = apply_remat(loss_fn, remat)
        self.tx = tx
        self.model_state = batch_norm_state(model)
        self._recomputes = resolve_remat(remat) != "none"  # every policy but none recomputes
        self.fused = tx if isinstance(tx, FusedAdamW) else None
        self.grad_accum_steps = int(grad_accum_steps)
        self.rng = rng if isinstance(rng, StepRng) else StepRng(0 if rng is None else rng)
        self.device = tx.device  # where the step runs (offloaded parameters live on the host)
        # the step counter on the device: dropout keys and the probe's
        # injection read it, so a captured graph needs no host value
        self.step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self.loss_scaler = None if loss_scaler is None else loss_scaler.to(self.device)
        self.detect_anomaly = bool(detect_anomaly)
        if numerics is True:
            from ..observe.numerics import NumericsProbe

            numerics = NumericsProbe()
        self.numerics = numerics or None
        self._layout = None
        if self.numerics is not None:
            self._layout = probe_layout(model, tx)
            if self.fused is None:
                tx.track_updates = True

    def __call__(self, batch, lr_factor: float = 1.0) -> dict[str, torch.Tensor]:
        with telemetry.dispatch_span(self, "TrainStep"):
            self.prepare(lr_factor)
            metrics = self._step(batch)
        self.rng.step += 1
        return metrics

    def prepare(self, lr_factor) -> None:
        """Write the next step's host values into its device scalars: the
        optimizer's lr factor and the step counter (``rng.step``). Fills,
        never copies from the host; outside a captured graph."""
        self.tx.set_lr_factor(lr_factor)
        self.step_t.fill_(self.rng.step)
        self.tx.release_params()  # device copies a forward outside the step left

    def bound_grads(self) -> list:
        """The parameters whose ``.grad`` a captured step writes and
        ``StepGraph`` binds back before each replay: a per-leaf
        optimizer's (it drops them between steps); none for
        ``FusedAdamW``, whose grads stay views of its flat buffer."""
        if self.fused is not None or self.tx.offloaded_params:
            return []  # offloaded: the parameters are on the host between replays
        return list(self.tx.params)

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a step writes: the parameters (``FusedAdamW``'s flat
        buffer), the model's buffers (BatchNorm statistics), the optimizer's
        state, the loss scaler's and the step counter. The gradients are
        not state: a step starts by zeroing them."""
        params = [] if self.fused is not None else list(self.tx.params)
        scaler = [] if self.loss_scaler is None else self.loss_scaler.state_tensors()
        return (params + list(self.model.buffers()) + self.tx.state_tensors() + scaler
                + [self.step_t])

    def state_snapshot(self) -> dict:
        """A copy of :meth:`state_tensors` and of the host's step count."""
        self.tx.settle()
        with torch.no_grad():
            return {"step": self.rng.step, "tensors": [t.clone() for t in self.state_tensors()]}

    def restore_state(self, snapshot: dict) -> None:
        """Put a :meth:`state_snapshot` back, in place (every tensor keeps
        its storage, so a captured graph still reads and writes it)."""
        self.tx.settle()
        with torch.no_grad():
            for t, v in zip(self.state_tensors(), snapshot["tensors"]):
                t.copy_(v)
        self.rng.step = snapshot["step"]

    def _shares(self, grads) -> tuple[list, list]:
        """This rank's share of each gradient and parameter, in ``tx``'s
        order: ``grads`` (from :func:`reduce_gradients`) and the local
        shares, or FusedAdamW's views of its flat buffers."""
        tx = self.tx
        if self.fused is not None:
            return [p.grad for p in tx.params], list(tx.params)
        return grads, list(tx.local)

    def _loss(self, mb, i: int, model=None):
        """``loss_fn`` on micro-batch ``i`` (of ``model``, default the
        step's), with its key when it takes one: the key holds a device
        copy of the step counter, a value that later steps do not change."""
        model = self.model if model is None else model
        if not self._keyed:
            return self.loss_fn(model, mb)
        key = DropoutKey(self.rng.seed, self.step_t.clone(), i)
        if self._keyed == "rng":
            return self.loss_fn(model, mb, rng=key)
        return self.loss_fn(model, mb, key)

    def _forward_backward(self, micro: list, model) -> tuple[list, list]:
        """Every micro-batch's forward and backward through ``model``: the
        losses and auxs. A DDP wrapper syncs at the last micro-batch only."""
        n = len(micro)
        losses, auxs = [], []
        start = [t.clone() for t in self.model_state] if self.model_state and n > 1 else None
        for i, mb in enumerate(micro):
            if start is not None and i > 0:  # every micro-batch from the step's state
                torch._foreach_copy_(self.model_state, start)
            quiet = _is_ddp(model) and i < n - 1
            with model.no_sync() if quiet else contextlib.nullcontext():
                loss, aux = self._loss(mb, i, model)
                kept = ([t.clone() for t in self.model_state]
                        if self.model_state and self._recomputes else None)
                scaler = self.loss_scaler
                (loss if scaler is None else scaler.scale_loss(loss)).backward()
            if kept is not None:  # the forward's update, not the recompute's
                torch._foreach_copy_(self.model_state, kept)
            losses.append(loss.detach())
            auxs.append(aux)
        return losses, auxs

    def program(self, batch) -> dict[str, torch.Tensor]:
        """:meth:`_step` as a graph captures it (``MultiStep``,
        ``Stoke.fused_step``): a DDP model runs without its wrapper and
        :func:`reduce_gradients` all-reduces its grads (the module
        docstring says why)."""
        return self._step(batch, program=True)

    def _step(self, batch, program: bool = False) -> dict[str, torch.Tensor]:
        """One step at the optimizer's lr factor and the device step
        counter (both written by :meth:`prepare`); advances the counter on
        the device. No host read unless ``detect_anomaly``. ``program``:
        as :meth:`program`."""
        n = self.grad_accum_steps
        self.tx.zero_grad()
        self.tx.params_in()  # offloaded parameters: to the device for the forward
        micro = _split_microbatches(batch, n) if n > 1 else [batch]
        before = ([t.clone() for t in self.model_state]
                  if self.model_state and self.detect_anomaly else None)
        model = unwrapped(self.model) if program else self.model
        losses, auxs = self._forward_backward(micro, model)
        grads = reduce_gradients(self.tx, self.policy, self.group, n,
                                 all_reduce=model is not self.model)
        probe, layout, scaler = self.numerics, self._layout, self.loss_scaler
        shard = None if self.fused is not None else self.tx.shard
        if scaler is not None and self.fused is None:
            grads = scaler.unscale(grads)  # f32 before clip and update (JAX's tree path)
        leaf_grads, leaf_params = self._shares(grads)
        if probe is not None:
            probe.inject(leaf_grads, self.step_t, layout["names"])
        if self.detect_anomaly:
            self._check_finite(leaf_grads, torch.stack(losses), shard, before,
                               nan_only=scaler is not None)
        # the pre-update parameters' norms, for the probe
        param_norms = leaf_norms(leaf_params) if probe is not None else None
        finite = None
        if self.fused is not None:
            gnorm, finite = self.fused.apply_tree(scaler=scaler)
        else:
            if scaler is not None:
                finite = all_finite(scaler.grads_finite(grads),
                                    None if shard is None else shard.group)
            gnorm = self.tx.step(grads, gate=finite)
            if gnorm is None:
                gnorm = self.tx.norm(grads)
        if scaler is not None:
            scaler.update(finite)
        metrics = {"loss": torch.stack(losses).float().mean()}
        for k in auxs[0]:
            metrics[k] = torch.stack([a[k].detach().float() for a in auxs]).mean(0)
        metrics = mean_over_ranks(metrics, self.group)
        metrics["grad_norm"] = gnorm
        if scaler is not None:
            metrics["loss_scale"] = scaler.scale.clone()
        if probe is not None:
            metrics["numerics"] = probe.aux(
                leaf_grads, param_norms=param_norms, grad_norm=gnorm, shard=shard,
                update_norms=None if self.fused is not None else self.tx.update_norms,
                **layout)
        self.step_t.add_(1)
        return metrics

    def _check_finite(self, grads: list, losses: torch.Tensor, shard, before,
                      nan_only: bool = False) -> None:
        """detect_anomaly: read the leaves' and the loss's finiteness (over
        every rank's shares) and raise naming the non-finite ones, the
        BatchNorm statistics put back to the step's start (nothing else has
        changed yet). With a loss scaler only NaN counts (an inf is the
        scaler's own skip, as in JAX and torch)."""
        bad_value = torch.isnan if nan_only else (lambda v: ~torch.isfinite(v))
        bad = bad_value(leaf_norms(grads, float("inf"))).float()
        flags = torch.cat([bad_value(losses.float()).any().float().reshape(1), bad])
        if shard is not None:
            all_reduce_sum_(flags, shard.group)
        elif self.group is not None:
            all_reduce_sum_(flags, self.group)
        flags = flags.cpu()
        if not flags.any():
            return
        if before is not None:
            torch._foreach_copy_(self.model_state, before)
        names = self._layout["names"] if self._layout else list(self.tx.names)
        bad_names = (["<loss>"] if flags[0] else []) + [
            n for n, f in zip(names, flags[1:].tolist()) if f]
        raise FloatingPointError("detect_anomaly: non-finite values in " + ", ".join(
            bad_names[:8]) + (" ..." if len(bad_names) > 8 else ""))

    def comm_cost(self, params=None) -> dict:
        """Analytic bytes on the wire for the gradient hop of one step, as
        JAX's ``TrainStep.comm_cost``: a reduce-scattered leaf moves its n
        f32 bytes once, an all-reduced one twice (the reduce and the
        gather hops); leaves below the policy's ``min_shard_size`` (or with
        no dimension the axis divides) stay whole and pay the all-reduce
        rate even under ``shard_grads``. ``params``: tensors or shapes
        (default: the model's trainable parameters, at their full shapes).
        This is JAX's layout: FSDP2 (ZeRO-3 here) reduce-scatters every
        leaf, small ones too, padded along its first dimension, so a traced
        ZeRO-3 step moves other bytes than this count."""
        from ..runtime.mesh import mesh_axis_size
        from .spec import leaf_spec, shard_axis

        ax = shard_axis(self.mesh)
        size = mesh_axis_size(self.mesh, ax) if ax else 1
        if ax is None or size <= 1:
            return {"collective": None, "fp32_bytes": 0, "wire_bytes": 0, "wire_format": None,
                    "axis": None, "axis_size": 1}
        if params is None:
            params = [p for p in self.model.parameters() if p.requires_grad]
        rs = bool(self.policy.shard_grads)
        total = 0
        for p in params:
            shape = tuple(getattr(p, "shape", p))
            n = 1
            for d in shape:
                n *= int(d)
            scattered = rs and leaf_spec(shape, ax, size, self.policy.min_shard_size) is not None
            total += (1 if scattered else 2) * n * 4
        return {
            "collective": "reduce-scatter" if rs else "all-reduce",
            "fp32_bytes": int(total),
            "wire_bytes": int(total),  # f32 wire: no quantized format
            "wire_format": None,
            "axis": ax,
            "axis_size": size,
        }

    def trace_comms(self, batch, lr_factor: float = 1.0) -> list:
        """Run one step of ``batch`` under the guarded profiler and return
        the collectives it ran, ``observe.comms.WireCollective`` records in
        trace order (the counterpart of JAX's ``compiled_text`` and
        ``observe.hlo.wire_inventory``). The step updates the state as any
        step does. Every rank calls it under a process group."""
        from ..observe import comms, profiling

        world = 1 if self.group is None else tdist.get_world_size(self.group)
        _, events = profiling.profile_call(lambda: self(batch, lr_factor))
        return comms.wire_inventory(events, group_size=world)

    def memory_analysis(self, batch):
        """The step's device memory at ``batch`` as an
        ``observe.memory.MemoryStats``, measured: one forward and backward
        of the first micro-batch (no update) between a reset of the
        allocator's peak and a read of it. JAX compiles the step and reads
        XLA's plan without running anything; eager torch has no such plan,
        so this runs the step's compute once. ``argument_bytes`` is what
        was allocated before (parameters, optimizer state, the batch),
        ``temp_bytes`` the rise to the peak. The parameters, their
        gradients (as they lay), the optimizer state, the BatchNorm
        statistics and the step stream are as they were afterwards. An
        out-of-memory error reads as a peak above the card's memory (does
        not fit). On the CPU there is no allocator peak: None, so
        ``tune_batch_size`` returns its ``start``. Every rank calls it under
        a process group (the backward's collectives)."""
        from ..observe.memory import MemoryStats, device_hbm_budget

        tx = self.tx
        dev = tx.device
        if dev.type != "cuda":
            return None
        n = self.grad_accum_steps
        mb = _split_microbatches(batch, n)[0] if n > 1 else batch
        state = [t.clone() for t in self.model_state]
        fused = self.fused
        saved = fused.flat_grad.to("cpu") if fused is not None else [p.grad for p in tx.params]
        if fused is not None:
            fused.flat_grad.zero_()
        else:
            for p in tx.params:
                p.grad = None
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        oom = False
        try:
            with self.model.no_sync() if _is_ddp(self.model) else contextlib.nullcontext(), \
                    tx.params_on_device():
                loss, _ = self._loss(mb, 0)
                loss.backward()
                del loss
            torch.cuda.synchronize(dev)
        except torch.cuda.OutOfMemoryError:
            oom = True
        peak = torch.cuda.max_memory_allocated(dev)
        if fused is not None:
            fused.flat_grad.copy_(saved)
        else:
            for p, g in zip(tx.params, saved):
                p.grad = g
        if state:
            torch._foreach_copy_(self.model_state, state)
        if oom:
            torch.cuda.empty_cache()
            peak = device_hbm_budget(dev) + 1
        return MemoryStats(argument_bytes=int(base), output_bytes=0,
                           temp_bytes=int(peak - base), alias_bytes=0, generated_code_bytes=0)


def _window_item(batches, i: int):
    """Step ``i``'s batch of a stacked window (a tensor or a tuple of them)."""
    if isinstance(batches, torch.Tensor):
        return batches[i]
    return type(batches)(x[i] for x in batches)


def _stack_metrics(ms: list) -> dict:
    """K steps' metrics as one dict of ``[K, ...]`` stacks (nested dicts,
    the numerics aux, stacked leaf by leaf)."""
    out = {}
    for key, v in ms[0].items():
        if isinstance(v, dict):
            out[key] = _stack_metrics([m[key] for m in ms])
        else:
            out[key] = torch.stack([m[key] for m in ms])
    return out


class MultiStep:
    """K train steps as ONE captured CUDA graph, replayed by one launch
    (JAX's ``MultiStep``: K steps as one ``lax.scan`` dispatch).

    Amortizes the host's launch cost over K steps, where the host paces
    the step (``PERF.md`` §5: the bf16 SwinIR steps)::

        multi = MultiStep(step, k=8)
        for stacked in multi.feed(loader):     # tensors [8, B, ...]
            metrics = multi(stacked)           # one graph launch

    Semantics against K ``step()`` calls: the same math and state, the
    dropout keys and the probe's injection keyed per step (the device step
    counter advances inside the graph), ``step.rng.step`` advanced by K
    afterwards. Metrics come back stacked ``[K]`` (the numerics aux too),
    copied out of the graph's outputs, so they do not change at the next
    replay. ``lr_factor`` is constant across the window.

    On the card the first window (and a window of new shapes) is captured:
    the stacked batch is copied into static ``[K, B, ...]`` buffers, the K
    steps run ``parallel.graph.WARMUP`` times on a side stream (which builds
    the kernels and every cache at first use) between a snapshot of the
    state and its restore, then one capture; every call copies its window
    into the buffers and replays. A failed capture or replay raises;
    nothing falls back to eager. On the CPU the same runner calls the K
    steps directly. Every layout captures: ZeRO-3 (FSDP2's hooks, copies
    and streams inside the capture) and a ``DistributedDataParallel``
    model, whose steps run :meth:`TrainStep.program` (the bare module, the
    grads all-reduced once). ``detect_anomaly`` (a host read every step)
    cannot be captured and raises here, on the CPU too.
    """

    def __init__(self, step: TrainStep, k: int):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        refuse_capture(step, "MultiStep")
        self.step = step
        self.k = int(k)
        self.graph = StepGraph(step, self._window)

    def _window(self, batches) -> dict:
        return _stack_metrics([self.step.program(_window_item(batches, i))
                               for i in range(self.k)])

    def __call__(self, batches, lr_factor: float = 1.0) -> dict[str, torch.Tensor]:
        """``batches``: a tensor or tuple of tensors, each ``[K, B, ...]``."""
        first = batches if isinstance(batches, torch.Tensor) else batches[0]
        k = first.shape[0]
        if k != self.k:
            raise ValueError(f"stacked batch has window {k}, MultiStep captured for {self.k}")
        with telemetry.dispatch_span(self, "MultiStep"):
            metrics = self.graph(batches, lr_factor)
        self.step.rng.step += self.k
        return metrics

    def feed(self, loader, depth: int | None = None):
        """Stacked windows from a loader (``data.DataLoader``), staged ahead
        by its device prefetch: ``depth`` batches (default ``k``, one whole
        window) copy to the device while the previous window computes, then
        :func:`~..data.loader.stack_windows` stacks each ``k``."""
        from ..data.loader import stack_windows

        return stack_windows(loader.device_iter(depth=self.k if depth is None else depth),
                             self.k)


def refuse_capture(step, what: str) -> None:
    """Raise ``ValueError`` where ``step`` (a ``TrainStep``) cannot run as
    a captured graph: ``detect_anomaly``. Every layout captures, ZeRO-3 and
    a ``DistributedDataParallel`` model too (``parallel.graph``'s docstring
    says how their streams join the capture)."""
    if step.detect_anomaly:
        raise ValueError(
            f"{what} cannot capture a step with detect_anomaly=True: it reads the gradients' "
            "finiteness back to the host every step; use the numerics probe (numerics=True), "
            "which stays on the device")


def tune_multi_step_k(step: TrainStep, batch, ks=(1, 2, 5, 10), steps_per_arm: int = 20,
                      lr_factor: float = 1.0):
    """Measure K steps per graph launch on the live device and pick the
    winner (JAX's ``tune_multi_step_k``)::

        best_k, rates, state = tune_multi_step_k(step, batch)
        multi = MultiStep(step, best_k) if best_k > 1 else step

    Each arm takes one call (capture and warm-up on the card) and then
    ``steps_per_arm // k`` timed calls of ``batch`` repeated K times, at
    ``lr_factor``: real optimizer steps, so the state advances (in place).
    The time is wall clock per completed arm, ended by a read of the last
    loss, so no arm can look fast by not waiting. Returns ``(best_k, {k:
    steps_per_sec}, state)``, ``state`` a :meth:`TrainStep.state_snapshot`
    of the advanced state. On a non-finite loss the raised
    ``RuntimeError`` carries ``err.state``, the snapshot taken before the
    failing arm (last-good: ``step.restore_state(err.state)`` resumes from
    it)."""
    rates: dict[int, float] = {}
    for k in ks:
        k = int(k)
        n_calls = max(1, steps_per_arm // k)
        snapshot = step.state_snapshot()
        if k == 1:
            runner, fed = step, batch
        else:
            runner = MultiStep(step, k)
            fed = (batch.expand(k, *batch.shape) if isinstance(batch, torch.Tensor)
                   else type(batch)(x.expand(k, *x.shape) for x in batch))
        metrics = runner(fed, lr_factor)  # capture and warm-up
        float(metrics["loss"].reshape(-1)[-1])
        t0 = time.perf_counter()
        for _ in range(n_calls):
            metrics = runner(fed, lr_factor)
        last = float(metrics["loss"].reshape(-1)[-1])  # waits for every step of the arm
        if not math.isfinite(last):
            err = RuntimeError(f"non-finite loss while tuning k={k}")
            err.state = snapshot  # pre-arm: last-good by construction
            raise err
        rates[k] = k * n_calls / (time.perf_counter() - t0)
    best_k = max(rates, key=rates.get)
    return best_k, rates, step.state_snapshot()


class EvalStep:
    """``step(batch) -> metrics``: ``eval_fn(model, batch) -> {name:
    scalar}`` as one program (JAX's compiled eval step): on the card a
    captured CUDA graph per input signature (``parallel.graph.StepGraph``,
    one shared pool; a last partial batch is one more capture), on the CPU
    the function itself. Each value is then averaged over the ranks of the
    mesh's data axis (each rank evaluates its own shard of the batch),
    outside the program: on gloo that all-reduce is a host-side call. A
    DDP model runs without its wrapper (:func:`unwrapped`). ``tx``, the
    train state's optimizer, streams offloaded parameters in for the
    forward (JAX's ``stream_to_device`` in the eval program)."""

    def __init__(self, model: torch.nn.Module, eval_fn: Callable, mesh=None, tx=None):
        self.model = model
        self.eval_fn = eval_fn
        self.mesh = mesh
        self.tx = tx
        self.group = None if mesh is None else data_group(mesh)
        self.device = tx.device if tx is not None else next(model.parameters()).device
        self.graphs: dict = {}  # input signature -> StepGraph
        self._pool = None

    def __call__(self, batch) -> dict[str, torch.Tensor]:
        key = signature(batch)
        graph = self.graphs.get(key)
        if graph is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            graph = self.graphs[key] = StepGraph(self, self._program, pool=self._pool)
        return mean_over_ranks(graph(batch), self.group)

    @torch.no_grad()
    def _program(self, batch) -> dict:
        with self.tx.params_on_device() if self.tx is not None else contextlib.nullcontext():
            metrics = dict(self.eval_fn(unwrapped(self.model), batch))
        reshard(self.model)  # the next program gathers from the shards again
        return metrics

    # the StepGraph owner (parallel.graph.GraphOwner): an eval writes no state

    def prepare(self) -> None:
        if self.tx is not None:
            self.tx.release_params()

    def state_snapshot(self) -> None:
        return None

    def restore_state(self, snapshot) -> None:
        pass

    def bound_grads(self) -> list:
        return []
