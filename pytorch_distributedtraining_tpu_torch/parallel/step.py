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

Not ported yet: ``MultiStep`` (a CUDA-graph twin, the CUDA-graph step
slice), host offload (the offload slice) and the loss scaler inside the
step (the facade has it).
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable

import torch
import torch.distributed as tdist

from ..observe import trace as telemetry
from ..observe.numerics import leaf_norms, probe_layout
from ..optim import FusedAdamW
from ..runtime.mesh import data_group
from .policy import Policy
from .remat import apply_remat, resolve_remat
from .rng import StepRng
from .spec import all_reduce_sum_, all_reduce_tensors
from .state import check_fused
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
          _is_ddp(model) and shard is None)
    if not ok:
        raise ValueError(f"{policy.name} with a per-leaf optimizer needs {want}: build the "
                         "model and optimizer with parallel.create_train_state")


def reduce_gradients(tx, policy: Policy, group, accum: int = 1) -> list[torch.Tensor] | None:
    """After the last backward of a step, make the gradients the global
    batch's mean: summed over ``group`` as ``policy`` says and divided by
    ranks times ``accum``. Returns this rank's share of the grads for a
    per-leaf ``tx.step``; None for ``FusedAdamW``, whose flat gradient is
    reduced in place. Without a group, only the division by ``accum``."""
    world = 1 if group is None else tdist.get_world_size(group)
    if isinstance(tx, FusedAdamW):
        if group is not None:
            all_reduce_sum_(tx.flat_grad, group)
        if world * accum > 1:
            tx.flat_grad.div_(world * accum)
        return None
    shard = tx.shard
    if shard is None or shard.dtensor:
        # one process, DDP's own all-reduce, or FSDP2's reduce-scatter: the
        # ranks are averaged already
        grads = tx.grads() if shard is None else shard.local(tx.grads())
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        return grads
    return shard.reduce_grads(tx.grads(), scatter=policy.shard_grads,
                              scale=1.0 / (world * accum))


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
                 rng: StepRng | int | None = None, numerics=None, detect_anomaly: bool = False):
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
        self._recomputes = resolve_remat(remat) in ("full", "dots")
        self.fused = tx if isinstance(tx, FusedAdamW) else None
        self.grad_accum_steps = int(grad_accum_steps)
        self.rng = rng if isinstance(rng, StepRng) else StepRng(0 if rng is None else rng)
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
            return self._step(batch, lr_factor)

    def _shares(self, grads) -> tuple[list, list]:
        """This rank's share of each gradient and parameter, in ``tx``'s
        order: ``grads`` (from :func:`reduce_gradients`) and the local
        shares, or FusedAdamW's views of its flat buffers."""
        tx = self.tx
        if self.fused is not None:
            return [p.grad for p in tx.params], list(tx.params)
        return grads, list(tx.local)

    def _loss(self, mb, i: int):
        """``loss_fn`` on micro-batch ``i``, with its key when it takes one."""
        if self._keyed == "rng":
            return self.loss_fn(self.model, mb, rng=self.rng.key(i))
        if self._keyed:
            return self.loss_fn(self.model, mb, self.rng.key(i))
        return self.loss_fn(self.model, mb)

    def _forward_backward(self, micro: list) -> tuple[list, list]:
        """Every micro-batch's forward and backward: the losses and auxs."""
        n = len(micro)
        losses, auxs = [], []
        start = [t.clone() for t in self.model_state] if self.model_state and n > 1 else None
        for i, mb in enumerate(micro):
            if start is not None and i > 0:  # every micro-batch from the step's state
                torch._foreach_copy_(self.model_state, start)
            quiet = _is_ddp(self.model) and i < n - 1
            with self.model.no_sync() if quiet else contextlib.nullcontext():
                loss, aux = self._loss(mb, i)
                kept = ([t.clone() for t in self.model_state]
                        if self.model_state and self._recomputes else None)
                loss.backward()
            if kept is not None:  # the forward's update, not the recompute's
                torch._foreach_copy_(self.model_state, kept)
            losses.append(loss.detach())
            auxs.append(aux)
        return losses, auxs

    def _step(self, batch, lr_factor: float) -> dict[str, torch.Tensor]:
        n = self.grad_accum_steps
        self.tx.zero_grad()
        micro = _split_microbatches(batch, n) if n > 1 else [batch]
        before = ([t.clone() for t in self.model_state]
                  if self.model_state and self.detect_anomaly else None)
        losses, auxs = self._forward_backward(micro)
        grads = reduce_gradients(self.tx, self.policy, self.group, n)
        probe, layout = self.numerics, self._layout
        shard = None if self.fused is not None else self.tx.shard
        leaf_grads, leaf_params = self._shares(grads)
        if probe is not None:
            probe.inject(leaf_grads, self.rng.step, layout["names"])
        if self.detect_anomaly:
            self._check_finite(leaf_grads, torch.stack(losses), shard, before)
        # the pre-update parameters' norms, for the probe
        param_norms = leaf_norms(leaf_params) if probe is not None else None
        if self.fused is not None:
            gnorm, _ = self.fused.apply_tree(lr_factor)
        else:
            gnorm = self.tx.step(grads, lr_factor=lr_factor)
            if gnorm is None:
                gnorm = self.tx.norm(grads)
        metrics = {"loss": torch.stack(losses).float().mean()}
        for k in auxs[0]:
            metrics[k] = torch.stack([a[k].detach().float() for a in auxs]).mean(0)
        metrics = mean_over_ranks(metrics, self.group)
        metrics["grad_norm"] = gnorm
        if probe is not None:
            metrics["numerics"] = probe.aux(
                leaf_grads, param_norms=param_norms, grad_norm=gnorm, shard=shard,
                update_norms=None if self.fused is not None else self.tx.update_norms,
                **layout)
        self.rng.step += 1
        return metrics

    def _check_finite(self, grads: list, losses: torch.Tensor, shard, before) -> None:
        """detect_anomaly: read the leaves' and the loss's finiteness (over
        every rank's shares) and raise naming the non-finite ones, the
        BatchNorm statistics put back to the step's start (nothing else has
        changed yet)."""
        bad = (~torch.isfinite(leaf_norms(grads, float("inf")))).float()
        flags = torch.cat([(~torch.isfinite(losses.float())).any().float().reshape(1), bad])
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
        dev = tx.params[0].device
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
            with self.model.no_sync() if _is_ddp(self.model) else contextlib.nullcontext():
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


class EvalStep:
    """``step(batch) -> metrics``: ``eval_fn(model, batch) -> {name:
    scalar}`` without a graph, each value averaged over the ranks of the
    mesh's data axis (each rank evaluates its own shard of the batch)."""

    def __init__(self, model: torch.nn.Module, eval_fn: Callable, mesh=None):
        self.model = model
        self.eval_fn = eval_fn
        self.mesh = mesh
        self.group = None if mesh is None else data_group(mesh)

    @torch.no_grad()
    def __call__(self, batch) -> dict[str, torch.Tensor]:
        return mean_over_ranks(dict(self.eval_fn(self.model, batch)), self.group)
