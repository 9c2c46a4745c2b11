"""Training-numerics observability: blame attribution and the divergence
watchdog.

Counterpart of ``pytorch_distributedtraining_tpu/observe/numerics.py``. Two
halves:

- **On-device probes** (:class:`NumericsProbe`): ``TrainStep`` (and the
  facade's step) call :meth:`NumericsProbe.aux` after the gradients are
  reduced and before the update, and put its dict under
  ``metrics["numerics"]``. It reads nothing back to the host: per-leaf
  finite flags (from each leaf's largest magnitude in f32, which never
  overflows on finite values, as an L2 norm can), the first offending
  leaf, each leaf's first offending row along its JAX leading axis
  (``bad_layer``; ``interop.jax_leading_axes`` gives the axis, so a
  ``Linear`` weight reports JAX's kernel row), the gradient norm (the
  recorded clip's when there is one), the norm of the pre-update
  parameters and, on the per-leaf optimizer path, each leaf's
  ``||update|| / ||param||``. Under a sharded policy every one of these is
  the global leaf's: squares and flags summed over the data group (whole
  leaves counted once), rows by a minimum, so world 2 reports what world 1
  does. The fp8 and quantized-wire fields stay absent until the fp8 matmul
  and wire slices land.
- **Host-side watchdog** (:class:`NumericsWatchdog`): JAX's rolling
  robust-z (MAD) detector over the loss and grad-norm series and a
  non-finite streak, with the policy action ``halt`` (raise),
  ``rollback`` (restore the newest committed checkpoint through
  ``checkpoint_sharded.CheckpointManager.restore_latest``) or ``degrade``
  (``GRAFT_WIRE`` back to the f32 wire for a restart).

Leaves are named by the port's parameter names (``transformer.h.0.attn.
c_attn.weight``), in the optimizer's order (torch's registration order,
not flax's sorted one): ``first_bad_leaf`` is an index into that list, and
:meth:`NumericsProbe.leaf_name` the name.

Env knobs (resolved by the facade and the drivers):

- ``GRAFT_NUMERICS``           enable the probes
- ``GRAFT_NUMERICS_ACTION``    halt | rollback | degrade (watchdog policy)
- ``GRAFT_NUMERICS_EVERY``     decode cadence in steps (the facade's)
- ``GRAFT_NUMERICS_INJECT``    ``<leaf-substring>@<step>``: NaN into every
  gradient leaf whose name holds the substring, at that step (0-based, the
  step count before it), before the update
"""

from __future__ import annotations

import collections
import math
import os
import time

from . import trace as _trace

__all__ = [
    "NumericsProbe",
    "NumericsWatchdog",
    "NumericsDivergence",
    "parse_inject_spec",
    "probe_from_env",
    "watchdog_from_env",
    "snapshot",
    "reset",
    "runtime_stats",
    "rolling_gauges",
    "ACTIONS",
]

ACTIONS = ("halt", "rollback", "degrade")

runtime_stats: dict = {
    "enabled": False,
    "action": None,
    "steps_observed": 0,
    "nonfinite_steps_total": 0,
    "last_nonfinite": None,  # {"step", "leaf", "layer"}
    "grad_norm_last": None,
    "verdicts": [],  # watchdog trip records, newest last
    "degraded_wire": False,
}

# the latest gauge values, by Prometheus-style name
rolling_gauges: dict = {}

# a row index above any leaf's: "no offending row" before the minimum
_NO_ROW = 2**31 - 1


def reset() -> None:
    """Restore the module gauges to their import-time state (they are
    process-global on purpose: the flight record reads them)."""
    runtime_stats.update(
        enabled=False,
        action=None,
        steps_observed=0,
        nonfinite_steps_total=0,
        last_nonfinite=None,
        grad_norm_last=None,
        verdicts=[],
        degraded_wire=False,
    )
    rolling_gauges.clear()


def snapshot() -> dict:
    """Numerics state for the crash flight recorder: compact, json-safe."""
    return {
        "steps_observed": runtime_stats["steps_observed"],
        "nonfinite_steps_total": runtime_stats["nonfinite_steps_total"],
        "last_nonfinite": runtime_stats["last_nonfinite"],
        "grad_norm_last": runtime_stats["grad_norm_last"],
        "verdicts": list(runtime_stats["verdicts"])[-4:],
        "gauges": {
            k: v for k, v in rolling_gauges.items()
            if isinstance(v, (int, float))
        },
    }


def parse_inject_spec(spec: str | None) -> tuple[str, int] | None:
    """``"<leaf-substring>@<step>"`` -> ``(pattern, step)`` or None."""
    if not spec:
        return None
    pat, sep, at = str(spec).rpartition("@")
    if not sep or not pat:
        raise ValueError(
            f"GRAFT_NUMERICS_INJECT spec {spec!r}: expected "
            "'<leaf-substring>@<step>' (e.g. 'attn.c_attn.weight@5')"
        )
    return pat, int(at)


def _host(v):
    import numpy as np

    if hasattr(v, "detach"):
        v = v.detach().cpu()
        return v.float().numpy() if v.dtype.is_floating_point else v.numpy()
    return np.asarray(v)


def leaf_norms(tensors: list, ord_=2):
    """The f32 ``ord_`` norm of each tensor, ``[n]``; 0 for an empty one (a
    ZeRO-3 chunk may be empty, and an empty tensor has no largest
    element). ``ord_=inf`` is the largest magnitude: NaN where a NaN is,
    inf where an inf is, and finite for finite values, which an L2 norm
    in f32 need not be."""
    import torch

    with torch.no_grad():  # ZeRO-3's local shards are views that the update wrote
        live = [t for t in tensors if t.numel()]
        norms = iter(torch._foreach_norm(live, ord_, dtype=torch.float32) if live else [])
        return torch.stack([next(norms) if t.numel() else
                            torch.zeros((), dtype=torch.float32, device=t.device)
                            for t in tensors])


def probe_layout(model, tx) -> dict:
    """The ``names``, ``axes`` and ``shapes`` keywords of
    :meth:`NumericsProbe.aux` for the optimizer ``tx`` over ``model``'s
    parameters (a DDP wrapper is looked through): the parameter names, each
    leaf's JAX leading axis (``interop.jax_leading_axes``) and its whole
    shape."""
    from ..interop import jax_leading_axes

    axes = jax_leading_axes(getattr(model, "module", model))
    return dict(names=list(tx.names), axes=[axes.get(n, 0) for n in tx.names],
                shapes=[tuple(p.shape) for p in tx.params])


def _first_bad_row(g, axis: int, index):
    """The first row along ``axis`` of ``g`` (a leaf or its shard) holding a
    non-finite value, as an int32 device scalar; the row count when every
    row is finite. ``index`` is ``arange(rows)``."""
    import torch

    dims = [d for d in range(g.dim()) if d != axis]
    rows = torch.linalg.vector_norm(g, float("inf"), dim=dims, dtype=torch.float32)
    return torch.where(torch.isfinite(rows), index.shape[0], index).min()


class NumericsProbe:
    """Builds the on-device numerics aux and decodes it on the host.

    One instance per step. :meth:`aux` runs inside the step, on the device;
    :meth:`observe` runs on the host at whatever cadence the caller can
    afford a device-to-host read, and feeds gauges, trace instants,
    :data:`runtime_stats` and an optional watchdog.
    """

    def __init__(self, *, inject: str | None = None):
        self.inject_spec = parse_inject_spec(
            inject if inject is not None else os.environ.get("GRAFT_NUMERICS_INJECT"))
        self.leaf_paths: list[str] = []  # set by aux()
        self._row_plans: dict = {}  # bad_layer's per-layout index vectors
        runtime_stats["enabled"] = True

    # -- the device half (no host read) -----------------------------------

    def inject(self, grads: list, step, names: list[str]) -> list:
        """NaN into every gradient leaf whose name holds the spec's pattern,
        in place, at the spec's step. ``step`` is the host's step count (a
        branch on the host) or a device counter (a train step's): then the
        fill is gated on the device, JAX's ``jnp.where`` on the traced step,
        so one captured graph runs clean and poisoned steps alike. Returns
        ``grads``."""
        if self.inject_spec is None:
            return grads
        import torch

        pat, at = self.inject_spec
        hit = [g for name, g in zip(names, grads) if pat in name]
        if isinstance(step, torch.Tensor):
            fire = step == at
            for g in hit:
                g.masked_fill_(fire, float("nan"))
        elif int(step) == at:
            for g in hit:
                g.fill_(float("nan"))
        return grads

    def aux(self, grads: list, *, names: list[str], params: list | None = None,
            param_norms=None, update_norms=None, grad_norm=None,
            axes: list[int] | None = None, shapes: list | None = None, shard=None) -> dict:
        """The aux dict of one step, device tensors only.

        ``grads`` and ``params`` (the pre-update parameters; or
        ``param_norms``, their f32 norms ``[n]`` taken before the update)
        are this rank's shares of the leaves named ``names``: whole leaves
        without ``shard``, its local shards under a
        ``parallel.spec.ShardPlan``. ``update_norms`` (f32 ``[n]``, the
        optimizer's per-leaf norms of the applied update, this rank's
        shares) gives ``update_ratio``; ``grad_norm`` is a norm already
        computed (the recorded clip's, ``FusedAdamW``'s); ``axes`` (each
        leaf's JAX leading axis, default 0) and ``shapes`` (each whole
        leaf's shape, default the grads' own) place ``bad_layer``.
        """
        import torch

        with torch.no_grad():
            return self._aux(grads, names, params, param_norms, update_norms, grad_norm,
                             axes, shapes, shard)

    def _aux(self, grads, names, params, param_norms, update_norms, grad_norm, axes, shapes,
             shard) -> dict:
        import torch

        f32 = torch.float32
        self.leaf_paths = list(names)
        n = len(grads)
        dev = grads[0].device
        axes = [0] * n if axes is None else list(axes)
        shapes = [tuple(g.shape) for g in grads] if shapes is None else [tuple(s) for s in shapes]
        bad = (~torch.isfinite(leaf_norms(grads, float("inf")))).to(f32)
        sq = leaf_norms(grads).square()
        if params is not None:
            param_norms = leaf_norms(params)
        psq = None if param_norms is None else param_norms.square()
        usq = None if update_norms is None else update_norms.to(f32).square()
        plan = self._row_plan(grads, axes, shapes, shard)
        rows = torch.full((n,), _NO_ROW, dtype=torch.int32, device=dev)
        if plan["leaves"]:
            first = torch.stack([_first_bad_row(grads[i], axes[i], plan["index"][i])
                                 for i in plan["leaves"]])
            rows.index_copy_(0, plan["at"], torch.where(first < plan["count"],
                                                        first + plan["offset"], _NO_ROW))
        if shard is not None:
            sq, bad, psq, usq, rows = _reduce_over_shards(shard, sq, bad, psq, usq, rows)

        finite = bad == 0
        idx = torch.arange(n, device=dev, dtype=torch.int32)
        first_bad = torch.where(finite, torch.full_like(idx, n), idx).min()
        first_bad = torch.where(first_bad < n, first_bad, torch.full_like(first_bad, -1))
        if grad_norm is None:
            grad_norm = torch.sqrt(sq.sum())
        out = {
            "finite_mask": finite,
            "first_bad_leaf": first_bad,
            "bad_layer": torch.where(rows == _NO_ROW, torch.full_like(rows, -1), rows),
            "grad_norm": torch.as_tensor(grad_norm, dtype=f32, device=dev).reshape(()),
        }
        if psq is not None:
            out["param_norm"] = torch.sqrt(psq.sum())
            if usq is not None:
                # ||update|| / ||param|| a leaf; zero-norm leaves (fresh zero
                # biases) report 0, not an astronomic ratio
                pn = torch.sqrt(psq)
                out["update_ratio"] = torch.where(pn > 0.0, torch.sqrt(usq) / (pn + 1e-12),
                                                  torch.zeros_like(pn))
        return out

    def _row_plan(self, grads, axes, shapes, shard) -> dict:
        """The leaves that have a JAX layer axis (rank >= 2, more than one
        row, a non-empty share), with each one's ``arange`` of its local
        rows, the row counts and this rank's offsets as device vectors:
        fixed by the layout, so built once and kept."""
        import torch

        key = (tuple(tuple(g.shape) for g in grads), tuple(axes), tuple(shapes),
               None if shard is None else shard.rank, str(grads[0].device))
        plan = self._row_plans.get(key)
        if plan is None:
            dev = grads[0].device
            leaves = [i for i, (g, a, s) in enumerate(zip(grads, axes, shapes))
                      if len(s) >= 2 and s[a] > 1 and g.numel()]
            count = [grads[i].shape[axes[i]] for i in leaves]
            offset = [0 if shard is None else _shard_offset(shard, i, axes[i], grads[i], shapes[i])
                      for i in leaves]
            ranges = {c: torch.arange(c, dtype=torch.int32, device=dev) for c in set(count)}
            index = {i: ranges[c] for i, c in zip(leaves, count)}
            plan = self._row_plans[key] = {
                "leaves": leaves, "index": index,
                "at": torch.tensor(leaves, dtype=torch.long, device=dev),
                "count": torch.tensor(count, dtype=torch.int32, device=dev),
                "offset": torch.tensor(offset, dtype=torch.int32, device=dev)}
        return plan

    # -- the host half (reads; call at an affordable cadence) -------------

    def leaf_name(self, idx: int) -> str:
        if 0 <= idx < len(self.leaf_paths):
            return self.leaf_paths[idx]
        return f"<leaf {idx}>"

    def observe(self, aux: dict, *, step: int | None = None, loss=None,
                watchdog: "NumericsWatchdog | None" = None) -> dict:
        """Decode one step's aux on the host: name the blame, update the
        gauges, emit ``numerics.*`` instants, feed the watchdog. Accepts
        k-stacked aux (``MultiStep``: a leading axis on every field), which
        the decode reduces to the worst step in the window, as JAX's does.
        Returns a json-safe summary; a watchdog's verdict rides under
        ``"verdict"``."""
        import numpy as np

        finite = _host(aux["finite_mask"]).astype(bool)
        first_bad = _host(aux["first_bad_leaf"]).reshape(-1)
        bad_layer = _host(aux["bad_layer"])
        if finite.ndim > 1:  # a k-stacked window: the worst step wins
            finite = finite.all(axis=tuple(range(finite.ndim - 1)))
            bad_layer = bad_layer.reshape(-1, bad_layer.shape[-1]).max(0)
        first_idx = int(next((i for i in first_bad if i >= 0), -1))
        gnorm = float(np.max(_host(aux["grad_norm"])))
        loss_val = None if loss is None else float(np.ravel(_host(loss))[-1])

        nonfinite = first_idx >= 0 or not bool(finite.all())
        blame = None
        if nonfinite:
            idx = first_idx if first_idx >= 0 else int(np.argmax(~finite))
            layer = int(bad_layer[idx]) if idx < bad_layer.size else -1
            blame = {"leaf": self.leaf_name(idx), "layer": layer, "step": step}

        runtime_stats["steps_observed"] += 1
        runtime_stats["grad_norm_last"] = gnorm
        rolling_gauges["grad_norm"] = gnorm
        if loss_val is not None and math.isfinite(loss_val):
            rolling_gauges["loss"] = loss_val
        if "param_norm" in aux:
            rolling_gauges["param_norm"] = float(np.max(_host(aux["param_norm"])))
        if "update_ratio" in aux:
            rolling_gauges["update_ratio_max"] = float(_host(aux["update_ratio"]).max())

        if nonfinite:
            runtime_stats["nonfinite_steps_total"] += 1
            runtime_stats["last_nonfinite"] = blame
            _trace.instant("numerics.nonfinite", "fault", step=step, leaf=blame["leaf"],
                           layer=blame["layer"])
        rolling_gauges["nonfinite_steps_total"] = float(runtime_stats["nonfinite_steps_total"])

        summary = {"step": step, "nonfinite": nonfinite, "blame": blame, "grad_norm": gnorm,
                   "loss": loss_val}
        for k in ("param_norm", "update_ratio_max"):
            if k in rolling_gauges:
                summary[k] = rolling_gauges[k]
        if watchdog is not None:
            summary["verdict"] = watchdog.observe(step=step, loss=loss_val, grad_norm=gnorm,
                                                  nonfinite=nonfinite, blame=blame)
        return summary


def _shard_offset(shard, i: int, axis: int, g, shape) -> int:
    """Where this rank's share of leaf ``i`` (whole shape ``shape``) starts
    along ``axis``: 0 unless the leaf is cut along that axis."""
    from ..parallel.spec import dim0_chunk_start

    if shard.dtensor:  # FSDP2: first-dimension chunks
        return dim0_chunk_start(shape[0], shard.rank, shard.world) if axis == 0 else 0
    d = shard.dims[i]
    return shard.rank * (shape[d] // shard.world) if d == axis else 0


def _reduce_over_shards(shard, sq, bad, psq, usq, rows):
    """The global leaves' values from this rank's shares: squares and bad
    flags summed over the group (a whole leaf counted on rank 0 only), the
    first offending rows by a minimum."""
    import torch
    import torch.distributed as tdist

    n = sq.numel()
    parts = [sq, bad] + [t for t in (psq, usq) if t is not None]
    vec = torch.cat(parts)
    if not shard.dtensor and shard.rank != 0:
        whole = getattr(shard, "_numerics_whole", None)  # built once per plan
        if whole is None or whole.numel() != vec.numel():
            whole = torch.tensor([d is None for d in shard.dims] * len(parts), device=vec.device)
            shard._numerics_whole = whole
        vec = torch.where(whole, torch.zeros_like(vec), vec)
    tdist.all_reduce(vec, group=shard.group)
    tdist.all_reduce(rows, op=tdist.ReduceOp.MIN, group=shard.group)
    out = list(vec.split(n))
    sq, bad = out[0], out[1]
    rest = iter(out[2:])
    psq = None if psq is None else next(rest)
    usq = None if usq is None else next(rest)
    return sq, bad, psq, usq, rows


class NumericsDivergence(RuntimeError):
    """Raised by the ``halt`` policy (and by ``rollback`` with no
    checkpoint manager to roll back through)."""

    def __init__(self, verdict: dict):
        self.verdict = verdict
        super().__init__(
            f"numerics watchdog: {verdict.get('kind')} at step "
            f"{verdict.get('step')} (action={verdict.get('action')}): "
            f"{verdict.get('detail')}"
        )


def _robust_z(value: float, history) -> float:
    """Modified z-score vs the rolling window — 0.6745·(x−median)/MAD,
    the statistic of goodput's straggler flagger. Degenerate (tiny /
    zero-MAD) windows return 0."""
    vals = sorted(history)
    n = len(vals)
    if n < 3:
        return 0.0
    med = vals[n // 2]
    mad = sorted(abs(v - med) for v in vals)[n // 2]
    if mad <= 0.0:
        return 0.0
    return 0.6745 * (value - med) / mad


class NumericsWatchdog:
    """Rolling robust-z divergence detector with a policy action.

    Trips on: a **sustained non-finite** streak (``nonfinite_patience``
    consecutive poisoned steps — a single fp16-overflow skip is the loss
    scaler's business, not a divergence), a **loss spike** (robust z of
    the new loss against the rolling window above ``z_gate``, upward
    only), or a **grad-norm explosion** (same test on the grad-norm
    series). Every verdict is logged as a ``numerics.divergence`` trace
    instant, appended to ``runtime_stats["verdicts"]``, optionally
    recorded through ``store.record_transition`` (a membership store, where
    one is given), and carries the configured action for
    :meth:`apply_action` to execute.
    """

    def __init__(
        self,
        action: str = "halt",
        *,
        window: int = 64,
        z_gate: float = 8.0,
        min_history: int = 8,
        nonfinite_patience: int = 2,
        store=None,
        clock=time.time,
    ):
        if action not in ACTIONS:
            raise ValueError(
                f"numerics action {action!r}: expected one of {ACTIONS}"
            )
        self.action = action
        self.window = int(window)
        self.z_gate = float(z_gate)
        self.min_history = int(min_history)
        self.nonfinite_patience = int(nonfinite_patience)
        self.store = store  # membership store: verdicts -> transitions
        self._clock = clock
        self._loss: collections.deque = collections.deque(maxlen=window)
        self._gnorm: collections.deque = collections.deque(maxlen=window)
        self._streak = 0
        self.tripped: dict | None = None
        runtime_stats["action"] = action

    def reset(self) -> None:
        """Re-arm after a rollback: the rolled-back window's statistics
        describe the divergent trajectory, not the resumed one."""
        self._loss.clear()
        self._gnorm.clear()
        self._streak = 0
        self.tripped = None

    def observe(
        self,
        *,
        step: int | None = None,
        loss: float | None = None,
        grad_norm: float | None = None,
        nonfinite: bool = False,
        blame: dict | None = None,
    ) -> dict | None:
        """One step's health facts in; a verdict dict out on a trip."""
        if nonfinite:
            self._streak += 1
            if self._streak >= self.nonfinite_patience:
                return self._trip(
                    "nonfinite", step,
                    detail=(
                        f"{self._streak} consecutive non-finite steps"
                        + (
                            f", first offender {blame['leaf']!r}"
                            f" (layer {blame['layer']})"
                            if blame else ""
                        )
                    ),
                    blame=blame,
                )
            return None
        self._streak = 0

        for name, series, value in (
            ("loss-spike", self._loss, loss),
            ("grad-explosion", self._gnorm, grad_norm),
        ):
            if value is None or not math.isfinite(value):
                continue
            if len(series) >= self.min_history:
                z = _robust_z(value, series)
                if z > self.z_gate:
                    return self._trip(
                        name, step,
                        detail=(
                            f"value {value:.6g} is z={z:.1f} above the "
                            f"rolling window of {len(series)} "
                            f"(median {sorted(series)[len(series)//2]:.6g},"
                            f" gate {self.z_gate})"
                        ),
                        z=z, value=value,
                    )
            series.append(value)
        return None

    def _trip(self, kind, step, *, detail, blame=None, z=None, value=None):
        verdict = {
            "kind": kind,
            "step": step,
            "action": self.action,
            "detail": detail,
            "t": self._clock(),
        }
        if blame is not None:
            verdict["blame"] = blame
        if z is not None:
            verdict["z"] = round(float(z), 3)
            verdict["value"] = value
        self.tripped = verdict
        runtime_stats["verdicts"].append(verdict)
        rolling_gauges["watchdog_trips_total"] = float(
            len(runtime_stats["verdicts"])
        )
        _trace.instant(
            "numerics.divergence", "fault",
            kind=kind, step=step, action=self.action,
        )
        if self.store is not None:
            try:
                self.store.record_transition(
                    "numerics_divergence",
                    numerics_kind=kind, step=step, action=self.action,
                )
            except Exception:  # noqa: BLE001 — telemetry never kills a run
                pass
        return verdict

    def apply_action(self, verdict: dict, *, manager=None, template=None):
        """Execute the verdict's policy.

        - ``halt``: raise :class:`NumericsDivergence`.
        - ``rollback``: ``manager.restore_latest(template)`` restores the
          newest committed checkpoint (the manager skips torn dirs) into
          ``template``, a ``TrainState``, in place (its step stream too);
          re-arm the detector and return ``(step, meta)`` for the caller to
          resume from. No manager, or no committed step to roll back to,
          raises as ``halt`` does.
        - ``degrade``: dial ``GRAFT_WIRE`` back to the f32 wire for the
          restart (the quantized wire is the usual numerics suspect and
          the one knob that changes numerics without changing the model)
          and return None; the caller relaunches.
        """
        action = verdict.get("action", self.action)
        if action == "rollback" and manager is not None:
            restored = manager.restore_latest(template)
            if restored is not None:
                self.reset()
                step, meta = restored
                _trace.instant(
                    "numerics.rollback", "fault",
                    restored_step=int(step),
                    tripped_step=verdict.get("step"),
                )
                return int(step), meta
            verdict = dict(verdict, detail=(
                verdict.get("detail", "")
                + " [rollback found no committed checkpoint]"
            ))
            raise NumericsDivergence(verdict)
        if action == "degrade":
            # the port has no quantized wire yet (the wire slice); the knob
            # is set as JAX sets it, for the relaunch to read
            os.environ["GRAFT_WIRE"] = "fp32"
            runtime_stats["degraded_wire"] = True
            _trace.instant(
                "numerics.degrade", "fault",
                tripped_step=verdict.get("step"), wire="fp32",
            )
            return None
        raise NumericsDivergence(verdict)


def numerics_from_env(numerics: bool = False, action: str = "halt",
                      env=None) -> tuple[bool, str]:
    """``(enabled, action)``, the arguments overridden by their env twins:
    ``GRAFT_NUMERICS`` (any value but a falsy one turns the plane on) for
    ``numerics`` and ``GRAFT_NUMERICS_ACTION`` for ``action``. A bad action
    fails here, at construction, not at the first watchdog trip."""
    e = os.environ if env is None else env
    raw = e.get("GRAFT_NUMERICS")
    on = bool(numerics) if raw is None else raw.strip().lower() not in _trace.FALSY
    action = e.get("GRAFT_NUMERICS_ACTION", action).strip().lower() or "halt"
    if action not in ACTIONS:
        raise ValueError(f"numerics action {action!r}: expected one of {ACTIONS} "
                         "(GRAFT_NUMERICS_ACTION / numerics_action)")
    return on, action


def probe_from_env(env=None) -> NumericsProbe | None:
    """``GRAFT_NUMERICS`` -> a probe, or None when the plane is off."""
    return NumericsProbe() if numerics_from_env(env=env)[0] else None


def watchdog_from_env(env=None) -> NumericsWatchdog:
    """Watchdog with ``GRAFT_NUMERICS_ACTION`` policy (default halt)."""
    return NumericsWatchdog(action=numerics_from_env(env=env)[1])
