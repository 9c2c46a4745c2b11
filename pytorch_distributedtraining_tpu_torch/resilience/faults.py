"""Deterministic fault injection: FaultPlan + fault_point hooks.

Counterpart of ``pytorch_distributedtraining_tpu/resilience/faults.py``,
with the sites the port threads so far:

=====================  =====================================================
``launch.worker``      launcher monitor SIGKILLs a chosen local rank
                       mid-generation (``runtime/launch.py``)
``launch.grow``        elastic launcher is about to initiate a grow-back
                       reshard -- ``raise`` vetoes this grow attempt (the
                       gate re-arms), ``sleep`` delays the teardown
                       (``runtime/launch.py``)
``membership.heartbeat`` a host's membership heartbeat is dropped -- the
                       host ages out of the live set and cannot be grown
                       onto (``runtime/membership.py``)
``dist.rendezvous``    the rendezvous fails before
                       ``torch.distributed.init_process_group``
                       (``runtime/dist.py``)
``collective.barrier`` the process-group barrier raises a pool-style
                       ``UNAVAILABLE`` error (``runtime/dist.py``)
``checkpoint.write``   transient I/O error on a checkpoint write: at the
                       sharded write (retried through the outage
                       classifier) and at ``CheckpointManager.save``
                       (``checkpoint_sharded.py``)
``ckpt.write``         kill/delay inside the portable writer (the
                       background thread with ``async_save``), after the
                       staging dir exists: manufactures torn, uncommitted
                       step dirs (``checkpoint_sharded.py``)
``train.preempt``      mid-step preemption delivered to self at a chosen
                       ``CheckpointManager.maybe_save`` call: ``sigterm``
                       takes the forced-save path, ``kill`` dies with only
                       the committed checkpoints (``checkpoint_sharded.py``)
``serve.admit``        admission controller sheds a request at admission
                       -- ``raise`` drops it, counted, engine keeps serving
                       (``serve/scheduler.py``)
``serve.client``       client misbehaves at delivery: ``sleep`` is a slow
                       reader stalling the tick loop, ``raise`` a
                       disconnect cancelling the request
                       (``serve/engine.py``, ``serve/tiles.py``)
=====================  =====================================================

A plan is JSON, inline in ``GRAFT_FAULT_PLAN`` or a file path, so it
crosses process boundaries through the environment::

    {"faults": [{"site": "serve.admit", "at": 2, "times": 1, "action": "raise"}]}

Rule fields: ``site`` (required); ``action``: ``raise`` (default,
:class:`InjectedFault`), ``oserror``, ``exit``, ``kill`` (SIGKILL self),
``sigterm`` (SIGTERM self), ``sleep``; ``at``: fire on the Nth hit of the
site, 1-based (default 1); ``times``: consecutive hits that fire (default
1; 0 = every hit from ``at`` on); ``rank``: only in the process whose
``RANK``/``LOCAL_RANK`` matches; ``attempt``: only when
``GRAFT_RESTART_ATTEMPT`` matches; ``match``: equality constraints on the
call site's context kwargs; ``message`` / ``arg``: error text / action
argument (exit code, sleep seconds); ``after_s``: delay for
monitor-driven sites (``launch.worker``: the launcher kills the rule's
``rank``, a local rank, ``after_s`` seconds into the generation whose
attempt matches).

Stdlib only; without a plan, :func:`fault_point` is a global read and a
``None`` check.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from dataclasses import dataclass, field
from typing import Any

ENV_VAR = "GRAFT_FAULT_PLAN"

_VALID_ACTIONS = ("raise", "oserror", "exit", "kill", "sigterm", "sleep")

SITES = frozenset({
    "launch.worker",
    "launch.grow",
    "membership.heartbeat",
    "dist.rendezvous",
    "collective.barrier",
    "checkpoint.write",
    "ckpt.write",
    "train.preempt",
    "serve.admit",
    "serve.client",
})


class InjectedFault(RuntimeError):
    """An error raised on purpose by a FaultPlan rule."""


def _telemetry_on_fire(site: str, action: str, msg: str) -> None:
    """Mark the injection in the telemetry stream, if telemetry is loaded.

    Looked up in ``sys.modules``, never imported. With the tracer live, the
    injection lands as an instant event and the flight recorder is flushed
    before the action runs: for ``kill``/``exit`` that flush is the only
    record the process leaves.
    """
    tr = sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.observe.trace")
    if tr is None:
        return
    try:
        if tr.enabled():
            tr.instant(f"fault.{site}", "fault", action=action, message=msg)
            tr.flush_flight_record(f"fault:{site}")
    except Exception:  # noqa: BLE001 -- injection never depends on telemetry health
        pass


@dataclass
class FaultRule:
    """One deterministic failure schedule at one site."""

    site: str
    action: str = "raise"
    at: int = 1
    times: int = 1
    rank: int | None = None
    attempt: int | None = None
    match: dict[str, Any] = field(default_factory=dict)
    message: str | None = None
    arg: float | None = None
    after_s: float = 0.0
    hits: int = 0  # per-process hit counter (mutable state)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; valid: {sorted(SITES)}"
            )
        if self.action not in _VALID_ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; "
                f"valid: {_VALID_ACTIONS}"
            )
        if self.at < 1:
            raise ValueError(f"at must be >= 1 (1-based), got {self.at}")

    # -- matching ----------------------------------------------------------

    def _env_rank(self) -> int:
        for var in ("RANK", "LOCAL_RANK"):
            raw = os.environ.get(var)
            if raw:
                try:
                    return int(raw)
                except ValueError:
                    pass
        return 0

    def applies(self, **ctx) -> bool:
        """Static filters only (rank/attempt/match) — no counter movement."""
        if self.rank is not None and self.rank != self._env_rank():
            return False
        if self.attempt is not None:
            cur = int(os.environ.get("GRAFT_RESTART_ATTEMPT", "0") or 0)
            if self.attempt != cur:
                return False
        return all(ctx.get(k) == v for k, v in self.match.items())

    def should_fire(self, **ctx) -> bool:
        """Advance the hit counter; True when this hit is scheduled."""
        if not self.applies(**ctx):
            return False
        self.hits += 1
        if self.hits < self.at:
            return False
        return self.times <= 0 or self.hits < self.at + self.times

    # -- firing ------------------------------------------------------------

    def fire(self, site_msg: str) -> None:
        msg = self.message or f"injected fault at {site_msg}"
        _telemetry_on_fire(site_msg, self.action, msg)
        if self.action == "raise":
            raise InjectedFault(msg)
        if self.action == "oserror":
            import errno

            raise OSError(errno.EIO, msg)
        if self.action == "exit":
            os._exit(int(self.arg) if self.arg is not None else 1)
        if self.action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if self.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        if self.action == "sleep":
            time.sleep(float(self.arg) if self.arg is not None else 3600.0)


class FaultPlan:
    """A parsed set of :class:`FaultRule`\\ s with per-process counters."""

    def __init__(self, rules: list[FaultRule]):
        self.rules = list(rules)

    @classmethod
    def from_json(cls, obj: dict | list) -> "FaultPlan":
        if isinstance(obj, dict):
            obj = obj.get("faults", [])
        rules = []
        for raw in obj:
            unknown = set(raw) - {
                "site", "action", "at", "times", "rank", "attempt",
                "match", "message", "arg", "after_s",
            }
            if unknown:
                # a typoed key would silently never fire: fail loudly
                raise ValueError(
                    f"fault rule has unknown keys {sorted(unknown)}: {raw}"
                )
            rules.append(FaultRule(**raw))
        return cls(rules)

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR) -> "FaultPlan | None":
        """Parse ``$GRAFT_FAULT_PLAN`` — inline JSON or a file path."""
        raw = os.environ.get(env_var, "").strip()
        if not raw:
            return None
        if raw.startswith("@"):
            raw = raw[1:]
        if not raw.lstrip().startswith(("{", "[")):
            with open(raw) as fh:
                raw = fh.read()
        return cls.from_json(json.loads(raw))

    def rules_for(self, site: str) -> list[FaultRule]:
        return [r for r in self.rules if r.site == site]

    def point(self, site: str, **ctx) -> None:
        """Hit ``site``; fire the first scheduled rule (if any)."""
        for rule in self.rules:
            if rule.site == site and rule.should_fire(**ctx):
                rule.fire(site)
                return


# -- module-level hook -------------------------------------------------------

# tri-state: "unset" = env not yet consulted; None = no plan (fast path)
_PLAN: FaultPlan | None | str = "unset"


def install_plan(plan: FaultPlan | None) -> None:
    """Install (or clear, with None) the process-wide plan — test hook."""
    global _PLAN
    _PLAN = plan


def active_plan() -> FaultPlan | None:
    """The process-wide plan, lazily parsed from the env once."""
    global _PLAN
    if _PLAN == "unset":
        _PLAN = FaultPlan.from_env()
    return _PLAN


def fault_point(site: str, **ctx) -> None:
    """Declare a named fault site; a no-op unless a plan schedules it here.

    Call it at the exact place the real failure would surface — the hook's
    cost without a plan is one global read and a ``None`` check.
    """
    plan = active_plan()
    if plan is not None:
        plan.point(site, **ctx)
