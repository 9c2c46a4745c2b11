"""Anomaly-triggered profiler capture: the trace that explains an incident
exists without a human in the loop.

Counterpart of ``pytorch_distributedtraining_tpu/observe/capture.py``.
:class:`OnDemandProfiler` arms a bounded ``torch.profiler`` capture and
fires it when an anomaly signal the port already computes trips:

- ``fleet-straggler``: the fleet monitor flagged a straggler
  (``observe.fleet.runtime_stats["stragglers_flagged"]`` grew);
- ``slo-burn``: the serving SLO burn rate crossed 1x or the error budget
  is exhausted (``observe.slo.runtime_stats``);
- ``numerics``: the numerics plane saw a non-finite step or a watchdog
  verdict (``observe.numerics.runtime_stats``);
- ``bench-regression``: the regression sentry returned a drift or
  regression verdict (``observe.fleet.runtime_stats["verdicts"]``).

Every source is the port's own module, read through ``sys.modules``
(``pytorch_distributedtraining_tpu_torch.<name>``), never imported: an
armed profiler in a process that runs none of those planes polls four dict
lookups and nothing else. ``observe.fleet`` comes with the serving-fleet
slice; until then its two sources read 0, as JAX's do in a process without
a fleet.

Captures are bounded three ways: a cooldown between fires, a budget of
captures a process and a disk cap on the capture directory. The profiler
starts and stops through ``observe.profiling``'s guard, so a fire during a
manual ``--trace`` session is a no-op (a warning), not a second session
that would empty the first. Stdlib only at import; torch is touched only
when a capture fires (tests inject fake start and stop hooks).
"""

from __future__ import annotations

import os
import sys
import time

__all__ = ["OnDemandProfiler", "TRIGGER_SOURCES", "runtime_stats", "reset", "capture_from_env",
           "armed"]

TRIGGER_SOURCES = (
    "fleet-straggler", "slo-burn", "numerics", "bench-regression",
)

_PACKAGE = __name__.rsplit(".", 2)[0]  # pytorch_distributedtraining_tpu_torch

# the capture plane's own ledger
runtime_stats: dict = {
    "armed": False,
    "captures": 0,
    "refused_cooldown": 0,
    "refused_budget": 0,
    "refused_disk": 0,
    "last_trigger": None,      # {"source", "dir", "wall_time"}
    "capture_dirs": [],
}


def reset() -> None:
    runtime_stats.update(
        armed=False,
        captures=0,
        refused_cooldown=0,
        refused_budget=0,
        refused_disk=0,
        last_trigger=None,
        capture_dirs=[],
    )


def capture_from_env(capture: bool = False, capture_dir: str | None = None,
                     env=None) -> tuple[bool, str | None]:
    """``(enabled, capture_dir)``: ``$GRAFT_CAPTURE`` overrides ``capture``;
    a value that is neither a boolean spelling nor empty is the capture
    directory (on + dir), overriding ``capture_dir`` (JAX facade's
    ``_capture_from_env``)."""
    raw = (os.environ if env is None else env).get("GRAFT_CAPTURE")
    if raw is None:
        return bool(capture), capture_dir
    v = raw.strip()
    if v.lower() in ("", "0", "false", "off", "no"):
        return False, capture_dir
    if v.lower() not in ("1", "true", "on", "yes"):
        capture_dir = v
    return True, capture_dir


def _mod(name: str):
    return sys.modules.get(f"{_PACKAGE}.{name}")


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                continue
    return total


class OnDemandProfiler:
    """Armed, bounded, anomaly-triggered ``torch.profiler`` capture.

    Call :meth:`arm` once (snapshots every source's baseline), then
    :meth:`note_step` from the hot loop: while idle it polls the four
    anomaly sources (dict reads only); when one trips, and the cooldown,
    budget and disk cap all allow, it starts a profiler session into
    ``<trace_dir>/capture-<n>-<source>`` and stops it ``capture_steps``
    calls later. ``on_capture(dir, source)`` runs after the stop (the
    opcost ingest hook); its failure never propagates into the training
    loop. ``trace_dir`` defaults to ``captures`` under the run dir
    (``observe.trace.run_dir``).
    """

    def __init__(
        self,
        trace_dir: str | None = None,
        *,
        cooldown_s: float = 300.0,
        max_captures: int = 3,
        disk_cap_bytes: int = 256 << 20,
        capture_steps: int = 3,
        clock=time.monotonic,
        start=None,
        stop=None,
        on_capture=None,
    ):
        if trace_dir is None:
            from .trace import run_dir

            trace_dir = os.path.join(run_dir(), "captures")
        self.trace_dir = trace_dir
        self.cooldown_s = float(cooldown_s)
        self.max_captures = int(max_captures)
        self.disk_cap_bytes = int(disk_cap_bytes)
        self.capture_steps = max(1, int(capture_steps))
        self._clock = clock
        self._start = start
        self._stop = stop
        self.on_capture = on_capture
        self.armed = False
        self.capturing: str | None = None  # active capture dir
        self._capture_source: str | None = None
        self._steps_left = 0
        self._last_fire: float | None = None
        self._baseline: dict = {}

    # -- anomaly sources (sys.modules reads, nothing else) --------------

    def _signals(self) -> dict:
        fleet = _mod("observe.fleet")
        slo = _mod("observe.slo")
        num = _mod("observe.numerics")
        fl = getattr(fleet, "runtime_stats", None) or {}
        sl = getattr(slo, "runtime_stats", None) or {}
        nm = getattr(num, "runtime_stats", None) or {}
        remaining = sl.get("budget_remaining")
        return {
            "fleet-straggler": int(fl.get("stragglers_flagged") or 0),
            "slo-burn": int(
                bool((sl.get("burn_rate_peak") or 0.0) > 1.0)
                or bool(remaining is not None and remaining <= 0)
            ),
            "numerics": (
                int(nm.get("nonfinite_steps_total") or 0)
                + len(nm.get("verdicts") or ())
            ),
            "bench-regression": sum(
                1 for v in (fl.get("verdicts") or ())
                if v.get("status") in ("drift", "regression")
            ),
        }

    def arm(self) -> "OnDemandProfiler":
        """Snapshot every source's baseline and start watching."""
        self._baseline = self._signals()
        self.armed = True
        runtime_stats["armed"] = True
        return self

    def poll(self) -> str | None:
        """The tripped source's name, or None. A pure read: no capture side
        effects (:meth:`note_step` is the firing path)."""
        if not self.armed or self.capturing is not None:
            return None
        sig = self._signals()
        for source in TRIGGER_SOURCES:
            if sig[source] > self._baseline.get(source, 0):
                return source
        return None

    # -- firing ---------------------------------------------------------

    def _profiler_hooks(self):
        if self._start is not None and self._stop is not None:
            return self._start, self._stop
        from . import profiling

        return profiling.start_profiler_trace, profiling.stop_profiler_trace

    def _refuse(self, kind: str) -> None:
        runtime_stats[f"refused_{kind}"] += 1

    def fire(self, source: str) -> str | None:
        """Start a capture for ``source`` if the bounds allow. Returns the
        capture dir, or None with the refusal counted."""
        now = self._clock()
        if self.capturing is not None:
            return None
        if runtime_stats["captures"] >= self.max_captures:
            self._refuse("budget")
            return None
        if (
            self._last_fire is not None
            and now - self._last_fire < self.cooldown_s
        ):
            self._refuse("cooldown")
            return None
        if (
            os.path.isdir(self.trace_dir)
            and _dir_bytes(self.trace_dir) >= self.disk_cap_bytes
        ):
            self._refuse("disk")
            return None
        n = runtime_stats["captures"]
        cap_dir = os.path.join(self.trace_dir, f"capture-{n}-{source}")
        start, _stop = self._profiler_hooks()
        try:
            started = start(cap_dir)
        except Exception:  # noqa: BLE001 — a probe must not kill the loop
            started = False
        if not started:
            # a manual trace already owns the profiler (the guard) or the
            # backend refused: count nothing, the anomaly may recur after it
            return None
        self._last_fire = now
        self.capturing = cap_dir
        self._capture_source = source
        self._steps_left = self.capture_steps
        tr = _mod("observe.trace")
        if tr is not None and tr.enabled():
            tr.instant("capture.fired", "profile", source=source, dir=cap_dir)
        return cap_dir

    def _finish(self) -> None:
        _start, stop = self._profiler_hooks()
        try:
            stop()
        except Exception:  # noqa: BLE001
            pass
        cap_dir, source = self.capturing, self._capture_source
        self.capturing = None
        self._capture_source = None
        runtime_stats["captures"] += 1
        runtime_stats["capture_dirs"].append(cap_dir)
        runtime_stats["last_trigger"] = {
            "source": source,
            "dir": cap_dir,
            "wall_time": time.time(),
        }
        # re-baseline: the anomaly that fired is now "seen"; the same
        # source fires again only on a NEW increment after the cooldown
        self._baseline = self._signals()
        if self.on_capture is not None:
            try:
                self.on_capture(cap_dir, source)
            except Exception:  # noqa: BLE001 — ingest must not kill the loop
                pass

    def note_step(self) -> str | None:
        """Per-step hook: advance an active capture toward its stop, or
        poll the anomaly sources and maybe fire. Returns the source name
        on the step a capture fires, else None."""
        if self.capturing is not None:
            self._steps_left -= 1
            if self._steps_left <= 0:
                self._finish()
            return None
        source = self.poll()
        if source is None:
            return None
        return source if self.fire(source) else None

    def summary(self) -> dict:
        return {
            "armed": self.armed,
            "captures": runtime_stats["captures"],
            "capture_dirs": list(runtime_stats["capture_dirs"]),
            "refused": {
                k: runtime_stats[f"refused_{k}"]
                for k in ("cooldown", "budget", "disk")
            },
            "last_trigger": runtime_stats["last_trigger"],
        }


def armed(capture_dir: str | None = None, on_capture=None) -> OnDemandProfiler:
    """The armed profiler the facade and the drivers poll. Under a process
    group of more than one rank each rank captures into its own
    ``rank<r>`` directory of ``capture_dir``, so its ingest reads its own
    trace, not whichever ranks' files have landed in a shared run
    directory by then."""
    from ..runtime import dist

    if capture_dir is not None and dist.world_size() > 1:
        capture_dir = os.path.join(capture_dir, f"rank{dist.rank()}")
    return OnDemandProfiler(trace_dir=capture_dir, on_capture=on_capture).arm()
