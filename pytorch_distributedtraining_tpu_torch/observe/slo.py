"""Request-lifecycle SLO accounting for the serving plane.

Counterpart of ``pytorch_distributedtraining_tpu/observe/slo.py``: where
did each request's time go, and is the engine inside its latency
objective.

- :class:`RequestLedger` assembles per-request lifecycle records from typed
  phase intervals (``queue_wait`` / ``prefill`` / ``decode`` / ``tile`` /
  ``stall`` / ``deliver`` / terminal ``shed``). Per phase the merged
  interval coverage is summed and uncovered lifecycle time lands in
  ``other``, so the buckets sum exactly to the request's wall latency. An
  interval that closes out of order raises.
- :func:`tail_attribution`: for requests at or above the q-th percentile,
  which phase owns the time, and how much of the compute phases is
  bucket or batch padding; :func:`spec_attribution` splits speculative
  decode into draft and verify time and its accept rate.
- :class:`SLOTracker`: latency/TTFT objectives and a rolling error-budget
  burn rate (1.0 = violations arrive at the budgeted rate).
- :func:`serve_chrome_events` / :func:`export_serve_trace`: the
  ``graft-serve`` Chrome-trace lane, one thread lane per slot and a flow
  chain per request.
- :data:`runtime_stats`: the process-wide counters JAX keeps at the same
  sites (requests closed, sheds, objective misses, the burn rate and its
  peak, the least error budget left, the objective), which the anomaly
  capture's ``slo-burn`` source reads through ``sys.modules``
  (``observe.capture``).

Stdlib only.
"""

from __future__ import annotations

import itertools
import os
import time
import weakref


def _merged_total(intervals: list) -> float:
    """Total covered time of possibly-overlapping [a, b) intervals (the
    JAX package's ``observe/goodput.py`` helper)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_a, cur_b = intervals[0]
    for a, b in intervals[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total + (cur_b - cur_a)


# the typed lifecycle phases; "other" is the computed remainder (engine
# time the request spent admitted but not in any instrumented interval —
# co-scheduled work on other slots, host bookkeeping)
PHASES = (
    "queue_wait",  # enqueue -> slot admit
    "prefill",     # per chunk; attrs: bucket, tokens, padding_fraction
    "decode",      # per batched tick; attrs: active_slots, share, padding;
                   # speculative ticks add spec_k, draft_s, verify_s,
                   # proposed, accepted (see spec_attribution)
    "tile",        # SwinIR tile batches; attrs: tiles, share, padding
    "stall",       # slow-reader/client time at delivery
    "deliver",     # record assembly + handoff
    "shed",        # terminal marker: dropped at admission
)
OTHER = "other"

# outcomes a lifecycle can close with
DONE, SHED, CANCELLED = "done", "shed", "cancelled"

# phases whose intervals may carry a padding_fraction (bucket/batch waste)
_COMPUTE_PHASES = ("prefill", "decode", "tile")

# slack for monotonicity checks: perf_counter deltas below this are
# indistinguishable from clock granularity, not reordering
_EPS = 1e-9

# process-wide SLO counters, read through sys.modules (observe/capture.py's
# slo-burn source): budget_remaining <= 0 or burn_rate_peak > 1 trips it
runtime_stats = {
    "requests": 0,          # lifecycles completed (any outcome)
    "shed": 0,              # terminal-shed lifecycles
    "violations": 0,        # SLO objective misses observed
    "burn_rate": None,      # latest rolling burn rate
    "burn_rate_peak": 0.0,  # worst rolling burn rate seen
    "budget_remaining": None,  # min all-time error-budget fraction left
    "objective": None,      # human-readable objective string
}

# live ledgers, for the crash flight recorder: observe/trace.py asks
# "which requests were in flight, and in what phase" at flush time
_LIVE_LEDGERS: "weakref.WeakSet[RequestLedger]" = weakref.WeakSet()
_LEDGER_SEQ = itertools.count()


def inflight_requests() -> list:
    """Open lifecycles across every live ledger — the serve half of the
    flight record (``observe.trace.flush_flight_record``)."""
    out = []
    for ledger in list(_LIVE_LEDGERS):
        try:
            out.extend(ledger.open_requests())
        except Exception:  # noqa: BLE001 — a recorder never masks a crash
            continue
    return out


def slo_knobs_from_env(env=None) -> dict:
    """Resolve the ``GRAFT_SERVE_SLO_*`` knob family into
    :class:`SLOTracker` kwargs (documented in ``serve/__init__.py``)."""
    e = os.environ if env is None else env

    def _float(name, default):
        raw = (e.get(name) or "").strip()
        return float(raw) if raw else default

    return dict(
        latency_target_s=_float("GRAFT_SERVE_SLO_LATENCY_MS", 60000.0) / 1e3,
        ttft_target_s=_float("GRAFT_SERVE_SLO_TTFT_MS", 0.0) / 1e3 or None,
        slo_fraction=_float("GRAFT_SERVE_SLO_FRACTION", 0.99),
        window_s=_float("GRAFT_SERVE_SLO_WINDOW_S", 60.0),
    )


class _Lifecycle:
    """One request's open lifecycle: ordered, non-overlapping intervals."""

    __slots__ = (
        "rid", "uid", "t_start", "slot", "intervals", "last_end",
    )

    def __init__(self, rid, uid, t_start):
        self.rid = rid
        self.uid = uid
        self.t_start = float(t_start)
        self.slot = None
        self.intervals: list = []  # (phase, t0, t1, attrs|None)
        self.last_end = float(t_start)

    def phase(self) -> str:
        """Current/most recent phase — what the request is doing *now*."""
        return self.intervals[-1][0] if self.intervals else "queue_wait"


class RequestLedger:
    """Per-request phase-interval accounting for one serving engine.

    The engine owns the clock (``time.perf_counter`` unless a timestamp
    is passed explicitly) and calls, per request: :meth:`begin` at
    enqueue, :meth:`note_admit` at slot admission (closing the
    ``queue_wait`` interval), :meth:`add_phase` per instrumented
    interval, then :meth:`complete` (or :meth:`shed` for a request
    dropped at admission). Completed lifecycles land in
    :attr:`completed` as plain dicts whose ``phases`` buckets sum to
    ``wall_s`` exactly (union-interval semantics, remainder ->
    ``other``).

    Hygiene is enforced, not assumed: per request, intervals must be
    time-ordered and non-overlapping — an interval that closes before
    the previous one ended raises :class:`ValueError` instead of
    silently double-counting the overlap.
    """

    def __init__(self, run_id: str | None = None):
        self.run_id = run_id or f"{os.getpid():x}.{next(_LEDGER_SEQ)}"
        self._open: dict = {}  # rid -> _Lifecycle
        self.completed: list = []
        _LIVE_LEDGERS.add(self)

    # -- lifecycle ---------------------------------------------------------

    def begin(self, rid, t: float | None = None) -> str:
        """Open a lifecycle at enqueue; returns the run-unique id."""
        if rid in self._open:
            raise ValueError(f"request {rid}: lifecycle already open")
        t = time.perf_counter() if t is None else float(t)
        life = _Lifecycle(rid, f"{self.run_id}/{rid}", t)
        self._open[rid] = life
        return life.uid

    def note_admit(self, rid, t: float | None = None,
                   slot: int | None = None) -> None:
        """Close the ``queue_wait`` interval (enqueue -> slot admit)."""
        life = self._require(rid)
        t = time.perf_counter() if t is None else float(t)
        life.slot = slot
        self.add_phase(rid, "queue_wait", life.t_start, t)

    def add_phase(self, rid, phase: str, t0: float, t1: float,
                  **attrs) -> None:
        """Record one closed interval ``[t0, t1)`` of ``phase``."""
        if phase not in PHASES:
            raise ValueError(
                f"unknown phase {phase!r}: expected one of {PHASES}"
            )
        life = self._require(rid)
        t0, t1 = float(t0), float(t1)
        if t1 < t0 - _EPS:
            raise ValueError(
                f"request {rid}: {phase} interval closes before it opens "
                f"(t0={t0:.9f} > t1={t1:.9f})"
            )
        # the monotone/non-overlap assertion: a close that lands before
        # the previous interval's end would double-bill the overlap and
        # break the phases-sum-to-wall invariant — refuse it loudly
        if t0 < life.last_end - _EPS:
            raise ValueError(
                f"request {rid}: out-of-order {phase} interval "
                f"(starts {life.last_end - t0:.9f}s before the previous "
                "interval closed)"
            )
        life.intervals.append(
            (phase, t0, max(t1, t0), attrs or None)
        )
        life.last_end = max(t1, t0)

    def shed(self, rid, t: float | None = None) -> dict:
        """Terminal ``shed``: the request was dropped at admission. Its
        queued time is billed, the lifecycle closes complete."""
        life = self._require(rid)
        t = time.perf_counter() if t is None else float(t)
        self.add_phase(rid, "queue_wait", life.t_start, t)
        self.add_phase(rid, "shed", t, t)
        runtime_stats["shed"] += 1
        return self.complete(rid, t=t, outcome=SHED)

    def complete(self, rid, t: float | None = None,
                 outcome: str = DONE) -> dict:
        """Close the lifecycle; returns (and stores) the summary record."""
        life = self._require(rid)
        t = time.perf_counter() if t is None else float(t)
        t = max(t, life.last_end)
        del self._open[rid]
        rec = {
            "uid": life.uid,
            "rid": life.rid,
            "slot": life.slot,
            "outcome": outcome,
            "t_start": life.t_start,
            "t_end": t,
            "wall_s": t - life.t_start,
            "phases": self._breakdown(life, t),
            "intervals": life.intervals,
        }
        self.completed.append(rec)
        runtime_stats["requests"] += 1
        return rec

    # -- accounting --------------------------------------------------------

    @staticmethod
    def _breakdown(life: _Lifecycle, t_end: float) -> dict:
        """Union-interval phase buckets over ``[t_start, t_end]`` — the
        ``GoodputLedger`` algorithm applied to one request: per-phase
        merged coverage, clipped to the lifecycle window, remainder ->
        ``other``. Sums to ``wall_s`` by construction."""
        per_phase: dict = {}
        for phase, a, b, _attrs in life.intervals:
            a = max(a, life.t_start)
            b = min(b, t_end)
            if b > a or phase == "shed":
                per_phase.setdefault(phase, []).append((a, max(b, a)))
        out = {
            phase: _merged_total(ivals)
            for phase, ivals in per_phase.items()
        }
        covered = _merged_total(
            [iv for ivals in per_phase.values() for iv in ivals]
        )
        out[OTHER] = max(0.0, (t_end - life.t_start) - covered)
        return out

    def open_requests(self) -> list:
        """Flight-recorder view: in-flight request ids + current phase."""
        now = time.perf_counter()
        return [
            {
                "uid": life.uid,
                "rid": life.rid,
                "slot": life.slot,
                "phase": life.phase(),
                "age_s": round(now - life.t_start, 6),
            }
            for life in self._open.values()
        ]

    def _require(self, rid) -> _Lifecycle:
        life = self._open.get(rid)
        if life is None:
            raise ValueError(f"request {rid}: no open lifecycle")
        return life


# -- host-side summaries -------------------------------------------------


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over a sorted list."""
    import math

    n = len(sorted_vals)
    idx = max(0, min(n - 1, math.ceil(q / 100.0 * n) - 1))
    return sorted_vals[idx]


def phase_quantiles(records: list, q: float) -> dict:
    """Per-phase q-th percentile seconds across completed lifecycles."""
    per_phase: dict = {}
    for rec in records:
        for phase, secs in (rec.get("phases") or {}).items():
            per_phase.setdefault(phase, []).append(float(secs))
    return {
        phase: round(_percentile(sorted(vals), q), 6)
        for phase, vals in per_phase.items()
    }


def tail_attribution(records: list, q: float = 99.0) -> dict:
    """Attribute the latency tail: for completed requests at/above the
    q-th percentile wall latency, which phase owns the time, and how much
    of the compute phases is bucket/batch padding vs genuine compute.

    Padding seconds are interval duration x the interval's
    ``padding_fraction`` attr (prefill: unused bucket tail; decode/tile:
    idle batch rows), so "the tail is prefill-bound" and "the tail is
    *padding*-bound" are distinguishable — only the second is fixed by
    re-bucketing.
    """
    done = [r for r in records if r.get("outcome") == DONE]
    if not done:
        return {}
    lats = sorted(r["wall_s"] for r in done)
    threshold = _percentile(lats, q)
    tail = [r for r in done if r["wall_s"] >= threshold - _EPS]
    phase_s: dict = {}
    padding_s = 0.0
    compute_s = 0.0
    for rec in tail:
        for phase, secs in (rec.get("phases") or {}).items():
            phase_s[phase] = phase_s.get(phase, 0.0) + float(secs)
        for phase, a, b, attrs in rec.get("intervals") or ():
            if phase not in _COMPUTE_PHASES:
                continue
            dur = max(0.0, b - a)
            compute_s += dur
            padding_s += dur * float((attrs or {}).get(
                "padding_fraction", 0.0
            ))
    dominant = max(phase_s, key=phase_s.get) if phase_s else None
    return {
        "q": q,
        "threshold_latency_s": round(threshold, 6),
        "n_tail": len(tail),
        "n_requests": len(done),
        "dominant_phase": dominant,
        "phase_seconds": {
            k: round(v, 6) for k, v in sorted(
                phase_s.items(), key=lambda kv: -kv[1]
            )
        },
        "compute_seconds": round(compute_s, 6),
        "padding_seconds": round(padding_s, 6),
        "padding_fraction": round(
            padding_s / compute_s, 4
        ) if compute_s > 0 else 0.0,
    }


def spec_attribution(records: list) -> dict:
    """Decode-phase draft/verify sub-attribution + realized accept-rate.

    Speculative decode ticks bill one ``decode`` interval per resident
    slot whose attrs carry the tick's host draft time, batched verify
    time, and the proposed/accepted draft counts. Because every resident
    slot is billed the full tick (phases sum to per-request wall), the
    tick-level seconds are recovered by ``share``-weighting each
    interval — ``sum(share * attr)`` over slots re-assembles one tick's
    wall exactly once. Returns the aggregate: where speculative decode
    time went (draft vs verify) and what it bought (accept rate, tokens
    per verify-second) — the honest speedup decomposition the bench and
    the serve-spec-regress rule read.
    """
    decode_request_s = 0.0
    draft_s = verify_s = 0.0
    proposed = accepted = tokens = 0
    spec_intervals = 0
    for rec in records:
        for phase, a, b, attrs in rec.get("intervals") or ():
            if phase != "decode":
                continue
            decode_request_s += max(0.0, b - a)
            at = attrs or {}
            if "spec_k" not in at:
                continue
            spec_intervals += 1
            share = float(at.get("share", 1.0))
            draft_s += float(at.get("draft_s", 0.0)) * share
            verify_s += float(at.get("verify_s", 0.0)) * share
            proposed += int(at.get("proposed", 0))
            accepted += int(at.get("accepted", 0))
            tokens += int(at.get("tokens", 0))
    return {
        "decode_request_seconds": round(decode_request_s, 6),
        "draft_seconds": round(draft_s, 6),
        "verify_seconds": round(verify_s, 6),
        "spec_intervals": spec_intervals,
        "proposed": proposed,
        "accepted": accepted,
        "accept_rate": round(
            accepted / proposed, 4
        ) if proposed else 1.0,
        "tokens": tokens,
        "tokens_per_verify_second": round(
            tokens / verify_s, 2
        ) if verify_s > 0 else 0.0,
    }


class SLOTracker:
    """Rolling error-budget burn rate against latency/TTFT objectives.

    The objective is "``slo_fraction`` of requests meet the target(s)",
    so the error budget is ``1 - slo_fraction`` of requests. Burn rate is
    the in-window violation rate divided by that budget: 1.0 = violations
    arriving exactly at the budgeted rate; 2.0 = the budget is being
    consumed twice as fast as provisioned. ``budget_remaining`` is the
    all-time view — the fraction of the whole run's error budget still
    unspent (negative = exhausted, the ``serve-slo-burn`` ERROR).
    """

    def __init__(
        self,
        *,
        latency_target_s: float | None = None,
        ttft_target_s: float | None = None,
        slo_fraction: float = 0.99,
        window_s: float = 60.0,
        clock=time.monotonic,
    ):
        self.latency_target_s = latency_target_s
        self.ttft_target_s = ttft_target_s
        self.slo_fraction = min(max(float(slo_fraction), 0.0), 0.9999)
        self.budget = 1.0 - self.slo_fraction
        self.window_s = float(window_s)
        self._clock = clock
        self._window: list = []  # (t, violated) — pruned to window_s
        self.total = 0
        self.violations = 0
        runtime_stats["objective"] = self.describe()

    def describe(self) -> str:
        parts = []
        if self.latency_target_s is not None:
            parts.append(f"latency<={self.latency_target_s:g}s")
        if self.ttft_target_s is not None:
            parts.append(f"ttft<={self.ttft_target_s:g}s")
        target = " & ".join(parts) or "no objective"
        return f"{self.slo_fraction:.4g} of requests {target}"

    # -- observation -------------------------------------------------------

    def observe(
        self,
        latency_s: float,
        ttft_s: float | None = None,
        t: float | None = None,
    ) -> bool:
        """Record one delivered request; returns True when it violated."""
        t = self._clock() if t is None else float(t)
        violated = bool(
            (
                self.latency_target_s is not None
                and latency_s > self.latency_target_s
            )
            or (
                self.ttft_target_s is not None
                and ttft_s is not None
                and ttft_s > self.ttft_target_s
            )
        )
        self.total += 1
        self.violations += int(violated)
        self._window.append((t, violated))
        self._prune(t)
        if violated:
            runtime_stats["violations"] += 1
        self._sync_stats(t)
        return violated

    def _prune(self, t: float) -> None:
        cut = t - self.window_s
        drop = 0
        for tv, _ in self._window:
            if tv >= cut:
                break
            drop += 1
        if drop:
            del self._window[:drop]

    # -- readouts ----------------------------------------------------------

    def burn_rate(self, t: float | None = None) -> float:
        """In-window violation rate / error budget (0.0 when idle)."""
        t = self._clock() if t is None else float(t)
        self._prune(t)
        n = len(self._window)
        if n == 0:
            return 0.0
        v = sum(1 for _, violated in self._window if violated)
        return (v / n) / self.budget

    def budget_remaining(self) -> float:
        """All-time fraction of the error budget left (1.0 = untouched,
        <= 0 = exhausted)."""
        if self.total == 0:
            return 1.0
        return 1.0 - (self.violations / self.total) / self.budget

    def _sync_stats(self, t: float) -> None:
        burn = self.burn_rate(t)
        remaining = self.budget_remaining()
        runtime_stats["burn_rate"] = burn
        runtime_stats["burn_rate_peak"] = max(runtime_stats["burn_rate_peak"], burn)
        prev = runtime_stats["budget_remaining"]
        runtime_stats["budget_remaining"] = remaining if prev is None else min(prev, remaining)

    def snapshot(self) -> dict:
        """Record-shaped summary for the SLO bench."""
        return {
            "objective": self.describe(),
            "latency_target_s": self.latency_target_s,
            "ttft_target_s": self.ttft_target_s,
            "slo_fraction": self.slo_fraction,
            "window_s": self.window_s,
            "requests": self.total,
            "violations": self.violations,
            "burn_rate": round(self.burn_rate(), 6),
            "budget_remaining": round(self.budget_remaining(), 6),
        }


# -- Chrome-trace export (the graft-serve lane) --------------------------

# lifecycle phase -> goodput span category (trace.CATEGORIES), so the
# serve lane's spans roll up alongside the telemetry lane's
_PHASE_CAT = {
    "queue_wait": "input",
    "prefill": "step",
    "decode": "step",
    "tile": "step",
    "stall": "outage",
    "deliver": "other",
    "shed": "fault",
}


def serve_chrome_events(
    records: list,
    *,
    pid: int | None = None,
    lane: str | None = None,
) -> list:
    """Chrome trace events for completed lifecycles: one ``graft-serve``
    process lane, one thread lane per slot (tid = slot + 1; the queue
    lane is tid 0), phase intervals as ``X`` spans, and a flow chain
    (``s``/``t``/``f``) tying every span of one request together across
    lanes — the Perfetto view of "this p99 request queued here, prefilled
    in these chunks, decoded in these ticks"."""
    if not records:
        return []
    pid = os.getpid() if pid is None else int(pid)
    lane = lane or f"graft-serve pid={pid}"
    t_zero = min(r["t_start"] for r in records)
    events: list = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": lane},
    }, {
        "ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
        "args": {"name": "queue"},
    }]
    slots = sorted({
        r["slot"] for r in records if r.get("slot") is not None
    })
    for slot in slots:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid,
            "tid": int(slot) + 1, "args": {"name": f"slot {slot}"},
        })
    for flow_id, rec in enumerate(records, start=1):
        slot_tid = (
            0 if rec.get("slot") is None else int(rec["slot"]) + 1
        )
        ivals = rec.get("intervals") or []
        for i, (phase, a, b, attrs) in enumerate(ivals):
            tid = 0 if phase in ("queue_wait", "shed") else slot_tid
            ts = (a - t_zero) * 1e6
            args = {"rid": rec["rid"], "uid": rec["uid"]}
            if attrs:
                args.update(attrs)
            events.append({
                "ph": "X", "name": phase,
                "cat": _PHASE_CAT.get(phase, OTHER),
                "pid": pid, "tid": tid,
                "ts": ts, "dur": max(b - a, 0.0) * 1e6,
                "args": args,
            })
            # the flow chain: s at the first span, f at the last,
            # t steps in between — Perfetto draws the arrows that make
            # one request followable across the queue and slot lanes
            ph = "s" if i == 0 else ("f" if i == len(ivals) - 1 else "t")
            flow = {
                "ph": ph, "name": "request", "cat": "serve",
                "id": flow_id, "pid": pid, "tid": tid, "ts": ts,
            }
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            events.append(flow)
    return events


def export_serve_trace(
    records: list, path: str | None = None, *, pid: int | None = None,
) -> str:
    """Write completed lifecycles as ``serve-<pid>.trace.json`` next to
    the telemetry export (under the run dir), so
    ``trace_summary.py`` and Perfetto see both lanes in one load."""
    import json

    from . import trace as _trace

    if path is None:
        path = os.path.join(_trace.run_dir(), f"serve-{os.getpid()}.trace.json")
    doc = {
        "traceEvents": serve_chrome_events(records, pid=pid),
        "displayTimeUnit": "ms",
        "graftMeta": {
            "kind": "graft-serve",
            "pid": os.getpid(),
            "n_requests": len(records),
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return path
