"""Structured span telemetry: spans, instants, the Chrome-trace export and
the crash flight record.

Counterpart of ``pytorch_distributedtraining_tpu/observe/trace.py``,
trimmed to what the serving path uses:

- :func:`span` records a named, categorized duration into a thread-safe
  bounded ring buffer; nesting is tracked per thread (``depth``).
- :func:`instant` records a zero-duration event (a fault injection).
- :func:`dispatch_span` / :func:`bucket_dispatch_span`: the first
  dispatch of an owner (of each ``(kind, bucket)``) is a ``compile`` span,
  later ones ``step`` spans. On the card the first eager call of a shape
  pays cuBLAS handle creation, kernel selection and the caching
  allocator's growth, which this lane keeps out of the steady ``step``
  time, as the JAX lane keeps XLA's compile out of it.
- :func:`export_chrome_trace` writes the buffer as Chrome trace-event JSON
  (Perfetto, ``chrome://tracing``).
- the flight recorder: the last records, the open span stack and the
  in-flight serve requests, flushed to a per-process file under
  :func:`run_dir` on an unhandled exception or a fault-site trip.

Stdlib only. With telemetry off, a call site costs one attribute load and
one branch.

Spans are collected between :func:`enable` and :func:`disable`;
:func:`configure_from_env` turns collection on from ``GRAFT_TELEMETRY``
(a falsy value is the opt-out that wins, any other collects) and
``GRAFT_TRACE`` (an export directory, which implies collection), as
:func:`telemetry_from_env` resolves them for the facade too. ``GRAFT_RUN_DIR`` is the
run-scoped scratch directory, where flight records and default exports go
(default ``<tempdir>/graft-runs/<pid>``). The flight record carries the
numerics probe's snapshot and the memory high-water (``observe.numerics``,
``observe.memory``) where those modules are loaded.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import sys
import tempfile
import threading
import time
import traceback

# the span categories of the JAX package's goodput ledger
CATEGORIES = (
    "step",        # dispatch + device sync -> productive
    "compile",     # first calls of a shape
    "input",       # blocked on the input pipeline
    "checkpoint",  # checkpoint write windows
    "collective",  # explicit cross-process sync
    "outage",      # riding an outage / retry backoff
    "fault",       # injected-fault instants (resilience/faults.py)
    "membership",  # elastic membership transitions
    "other",
)


def run_dir() -> str:
    """The run-scoped scratch directory, created on first use:
    ``GRAFT_RUN_DIR``, else ``graft-runs/<pid>`` under the temp directory."""
    path = os.environ.get("GRAFT_RUN_DIR") or os.path.join(
        tempfile.gettempdir(), "graft-runs", str(os.getpid()))
    os.makedirs(path, exist_ok=True)
    return path


def _rank() -> int:
    for var in ("GRAFT_RANK", "RANK"):
        raw = os.environ.get(var)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                pass
    return 0


def _host() -> str:
    explicit = os.environ.get("GRAFT_HOST_ID")
    if explicit:
        return explicit
    node = os.environ.get("GRAFT_NODE_RANK")
    if node is not None:
        return f"node{node}"
    try:
        return socket.gethostname() or "host?"
    except OSError:
        return "host?"


class Tracer:
    """Thread-safe bounded span/event recorder.

    Records are plain dicts: a span ``{"name", "cat", "t0", "dur", "tid",
    "depth", "attrs"}``, an event the same with ``"dur": 0.0`` and
    ``"instant": True``. ``t0`` is ``time.perf_counter()``, the clock the
    request ledger uses too.
    """

    def __init__(self, capacity: int = 8192):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.enabled = False
        self.capacity = capacity
        self.dropped = 0  # records evicted by the ring bound

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, rec: dict) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(rec)

    def add_span(self, name: str, cat: str, t0: float, dur: float,
                 attrs: dict | None = None, depth: int | None = None) -> None:
        if not self.enabled:
            return
        self._append({
            "name": name, "cat": cat, "t0": t0, "dur": max(0.0, dur),
            "tid": threading.get_ident(),
            "depth": len(self._stack()) if depth is None else depth,
            "attrs": dict(attrs) if attrs else {},
        })

    def instant(self, name: str, cat: str = "other", **attrs) -> None:
        if not self.enabled:
            return
        self._append({
            "name": name, "cat": cat, "t0": time.perf_counter(),
            "dur": 0.0, "tid": threading.get_ident(),
            "depth": len(self._stack()), "attrs": attrs, "instant": True,
        })

    def records(self) -> list:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def open_spans(self) -> list:
        """The current thread's in-flight span frames, innermost last."""
        return [{"name": s.name, "cat": s.cat, "t0": s.t0, "attrs": s.attrs}
                for s in self._stack()]

    def chrome_events(self, process_name: str = "graft-telemetry") -> list:
        """The buffer as Chrome trace-event dicts (µs), re-zeroed to the
        earliest record; one named lane per recording thread."""
        recs = self.records()
        pid = os.getpid()
        events = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"{process_name} (rank {_rank()})",
                     "host": _host(), "rank": _rank()},
        }]
        if not recs:
            return events
        base = min(r["t0"] for r in recs)
        tids: dict = {}
        for r in recs:
            tids.setdefault(r["tid"], len(tids))
        for raw, tid in tids.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": f"thread-{raw}"}})
        for r in recs:
            ev = {
                "name": r["name"], "cat": r["cat"], "pid": pid, "tid": tids[r["tid"]],
                "ts": round((r["t0"] - base) * 1e6, 3),
                "args": {k: _jsonable(v) for k, v in r["attrs"].items()},
            }
            if r.get("instant"):
                ev["ph"] = "i"
                ev["s"] = "t"  # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = round(r["dur"] * 1e6, 3)
                ev["depth"] = int(r.get("depth", 0))
            events.append(ev)
        return events

    def export_chrome_trace(self, path: str) -> str:
        """Write the buffer as Chrome trace-event JSON; ``graftMeta.wall_t0``
        is the wall clock at the trace's zero."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        recs = self.records()
        base = min((r["t0"] for r in recs), default=time.perf_counter())
        wall_t0 = time.time() - (time.perf_counter() - base)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({
                "traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms",
                "graftMeta": {"host": _host(), "rank": _rank(), "pid": os.getpid(),
                              "wall_t0": wall_t0},
            }, fh)
        return path


class _NullSpanType:
    """Disabled fast path: one shared no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpanType()


class _LiveSpan:
    __slots__ = ("tracer", "name", "cat", "attrs", "t0", "_depth")

    def __init__(self, tracer: Tracer, name: str, cat: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0 = 0.0

    def set(self, **attrs):
        """Attach attrs discovered mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self.tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # mis-nested exit (generator teardown)
            stack.remove(self)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer.add_span(self.name, self.cat, self.t0, dur, self.attrs, depth=self._depth)
        return False


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# -- module-level default tracer ---------------------------------------

_TRACER = Tracer()


def enabled() -> bool:
    return _TRACER.enabled


def enable(capacity: int | None = None, crash_handler: bool = True) -> Tracer:
    """Turn span collection on (idempotent); the crash handler hooks
    ``sys.excepthook`` so a dying process leaves a flight record."""
    if capacity is not None and capacity != _TRACER.capacity:
        with _TRACER._lock:
            _TRACER._buf = collections.deque(_TRACER._buf, maxlen=capacity)
            _TRACER.capacity = capacity
    _TRACER.enabled = True
    if crash_handler:
        install_crash_handler()
    return _TRACER


def disable() -> None:
    _TRACER.enabled = False


FALSY = ("", "0", "false", "off", "no")


def telemetry_from_env(telemetry: bool = False, trace_dir: str | None = None,
                       env: dict | None = None) -> tuple[bool, str | None]:
    """``(enabled, trace_dir)``, the arguments overridden by their env
    twins: ``GRAFT_TELEMETRY`` (any value but a falsy one collects) for
    ``telemetry``; a non-empty ``GRAFT_TRACE`` (the Chrome-trace export
    destination) for ``trace_dir``, which turns collection on too. An
    explicit falsy ``GRAFT_TELEMETRY`` wins over everything."""
    e = os.environ if env is None else env
    trace_dir = e.get("GRAFT_TRACE", trace_dir) or None
    raw = e.get("GRAFT_TELEMETRY")
    if raw is not None:
        return raw.strip().lower() not in FALSY, trace_dir
    return bool(telemetry or trace_dir), trace_dir


def configure_from_env(env: dict | None = None) -> bool:
    """Turn collection on or off by :func:`telemetry_from_env`, the
    current state as its default; returns whether it is on."""
    on, _ = telemetry_from_env(_TRACER.enabled, None, env)
    (enable if on else disable)()
    return on


def trace_path(base: str | None = None) -> str:
    """Where a Chrome trace goes: ``base`` itself when it ends in
    ``.json``, else ``telemetry-<pid>.trace.json`` in ``base`` (default
    the run dir)."""
    base = base or run_dir()
    if base.endswith(".json"):
        return base
    return os.path.join(base, f"telemetry-{os.getpid()}.trace.json")


def get_tracer() -> Tracer:
    return _TRACER


def add_span(name: str, cat: str, t0: float, dur: float, attrs: dict | None = None) -> None:
    """Record a span measured by the caller (``t0`` from
    ``time.perf_counter()``), at the current nesting depth."""
    _TRACER.add_span(name, cat, t0, dur, attrs)


def span(name: str, cat: str = "other", **attrs):
    """``with span("serve.tick", "step"): ...`` on the default tracer."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return _LiveSpan(_TRACER, name, cat, attrs)


def instant(name: str, cat: str = "other", **attrs) -> None:
    _TRACER.instant(name, cat, **attrs)


def dispatch_span(owner, kind: str):
    """Span for one dispatch of ``owner``: its first is a ``compile`` span,
    later ones ``step`` spans. Warmth lives on the owner
    (``_telemetry_warm``), so two owners each get their own compile span."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    if not getattr(owner, "_telemetry_warm", False):
        owner._telemetry_warm = True
        return _LiveSpan(_TRACER, f"{kind}.compile+dispatch", "compile", {"kind": kind})
    return _LiveSpan(_TRACER, f"{kind}.dispatch", "step", {"kind": kind})


def bucket_dispatch_span(owner, kind: str, bucket):
    """:func:`dispatch_span` for shape-bucketed dispatch families: warmth is
    per ``(kind, bucket)``, so the first dispatch of each bucket is a
    ``compile`` span and every later one a ``step`` span. The bucket rides
    on the span's attrs."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    warm = getattr(owner, "_telemetry_warm_buckets", None)
    if warm is None:
        warm = owner._telemetry_warm_buckets = set()
    key = (kind, bucket)
    attrs = {"kind": kind, "bucket": bucket}
    if key not in warm:
        warm.add(key)
        return _LiveSpan(_TRACER, f"{kind}.compile+dispatch", "compile", attrs)
    return _LiveSpan(_TRACER, f"{kind}.dispatch", "step", attrs)


def records() -> list:
    return _TRACER.records()


def clear() -> None:
    _TRACER.clear()


def export_chrome_trace(path: str | None = None) -> str:
    """Export the default tracer; default path
    ``telemetry-<pid>.trace.json`` under :func:`run_dir`."""
    if path is None:
        path = os.path.join(run_dir(), f"telemetry-{os.getpid()}.trace.json")
    return _TRACER.export_chrome_trace(path)


# -- crash flight recorder ---------------------------------------------

FLIGHT_RECORD_KEEP = 64  # last N records in a flight file


def flight_record_path(pid: int | None = None) -> str:
    return os.path.join(run_dir(), f"flightrec-{os.getpid() if pid is None else pid}.json")


def flush_flight_record(reason: str, exc: BaseException | None = None,
                        path: str | None = None) -> str | None:
    """Write the last records, the open span stack and the in-flight serve
    requests to a per-process file (last writer wins). Called by the crash
    handler and at fault-site trips; never raises."""
    try:
        open_spans = _TRACER.open_spans()
        now = time.perf_counter()
        doc = {
            "reason": reason,
            "pid": os.getpid(),
            "rank": _rank(),
            "wall_time": time.time(),
            "telemetry_enabled": _TRACER.enabled,
            # innermost open span = what the process was doing when it died
            "in_flight": [dict(s, age_s=round(now - s["t0"], 6)) for s in open_spans],
            "recent": _TRACER.records()[-FLIGHT_RECORD_KEEP:],
            "dropped": _TRACER.dropped,
        }
        # the serving half, looked up and not imported: the request ledger
        # is consulted only where the serve plane is live in this process
        slo_mod = sys.modules.get(f"{__package__}.slo")
        if slo_mod is not None:
            serve_inflight = slo_mod.inflight_requests()
            if serve_inflight:
                doc["serve_in_flight"] = serve_inflight
        # the numerics and memory halves, by the same lookup: the non-finite
        # blame, watchdog verdicts and high-water at the moment of death
        num_mod = sys.modules.get(f"{__package__}.numerics")
        if num_mod is not None:
            num_snap = num_mod.snapshot()
            if num_snap.get("steps_observed"):
                doc["numerics"] = num_snap
        mem_stats = getattr(sys.modules.get(f"{__package__}.memory"), "runtime_stats", None)
        if mem_stats and any(v is not None for v in mem_stats.values()):
            doc["memory"] = dict(mem_stats)
        if exc is not None:
            doc["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:500],
                "traceback": traceback.format_exception(type(exc), exc, exc.__traceback__)[-10:],
            }
        path = path or flight_record_path()
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=str)
        os.replace(tmp, path)  # atomic: a reader never sees half a record
        return path
    except Exception:  # noqa: BLE001 -- a recorder must never mask the crash
        return None


_prev_excepthook = None


def install_crash_handler() -> None:
    """Chain a flight-record flush into ``sys.excepthook`` (idempotent)."""
    global _prev_excepthook
    if _prev_excepthook is not None:
        return
    prev = sys.excepthook

    def _hook(exc_type, exc, tb):
        flush_flight_record("unhandled-exception", exc=exc)
        prev(exc_type, exc, tb)

    _prev_excepthook = prev
    sys.excepthook = _hook


def read_flight_records(directory: str | None = None) -> list:
    """Parse every ``flightrec-*.json`` under a run dir; unreadable or
    partial files are skipped."""
    directory = directory or run_dir()
    out = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for n in names:
        if not (n.startswith("flightrec-") and n.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, n), encoding="utf-8") as fh:
                out.append(json.load(fh))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def describe_flight_record(doc: dict) -> str:
    """One line: who died doing what, with the serve requests in flight."""
    exc = doc.get("exception") or {}
    inflight = doc.get("in_flight") or []
    doing = (f"in span '{inflight[-1]['name']}' ({inflight[-1]['cat']})"
             if inflight else "between spans")
    serve = doc.get("serve_in_flight") or []
    if serve:
        phases = ", ".join(f"{r.get('rid', '?')}:{r.get('phase', '?')}" for r in serve[:4])
        more = f" +{len(serve) - 4} more" if len(serve) > 4 else ""
        doing += f" with {len(serve)} serve request(s) in flight ({phases}{more})"
    cause = f" [{exc['type']}: {exc['message']}]" if exc else ""
    return (f"rank {doc.get('rank', '?')} pid {doc.get('pid', '?')} "
            f"({doc.get('reason', '?')}) was {doing}{cause}")
