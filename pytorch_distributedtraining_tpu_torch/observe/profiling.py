"""The guarded profiler, step timing and the input-overlap probe.

Counterpart of ``pytorch_distributedtraining_tpu/observe/profiling.py``:

- :func:`trace` (``observe.profiler_trace``): a context manager around
  ``torch.profiler`` (CPU activity, and CUDA's where a card exists) that
  writes a Chrome trace on exit;
- :class:`StepTimer`: per-step wall-time statistics past the warm-up steps;
- :class:`TransferOverlapProbe`: the share of a loop's host time not lost
  waiting for staged input.

The profiler is one session a process: a second ``torch.profiler.profile``
entered while one runs takes over silently, and the first one's trace comes
back empty (torch 2.13 on the CPU; its stop logs "disableProfiler called but
no active profiling session found"). So this module arbitrates, as JAX's
does for ``jax.profiler``: the first entrant wins, and a second one, the
manual ``--trace``/:func:`trace` context or an anomaly capture
(``observe.capture``), is a no-op with a ``RuntimeWarning`` and a
``profiler.reentrant`` instant. A raw session started outside this module
is seen through ``torch.autograd.profiler._is_profiler_enabled`` and makes the
entrant a no-op in the same way.

:func:`stop_profiler_trace` writes the trace to
``<logdir>/<start time>/<host>.<pid>.trace.json.gz``: one directory per
run, one file per process, the layout ``observe.opcost.load_trace_events``
reads (the newest run directory only, all of its files). torch's
``tensorboard_trace_handler`` would put every run of a logdir into one
directory, and the loader would then add several runs together. A
session records the host ops' input shapes only under a gloo group
(:func:`inventory_needs_shapes`): there the collective inventory
(``observe.comms``) reads each collective's element counts from its
``c10d::`` op's shapes, while NCCL's ``record_param_comms`` events carry
their own; recording shapes costs host time on every op. :func:`profile_call`
is the measurement scripts' one-call session (``benchmarks/profile_swinir.py``,
``benchmarks/ladder.py --trace``, ``chip_smoke.py``).

On a card a session warms CUPTI up before its window opens: it starts
collecting (``prepare_trace``), runs ``WARMUP_KERNELS`` one-element kernels
to the end, and only then opens the trace's window (``start_trace``), the
split torch's own ``WARMUP`` schedule step makes. In a process that had run
``chip_smoke.py``'s earlier phases, CUPTI lost the first device records of
every session, whatever they were and however long after the start they
came (the H100, torch 2.11, CUDA runtime 12.8, driver 13.0; never in a
fresh process; why, unknown). The loss counts records, not time: a raw
session lost its first 12-21 calls' records, a warm-up of k quick kernels
cut that by about k, 8 kernels spread over 10 ms by as much as 8 quick
ones, and one 10 ms spin kernel by about one kernel's worth. The warm-up's
records absorb the loss, and those that survive fall before the window,
where Kineto drops them. 256 kernels absorbed it in every session but one
(a guarded session once lost 25 records, whose place in its trace was not
recorded); 4096, tried beside 256 in one lossy process, lost none either.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import warnings
from dataclasses import dataclass, field

from . import trace as _telemetry

WARMUP_KERNELS = 4096  # 16x the 256 that once fell short; 200x the 21 a raw session lost

# the session this module started: its logdir, the profile object and the
# wall time it started at (the run directory's name)
_ACTIVE: dict = {"logdir": None, "prof": None, "t0": None}


def profiler_active() -> str | None:
    """The logdir of the trace this module started, or None."""
    return _ACTIVE["logdir"]


def _note_reentrant(logdir: str, owner) -> None:
    warnings.warn(
        f"torch profiler session already active (-> {owner!r}); request for {logdir!r} "
        "is a no-op", RuntimeWarning, stacklevel=3)
    if _telemetry.enabled():
        _telemetry.instant("profiler.reentrant", "profile", active=owner, requested=logdir)


def _raw_session_active() -> bool:
    import torch

    return bool(torch.autograd.profiler._is_profiler_enabled)


def inventory_needs_shapes() -> bool:
    """Whether a session must record input shapes for ``observe.comms``:
    under a gloo group, which emits no ``record_param_comms`` event (torch
    2.13)."""
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized() and tdist.get_backend() == "gloo"


def start_profiler_trace(logdir: str) -> bool:
    """Start a ``torch.profiler`` session whose trace :func:`stop_profiler_trace`
    writes under ``logdir``: True when this call started it, False when a
    session was already active (this module's or a raw one), which is a
    no-op with a warning."""
    if _ACTIVE["logdir"] is not None:
        _note_reentrant(logdir, _ACTIVE["logdir"])
        return False
    if _raw_session_active():
        _note_reentrant(logdir, "a torch.profiler session started outside observe.profiling")
        return False
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=inventory_needs_shapes())
    prof.prepare_trace()
    if torch.cuda.is_available():  # the warm-up of the module docstring
        x = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_KERNELS):
            x.add_(1)
        torch.cuda.synchronize()
    prof.start_trace()
    _ACTIVE.update(logdir=logdir, prof=prof, t0=time.time())
    return True


def trace_file(logdir: str, t0: float) -> str:
    """Where a session that started at wall time ``t0`` writes its trace:
    ``<logdir>/<YYYY_MM_DD_HH_MM_SS>/<host>.<pid>.trace.json.gz``."""
    run = time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime(t0))
    return os.path.join(logdir, run, f"{_telemetry._host()}.{os.getpid()}.trace.json.gz")


def stop_profiler_trace(path: str | None = None) -> str | None:
    """Stop the session :func:`start_profiler_trace` started, once the card's
    queued work is done, and write its trace to :func:`trace_file` (or to
    ``path``, a ``.json`` or ``.json.gz`` file); returns the file. None when
    this module owns no session: it never stops someone else's."""
    prof, logdir, t0 = _ACTIVE["prof"], _ACTIVE["logdir"], _ACTIVE["t0"]
    if logdir is None:
        return None
    import torch

    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = path or trace_file(logdir, t0)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)
    finally:
        _ACTIVE.update(logdir=None, prof=None, t0=None)
    return path


def profile_call(fn, path: str | None = None) -> tuple:
    """``(fn(), events)``: one call of ``fn`` inside a guarded session and
    the events of its trace, which goes to ``path`` (default: a temporary
    file, removed after the read). Raises ``RuntimeError`` when a session is
    already active: a measurement does not run untraced."""
    from .opcost import read_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = path or os.path.join(tmp, "trace.json.gz")
        if not start_profiler_trace(os.path.dirname(path) or "."):
            raise RuntimeError("a torch.profiler session is already active")
        try:
            value = fn()
        finally:
            stop_profiler_trace(path)
        return value, read_trace(path)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with profiler_trace(dir): ...`` traces the block into ``dir``
    (default ``<run dir>/profile``); a no-op with a warning when a session
    is already active."""
    logdir = logdir or os.path.join(_telemetry.run_dir(), "profile")
    started = start_profiler_trace(logdir)
    try:
        yield logdir
    finally:
        if started:
            stop_profiler_trace()


@dataclass
class StepTimer:
    """Track step wall-times; ``summary()`` gives p50/p90/p99/mean/tails
    excluding the warm-up steps (the first calls of a shape pay the kernel
    build, cuBLAS's handles and the allocator's growth).

    With telemetry on (``observe.trace``), every timed step is also a
    ``train.step`` span (the warm-up ones billed as ``compile``), so the
    timer and the goodput ledger read the same measurements.
    """

    warmup: int = 2
    times: list = field(default_factory=list)
    span_name: str = "train.step"
    _t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if _telemetry.enabled():
            n = len(self.times)
            _telemetry.add_span(self.span_name, "compile" if n <= self.warmup else "step",
                                self._t0, dt, {"n": n})
        self._t0 = None

    def summary(self) -> dict:
        steady = self.times[self.warmup:] or self.times
        if not steady:
            return {}
        s = sorted(steady)
        n = len(s)
        return {
            "steps": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(0.9 * n))],
            "p99_s": s[min(n - 1, int(0.99 * n))],
            "min_s": s[0],
            "max_s": s[-1],
        }

    def throughput(self, items_per_step: int) -> float:
        m = self.summary()
        return items_per_step / m["mean_s"] if m else 0.0


@dataclass
class TransferOverlapProbe:
    """How well input staging overlaps with compute.

    The consumer marks time spent blocked on the input pipeline
    (``waiting()`` / ``note_wait``) and time spent in the step itself
    (``computing()`` / ``note_busy``). ``fraction()`` is the share of
    accounted wall clock NOT lost to input waits: 1.0 means transfers were
    fully hidden behind compute, 0.0 means the step was input-bound.

    ``data.DevicePrefetcher`` takes one as its ``probe`` and feeds
    ``note_wait`` from its waits, so a hot loop only needs to wrap the step
    call in ``computing()``. On the card the step call returns when its
    kernels are queued: ``computing()`` measures the host's share unless the
    block ends in a synchronisation.
    """

    wait_s: float = 0.0
    busy_s: float = 0.0
    waits: int = 0

    def note_wait(self, dt: float) -> None:
        self.wait_s += max(0.0, dt)
        self.waits += 1

    def note_busy(self, dt: float) -> None:
        self.busy_s += max(0.0, dt)

    @contextlib.contextmanager
    def waiting(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note_wait(time.perf_counter() - t0)

    @contextlib.contextmanager
    def computing(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note_busy(time.perf_counter() - t0)

    def fraction(self) -> float | None:
        total = self.wait_s + self.busy_s
        if total <= 0.0:
            return None
        return max(0.0, min(1.0, 1.0 - self.wait_s / total))

    def summary(self) -> dict:
        return {
            "wait_s": self.wait_s,
            "busy_s": self.busy_s,
            "waits": self.waits,
            "overlap_fraction": self.fraction(),
        }
