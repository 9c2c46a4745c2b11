"""The port's guarded profiler and step timing (``observe/profiling.py``)
against the JAX package's: the guard's three cases (JAX
``tests/test_opcost.py``'s), then the same with a real ``torch.profiler``
on the CPU, which JAX's tests cannot run: a second entrant while a
session is open, the port's or a raw one, is a no-op with a warning and
leaves the first session's trace whole; a session's trace lands as
``<logdir>/<start time>/<host>.<pid>.trace.json.gz`` and
``opcost.load_trace_events`` reads the newest run only. ``StepTimer`` and
``TransferOverlapProbe`` give JAX's numbers on the same samples, and
``DevicePrefetcher(probe=)`` feeds the probe one wait a batch."""

from __future__ import annotations

import os
import re

import pytest
import torch

from pytorch_distributedtraining_tpu.observe import profiling as jprof
from pytorch_distributedtraining_tpu_torch.data import DevicePrefetcher
from pytorch_distributedtraining_tpu_torch.observe import opcost
from pytorch_distributedtraining_tpu_torch.observe import profiling as tprof
from pytorch_distributedtraining_tpu_torch.observe import trace as telemetry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    tprof.stop_profiler_trace()


# -- the guard: JAX's three cases -----------------------------------------------


@pytest.mark.parametrize("prof", [jprof, tprof], ids=["jax", "port"])
def test_second_entrant_noop_with_warning(monkeypatch, prof):
    monkeypatch.setitem(prof._ACTIVE, "logdir", "/owner")
    with pytest.warns(RuntimeWarning, match="already active"):
        assert prof.start_profiler_trace("/second") is False
    assert prof.profiler_active() == "/owner"


@pytest.mark.parametrize("prof", [jprof, tprof], ids=["jax", "port"])
def test_trace_cm_does_not_stop_the_owner(monkeypatch, prof):
    monkeypatch.setitem(prof._ACTIVE, "logdir", "/owner")
    with pytest.warns(RuntimeWarning):
        with prof.trace("/second"):
            pass
    assert prof.profiler_active() == "/owner"


@pytest.mark.parametrize("prof", [jprof, tprof], ids=["jax", "port"])
def test_stop_without_ownership_is_noop(prof):
    assert prof.profiler_active() is None
    prof.stop_profiler_trace()  # must not raise


# -- the guard over a real CPU profiler --------------------------------------------


def _ops(events) -> set:
    return {e.get("name") for e in events if e.get("cat") == "cpu_op"}


def test_session_writes_one_run_dir_per_session(tmp_path):
    telemetry.enable(crash_handler=False)
    try:
        with tprof.trace(str(tmp_path)) as logdir:
            assert logdir == str(tmp_path) and tprof.profiler_active() == str(tmp_path)
            torch.ones(3).mul(2)
        assert tprof.profiler_active() is None
    finally:
        telemetry.disable()
    files = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path) for f in fs]
    assert len(files) == 1
    rel = os.path.relpath(files[0], tmp_path)
    assert re.fullmatch(r"\d{4}(_\d\d){5}/[^/]+\.%d\.trace\.json\.gz" % os.getpid(), rel), rel
    events, n = opcost.load_trace_events(str(tmp_path))
    assert n == 1 and "aten::mul" in _ops(events)
    # a later run in its own directory: the loader reads that one only
    old = os.path.dirname(files[0])
    os.rename(old, os.path.join(tmp_path, "0000_00_00_00_00_00"))
    with tprof.trace(str(tmp_path)):
        torch.ones(3).add(1)
    events, n = opcost.load_trace_events(str(tmp_path))
    assert n == 1 and "aten::add" in _ops(events) and "aten::mul" not in _ops(events)


def test_second_entrant_leaves_the_first_trace_whole(tmp_path):
    """torch itself lets a second session take over and empties the first;
    through the guard the second is a no-op and the first keeps its ops,
    those after the refused start included."""
    telemetry.enable(crash_handler=False)
    telemetry.clear()
    try:
        with tprof.trace(str(tmp_path / "a")):
            torch.ones(3).mul(2)
            with pytest.warns(RuntimeWarning, match="already active"):
                with tprof.trace(str(tmp_path / "b")):
                    torch.ones(3).add(1)
            torch.ones(3).sub(1)
        instants = [r for r in telemetry.records() if r.get("instant")]
    finally:
        telemetry.disable()
    assert not (tmp_path / "b").exists()
    events, _ = opcost.load_trace_events(str(tmp_path / "a"))
    assert {"aten::mul", "aten::add", "aten::sub"} <= _ops(events)
    assert [r["name"] for r in instants] == ["profiler.reentrant"]
    assert instants[0]["attrs"]["requested"] == str(tmp_path / "b")


def test_raw_torch_reentry_empties_the_first_session():
    """What the guard exists for: torch itself enters a second session over
    a running one without a word, and the first comes back empty."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    first = torch.profiler.profile(activities=acts)
    first.__enter__()
    torch.ones(3).mul(2)
    second = torch.profiler.profile(activities=acts)
    second.__enter__()
    torch.ones(3).add(1)
    second.__exit__(None, None, None)
    first.__exit__(None, None, None)
    assert "aten::add" in {e.name for e in second.events()}
    assert len(first.events()) == 0


def test_a_raw_torch_session_makes_the_guard_a_noop(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as raw:
        torch.ones(3).mul(2)
        with pytest.warns(RuntimeWarning, match="outside observe.profiling"):
            assert tprof.start_profiler_trace(str(tmp_path)) is False
        assert tprof.profiler_active() is None
        torch.ones(3).add(1)
    names = {e.name for e in raw.events()}
    assert {"aten::mul", "aten::add"} <= names
    assert os.listdir(tmp_path) == []  # nothing written


def test_shapes_are_recorded_only_under_a_gloo_group(tmp_path):
    """Recording input shapes costs host time on every op; only the gloo
    collective inventory reads them, so a session records them under a gloo
    group and not without one."""
    import torch.distributed as tdist

    from pytorch_distributedtraining_tpu_torch.runtime.dist import find_free_port

    def shapes_recorded(path):
        _, events = tprof.profile_call(lambda: torch.ones(4).add(1), str(path))
        return any("Input Dims" in e.get("args", {}) for e in events if e.get("cat") == "cpu_op")

    assert not tprof.inventory_needs_shapes() and not shapes_recorded(tmp_path / "a.json")
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{find_free_port()}",
                             rank=0, world_size=1)
    try:
        assert tprof.inventory_needs_shapes() and shapes_recorded(tmp_path / "b.json")
    finally:
        tdist.destroy_process_group()


def test_profile_call_returns_the_value_and_the_events(tmp_path):
    value, events = tprof.profile_call(lambda: torch.ones(3).mul(2).sum().item())
    assert value == 6.0 and "aten::mul" in _ops(events)
    path = str(tmp_path / "t.json")
    _, events = tprof.profile_call(lambda: torch.ones(2).add(1), path)
    assert opcost.read_trace(path) == events
    with tprof.trace(str(tmp_path / "owner")):
        with pytest.warns(RuntimeWarning), pytest.raises(RuntimeError, match="already active"):
            tprof.profile_call(lambda: None)


def _lead_trace() -> list:
    """A card's trace as Kineto writes it: the lead's range on thread 1 with
    its op, two launches (one without its device record), a sync and a flow
    arrow; then the traced work on thread 1 and a launch on thread 2 that
    falls inside the lead's time."""
    lead = opcost.LEAD_NAME
    return [
        {"ph": "X", "cat": "user_annotation", "name": lead, "ts": 100, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": lead, "ts": 105, "dur": 40,
         "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add_", "ts": 110, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 111, "dur": 2,
         "tid": 1, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 112, "dur": 1, "tid": 7,
         "args": {"correlation": 5}},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 5, "ts": 111, "tid": 1},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 5, "ts": 112, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120, "dur": 2,
         "tid": 1, "args": {"correlation": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 140, "dur": 9,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120, "dur": 2,
         "tid": 2, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "copy_kernel", "ts": 130, "dur": 1, "tid": 8,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 200, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 201, "dur": 2,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "mul_kernel", "ts": 202, "dur": 1, "tid": 7,
         "args": {"correlation": 8}},
    ]


def test_cut_lead_drops_the_lead_and_counts_its_lost_records():
    """A card's session opens with a lead that its written trace leaves
    out: the lead's ranges, its host ops and calls on its thread, their
    device records and flow arrows go; another thread's launch and the
    traced work stay; the lead's launch without a device record is
    counted (its sync is no launch)."""
    events = _lead_trace()
    kept, lost = opcost.cut_lead(events)
    assert lost == 1
    assert [e["name"] for e in kept] == ["cudaLaunchKernel", "copy_kernel", "aten::mul",
                                         "cudaLaunchKernel", "mul_kernel"]
    assert opcost.cut_lead(kept) == (kept, 0)


def test_cut_lead_reads_a_torch_profiler_range(tmp_path):
    """On the CPU, a ``record_function(LEAD_NAME)`` range in a real
    ``torch.profiler`` trace is what ``cut_lead`` finds: the ops inside it
    go, those after it stay."""
    path = str(tmp_path / "t.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(opcost.LEAD_NAME):
            torch.ones(3).add_(1)
        torch.ones(2).mul(2)
    prof.export_chrome_trace(path)
    events = opcost.read_trace(path, keep_lead=True)
    assert "aten::add_" in _ops(events)
    kept, lost = opcost.cut_lead(events)
    assert lost == 0 and "aten::add_" not in _ops(kept) and "aten::mul" in _ops(kept)
    assert not any(e.get("name") == opcost.LEAD_NAME for e in kept)


@pytest.mark.parametrize("name", ["t.json", "t.trace.json.gz"])
def test_the_port_reads_a_trace_without_its_lead(tmp_path, name):
    """A card's session keeps its lead in the file it writes; the port's
    readers (``read_trace``, ``load_trace_events``) leave it out, and
    ``read_trace(keep_lead=True)`` reads the file whole."""
    import gzip
    import json

    run = tmp_path / "2026_01_01_00_00_00"
    run.mkdir()
    path = str(run / name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": _lead_trace()}, fh)
    assert opcost.read_trace(path, keep_lead=True) == _lead_trace()
    assert opcost.read_trace(path) == opcost.cut_lead(_lead_trace())[0]
    if name.endswith(".trace.json.gz"):
        assert opcost.load_trace_events(str(tmp_path)) == (opcost.read_trace(path), 1)


# -- StepTimer and TransferOverlapProbe --------------------------------------------


@pytest.mark.parametrize("times", [[], [0.5], [3.0, 2.0, 0.1, 0.3, 0.2, 0.4, 0.25]])
@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_matches_jax(times, warmup):
    timers = [m.StepTimer(warmup=warmup, times=list(times)) for m in (jprof, tprof)]
    assert timers[1].summary() == timers[0].summary()
    assert timers[1].throughput(36) == timers[0].throughput(36)


def test_step_timer_records_spans():
    telemetry.enable(crash_handler=False)
    telemetry.clear()
    try:
        timer = tprof.StepTimer(warmup=1)
        for _ in range(3):
            with timer:
                pass
        spans = [(r["name"], r["cat"]) for r in telemetry.records()]
    finally:
        telemetry.disable()
    assert len(timer.times) == 3
    assert spans == [("train.step", "compile"), ("train.step", "step"), ("train.step", "step")]


def test_transfer_overlap_probe_matches_jax():
    probes = [m.TransferOverlapProbe() for m in (jprof, tprof)]
    for p in probes:
        assert p.fraction() is None
        for w, b in ((0.1, 0.9), (-1.0, 0.5), (0.4, 0.0)):
            p.note_wait(w)
            p.note_busy(b)
    assert probes[1].summary() == probes[0].summary()
    assert probes[1].summary()["overlap_fraction"] == pytest.approx(1.4 / 1.9)
    with probes[1].waiting():
        pass
    with probes[1].computing():
        pass
    assert probes[1].waits == 4


def test_prefetcher_feeds_the_probe_one_wait_a_batch():
    probe = tprof.TransferOverlapProbe()
    batches = [(torch.full((2,), float(i)),) for i in range(5)]
    got = list(DevicePrefetcher(batches, "cpu", depth=2, probe=probe))
    assert [b[0][0].item() for b in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert probe.waits == 5 and probe.wait_s >= 0.0
