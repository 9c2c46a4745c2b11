"""The port's anomaly-triggered capture (``observe/capture.py``) against the
JAX package's: the same scripted signals, fake clock and fake profiler
hooks give the same fires, refusals and ``runtime_stats`` (wall times
apart), for each of the four sources and each bound (cooldown, budget,
disk, a profiler already owned, a raising ingest hook). The sources are
each package's own modules: a bump of the JAX package's numerics ledger
does not fire the port's capture, and without the port's ``observe.fleet``
its two sources read 0. ``observe.slo``'s seven process-wide counters
after one request stream equal JAX's. Then the capture through its users:
the facade (``GRAFT_CAPTURE``/``GRAFT_OPCOST``) and the ESPCN driver
(``--capture``/``--opcost``), each tripped by an injected non-finite
gradient on the CPU, and the drivers' flags and env twins."""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.observe import capture as jcap
from pytorch_distributedtraining_tpu.observe import fleet as jfleet
from pytorch_distributedtraining_tpu.observe import numerics as jnum
from pytorch_distributedtraining_tpu.observe import slo as jslo
from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp, observe_flags, stoke_ddp
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.observe import capture as tcap
from pytorch_distributedtraining_tpu_torch.observe import numerics as tnum
from pytorch_distributedtraining_tpu_torch.observe import opcost as top
from pytorch_distributedtraining_tpu_torch.observe import profiling
from pytorch_distributedtraining_tpu_torch.observe import slo as tslo

torch.set_num_threads(1)
PORT_FLEET = "pytorch_distributedtraining_tpu_torch.observe.fleet"
ENV = ("GRAFT_CAPTURE", "GRAFT_OPCOST", "GRAFT_NUMERICS", "GRAFT_NUMERICS_ACTION",
       "GRAFT_NUMERICS_INJECT", "GRAFT_TRACE", "GRAFT_TELEMETRY", "GRAFT_WIRE")


@pytest.fixture
def sources(monkeypatch):
    """Every anomaly ledger both captures poll, at rest; the port's
    ``observe.fleet`` (the serving-fleet slice) stood in by a namespace with
    JAX's ledger shape, so the fleet sources can be scripted alike."""
    saved = {"jslo": dict(jslo.runtime_stats), "tslo": dict(tslo.runtime_stats)}
    port_fleet = SimpleNamespace(runtime_stats={"verdicts": [], "stragglers_flagged": 0})
    monkeypatch.setitem(sys.modules, PORT_FLEET, port_fleet)
    jfleet.reset_runtime_stats()
    for m in (jnum, tnum, jcap, tcap):
        m.reset()
    for m in (jslo, tslo):
        m.runtime_stats.update(burn_rate_peak=0.0, budget_remaining=None)
    yield {"jax": (jfleet, jslo, jnum), "port": (port_fleet, tslo, tnum)}
    jfleet.reset_runtime_stats()
    for m in (jnum, tnum, jcap, tcap):
        m.reset()
    jslo.runtime_stats.update(saved["jslo"])
    tslo.runtime_stats.update(saved["tslo"])


def _trip(source: str, fleet, slo, num) -> None:
    if source == "fleet-straggler":
        fleet.runtime_stats["stragglers_flagged"] += 1
    elif source == "slo-burn":
        slo.runtime_stats.update(burn_rate_peak=2.0)
    elif source == "slo-budget":
        slo.runtime_stats.update(budget_remaining=0.0)
    elif source == "numerics":
        num.runtime_stats["nonfinite_steps_total"] += 1
    elif source == "numerics-verdict":
        num.runtime_stats["verdicts"].append({"kind": "spike"})
    elif source == "bench-regression":
        fleet.runtime_stats["verdicts"].append({"status": "regression"})
    elif source == "bench-ok":
        fleet.runtime_stats["verdicts"].append({"status": "ok"})


def _profiler(cap, root, clock, calls, owned=False, **kw):
    """A capture with fake hooks; ``owned``: the profiler is someone else's
    (the guard refuses every start)."""
    def start(d):
        calls.append(("start", os.path.relpath(d, root)))
        if not owned:
            os.makedirs(d, exist_ok=True)
        return not owned

    def stop():
        calls.append(("stop",))

    return cap.OnDemandProfiler(os.path.join(root, "caps"), clock=lambda: clock[0],
                                start=start, stop=stop, **kw)


def _stats(cap, root):
    """``runtime_stats`` without wall times, dirs relative to ``root``."""
    s = dict(cap.runtime_stats)
    s["capture_dirs"] = [os.path.relpath(d, root) for d in s["capture_dirs"]]
    if s["last_trigger"] is not None:
        s["last_trigger"] = {"source": s["last_trigger"]["source"],
                             "dir": os.path.relpath(s["last_trigger"]["dir"], root)}
    return s


# scripts: a list of ("trip", source) | ("step",) | ("clock", seconds)
SCRIPTS = {
    **{f"fires_once_{src}": [("step",), ("trip", src), ("step",), ("step",), ("clock", 99.0),
                             ("step",), ("step",), ("step",)]
       for src in ("fleet-straggler", "slo-burn", "slo-budget", "numerics", "numerics-verdict",
                   "bench-regression")},
    "ok_verdict_is_quiet": [("trip", "bench-ok"), ("step",), ("step",)],
    "cooldown": [("trip", "fleet-straggler"), ("step",), ("step",), ("clock", 5.0),
                 ("trip", "fleet-straggler"), ("step",), ("step",), ("clock", 11.0), ("step",),
                 ("step",)],
    "budget": [("trip", "numerics"), ("step",), ("step",), ("clock", 99.0), ("trip", "numerics"),
               ("step",), ("step",)],
    "three_capture_steps": [("trip", "numerics"), ("step",), ("step",), ("step",), ("step",),
                            ("step",)],
}
PROFILER_KW = {"budget": {"max_captures": 1}, "three_capture_steps": {"capture_steps": 3}}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_capture_script_matches_jax(tmp_path, sources, name):
    outs = {}
    for impl, cap in (("jax", jcap), ("port", tcap)):
        root = str(tmp_path / impl)
        clock, calls = [0.0], []
        kw = {"cooldown_s": 10.0, "capture_steps": 1, **PROFILER_KW.get(name, {})}
        prof = _profiler(cap, root, clock, calls, **kw).arm()
        fired = []
        for op in SCRIPTS[name]:
            if op[0] == "trip":
                _trip(op[1], *sources[impl])
            elif op[0] == "clock":
                clock[0] = op[1]
            else:
                fired.append(prof.note_step())
        summary = prof.summary()
        outs[impl] = (fired, calls, _stats(cap, root), summary["refused"], summary["captures"])
    assert outs["port"] == outs["jax"]
    fired = outs["port"][0]
    if name.startswith("fires_once"):
        src = name[len("fires_once_"):]
        want = {"slo-budget": "slo-burn", "numerics-verdict": "numerics"}.get(src, src)
        assert [f for f in fired if f] == [want] and outs["port"][4] == 1


@pytest.mark.parametrize("case", ["disk_cap", "owned_profiler", "raising_hook"])
def test_capture_bounds_match_jax(tmp_path, sources, case):
    outs = {}
    for impl, cap in (("jax", jcap), ("port", tcap)):
        root = str(tmp_path / impl)
        clock, calls, seen = [0.0], [], []
        kw = {"cooldown_s": 10.0, "capture_steps": 1}
        if case == "disk_cap":
            kw["disk_cap_bytes"] = 50
            os.makedirs(os.path.join(root, "caps"))
            with open(os.path.join(root, "caps", "junk"), "wb") as fh:
                fh.write(b"x" * 100)
        if case == "owned_profiler":
            kw["owned"] = True
        if case == "raising_hook":
            kw["on_capture"] = lambda d, s: seen.append(s) or 1 / 0
        prof = _profiler(cap, root, clock, calls, **kw).arm()
        _trip("numerics", *sources[impl])
        fired = [prof.note_step(), prof.note_step()]
        outs[impl] = (fired, calls, _stats(cap, root), prof.capturing, seen)
    assert outs["port"] == outs["jax"]
    stats = outs["port"][2]
    assert {"disk_cap": stats["refused_disk"] == 2 and stats["captures"] == 0,
            "owned_profiler": stats["captures"] == 0 and outs["port"][3] is None,
            "raising_hook": stats["captures"] == 1 and outs["port"][4] == ["numerics"]}[case]


def test_jax_numerics_does_not_fire_the_ports_capture(tmp_path, sources):
    """The JAX package's ledger, loaded in the same process, is not the
    port's source: a bump there is no anomaly here."""
    calls = []
    prof = _profiler(tcap, str(tmp_path), [0.0], calls, capture_steps=1).arm()
    jnum.runtime_stats["nonfinite_steps_total"] += 5
    jnum.runtime_stats["verdicts"].append({"kind": "nonfinite"})
    jfleet.runtime_stats["stragglers_flagged"] += 1
    jslo.runtime_stats.update(burn_rate_peak=9.0)
    assert [prof.note_step() for _ in range(3)] == [None] * 3
    assert calls == [] and tcap.runtime_stats["captures"] == 0
    tnum.runtime_stats["nonfinite_steps_total"] += 1
    assert prof.note_step() == "numerics"


def test_fleet_sources_read_zero_without_the_ports_fleet(monkeypatch, tmp_path, sources):
    monkeypatch.delitem(sys.modules, PORT_FLEET)
    prof = _profiler(tcap, str(tmp_path), [0.0], []).arm()
    sig = prof._signals()
    assert sig["fleet-straggler"] == 0 and sig["bench-regression"] == 0


def test_default_capture_dir_is_under_the_run_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAFT_RUN_DIR", str(tmp_path))
    assert tcap.OnDemandProfiler().trace_dir == os.path.join(str(tmp_path), "captures")


# -- the SLO counters the slo-burn source reads -----------------------------------


def _request_stream(slo) -> dict:
    slo.runtime_stats.update(requests=0, shed=0, violations=0, burn_rate=None,
                             burn_rate_peak=0.0, budget_remaining=None, objective=None)
    led = slo.RequestLedger(run_id="s")
    tracker = slo.SLOTracker(latency_target_s=1.0, ttft_target_s=0.5, slo_fraction=0.9,
                             window_s=10.0, clock=lambda: 0.0)
    for rid, (t_end, ttft) in enumerate([(0.5, 0.1), (2.0, 0.2), (0.7, 0.9), (0.4, 0.1)]):
        led.begin(rid, t=0.0)
        led.note_admit(rid, t=0.05, slot=rid % 2)
        led.add_phase(rid, "decode", 0.1, t_end)
        led.complete(rid, t=t_end)
        tracker.observe(t_end, ttft_s=ttft, t=float(rid))
    led.begin(9, t=0.0)
    led.shed(9, t=0.3)
    return dict(slo.runtime_stats)


def test_slo_runtime_stats_match_jax(sources):
    got = {impl: _request_stream(m) for impl, m in (("jax", jslo), ("port", tslo))}
    assert got["port"] == got["jax"]
    s = got["port"]
    assert (s["requests"], s["shed"], s["violations"]) == (5, 1, 2)
    assert s["burn_rate_peak"] > 1.0 and s["budget_remaining"] < 0
    assert s["objective"] == "0.9 of requests latency<=1s & ttft<=0.5s"


# -- through the facade and the ESPCN driver ------------------------------------


@pytest.fixture
def clean_env(monkeypatch):
    for v in ENV:  # set then delete: the teardown removes what a driver set
        monkeypatch.setenv(v, "")
        monkeypatch.delenv(v)
    tcap.reset()
    top.reset()
    tnum.reset()
    yield
    profiling.stop_profiler_trace()  # a capture a failing run left open
    tcap.reset()
    top.reset()
    tnum.reset()


def test_facade_capture_fires_once_on_an_injected_nan(monkeypatch, tmp_path, clean_env):
    """One process, no group: the numerics plane trips on the poisoned step,
    the armed capture traces the next three optimizer steps, and the ingest
    lands a table (host collectives only: none without a group)."""
    monkeypatch.setenv("GRAFT_NUMERICS", "1")
    monkeypatch.setenv("GRAFT_NUMERICS_ACTION", "rollback")
    monkeypatch.setenv("GRAFT_NUMERICS_INJECT", "conv_first.weight@1")
    monkeypatch.setenv("GRAFT_OPCOST", "1")
    monkeypatch.setenv("GRAFT_CAPTURE", str(tmp_path / "caps"))
    model = SwinIR(img_size=8, window_size=4, depths=(2,), embed_dim=12, num_heads=(2,),
                   generator=torch.Generator().manual_seed(0))
    s = stoke_ddp.build_stoke(model, batch_size=2, device="cpu", verbose=False)
    assert s.opcost and s.capture is not None and s.capture.armed
    rng = np.random.default_rng(0)
    hr = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
    lr = hr.reshape(2, 8, 2, 8, 2, 3).mean(dim=(2, 4))
    captures = []
    for _ in range(2 * 6):
        s.backward(s.loss(s.model(lr), hr))
        s.step()
        captures.append(tcap.runtime_stats["captures"])
    assert captures[1::2] == [0, 0, 0, 0, 1, 1]  # fired after step 2, landed after step 5
    assert tcap.runtime_stats["last_trigger"]["source"] == "numerics"
    assert tcap.runtime_stats["capture_dirs"] == [str(tmp_path / "caps" / "capture-0-numerics")]
    assert top.runtime_stats["tables_built"] == 1
    assert s.opcost_result["table"]["total_s"] == 0.0 and s.opcost_result["steps"] == 3
    assert top.load_trace_events(tcap.runtime_stats["capture_dirs"][0])[1] == 1


@pytest.mark.parametrize("value", ["0", "off", ""])
def test_a_falsy_graft_capture_arms_nothing(monkeypatch, clean_env, value):
    monkeypatch.setenv("GRAFT_CAPTURE", value)
    model = SwinIR(img_size=8, window_size=4, depths=(2,), embed_dim=12, num_heads=(2,))
    s = stoke_ddp.build_stoke(model, batch_size=2, device="cpu", verbose=False)
    assert s.capture is None and not s.opcost


def test_espcn_driver_captures_and_ingests(monkeypatch, tmp_path, clean_env):
    monkeypatch.setenv("GRAFT_NUMERICS_INJECT", "conv1.weight@1")
    cap_dir = tmp_path / "caps"
    fairscale_ddp.main(["--synthetic", "--synthetic-n", "96", "--epochs", "1", "--batch-size",
                        "8", "--workers", "0", "--device", "cpu", "--numerics", "degrade",
                        "--capture", str(cap_dir), "--opcost"])
    assert os.environ["GRAFT_CAPTURE"] == str(cap_dir) and os.environ["GRAFT_OPCOST"] == "1"
    assert tcap.runtime_stats["captures"] == 1
    assert tcap.runtime_stats["last_trigger"]["source"] == "numerics"
    assert top.runtime_stats["tables_built"] == 1


def test_driver_capture_ingests_over_its_steps(monkeypatch, tmp_path, clean_env):
    """The drivers' armed profiler hands its ingest the steps it covers, so
    the table's per-step numbers divide by the capture's window."""
    monkeypatch.setenv("GRAFT_CAPTURE", str(tmp_path / "caps"))
    monkeypatch.setenv("GRAFT_OPCOST", "1")
    seen = []
    monkeypatch.setattr(top, "ingest_trace", lambda d, **kw: seen.append((d, kw)))
    prof = observe_flags.armed_capture({"dp": 1}, "cpu")
    assert prof.armed and prof.capture_steps == 3
    prof.capture_steps = 5
    prof.on_capture("dir", "numerics")
    assert seen == [("dir", {"mesh_axes": {"dp": 1}, "steps": 5, "device": "cpu"})]


@pytest.mark.parametrize("argv,capture,opcost", [
    ([], None, None),
    (["--capture"], "1", None),
    (["--capture", "/some/dir", "--opcost"], "/some/dir", "1"),
    (["--capture", "0"], None, None),
])
@pytest.mark.parametrize("driver", [stoke_ddp, fairscale_ddp])
def test_driver_flags_set_the_env_twins(clean_env, driver, argv, capture, opcost):
    opt = driver.build_parser().parse_args(argv)
    observe_flags.apply(opt)
    assert os.environ.get("GRAFT_CAPTURE") == capture
    assert os.environ.get("GRAFT_OPCOST") == opcost
    assert "--opcost" not in driver.__doc__.split("are not")[-1]
