"""Request-lifecycle SLO accounting (``observe/slo.py``), the telemetry
trace and flight record (``observe/trace.py``) of the port, held against
the JAX package's copies and wired through the port's engines.

The stdlib modules run the same scripted intervals, trackers and records
as the JAX ones and must return the same values exactly (the same
arithmetic on the same floats). The engine and tile server runs check
what only the port's wiring can break: every lifecycle closes, its phases
sum to its wall latency (held at 1e-6 s, float rounding of the sums), shed
requests bill ``queue_wait`` and a terminal ``shed``, and slow-reader time
bills ``stall``.
"""

import json
import os

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.observe import slo as jslo
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.observe import slo as tslo
from pytorch_distributedtraining_tpu_torch.observe import trace
from pytorch_distributedtraining_tpu_torch.resilience.faults import FaultPlan, install_plan
from pytorch_distributedtraining_tpu_torch.serve.engine import ServeEngine
from pytorch_distributedtraining_tpu_torch.serve.scheduler import Request
from pytorch_distributedtraining_tpu_torch.serve.tiles import SwinIRTileServer, TileRequest

IMPLS = {"jax": jslo, "port": tslo}


def _ledger_script(slo):
    """Scripted lifecycles: a served request, a shed one, a cancelled one."""
    led = slo.RequestLedger(run_id="t")
    led.begin(0, t=0.0)
    led.note_admit(0, t=1.0, slot=2)
    led.add_phase(0, "prefill", 1.0, 1.5, bucket=16, tokens=12, padding_fraction=0.25)
    led.add_phase(0, "decode", 2.0, 2.5, active_slots=2, share=0.5, padding_fraction=0.5)
    led.add_phase(0, "deliver", 2.5, 2.6)
    led.complete(0, t=2.6)
    led.begin(3, t=0.0)
    led.shed(3, t=0.25)
    led.begin(4, t=0.1)
    led.note_admit(4, t=0.2, slot=0)
    led.add_phase(4, "stall", 0.3, 0.7)
    led.complete(4, t=0.8, outcome=slo.CANCELLED)
    return led


def test_ledger_records_match_jax():
    recs = {k: _ledger_script(m).completed for k, m in IMPLS.items()}
    assert recs["port"] == recs["jax"]
    rec, shed, cancelled = recs["port"]
    assert rec["uid"] == "t/0" and rec["slot"] == 2 and rec["wall_s"] == pytest.approx(2.6)
    # queue 1.0 + prefill 0.5 + decode 0.5 + deliver 0.1 + other 0.5
    assert rec["phases"]["queue_wait"] == pytest.approx(1.0)
    assert rec["phases"]["other"] == pytest.approx(0.5)
    for r in recs["port"]:
        assert sum(r["phases"].values()) == pytest.approx(r["wall_s"])
    assert shed["outcome"] == "shed" and shed["phases"]["queue_wait"] == pytest.approx(0.25)
    assert "shed" in shed["phases"] and cancelled["outcome"] == "cancelled"


@pytest.mark.parametrize("impl", IMPLS)
def test_ledger_hygiene(impl):
    slo = IMPLS[impl]
    led = slo.RequestLedger(run_id="t")
    led.begin(0, t=0.0)
    led.add_phase(0, "prefill", 0.0, 1.0)
    with pytest.raises(ValueError, match="out-of-order"):
        led.add_phase(0, "decode", 0.5, 1.5)
    with pytest.raises(ValueError, match="closes before it opens"):
        led.add_phase(0, "decode", 2.0, 1.0)
    with pytest.raises(ValueError, match="unknown phase"):
        led.add_phase(0, "naptime", 0.0, 1.0)
    with pytest.raises(ValueError, match="no open lifecycle"):
        led.add_phase(7, "decode", 0.0, 1.0)
    with pytest.raises(ValueError, match="already open"):
        led.begin(0, t=0.5)
    led.begin(5)
    led.note_admit(5, slot=1)
    assert [(r["rid"], r["phase"], r["slot"]) for r in led.open_requests()
            if r["rid"] == 5] == [(5, "queue_wait", 1)]
    assert any(r["uid"] == "t/5" for r in slo.inflight_requests())


def _mk_record(rid, wall, phases, intervals=(), outcome="done"):
    return {"uid": f"t/{rid}", "rid": rid, "slot": 0, "outcome": outcome, "t_start": 0.0,
            "t_end": wall, "wall_s": wall, "phases": phases, "intervals": list(intervals)}


def _summary_records():
    fast = [_mk_record(i, 0.1 + 0.01 * i, {"decode": 0.1, "prefill": 0.01 * i})
            for i in range(9)]
    slow = _mk_record(9, 2.0, {"queue_wait": 1.5, "decode": 0.5}, intervals=[
        ("prefill", 1.4, 1.5, {"padding_fraction": 0.75}),
        ("decode", 1.5, 2.0, {"padding_fraction": 0.5, "spec_k": 4, "share": 0.5,
                              "draft_s": 0.1, "verify_s": 0.3, "proposed": 3,
                              "accepted": 2, "tokens": 3})])
    return fast + [slow, _mk_record(10, 1.0, {"shed": 0.0}, outcome="shed")]


def test_tail_quantiles_and_spec_attribution_match_jax():
    recs = _summary_records()
    for q in (50.0, 90.0, 99.0):
        assert tslo.tail_attribution(recs, q=q) == jslo.tail_attribution(recs, q=q)
        assert tslo.phase_quantiles(recs, q) == jslo.phase_quantiles(recs, q)
    assert tslo.spec_attribution(recs) == jslo.spec_attribution(recs)
    out = tslo.tail_attribution(recs, q=99.0)
    assert out["dominant_phase"] == "queue_wait" and out["n_tail"] == 1
    assert out["n_requests"] == 10  # the shed record is not a delivery
    assert out["padding_seconds"] == pytest.approx(0.1 * 0.75 + 0.5 * 0.5)
    spec = tslo.spec_attribution(recs)
    assert spec["accept_rate"] == 0.6667 and spec["verify_seconds"] == 0.15  # rounded
    assert tslo.tail_attribution([]) == {}


def _tracker_script(slo):
    t = [0.0]
    tr = slo.SLOTracker(latency_target_s=1.0, ttft_target_s=0.1, slo_fraction=0.9,
                        window_s=10.0, clock=lambda: t[0])
    out = [tr.observe(0.5) for _ in range(8)]
    out.append(tr.observe(2.0))  # latency violated
    out.append(tr.observe(0.5, ttft_s=0.2))  # TTFT violated
    out.append(tr.burn_rate())
    t[0] = 11.0  # both violations leave the 10 s window
    out.append(tr.observe(0.5))
    out += [tr.burn_rate(), tr.budget_remaining(), tr.snapshot()]
    return out


def test_slo_tracker_matches_jax_and_knobs():
    got, want = _tracker_script(tslo), _tracker_script(jslo)
    assert got == want
    assert got[10] == pytest.approx(2.0)  # 2 violations in 10, budget 0.1
    assert got[12] == 0.0 and got[13] == pytest.approx(1.0 - (2 / 11) / 0.1)
    assert "ttft<=0.1s" in got[-1]["objective"]
    env = {"GRAFT_SERVE_SLO_LATENCY_MS": "250", "GRAFT_SERVE_SLO_TTFT_MS": "50",
           "GRAFT_SERVE_SLO_FRACTION": "0.95", "GRAFT_SERVE_SLO_WINDOW_S": "30"}
    for e in (env, {}):
        assert tslo.slo_knobs_from_env(e) == jslo.slo_knobs_from_env(e)
    assert tslo.slo_knobs_from_env(env) == dict(latency_target_s=0.25, ttft_target_s=0.05,
                                                slo_fraction=0.95, window_s=30.0)


def test_chrome_lanes_and_export_match_jax(tmp_path):
    recs = {k: _ledger_script(m).completed for k, m in IMPLS.items()}
    events = tslo.serve_chrome_events(recs["port"], pid=42)
    assert events == jslo.serve_chrome_events(recs["jax"], pid=42)
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"}
    assert lanes == {"queue", "slot 0", "slot 2"}
    spans = [e for e in events if e["ph"] == "X"]
    assert all(e["tid"] == 0 for e in spans if e["name"] in ("queue_wait", "shed"))
    assert all(e["tid"] == 3 for e in spans if e["name"] in ("prefill", "decode"))
    chains: dict = {}
    for e in events:
        if e["ph"] in ("s", "t", "f"):
            chains.setdefault(e["id"], []).append(e["ph"])
    assert len(chains) == 3 and all(c[0] == "s" and c[-1] == "f" for c in chains.values())
    path = tslo.export_serve_trace(recs["port"], str(tmp_path / "serve.trace.json"))
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    assert doc["graftMeta"]["kind"] == "graft-serve" and doc["graftMeta"]["n_requests"] == 3
    assert tslo.serve_chrome_events([]) == []


def test_flight_record_names_inflight_requests_and_faults(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFT_RUN_DIR", str(tmp_path))
    led = tslo.RequestLedger(run_id="fr")
    led.begin(7)
    led.note_admit(7, slot=0)
    led.add_phase(7, "decode", led._open[7].last_end, led._open[7].last_end + 0.001)
    trace.enable(crash_handler=False)
    try:
        with trace.span("serve.tick", "step"):
            path = trace.flush_flight_record("test")
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        # a fault-site trip flushes a record too, with its instant
        install_plan(FaultPlan.from_json([{"site": "serve.client", "action": "raise"}]))
        from pytorch_distributedtraining_tpu_torch.resilience.faults import (InjectedFault,
                                                                             fault_point)
        with pytest.raises(InjectedFault):
            fault_point("serve.client", rid=7)
        assert any(r["name"] == "fault.serve.client" for r in trace.records())
        out = trace.export_chrome_trace(str(tmp_path / "telemetry.trace.json"))
    finally:
        install_plan(None)
        trace.disable()
        trace.clear()
        led.complete(7)
    assert path == str(tmp_path / f"flightrec-{doc['pid']}.json")
    assert doc["in_flight"][-1]["name"] == "serve.tick"
    assert any(r["uid"] == "fr/7" and r["phase"] == "decode" for r in doc["serve_in_flight"])
    line = trace.describe_flight_record(doc)
    assert "serve request(s) in flight" in line and "7:decode" in line
    reread = trace.read_flight_records(str(tmp_path))
    assert [d["reason"] for d in reread] == ["fault:serve.client"]  # the last writer
    with open(out, encoding="utf-8") as fh:
        assert any(e["ph"] == "i" for e in json.load(fh)["traceEvents"])


def test_telemetry_switch_and_default_export_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFT_RUN_DIR", str(tmp_path))
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")  # the shared no-op when disabled
    trace.enable(crash_handler=False)
    try:
        assert trace.enabled()
        with trace.span("serve.tick", "step"):
            pass
        out = trace.export_chrome_trace()
    finally:
        trace.disable()
        trace.clear()
    assert out == str(tmp_path / f"telemetry-{os.getpid()}.trace.json")
    with open(out, encoding="utf-8") as fh:
        assert any(e.get("name") == "serve.tick" for e in json.load(fh)["traceEvents"])
    assert tslo.export_serve_trace([]) == str(tmp_path / f"serve-{os.getpid()}.trace.json")


@pytest.fixture(scope="module")
def served():
    """A clean and a chaotic run of the tiny port engine."""
    cfg = tg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=96)
    params = tg.GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)

    def run(plan=None, n=4):
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=6), 3) for i in range(n)]
        install_plan(plan)
        try:
            eng = ServeEngine(cfg, params, n_slots=2, page_size=8, max_len=48, prefill_chunk=16,
                              prefill_buckets=(8, 16), device="cpu")
            delivered = eng.run(reqs, realtime=False)
        finally:
            install_plan(None)
        return eng, reqs, delivered

    chaos = FaultPlan.from_json([
        {"site": "serve.admit", "action": "raise", "at": 2},
        {"site": "serve.client", "action": "sleep", "arg": 0.02, "at": 1},
    ])
    return run(), run(chaos)


def test_clean_run_lifecycles_sum_to_wall(served):
    (eng, reqs, delivered), _ = served
    completed = eng.ledger.completed
    assert len(completed) == len(reqs) == len(delivered) and not eng.ledger._open
    for rec in completed:
        assert rec["outcome"] == "done"
        assert sum(rec["phases"].values()) == pytest.approx(rec["wall_s"], abs=1e-6)
        assert rec["phases"].get("prefill", 0.0) > 0.0 and rec["phases"].get("decode", 0.0) > 0
    for r in delivered:
        assert r["req_id"].endswith(f"/{r['rid']}") and r["wall_s"] > 0.0 and r["phases"]
    out = eng.tail_attribution()
    assert out["dominant_phase"] and out["n_requests"] == len(completed)
    snap = eng.slo.snapshot()
    assert snap["requests"] == len(completed) and snap["burn_rate"] == 0.0


def test_chaos_run_closes_every_lifecycle(served):
    _, (eng, reqs, _) = served
    completed = eng.ledger.completed
    assert len(completed) == len(reqs) and not eng.ledger._open
    outcomes = [r["outcome"] for r in completed]
    assert outcomes.count("shed") == 1
    shed = next(r for r in completed if r["outcome"] == "shed")
    assert shed["phases"].get("shed") == 0.0 and "decode" not in shed["phases"]
    assert max(r["phases"].get("stall", 0.0) for r in completed) >= 0.02
    for rec in completed:
        assert sum(rec["phases"].values()) == pytest.approx(rec["wall_s"], abs=1e-6)


def test_engine_serve_trace_export(served, tmp_path):
    (eng, reqs, _), _ = served
    with open(eng.export_serve_trace(str(tmp_path / "s.trace.json")), encoding="utf-8") as fh:
        doc = json.load(fh)
    assert doc["graftMeta"]["n_requests"] == len(reqs)
    flows = {e["id"] for e in doc["traceEvents"] if e["ph"] == "s"}
    assert len(flows) == len(reqs)


class _Double(torch.nn.Module):
    upscale = 1

    def forward(self, x):
        return x * 2.0


def test_tile_phases_and_completion():
    srv = SwinIRTileServer(_Double(), tile=32, tile_batch=3, overlap=0, device="cpu")
    rng = np.random.default_rng(0)
    recs = srv.run([TileRequest(0, rng.random((32, 64, 3)).astype(np.float32)),
                    TileRequest(1, rng.random((32, 32, 3)).astype(np.float32))])
    assert len(recs) == 2
    completed = srv.ledger.completed
    assert len(completed) == 2 and not srv.ledger._open
    for rec in completed:
        assert rec["phases"].get("tile", 0.0) > 0.0
        assert sum(rec["phases"].values()) == pytest.approx(rec["wall_s"], abs=1e-6)
    tiles = [attrs for rec in completed for phase, _, _, attrs in rec["intervals"]
             if phase == "tile"]
    assert tiles and all({"tiles", "share", "padding_fraction"} <= set(a) for a in tiles)
    assert srv.tail_attribution()["dominant_phase"] and srv.slo.snapshot()["requests"] == 2
