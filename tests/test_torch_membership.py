"""``runtime.membership``, the port's stdlib copy of JAX's membership store.

One scripted call sequence, on an injected clock, runs on JAX's
``MembershipStore`` and on the port's, each over its own directory: the
result of every call (hosts and their liveness window, rank liveness,
health, quarantine and its remaining seconds, admissible hosts and
capacity, epochs, generations, results, teardown, replica records, metric
snapshots, the transition log) must be equal, and so must the errors.
``GrowGate`` gives the same decisions over the same capacity series, the
TCP proxy round-trips the port's store, the ``membership.heartbeat`` fault
site drops a heartbeat, and the store's transitions reach the port's
tracer as ``membership.<kind>`` instants.
"""

import json

import pytest

from pytorch_distributedtraining_tpu.runtime import membership as jm
from pytorch_distributedtraining_tpu_torch.observe import trace
from pytorch_distributedtraining_tpu_torch.resilience import faults
from pytorch_distributedtraining_tpu_torch.runtime import membership as tm


class Clock:
    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t


# (method, kwargs) calls, or ("advance", seconds) on both clocks
SCRIPT = [
    ("register_host", dict(host_id="node0", capacity=2, node_rank=0)),
    ("register_host", dict(host_id="node1", capacity=2, node_rank=1)),
    ("register_host", dict(host_id="node0", capacity=2, node_rank=0)),  # idempotent
    ("hosts", {}),
    ("advance", 10.0),
    ("heartbeat", dict(host_id="node0")),
    ("advance", 25.0),
    ("hosts", {}),  # node1's heartbeat is 35 s old: out of the 30 s window
    ("hosts", dict(alive_within_s=0)),
    ("heartbeat", dict(host_id="node1")),
    ("heartbeat", dict(host_id="ghost")),  # KeyError
    ("register_host", dict(host_id="bad host!", capacity=1)),  # ValueError
    ("note_rank", dict(rank=0, host_id="node0", pid=123)),
    ("note_rank", dict(rank=1, host_id="node1", up=False, pid=124)),
    ("live_ranks", {}),
    ("record_failure", dict(host_id="node1", rc=-11, attributed=True, detail="segv")),
    ("is_quarantined", dict(host_id="node1")),
    ("quarantine_remaining_s", dict(host_id="node1")),
    ("admissible_hosts", {}),
    ("admissible_capacity", {}),
    ("record_probe", dict(host_id="node1")),
    ("record_probe", dict(host_id="node0")),
    ("advance", 61.0),
    ("heartbeat", dict(host_id="node0")),
    ("heartbeat", dict(host_id="node1")),
    ("is_quarantined", dict(host_id="node1")),
    ("quarantine_remaining_s", dict(host_id="node1")),
    ("record_probe", dict(host_id="node1")),
    ("record_probe", dict(host_id="node1")),
    ("admissible_capacity", dict(min_healthy_probes=3)),
    ("record_probe", dict(host_id="node1")),
    ("admissible_capacity", dict(min_healthy_probes=3)),
    ("admissible_hosts", dict(min_healthy_probes=1)),
    ("record_failure", dict(host_id="node1", rc=-9, attributed=False)),
    ("record_failure", dict(host_id="node1", rc=-11, attributed=True)),  # round 2: 120 s
    ("quarantine_remaining_s", dict(host_id="node1")),
    ("record_probe", dict(host_id="node1", healthy=False)),
    ("health", dict(host_id="node1")),
    ("health", dict(host_id="node0")),
    ("current_epoch", {}),
    ("bump_epoch", dict(world=4, mode="start", reason="launch")),
    ("publish_generation", dict(epoch=1, world=4, assignments=[["node0", 2], ["node1", 2]],
                                port=29500, mode=None, attempt=0)),
    ("read_generation", {}),
    ("wait_generation", dict(min_epoch=1, timeout_s=0.5)),
    ("wait_generation", dict(min_epoch=2, timeout_s=0.1)),
    ("post_result", dict(epoch=1, host_id="node0", code=0, n_failed=0)),
    ("post_result", dict(epoch=1, host_id="node1", code=-9, n_failed=1, rcs=[-9])),
    ("results", dict(epoch=1)),
    ("results", dict(epoch=2)),
    ("teardown_requested", dict(epoch=1)),
    ("request_teardown", dict(epoch=1, reason="peer-failure")),
    ("teardown_requested", dict(epoch=1)),
    ("teardown_requested", dict(epoch=2)),
    ("advance", 3.0),
    ("bump_epoch", dict(world=2, mode="shrink", reason="rc=-9")),
    ("current_epoch", {}),
    ("publish_generation", dict(epoch=2, world=0, assignments=[], mode="done", attempt=1,
                                code=0)),
    ("register_replica", dict(replica_id="r0", host_id="node0", address="tcp://h:1")),
    ("register_replica", dict(replica_id="r1", standby=True)),
    ("replica_heartbeat", dict(replica_id="r0")),
    ("replicas", {}),
    ("replicas", dict(include_standby=True)),
    ("request_drain", dict(replica_id="r0", reason="scale-in")),
    ("drain_requested", dict(replica_id="r0")),
    ("register_replica", dict(replica_id="r0", host_id="node0")),  # clears the drain
    ("deregister_replica", dict(replica_id="r1")),
    ("deregister_replica", dict(replica_id="r1")),
    ("replica_heartbeat", dict(replica_id="r1")),  # KeyError
    ("publish_metrics", dict(host_id="node0", rank=0, doc={"step_ms": [1.0, 2.0]})),
    ("read_metrics", {}),
    ("advance", 31.0),
    ("read_metrics", {}),
    ("record_transition", dict(kind="hold", world=2)),
    ("transitions", dict(limit=3)),
    ("transitions", {}),
]


def _play(mod, root, clock) -> list:
    store = mod.MembershipStore(str(root), ttl_s=30.0, quarantine_base_s=60.0,
                                quarantine_max_s=3600.0, clock=clock)
    out = []
    for name, arg in SCRIPT:
        if name == "advance":
            clock.t += arg
            continue
        try:
            got = getattr(store, name)(**arg)
            out.append((name, json.loads(json.dumps(got))))
        except (KeyError, ValueError) as e:
            out.append((name, type(e).__name__))
    return out


def test_scripted_store_equals_jax(tmp_path):
    jm.reset_runtime_stats()
    tm.reset_runtime_stats()
    want = _play(jm, tmp_path / "jax", Clock())
    got = _play(tm, tmp_path / "port", Clock())
    assert len(got) == len(want)
    for (name, g), (_, w) in zip(got, want):
        assert g == w, name
    kinds = [ev["kind"] for ev in dict(got)["transitions"]]
    assert {"register", "quarantine", "failure", "epoch", "teardown", "replica_register",
            "replica_drain", "replica_deregister", "hold"} <= set(kinds)
    for key in ("transitions", "epoch_advances", "replica_events"):
        got_v, want_v = tm.runtime_stats[key], jm.runtime_stats[key]
        assert (len(got_v) if isinstance(got_v, list) else got_v) == (
            len(want_v) if isinstance(want_v, list) else want_v), key


# (capacity, world) probes, "reshard", "veto", or ("advance", s)
GATE_SCRIPT = [(2, 2), (3, 2), (3, 2), (3, 2), (2, 2), (3, 2), ("veto",), (3, 2), (3, 2),
               (3, 2), ("reshard",), (3, 2), (3, 2), (3, 2), ("advance", 29.0), (3, 2),
               ("advance", 1.5), (3, 2), (1, 2), (4, 2), (4, 2), (4, 2)]


@pytest.mark.parametrize("probes,interval", [(1, 0.0), (3, 30.0), (2, 5.0)])
def test_grow_gate_decisions_equal_jax(probes, interval):
    runs = []
    for mod in (jm, tm):
        clock = Clock()
        gate = mod.GrowGate(probes_needed=probes, min_interval_s=interval, clock=clock)
        seen = []
        for item in GATE_SCRIPT:
            if item[0] == "advance":
                clock.t += item[1]
            elif item[0] == "veto":
                gate.veto()
            elif item[0] == "reshard":
                gate.note_reshard()
            else:
                seen.append((gate.observe(*item), gate.streak))
        runs.append(seen)
    assert runs[0] == runs[1]
    assert any(fired for fired, _ in runs[1]) and not all(fired for fired, _ in runs[1])


def test_tcp_store_round_trips(tmp_path):
    backing = tm.MembershipStore(str(tmp_path / "ms"), ttl_s=30.0)
    server, _ = tm.serve_store(backing)
    try:
        host, port = server.server_address[:2]
        client = tm.open_store(f"tcp://{host}:{port}")
        assert isinstance(client, tm.TCPMembershipStore)
        doc = client.register_host(host_id="node1", capacity=4, node_rank=1)
        assert doc["capacity"] == 4 and backing.hosts()[0]["host_id"] == "node1"
        assert client.heartbeat(host_id="node1") >= doc["last_heartbeat"]
        epoch = client.bump_epoch(world=4, mode="start", reason="launch")
        client.publish_generation(epoch=epoch, world=4, assignments=[["node1", 4]], port=1)
        assert client.wait_generation(min_epoch=epoch, timeout_s=2.0)["world"] == 4
        assert client.wait_generation(min_epoch=epoch + 1, timeout_s=0.3) is None
        client.post_result(epoch=epoch, host_id="node1", code=0, n_failed=0)
        assert backing.results(epoch)[0]["host_id"] == "node1"
        assert client.admissible_capacity() == 4
        assert [t["kind"] for t in client.transitions()] == ["register", "epoch"]
        with pytest.raises(RuntimeError, match="KeyError"):
            client.heartbeat(host_id="ghost")
        with pytest.raises(AttributeError):
            client.no_such_method  # noqa: B018 -- only the proxyable surface
    finally:
        server.shutdown()
        server.server_close()
    assert isinstance(tm.open_store(str(tmp_path / "other")), tm.MembershipStore)
    with pytest.raises(ValueError, match="tcp://host:port"):
        tm.TCPMembershipStore("tcp://nohost")


def test_transitions_reach_the_tracer_as_membership_instants(tmp_path):
    trace.clear()
    trace.enable(crash_handler=False)
    try:
        store = tm.MembershipStore(str(tmp_path / "ms"))
        store.register_host(host_id="node0", capacity=1)
        store.bump_epoch(world=1, mode="start")
    finally:
        trace.disable()
    got = [(r["name"], r["cat"]) for r in trace.records() if r.get("instant")]
    assert got == [("membership.register", "membership"), ("membership.epoch", "membership")]
    assert "membership" in trace.CATEGORIES
    trace.clear()


def test_the_heartbeat_fault_site_drops_one_heartbeat(tmp_path, monkeypatch):
    clock = Clock()
    store = tm.MembershipStore(str(tmp_path / "ms"), ttl_s=30.0, clock=clock)
    store.register_host(host_id="node0", capacity=1)
    monkeypatch.setattr(faults, "_PLAN", faults.FaultPlan.from_json(
        [{"site": "membership.heartbeat", "action": "raise", "match": {"host": "node0"}}]))
    clock.t += 20.0
    with pytest.raises(faults.InjectedFault):
        store.heartbeat(host_id="node0")
    clock.t += 20.0
    assert store.hosts() == []  # the dropped heartbeat let the host age out
    assert store.heartbeat(host_id="node0") == clock.t  # the rule fired once
    assert [h["host_id"] for h in store.hosts()] == ["node0"]
