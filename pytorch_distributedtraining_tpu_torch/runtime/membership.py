"""Membership layer for elastic launches: heartbeats, epochs, host health.

Counterpart of ``pytorch_distributedtraining_tpu/runtime/membership.py``,
copied nearly verbatim (it is stdlib only on both sides). The elastic
launcher (``runtime/launch.py``) can only see its own children's exit
codes; this module is the shared state every node's launcher reads and
writes, so

- the shrink decision sees REMOTE rank deaths (each node posts its
  generation result; the controller aggregates),
- the pool is a *dynamic* set: hosts register capacity and heartbeat,
  so capacity that left can come back and be grown onto,
- hosts whose failures the outage classifier attributes to THEM
  (``resilience.outage.attributes_to_host``) are quarantined with
  exponential backoff instead of being re-admitted to crash again, and
- every membership transition (register, shrink, grow, quarantine,
  hold, epoch bump) lands in an append-only ``transitions.jsonl`` the
  launcher prints and telemetry mirrors as ``membership.<kind>`` instants
  (``observe/trace.py``, category ``membership``).

Two backends share one method surface:

- :class:`MembershipStore`: file-backed, for single-node elastic and
  multi-node launchers that share a filesystem (the checkpoint root is
  usually shared already). All writes are atomic (tmp + rename,
  single-line O_APPEND), all reads tolerate torn files.
- :func:`serve_store` / :class:`TCPMembershipStore`: a line-JSON TCP
  proxy over a file store, for launchers with no shared filesystem:
  node 0 serves, the others point ``--membership-dir`` at
  ``tcp://host:port``.

Stdlib only: the launcher, which must never import torch, imports this,
and :data:`runtime_stats` holds JAX's live counters for whoever reads
them. The replica records and metric snapshots are the serving fleet's
(a later slice reads them); they live in the same store, as in JAX.

On-disk layout::

    <root>/
      epoch.json            {"epoch": N, "world": W, "mode", "reason", "t"}
      generation.json       controller's published next-generation plan
      teardown.json         controller's "stop the current epoch" request
      hosts/<host>.json     {"host_id", "capacity", "node_rank",
                             "registered_t", "last_heartbeat"}
      health/<host>.json    {"failures", "attributed_failures",
                             "consecutive_healthy_probes",
                             "quarantine_round", "quarantined_until"}
      ranks/<rank>.json     rank-level liveness (runtime/dist.initialize)
      results/<epoch>_<host>.json   per-host generation outcome
      metrics/rank_<r>.json per-rank metric snapshot
      replicas/<id>.json    serve-replica role record:
                            {"replica_id", "host_id", "address",
                             "standby", "draining", "registered_t",
                             "last_heartbeat"}
      transitions.jsonl     append-only membership transition log
"""

from __future__ import annotations

import json
import os
import re
import socket
import socketserver
import sys
import threading
import time

__all__ = [
    "MembershipStore",
    "TCPMembershipStore",
    "GrowGate",
    "open_store",
    "serve_store",
    "runtime_stats",
]

# live counters, JAX's keys: the launcher populates them as epochs advance
runtime_stats: dict = {
    "epoch_advances": [],       # time.monotonic() of every epoch bump
    "hysteresis_window_s": None,  # the launcher's min-interval knob
    "flap_limit": None,           # max epoch advances tolerated per window
    "transitions": 0,
    # serve-replica lifecycle events:
    # (time.monotonic(), replica_id, "register"|"deregister") tuples
    "replica_events": [],
}


def reset_runtime_stats() -> None:
    runtime_stats.update(
        epoch_advances=[], hysteresis_window_s=None, flap_limit=None,
        transitions=0, replica_events=[],
    )


_HOST_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# default liveness window: a host whose heartbeat is older than this is
# not counted as capacity (the launcher heartbeats ~1/s from its monitor).
# GRAFT_MEMBERSHIP_TTL_S is resolved at store construction, not here: an
# import-time read would freeze whatever the first importer's environment
# held.
DEFAULT_TTL_S = 30.0


def _tracer():
    """observe.trace via sys.modules, never imported (the contract of
    resilience/faults.py: membership must stay stdlib-importable)."""
    return sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.observe.trace")


def _write_json_atomic(path: str, doc: dict) -> None:
    # pid AND thread id: the TCP server handles requests on threads that
    # share a pid with the monitor loop, and a shared tmp name would let
    # one writer os.replace the other's half-written file
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        # missing, or torn mid-replace on a non-atomic network fs: a
        # reader must never crash the monitor loop
        return None


def _check_host_id(host_id: str) -> str:
    if not _HOST_ID_RE.fullmatch(str(host_id)):
        raise ValueError(
            f"host_id must match {_HOST_ID_RE.pattern}, got {host_id!r}"
        )
    return str(host_id)


class MembershipStore:
    """File-backed membership: the shared state under elastic decisions.

    ``clock`` is injectable (wall-clock seconds) so quarantine/backoff
    tests advance time deterministically. All public methods take and
    return JSON-plain values -- the TCP proxy forwards them verbatim.
    """

    def __init__(
        self,
        root: str,
        *,
        ttl_s: float | None = None,
        quarantine_base_s: float | None = None,
        quarantine_max_s: float | None = None,
        clock=time.time,
    ):
        self.root = os.path.abspath(root)
        self.ttl_s = float(
            ttl_s if ttl_s is not None
            else os.environ.get("GRAFT_MEMBERSHIP_TTL_S", DEFAULT_TTL_S)
        )
        self.quarantine_base_s = float(
            quarantine_base_s if quarantine_base_s is not None
            else os.environ.get("GRAFT_QUARANTINE_BASE_S", "60")
        )
        self.quarantine_max_s = float(
            quarantine_max_s if quarantine_max_s is not None
            else os.environ.get("GRAFT_QUARANTINE_MAX_S", "3600")
        )
        self._clock = clock
        for sub in (
            "hosts", "health", "ranks", "results", "metrics", "replicas",
        ):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _host_path(self, host_id: str) -> str:
        return os.path.join(self.root, "hosts", f"{_check_host_id(host_id)}.json")

    def _health_path(self, host_id: str) -> str:
        return os.path.join(
            self.root, "health", f"{_check_host_id(host_id)}.json"
        )

    # -- hosts + heartbeats ------------------------------------------------

    def register_host(
        self, host_id: str, capacity: int, node_rank: int = 0
    ) -> dict:
        """Announce a host with ``capacity`` rank slots; idempotent."""
        now = self._clock()
        prev = _read_json(self._host_path(host_id))
        doc = {
            "host_id": _check_host_id(host_id),
            "capacity": int(capacity),
            "node_rank": int(node_rank),
            "registered_t": (prev or {}).get("registered_t", now),
            "last_heartbeat": now,
        }
        _write_json_atomic(self._host_path(host_id), doc)
        if prev is None:
            self.record_transition(
                "register", host=host_id, capacity=int(capacity)
            )
        return doc

    def heartbeat(self, host_id: str) -> float:
        """Refresh a host's liveness stamp; returns the stamp written.

        The chaos site lets a plan drop heartbeats (the host then ages
        out of :meth:`hosts` and cannot be grown onto) without touching
        the process that owns them.
        """
        from ..resilience.faults import fault_point

        fault_point("membership.heartbeat", host=host_id)
        path = self._host_path(host_id)
        doc = _read_json(path)
        if doc is None:
            raise KeyError(f"heartbeat for unregistered host {host_id!r}")
        doc["last_heartbeat"] = self._clock()
        _write_json_atomic(path, doc)
        return doc["last_heartbeat"]

    def hosts(self, alive_within_s: float | None = None) -> list[dict]:
        """All registered hosts, optionally filtered to live heartbeats."""
        ttl = self.ttl_s if alive_within_s is None else float(alive_within_s)
        now = self._clock()
        out = []
        hosts_dir = os.path.join(self.root, "hosts")
        for name in sorted(os.listdir(hosts_dir)):
            if not name.endswith(".json"):
                continue
            doc = _read_json(os.path.join(hosts_dir, name))
            if doc is None:
                continue
            if ttl > 0 and now - doc.get("last_heartbeat", 0.0) > ttl:
                continue
            out.append(doc)
        out.sort(key=lambda d: (d.get("node_rank", 0), d["host_id"]))
        return out

    # -- rank liveness (runtime/dist.initialize) ---------------------------

    def note_rank(
        self, rank: int, host_id: str | None = None, up: bool = True,
        pid: int | None = None,
    ) -> None:
        """Rank-level liveness record: written by ``dist.initialize`` so a
        launcher can see REMOTE rank deaths (a rank that registered but
        stopped refreshing) -- not just its local children's exit codes."""
        path = os.path.join(self.root, "ranks", f"{int(rank)}.json")
        _write_json_atomic(path, {
            "rank": int(rank),
            "host_id": host_id,
            "pid": pid if pid is not None else os.getpid(),
            "up": bool(up),
            "t": self._clock(),
        })

    def live_ranks(self, alive_within_s: float | None = None) -> list[dict]:
        ttl = self.ttl_s if alive_within_s is None else float(alive_within_s)
        now = self._clock()
        out = []
        ranks_dir = os.path.join(self.root, "ranks")
        for name in sorted(os.listdir(ranks_dir)):
            doc = _read_json(os.path.join(ranks_dir, name))
            if doc is None or not doc.get("up"):
                continue
            if ttl > 0 and now - doc.get("t", 0.0) > ttl:
                continue
            out.append(doc)
        return out

    # -- health + quarantine -----------------------------------------------

    def _default_health(self, host_id: str) -> dict:
        return {
            "host_id": host_id,
            "failures": 0,
            "attributed_failures": 0,
            "consecutive_healthy_probes": 0,
            "quarantine_round": 0,
            "quarantined_until": None,
            "last_rc": None,
        }

    def health(self, host_id: str) -> dict:
        return (
            _read_json(self._health_path(host_id))
            or self._default_health(_check_host_id(host_id))
        )

    def record_failure(
        self,
        host_id: str,
        rc: int | None = None,
        attributed: bool = False,
        detail: str = "",
    ) -> dict:
        """Record one generation failure on ``host_id``.

        ``attributed=True`` (the outage classifier blames the host -- see
        ``resilience.outage.attributes_to_host``) quarantines it with
        exponential backoff: ``base * 2**(round-1)`` seconds, capped.
        External terminations (preemption) are failures of the *pool*,
        not the host -- record them un-attributed so the host stays
        admissible for grow-back.
        """
        doc = self.health(host_id)
        doc["failures"] += 1
        doc["last_rc"] = rc
        doc["consecutive_healthy_probes"] = 0
        if attributed:
            doc["attributed_failures"] += 1
            doc["quarantine_round"] += 1
            backoff = min(
                self.quarantine_max_s,
                self.quarantine_base_s * (2 ** (doc["quarantine_round"] - 1)),
            )
            doc["quarantined_until"] = self._clock() + backoff
            self.record_transition(
                "quarantine", host=host_id, rc=rc, backoff_s=backoff,
                round=doc["quarantine_round"], detail=detail,
            )
        else:
            self.record_transition(
                "failure", host=host_id, rc=rc, detail=detail
            )
        _write_json_atomic(self._health_path(host_id), doc)
        return doc

    def record_probe(self, host_id: str, healthy: bool = True) -> int:
        """Count one capacity probe; returns the consecutive-healthy run.

        Probes observed while a quarantine is still ticking do NOT
        accumulate: the backoff must fully expire before a host starts
        earning its way back in.
        """
        doc = self.health(host_id)
        if not healthy or self.is_quarantined(host_id):
            doc["consecutive_healthy_probes"] = 0
        else:
            doc["consecutive_healthy_probes"] += 1
        _write_json_atomic(self._health_path(host_id), doc)
        return doc["consecutive_healthy_probes"]

    def is_quarantined(self, host_id: str) -> bool:
        until = self.health(host_id).get("quarantined_until")
        return until is not None and self._clock() < until

    def quarantine_remaining_s(self, host_id: str) -> float:
        until = self.health(host_id).get("quarantined_until")
        if until is None:
            return 0.0
        return max(0.0, until - self._clock())

    def admissible_hosts(
        self,
        alive_within_s: float | None = None,
        min_healthy_probes: int = 0,
    ) -> list[dict]:
        """Hosts the launcher may place ranks on: alive, not quarantined,
        and (for grow admission) with enough consecutive healthy probes."""
        out = []
        for doc in self.hosts(alive_within_s):
            hid = doc["host_id"]
            if self.is_quarantined(hid):
                continue
            if (
                min_healthy_probes > 0
                and self.health(hid)["consecutive_healthy_probes"]
                < min_healthy_probes
            ):
                continue
            out.append(doc)
        return out

    def admissible_capacity(
        self,
        alive_within_s: float | None = None,
        min_healthy_probes: int = 0,
    ) -> int:
        return sum(
            h["capacity"]
            for h in self.admissible_hosts(alive_within_s, min_healthy_probes)
        )

    # -- epochs + generations ----------------------------------------------

    def current_epoch(self) -> dict:
        return _read_json(os.path.join(self.root, "epoch.json")) or {
            "epoch": 0, "world": None, "mode": None,
        }

    def bump_epoch(self, world: int, mode: str, reason: str = "") -> int:
        """Advance the generation epoch; every world transition is one bump.

        Feeds :data:`runtime_stats`, whose ``epoch_advances`` against the
        hysteresis window show a store whose epochs advance faster than
        the window should allow (a flapping host thrashing the run).
        """
        doc = self.current_epoch()
        epoch = int(doc.get("epoch", 0)) + 1
        _write_json_atomic(os.path.join(self.root, "epoch.json"), {
            "epoch": epoch, "world": int(world), "mode": mode,
            "reason": reason, "t": self._clock(),
        })
        runtime_stats["epoch_advances"].append(time.monotonic())
        self.record_transition(
            "epoch", epoch=epoch, world=int(world), mode=mode, reason=reason
        )
        return epoch

    def publish_generation(
        self,
        epoch: int,
        world: int,
        assignments: list,
        port: int | None = None,
        mode: str | None = None,
        attempt: int = 0,
        code: int | None = None,
    ) -> dict:
        """Controller → followers: the next generation's launch plan.

        ``assignments`` is an ordered ``[[host_id, nproc], ...]`` -- rank
        bases are cumulative in list order, so every launcher derives its
        global ranks from the same document. ``mode`` is the children's
        ``GRAFT_RECOVERY_MODE`` (shrink/retry/grow), or the terminal
        ``done`` / ``abort`` that releases idle followers.
        """
        doc = {
            "epoch": int(epoch),
            "world": int(world),
            "assignments": [[h, int(n)] for h, n in assignments],
            "port": port,
            "mode": mode,
            "attempt": int(attempt),
            "code": code,
            "t": self._clock(),
        }
        _write_json_atomic(os.path.join(self.root, "generation.json"), doc)
        return doc

    def read_generation(self) -> dict | None:
        return _read_json(os.path.join(self.root, "generation.json"))

    def wait_generation(
        self,
        min_epoch: int,
        timeout_s: float = 300.0,
        poll_s: float = 0.2,
        heartbeat_host: str | None = None,
    ) -> dict | None:
        """Block until a generation with ``epoch >= min_epoch`` is published
        (follower path). Heartbeats ``heartbeat_host`` while waiting so an
        idle, shrunk-out host keeps counting as returnable capacity."""
        deadline = time.monotonic() + timeout_s
        last_hb = 0.0
        while time.monotonic() < deadline:
            doc = self.read_generation()
            if doc is not None and doc.get("epoch", -1) >= min_epoch:
                return doc
            if heartbeat_host and time.monotonic() - last_hb >= 1.0:
                try:
                    self.heartbeat(heartbeat_host)
                except (KeyError, OSError):
                    pass
                last_hb = time.monotonic()
            time.sleep(poll_s)
        return None

    # -- per-epoch results + teardown coordination -------------------------

    def post_result(
        self, epoch: int, host_id: str, code: int, n_failed: int,
        rcs: list | None = None,
    ) -> None:
        """One host's generation outcome (the controller aggregates these
        so its shrink math counts REMOTE rank deaths too)."""
        path = os.path.join(
            self.root, "results", f"{int(epoch)}_{_check_host_id(host_id)}.json"
        )
        _write_json_atomic(path, {
            "epoch": int(epoch), "host_id": host_id, "code": int(code),
            "n_failed": int(n_failed), "rcs": rcs or [], "t": self._clock(),
        })

    def results(self, epoch: int) -> list[dict]:
        out = []
        results_dir = os.path.join(self.root, "results")
        prefix = f"{int(epoch)}_"
        for name in sorted(os.listdir(results_dir)):
            if not name.startswith(prefix):
                continue
            doc = _read_json(os.path.join(results_dir, name))
            if doc is not None:
                out.append(doc)
        return out

    def request_teardown(self, epoch: int, reason: str) -> None:
        """Controller → every launcher: stop epoch ``epoch``'s children
        (gracefully -- SIGTERM forces the preemption save) and post results."""
        _write_json_atomic(os.path.join(self.root, "teardown.json"), {
            "epoch": int(epoch), "reason": reason, "t": self._clock(),
        })
        self.record_transition("teardown", epoch=int(epoch), reason=reason)

    def teardown_requested(self, epoch: int) -> dict | None:
        doc = _read_json(os.path.join(self.root, "teardown.json"))
        if doc is not None and doc.get("epoch") == int(epoch):
            return doc
        return None

    # -- fleet metrics -------------------------------------------------------

    def clock_probe(self) -> dict:
        """One timestamp off this store's clock: the remote half of a
        midpoint clock-offset estimate. Over the TCP proxy the
        request/response pair rides the same line-JSON protocol as every
        other call, so the estimate's RTT bound *is* the protocol's round
        trip."""
        return {"t": self._clock(), "pid": os.getpid()}

    def publish_metrics(self, host_id: str, rank: int, doc: dict) -> None:
        """One rank's current metric snapshot; last write wins per rank,
        and a fleet monitor folds all of them per refresh."""
        path = os.path.join(self.root, "metrics", f"rank_{int(rank)}.json")
        _write_json_atomic(path, {
            "host_id": host_id,
            "rank": int(rank),
            "t": self._clock(),
            **(doc or {}),
        })

    def read_metrics(self, alive_within_s: float | None = None) -> list[dict]:
        """Every rank's latest published snapshot, stale ones dropped."""
        ttl = self.ttl_s if alive_within_s is None else float(alive_within_s)
        now = self._clock()
        out = []
        metrics_dir = os.path.join(self.root, "metrics")
        try:
            names = sorted(os.listdir(metrics_dir))
        except OSError:
            return []
        for name in names:
            doc = _read_json(os.path.join(metrics_dir, name))
            if doc is None:
                continue
            if ttl > 0 and now - doc.get("t", 0.0) > ttl:
                continue
            out.append(doc)
        return out

    # -- serve-replica role records ------------------------------------------

    def _replica_path(self, replica_id: str) -> str:
        return os.path.join(
            self.root, "replicas", f"{_check_host_id(replica_id)}.json"
        )

    def register_replica(
        self,
        replica_id: str,
        host_id: str = "",
        address: str = "",
        standby: bool = False,
    ) -> dict:
        """Announce a serve replica (an engine process the router may
        dispatch to). ``address`` is the replica's transport endpoint
        (``tcp://host:port``; empty for in-process fleets); ``standby``
        marks registered-but-not-serving capacity the scale controller
        can admit on sustained SLO burn. Idempotent -- re-registration
        refreshes the heartbeat and clears any drain mark."""
        now = self._clock()
        prev = _read_json(self._replica_path(replica_id))
        doc = {
            "replica_id": _check_host_id(replica_id),
            "host_id": str(host_id),
            "address": str(address),
            "standby": bool(standby),
            "draining": False,
            "registered_t": (prev or {}).get("registered_t", now),
            "last_heartbeat": now,
        }
        _write_json_atomic(self._replica_path(replica_id), doc)
        if prev is None or prev.get("draining"):
            runtime_stats["replica_events"].append(
                (time.monotonic(), str(replica_id), "register")
            )
            self.record_transition(
                "replica_register", replica=replica_id, host=host_id,
                address=address, standby=bool(standby),
            )
        return doc

    def replica_heartbeat(self, replica_id: str) -> float:
        """Refresh a replica's liveness stamp; returns the stamp written.
        A replica whose heartbeat ages out of the TTL stops being routed
        to -- membership TTL expiry IS the router's loss detector."""
        path = self._replica_path(replica_id)
        doc = _read_json(path)
        if doc is None:
            raise KeyError(
                f"heartbeat for unregistered replica {replica_id!r}"
            )
        doc["last_heartbeat"] = self._clock()
        _write_json_atomic(path, doc)
        return doc["last_heartbeat"]

    def replicas(
        self,
        alive_within_s: float | None = None,
        include_standby: bool = False,
    ) -> list[dict]:
        """Registered replicas with live heartbeats, sorted by id.
        Standby records are excluded unless asked for -- the router routes
        only to serving replicas; the scale controller asks for both."""
        ttl = self.ttl_s if alive_within_s is None else float(alive_within_s)
        now = self._clock()
        out = []
        rep_dir = os.path.join(self.root, "replicas")
        try:
            names = sorted(os.listdir(rep_dir))
        except OSError:
            return []
        for name in names:
            if not name.endswith(".json"):
                continue
            doc = _read_json(os.path.join(rep_dir, name))
            if doc is None:
                continue
            if ttl > 0 and now - doc.get("last_heartbeat", 0.0) > ttl:
                continue
            if doc.get("standby") and not include_standby:
                continue
            out.append(doc)
        return out

    def request_drain(self, replica_id: str, reason: str = "") -> dict:
        """Mark a replica for graceful drain: the router stops placing
        new requests on it immediately (the record's ``draining`` flag);
        the replica polls :meth:`drain_requested`, finishes or migrates
        its resident requests, then calls :meth:`deregister_replica`."""
        path = self._replica_path(replica_id)
        doc = _read_json(path)
        if doc is None:
            raise KeyError(f"drain for unregistered replica {replica_id!r}")
        if not doc.get("draining"):
            doc["draining"] = True
            _write_json_atomic(path, doc)
            self.record_transition(
                "replica_drain", replica=replica_id, reason=reason
            )
        return doc

    def drain_requested(self, replica_id: str) -> bool:
        doc = _read_json(self._replica_path(replica_id))
        return bool(doc and doc.get("draining"))

    def deregister_replica(self, replica_id: str, reason: str = "") -> None:
        """Remove a replica's role record (graceful exit after drain, or
        janitorial cleanup of a corpse). Safe to call twice."""
        path = self._replica_path(replica_id)
        existed = _read_json(path) is not None
        try:
            os.remove(path)
        except OSError:
            pass
        if existed:
            runtime_stats["replica_events"].append(
                (time.monotonic(), str(replica_id), "deregister")
            )
            self.record_transition(
                "replica_deregister", replica=replica_id, reason=reason
            )

    # -- transitions ---------------------------------------------------------

    def record_transition(self, kind: str, **detail) -> None:
        """Append one membership transition; mirrored as a telemetry
        ``membership.<kind>`` instant when the tracer is live."""
        event = {"kind": kind, "t": self._clock(), **detail}
        line = json.dumps(event) + "\n"
        fd = os.open(
            os.path.join(self.root, "transitions.jsonl"),
            os.O_WRONLY | os.O_CREAT | os.O_APPEND,
            0o644,
        )
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        runtime_stats["transitions"] += 1
        tr = _tracer()
        if tr is not None:
            try:
                if tr.enabled():
                    tr.instant(f"membership.{kind}", "membership", **detail)
            except Exception:
                pass  # membership semantics never depend on telemetry health

    def transitions(self, limit: int | None = None) -> list[dict]:
        path = os.path.join(self.root, "transitions.jsonl")
        try:
            with open(path, encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            return []
        out = []
        for raw in lines[-limit:] if limit else lines:
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
        return out


class GrowGate:
    """Hysteresis for grow-back: K consecutive capacity-exceeds probes AND
    a minimum interval since the last reshard, so a flapping host (joins,
    heartbeats twice, dies) can never thrash the run through repeated
    save/relaunch cycles.
    """

    def __init__(
        self,
        probes_needed: int = 3,
        min_interval_s: float = 30.0,
        clock=time.monotonic,
    ):
        self.probes_needed = max(1, int(probes_needed))
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._streak = 0
        self._last_reshard: float | None = None

    @property
    def streak(self) -> int:
        return self._streak

    def note_reshard(self) -> None:
        """Any world transition (shrink OR grow) restarts the clock."""
        self._last_reshard = self._clock()
        self._streak = 0

    def veto(self) -> None:
        """Re-arm after a vetoed grow (chaos ``launch.grow`` raise, or a
        store read failing mid-probe): the streak starts over, so the
        veto costs a full K-probe re-confirmation, not just one tick."""
        self._streak = 0

    def observe(self, capacity: int, world: int) -> bool:
        """One probe: True when a grow to ``capacity`` should fire NOW."""
        if capacity <= world:
            self._streak = 0
            return False
        self._streak += 1
        if self._streak < self.probes_needed:
            return False
        if (
            self._last_reshard is not None
            and self._clock() - self._last_reshard < self.min_interval_s
        ):
            return False
        return True


# -- TCP backend -------------------------------------------------------------

# the proxyable surface: every method both backends share. wait_generation
# is deliberately absent -- the client loops read_generation locally instead
# of parking a thread in the server.
_RPC_METHODS = frozenset({
    "register_host", "heartbeat", "hosts",
    "note_rank", "live_ranks",
    "health", "record_failure", "record_probe",
    "is_quarantined", "quarantine_remaining_s",
    "admissible_hosts", "admissible_capacity",
    "current_epoch", "bump_epoch",
    "publish_generation", "read_generation",
    "post_result", "results",
    "request_teardown", "teardown_requested",
    "record_transition", "transitions",
    "clock_probe", "publish_metrics", "read_metrics",
    "register_replica", "replica_heartbeat", "replicas",
    "request_drain", "drain_requested", "deregister_replica",
})


class _StoreRequestHandler(socketserver.StreamRequestHandler):
    def handle(self):
        for raw in self.rfile:
            try:
                req = json.loads(raw)
                method = req["method"]
                if method not in _RPC_METHODS:
                    raise ValueError(f"unknown method {method!r}")
                result = getattr(self.server.store, method)(
                    **req.get("kwargs", {})
                )
                resp = {"ok": True, "result": result}
            except Exception as e:  # noqa: BLE001 -- serialized to the client
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _StoreServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve_store(
    store: MembershipStore, host: str = "127.0.0.1", port: int = 0
) -> tuple[_StoreServer, threading.Thread]:
    """Serve ``store`` over line-JSON TCP; returns (server, thread).

    ``server.server_address`` carries the bound (host, port); callers pass
    ``tcp://host:port`` as the peers' ``--membership-dir``.
    """
    server = _StoreServer((host, port), _StoreRequestHandler)
    server.store = store
    thread = threading.Thread(
        target=server.serve_forever, name="membership-store", daemon=True
    )
    thread.start()
    return server, thread


class TCPMembershipStore:
    """Client proxy: the :class:`MembershipStore` surface over TCP.

    One short-lived connection per call -- the membership rate is a few
    calls per second per launcher, and connectionlessness means a bounced
    server (controller restart) needs no client-side reconnect logic.
    """

    def __init__(self, address: str, timeout_s: float = 10.0):
        addr = address[len("tcp://"):] if address.startswith("tcp://") else address
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"TCP membership address must be tcp://host:port, got {address!r}"
            )
        self.host, self.port = host, int(port)
        self.timeout_s = timeout_s

    def _call(self, method: str, **kwargs):
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        ) as sock:
            sock.sendall(
                (json.dumps({"method": method, "kwargs": kwargs}) + "\n").encode()
            )
            with sock.makefile("r", encoding="utf-8") as fh:
                resp = json.loads(fh.readline())
        if not resp.get("ok"):
            raise RuntimeError(
                f"membership rpc {method} failed: {resp.get('error')}"
            )
        return resp.get("result")

    def __getattr__(self, name: str):
        if name in _RPC_METHODS:
            return lambda **kwargs: self._call(name, **kwargs)
        raise AttributeError(name)

    def wait_generation(
        self,
        min_epoch: int,
        timeout_s: float = 300.0,
        poll_s: float = 0.2,
        heartbeat_host: str | None = None,
    ) -> dict | None:
        deadline = time.monotonic() + timeout_s
        last_hb = 0.0
        while time.monotonic() < deadline:
            doc = self._call("read_generation")
            if doc is not None and doc.get("epoch", -1) >= min_epoch:
                return doc
            if heartbeat_host and time.monotonic() - last_hb >= 1.0:
                try:
                    self._call("heartbeat", host_id=heartbeat_host)
                except RuntimeError:
                    pass
                last_hb = time.monotonic()
            time.sleep(poll_s)
        return None


def open_store(location: str, **kwargs):
    """``MembershipStore`` for a directory, ``TCPMembershipStore`` for a
    ``tcp://host:port`` address -- the launcher's one entry point."""
    if location.startswith("tcp://"):
        return TCPMembershipStore(location)
    return MembershipStore(location, **kwargs)
