"""Launcher: twins of ``torch.distributed.launch`` and ``mp.spawn``.

Counterpart of ``pytorch_distributedtraining_tpu/runtime/launch.py``. The
reference starts ranks two ways:

- ``python -m torch.distributed.launch --nproc_per_node=4 Stoke-DDP.py``
- ``mp.spawn(train, args=(W, E), nprocs=4)``

Here one process drives one card (``cuda:LOCAL_RANK``), so the launcher
fans out ``--nproc_per_node`` children per node and gives each the env
contract (``RANK``/``LOCAL_RANK``/``WORLD_SIZE``/``MASTER_*``) that
``runtime/dist.initialize`` consumes, plus ``GRAFT_RESTART_ATTEMPT``,
``GRAFT_NODE_RANK``, ``GRAFT_HOST_ID``, ``GRAFT_GEN_EPOCH`` and
``GRAFT_RUN_DIR`` (one run dir for every generation's children,
``graft-runs/launch-<pid>`` under the temp directory unless set), and
``GRAFT_RECOVERY_MODE`` (``retry``/``shrink``/``grow``) from the second
generation on. The launcher itself imports neither torch nor numpy and
never touches a card: only its children do. ``--one_cpu_device_per_rank``
hides every card from the children (``CUDA_VISIBLE_DEVICES=""``) for
localhost testing over gloo; the child still asks for the CPU itself
(``--device cpu`` to a driver), and a child that asks for ``cuda`` then
fails, with its exit code reported.

Fate-sharing: a crashed rank strands the others in the rendezvous or a
collective, so the monitor kills the survivors on the first non-zero exit
(SIGTERM, then SIGKILL after ``GRAFT_LAUNCH_ESCALATE_S``, default 15 s),
prints the flight records dead children left in the run dir
(``observe/trace.py``'s ``flightrec-<pid>.json``: what the rank was
doing) and, with ``--max_restarts N``, relaunches the world while the
outage classifier (``resilience.outage.classify``) says another generation
can help; a DETERMINISTIC exit code gives up at once.

Elastic membership (``--elastic`` + ``runtime/membership.py``): every
node's launcher registers its host and heartbeats into a shared membership
store, posts its generation results there, and the node-0 launcher (the
controller) aggregates them into the next generation's world -- so the
shrink decision sees REMOTE rank deaths, multi-node elastic works with a
shared ``--membership-dir`` (directory or ``tcp://host:port``), and with
``--grow`` the controller re-probes registered capacity between and
*during* generations: when the admissible pool exceeds the running world
for K consecutive probes (and the min-interval hysteresis has passed), it
tears the world down gracefully -- SIGTERM forces the children's
preemption checkpoint -- and relaunches onto the larger world with
``GRAFT_RECOVERY_MODE=grow``. Hosts whose failures the outage classifier
attributes to THEM (``resilience.outage.attributes_to_host``) are
quarantined with exponential backoff and never grown onto until the
backoff expires.

``--observe`` (the fleet metrics exporter) belongs to the serving fleet,
which is not ported yet, and raises.

CLI (the script is a file path, as in JAX)::

    python -m pytorch_distributedtraining_tpu_torch.runtime.launch \
        --nproc_per_node=4 your_script.py --its --flags
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

from ..resilience.faults import InjectedFault, active_plan, fault_point
from ..resilience.outage import (
    OutageClass,
    RetryPolicy,
    attributes_to_host,
    classify,
    external_termination,
)
from .membership import GrowGate, MembershipStore, open_store, serve_store
from .membership import runtime_stats as membership_stats
from .ports import find_free_port


def default_run_dir(pid: int | None = None) -> str:
    """The run dir the launcher and every child share when ``GRAFT_RUN_DIR``
    is unset: ``graft-runs/launch-<launcher pid>`` under the temp directory,
    beside ``observe.trace.run_dir()``'s per-process default."""
    return os.path.join(tempfile.gettempdir(), "graft-runs",
                        f"launch-{os.getpid() if pid is None else pid}")


def _child_env(
    rank: int, local_rank: int, world_size: int, master_addr: str,
    master_port: int, one_cpu_device: bool,
) -> dict:
    env = dict(os.environ)
    # recovery-mode hygiene: the launcher's OWN environment may carry a
    # stale GRAFT_RECOVERY_MODE (a previous shrink's export, an outer
    # launcher, a test harness) -- a generation launched without an
    # explicit mode decision must not inherit one and mislabel its
    # resume path. The per-generation decision re-adds it via extra_env.
    env.pop("GRAFT_RECOVERY_MODE", None)
    env.update(
        RANK=str(rank),
        LOCAL_RANK=str(local_rank),
        WORLD_SIZE=str(world_size),
        MASTER_ADDR=master_addr,
        MASTER_PORT=str(master_port),
    )
    # one shared run dir across all ranks (keyed on the LAUNCHER's pid, so
    # every generation's children agree): telemetry flight records and
    # per-rank step logs land where the restart gate below can find them
    # (observe/trace.py run_dir contract)
    env.setdefault("GRAFT_RUN_DIR", default_run_dir())
    if one_cpu_device:
        # localhost testing: every rank runs on the CPU (gloo). Children
        # must NOT attach to a card -- N ranks fighting over one card is
        # not the run asked for -- so every card is hidden from them; a
        # child that still asks for cuda fails instead of falling back
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _spawn_target(fn, rank, args, env):
    # replace, don't merge: the parent's rank contract must not leak in
    os.environ.clear()
    os.environ.update(env)
    fn(rank, *args)


def spawn(
    fn,
    args: tuple = (),
    nprocs: int = 1,
    *,
    join: bool = True,
    master_addr: str = "127.0.0.1",
    master_port: int | None = None,
    one_cpu_device: bool = True,
):
    """``mp.spawn`` twin: run ``fn(rank, *args)`` in ``nprocs`` processes.

    Sets the env rendezvous contract for each child so ``fn`` can call
    ``runtime.dist.initialize()`` exactly like the reference's ``train``
    calls ``init_process_group``. With ``one_cpu_device`` (the default, as
    in JAX) the children see no card: ``fn`` forms a gloo group with
    ``initialize(device="cpu")``.
    """
    master_port = master_port or find_free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = _child_env(
            rank, rank, nprocs, master_addr, master_port, one_cpu_device
        )
        p = ctx.Process(target=_spawn_target, args=(fn, rank, args, env))
        p.start()
        procs.append(p)
    if not join:
        return procs
    failed = []
    for rank, p in enumerate(procs):
        p.join()
        if p.exitcode != 0:
            failed.append((rank, p.exitcode))
    if failed:
        for p in procs:
            if p.is_alive():
                p.terminate()
        raise RuntimeError(f"spawned ranks failed: {failed}")
    return None


class _MembershipCtl:
    """One elastic run's launcher-side membership state.

    Bundles the store handle, this launcher's host identity, the
    controller flag (node 0 aggregates and decides; the others follow the
    published generations), and the grow-back hysteresis gate.
    """

    def __init__(self, store, host_id: str, controller: bool, opt):
        self.store = store
        self.host_id = host_id
        self.controller = controller
        self.epoch = 0
        self.grow = bool(getattr(opt, "grow", False))
        self.grow_probes = max(1, int(os.environ.get("GRAFT_GROW_PROBES", "3")))
        self.probe_interval_s = float(
            os.environ.get("GRAFT_GROW_PROBE_INTERVAL_S", "5")
        )
        self.min_interval_s = float(
            os.environ.get("GRAFT_GROW_MIN_INTERVAL_S", "30")
        )
        self.gate = GrowGate(
            probes_needed=self.grow_probes, min_interval_s=self.min_interval_s
        )
        self._transitions_seen = 0
        membership_stats["hysteresis_window_s"] = self.min_interval_s
        membership_stats["flap_limit"] = int(
            os.environ.get("GRAFT_FLAP_MAX", "3")
        )

    def report_transitions(self) -> None:
        """Print membership transitions recorded since the last report --
        the launcher-side readout every membership change is visible in."""
        if not self.controller:
            return
        try:
            events = self.store.transitions()
        except (OSError, RuntimeError):
            return
        for ev in events[self._transitions_seen:]:
            detail = " ".join(
                f"{k}={v}" for k, v in ev.items() if k not in ("kind", "t")
            )
            print(
                f"[launch] membership: {ev.get('kind')} {detail}",
                file=sys.stderr, flush=True,
            )
        self._transitions_seen = len(events)


def _my_share(assignments: list, host_id: str) -> tuple[int, int]:
    """(nproc, rank_base) for ``host_id`` under ordered assignments."""
    base = 0
    for hid, nproc in assignments:
        if hid == host_id:
            return int(nproc), base
        base += int(nproc)
    return 0, base


def _assign_world(hosts: list[dict], world: int) -> list:
    """Greedy rank placement over admissible hosts, node_rank order."""
    out = []
    left = int(world)
    for h in hosts:
        take = min(int(h["capacity"]), left)
        if take > 0:
            out.append([h["host_id"], take])
        left -= take
    return out


def _exits(procs) -> list:
    """``(proc, rc)`` of the children that have exited, causes first.

    A peer's death makes a survivor's next gloo collective raise at once
    (JAX's survivors hang there until the monitor tears them down), and
    the survivor exits 1 only after that death: so every child is polled
    before any is judged, the live ones once more when one has failed (a
    death that raced the first pass), and the exits are ordered external
    terminations first, rc 1 (an uncaught exception) last, local rank
    within a class. The first one judged is the cause; the others are
    terminated as its victims.
    """
    polled = [(p, p.poll()) for p in procs]
    if any(rc not in (None, 0) for _, rc in polled):
        polled = [(p, p.poll() if rc is None else rc) for p, rc in polled]
    exited = [(p, rc) for p, rc in polled if rc is not None]
    return sorted(exited, key=lambda e: (
        0 if external_termination(e[1]) else 2 if e[1] == 1 else 1))


def _graceful_teardown(procs, signalled: set, escalate_s: float) -> None:
    """SIGTERM every live child (forcing the preemption save-and-drain in
    checkpoint-aware trainers), escalate to SIGKILL after the grace."""
    for q in procs:
        if q.poll() is None:
            signalled.add(q.pid)
            q.terminate()
    deadline = time.monotonic() + escalate_s
    while (
        any(q.poll() is None for q in procs)
        and time.monotonic() < deadline
    ):
        time.sleep(0.1)
    for q in procs:
        if q.poll() is None:
            q.kill()
    for q in procs:
        if q.poll() is None:
            try:
                q.wait(timeout=10)
            except Exception:
                pass


def _run_world(
    opt,
    attempt: int,
    nproc: int,
    rank_base: int,
    world: int,
    port: int,
    extra_env: dict | None = None,
    ctl: _MembershipCtl | None = None,
) -> tuple[int, int, list, str]:
    """Launch one generation of this node's share of the world.

    Returns ``(code, n_failed, rcs, outcome)``:

    - ``code``     -- 0 on success, else the rc of the first death judged
      (:func:`_exits`: the cause, before the deaths it caused).
    - ``n_failed`` -- local ranks that died on their OWN (crash, preemption,
      chaos kill) -- ranks the monitor itself terminated for fate-sharing
      are victims, not failures, and the elastic shrink math must not
      count them.
    - ``rcs``      -- the own-death return codes (attribution evidence).
    - ``outcome``  -- ``ok`` / ``failed`` / ``grow`` (controller decided to
      grow back mid-generation) / ``teardown`` (a remote host's failure or
      the controller's grow request tore this node's healthy children
      down).

    A crashed rank strands the others in the rendezvous/collective, so the
    monitor polls all children, kills the survivors on the first non-zero
    exit, and reports -- the fate-sharing ``torch.distributed.launch``
    provides. With membership on, the monitor also heartbeats this host,
    watches for cross-node teardown requests, and (controller + ``--grow``)
    probes admissible capacity for grow-back.
    """
    procs = []
    for local_rank in range(nproc):
        rank = rank_base + local_rank
        env = _child_env(
            rank, local_rank, world, opt.master_addr, port,
            opt.one_cpu_device_per_rank,
        )
        # scripts can adapt (e.g. resume from the preemption checkpoint,
        # cf. the reference driver's --start-epoch "useful on restarts")
        env["GRAFT_RESTART_ATTEMPT"] = str(attempt)
        env["GRAFT_NODE_RANK"] = str(opt.node_rank)
        env.update(extra_env or {})
        procs.append(
            subprocess.Popen(
                [sys.executable, opt.script, *opt.script_args], env=env
            )
        )

    # monitor-driven chaos (site launch.worker): the launcher itself plays
    # the preemption agent, SIGKILLing a chosen local rank after a delay.
    # Hit counters reset per process, so cross-generation schedules key on
    # the generation's attempt counter, matched here (not via env -- the
    # launcher's own GRAFT_RESTART_ATTEMPT is never set).
    plan = active_plan()
    chaos = []
    if plan is not None:
        chaos = [
            r for r in plan.rules_for("launch.worker")
            if r.attempt is None or r.attempt == attempt
        ]
    chaos_fired: set[int] = set()
    all_procs = list(procs)  # stable local_rank -> proc indexing
    t_start = time.monotonic()
    escalate_s = float(os.environ.get("GRAFT_LAUNCH_ESCALATE_S", "15"))

    code = 0
    n_failed = 0
    rcs: list[int] = []
    outcome = "ok"
    failed_at = None
    last_heartbeat = 0.0
    last_coord_poll = 0.0
    last_grow_probe = 0.0
    signalled: set[int] = set()  # pids the MONITOR terminated (fate-sharing)
    try:
        while procs:
            now = time.monotonic()
            for i, rule in enumerate(chaos):
                if i in chaos_fired:
                    continue
                if now - t_start >= rule.after_s:
                    chaos_fired.add(i)
                    victim = all_procs[(rule.rank or 0) % len(all_procs)]
                    if victim.poll() is None:
                        # a chaos kill IS a preemption: the victim counts
                        # as failed, unlike a monitor fate-sharing kill
                        victim.kill()
            for p, rc in _exits(procs):
                procs.remove(p)
                if rc != 0:
                    if p.pid not in signalled:
                        n_failed += 1
                        rcs.append(rc)
                    code = code or rc
                    failed_at = failed_at or time.monotonic()
                    for q in procs:
                        signalled.add(q.pid)
                        q.terminate()

            if ctl is not None and code == 0:
                # membership heartbeat: this host stays live capacity
                if now - last_heartbeat >= 1.0:
                    last_heartbeat = now
                    try:
                        ctl.store.heartbeat(host_id=ctl.host_id)
                    except (KeyError, OSError, RuntimeError):
                        pass
                # cross-node coordination: a teardown request (remote
                # failure, or the controller's grow) stops this node's
                # healthy children gracefully -- SIGTERM forces their
                # preemption save before the relaunch
                if now - last_coord_poll >= 0.5:
                    last_coord_poll = now
                    torn = False
                    try:
                        torn = (
                            ctl.store.teardown_requested(epoch=ctl.epoch)
                            is not None
                        )
                        if not torn and ctl.controller:
                            torn = any(
                                r["code"] != 0 and r["host_id"] != ctl.host_id
                                for r in ctl.store.results(epoch=ctl.epoch)
                            )
                            if torn:
                                ctl.store.request_teardown(
                                    epoch=ctl.epoch, reason="peer-failure"
                                )
                    except (OSError, RuntimeError):
                        torn = False
                    if torn:
                        _graceful_teardown(procs, signalled, escalate_s)
                        outcome = "teardown"
                        break
                # grow-back probing: the controller re-checks registered
                # capacity while the (possibly shrunken) world runs
                if (
                    ctl.controller and ctl.grow
                    and now - last_grow_probe >= ctl.probe_interval_s
                ):
                    last_grow_probe = now
                    if _probe_grow(ctl, world):
                        try:
                            # chaos veto point: a `raise` rule here skips
                            # this grow attempt and re-arms the gate
                            fault_point(
                                "launch.grow", epoch=ctl.epoch, world=world
                            )
                        except InjectedFault:
                            ctl.gate.veto()
                        else:
                            ctl.store.record_transition(
                                kind="grow_initiate", epoch=ctl.epoch,
                                world=world,
                            )
                            ctl.store.request_teardown(
                                epoch=ctl.epoch, reason="grow"
                            )
                            _graceful_teardown(procs, signalled, escalate_s)
                            outcome = "grow"
                            break

            # escalate: a survivor trapping SIGTERM (e.g. writing its
            # preemption checkpoint while stuck in the dead collective)
            # must not stall the monitor forever
            if (
                failed_at is not None
                and time.monotonic() - failed_at > escalate_s
            ):
                for q in procs:
                    if q.poll() is None:
                        signalled.add(q.pid)
                        q.kill()
            time.sleep(0.1)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    if code != 0:
        outcome = "failed"
    return code, n_failed, rcs, outcome


def _probe_grow(ctl: _MembershipCtl, world: int) -> bool:
    """One capacity probe; True when the grow gate fires.

    Every live host earns one healthy-probe tick (quarantined hosts'
    streaks stay pinned at zero inside the store), admission requires K
    consecutive healthy probes, and the gate layers the global
    capacity-exceeds streak + min-interval hysteresis on top.
    """
    try:
        live = ctl.store.hosts()
        for h in live:
            ctl.store.record_probe(host_id=h["host_id"], healthy=True)
        quarantined = [
            h["host_id"] for h in live
            if ctl.store.is_quarantined(host_id=h["host_id"])
        ]
        capacity = ctl.store.admissible_capacity(
            min_healthy_probes=ctl.grow_probes
        )
    except (OSError, RuntimeError):
        ctl.gate.veto()
        return False
    fired = ctl.gate.observe(capacity, world)
    if capacity != world or quarantined:
        ctl.store.record_transition(
            kind="grow_probe", capacity=capacity, world=world,
            streak=ctl.gate.streak, excluded=quarantined, fired=fired,
        )
    return fired


def _report_flight_records(run_dir: str) -> None:
    """Print (and consume) telemetry flight records left by dead children.

    Inline json/os only: importing ``observe`` would pull torch into the
    launcher, which must stay stdlib-importable. Each record answers the
    question a restart gate actually has: what was the dying rank DOING?
    Consumed files are removed so the next generation reports fresh.
    """
    import json as _json

    try:
        names = sorted(
            n for n in os.listdir(run_dir) if n.startswith("flightrec-")
        )
    except OSError:
        return
    for name in names:
        path = os.path.join(run_dir, name)
        try:
            with open(path, encoding="utf-8") as fh:
                doc = _json.load(fh)
        except (OSError, ValueError):
            continue
        inflight = doc.get("in_flight") or []
        doing = (
            f"was in span {inflight[-1].get('name')!r}"
            f" ({inflight[-1].get('cat')})"
            if inflight else "had no span in flight"
        )
        exc = doc.get("exception") or {}
        tail = f" [{exc['type']}: {exc.get('message', '')}]" if exc else ""
        print(
            f"[launch] flight record: rank {doc.get('rank')} "
            f"pid {doc.get('pid')} ({doc.get('reason')}) {doing}{tail}",
            file=sys.stderr,
            flush=True,
        )
        try:
            os.remove(path)
        except OSError:
            pass


def _gc_stale_step_logs(run_dir: str, keep_epoch: int) -> None:
    """Run-dir hygiene between generations.

    Step logs are epoch-namespaced (``steps/epoch_<E>/rank_N.jsonl``,
    ``observe/goodput.step_log_dir``) so a shrunken world's straggler statistics are
    never computed over stale files from ranks of a larger world that no
    longer exist. This drops every namespace older than the generation
    about to launch -- and, once epochs are in use, the flat legacy
    layout too (it can only be a previous generation's leftovers).
    """
    steps = os.path.join(run_dir, "steps")
    try:
        names = os.listdir(steps)
    except OSError:
        return
    for name in names:
        path = os.path.join(steps, name)
        try:
            if name.startswith("epoch_"):
                try:
                    epoch = int(name[len("epoch_"):])
                except ValueError:
                    continue
                if epoch < keep_epoch:
                    shutil.rmtree(path, ignore_errors=True)
            elif (
                keep_epoch > 0
                and name.startswith("rank_")
                and name.endswith(".jsonl")
            ):
                os.remove(path)
        except OSError:
            continue


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="torch.distributed.launch twin with elastic restarts"
    )
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--master_addr", default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=None)
    parser.add_argument(
        "--one_cpu_device_per_rank", action="store_true",
        help="hide every card from the children (CUDA_VISIBLE_DEVICES='') for "
        "localhost testing over gloo; the script still asks for the CPU itself",
    )
    parser.add_argument(
        "--max_restarts", type=int, default=0,
        help="elastic twin of torchrun --max-restarts: on any rank failure "
        "the whole world is killed and relaunched (fresh rendezvous) up to "
        "N times; children see GRAFT_RESTART_ATTEMPT and should resume "
        "from their last checkpoint (cf. the reference driver's --start-epoch)",
    )
    parser.add_argument(
        "--elastic", action="store_true",
        help="shrink-to-survive: when a generation dies to an EXTERNAL "
        "termination (preemption/OOM-kill/timeout -- resilience.outage."
        "external_termination), relaunch with the surviving world size "
        "instead of the original one; children see the decision as "
        "GRAFT_RECOVERY_MODE=shrink|retry|grow and must reshard their "
        "resume checkpoint onto the new world. Multi-node elastic needs "
        "a shared --membership-dir",
    )
    parser.add_argument(
        "--grow", action="store_true",
        help="grow-back (needs --elastic): while a shrunken world runs, "
        "the controller re-probes the membership store's admissible "
        "capacity; after GRAFT_GROW_PROBES consecutive healthy probes "
        "above the running world (and GRAFT_GROW_MIN_INTERVAL_S since the "
        "last reshard), it forces a portable save via SIGTERM and "
        "relaunches onto the larger world with GRAFT_RECOVERY_MODE=grow",
    )
    parser.add_argument(
        "--membership-dir", "--membership_dir", default=None,
        dest="membership_dir",
        help="shared membership store: a directory every node's launcher "
        "can reach (heartbeats, health, epochs), or tcp://host:port of a "
        "peer serving one (--serve_membership). Defaults to a per-launcher "
        "store under the run dir (single-node only)",
    )
    parser.add_argument(
        "--serve_membership", type=int, default=None, metavar="PORT",
        help="serve this launcher's file-backed membership store over TCP "
        "on PORT (0 = ephemeral) for nodes without a shared filesystem",
    )
    parser.add_argument(
        "--observe", type=int, default=None, metavar="PORT",
        help="live fleet metrics on 127.0.0.1:PORT: not ported yet (it comes "
        "with the serving fleet); raises",
    )
    parser.add_argument(
        "--min_world", "--min-world", type=int, default=1, dest="min_world",
        help="floor for --elastic shrinking: never relaunch fewer than "
        "this many ranks (default 1)",
    )
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    opt = parser.parse_args(argv)

    total_world = opt.nnodes * opt.nproc_per_node
    if opt.max_restarts < 0:
        parser.error("--max_restarts must be >= 0 (torchrun rejects -1 too)")
    if opt.nnodes > 1 and not opt.master_port:
        # each node's launcher would otherwise probe its own random port
        # and the cross-node rendezvous could never form
        parser.error("--master_port is required when --nnodes > 1")
    if opt.max_restarts > 0 and opt.nnodes > 1 and not opt.membership_dir:
        # each node's launcher only sees its local ranks; restarting one
        # node's generation while the others poll the dead collective can
        # never reform the world -- the membership store IS the external
        # coordinator that makes multi-node restarts well-defined
        parser.error(
            "--max_restarts with --nnodes > 1 needs a shared membership "
            "store: pass --membership-dir (shared directory or "
            "tcp://host:port of a --serve_membership peer)"
        )
    if opt.elastic:
        if opt.nnodes > 1 and not opt.membership_dir:
            parser.error(
                "--elastic with --nnodes > 1 needs a shared membership "
                "store: pass --membership-dir (shared directory or "
                "tcp://host:port of a --serve_membership peer)"
            )
        if opt.max_restarts < 1:
            parser.error("--elastic needs --max_restarts >= 1 (shrinking "
                         "only happens across a relaunch)")
        # validated against the TOTAL elastic world -- a multi-node job's
        # floor can legitimately exceed one node's nproc_per_node
        if not (1 <= opt.min_world <= total_world):
            parser.error(
                f"--min_world must be in [1, nnodes*nproc_per_node="
                f"{total_world}], got {opt.min_world}"
            )
    if opt.grow and not opt.elastic:
        parser.error("--grow requires --elastic")
    if opt.observe is not None:
        raise NotImplementedError(
            "--observe (the fleet metrics exporter and its straggler check) comes "
            "with the serving fleet, which the port does not have yet")

    # one policy drives the inter-generation backoff; the shared classifier
    # decides whether another generation can even help (a usage error or
    # import typo fails identically every time -- restarting burns the
    # budget torchrun-style without the torchrun excuse)
    policy = RetryPolicy(
        attempts=opt.max_restarts + 1,
        base_delay_s=float(os.environ.get("GRAFT_RESTART_BACKOFF", "0.5")),
        max_delay_s=30.0,
    )
    delays = policy.delays()
    # mirrors _child_env's setdefault: the same expression in the same
    # process, so the gate reads exactly where the children wrote
    run_dir = os.environ.get("GRAFT_RUN_DIR", default_run_dir())

    # -- membership wiring --------------------------------------------------
    ctl: _MembershipCtl | None = None
    server = None
    host_id = f"node{opt.node_rank}"
    if opt.elastic or opt.membership_dir:
        location = opt.membership_dir or os.path.join(run_dir, "membership")
        if opt.serve_membership is not None:
            if location.startswith("tcp://"):
                parser.error(
                    "--serve_membership needs a directory-backed "
                    "--membership-dir to serve"
                )
            backing = MembershipStore(location)
            server, _ = serve_store(backing, port=opt.serve_membership)
            print(
                f"[launch] membership store served on "
                f"tcp://{server.server_address[0]}:{server.server_address[1]}",
                file=sys.stderr, flush=True,
            )
            store = backing
        else:
            store = open_store(location)
        store.register_host(
            host_id=host_id, capacity=opt.nproc_per_node,
            node_rank=opt.node_rank,
        )
        ctl = _MembershipCtl(store, host_id, opt.node_rank == 0, opt)
        # children (and their dist.initialize) can note rank liveness into
        # the same store -- only meaningful for directory-backed stores
        if not location.startswith("tcp://"):
            os.environ.setdefault("GRAFT_MEMBERSHIP", location)

    assignments = [
        [f"node{i}", opt.nproc_per_node] for i in range(opt.nnodes)
    ]
    world = total_world
    gen = 0              # launcher generation counter (GRAFT_RESTART_ATTEMPT)
    restarts_used = 0    # failure-driven restarts consumed vs --max_restarts
    mode: str | None = None
    port = opt.master_port
    gen_timeout_s = float(
        os.environ.get("GRAFT_MEMBERSHIP_GEN_TIMEOUT_S", "300")
    )
    if ctl is not None and ctl.controller:
        ctl.epoch = ctl.store.bump_epoch(
            world=world, mode="start", reason="launch"
        )
        # single-publisher protocol: exactly one controller publishes,
        # every follower adopts -- the asymmetry IS the design
        ctl.store.publish_generation(
            epoch=ctl.epoch, world=world, assignments=assignments,
            port=port, mode=None, attempt=0,
        )
    elif ctl is not None:
        # follower: generation 0's plan is implied by the (identical) CLI
        # args on every node; adopt the controller's epoch once visible
        doc = ctl.store.read_generation()
        ctl.epoch = doc["epoch"] if doc else 1

    def _publish_terminal(terminal_mode: str, code: int) -> None:
        if ctl is not None and ctl.controller:
            try:
                # single-publisher terminal marker (see generation 0 above)
                ctl.store.publish_generation(
                    epoch=ctl.epoch + 1, world=0, assignments=[],
                    port=None, mode=terminal_mode, attempt=gen, code=code,
                )
            except (OSError, RuntimeError):
                pass

    while True:
        nproc, rank_base = _my_share(assignments, host_id)

        if nproc == 0:
            # shrunk out (or quarantined): stay registered, keep
            # heartbeating, and wait for a future generation that includes
            # this host again -- that is exactly how capacity "returns"
            doc = ctl.store.wait_generation(
                min_epoch=ctl.epoch + 1, timeout_s=gen_timeout_s,
                heartbeat_host=host_id,
            )
            if doc is None:
                print(
                    f"[launch] membership: host {host_id} idled "
                    f"{gen_timeout_s:.0f}s with no new generation; giving up",
                    file=sys.stderr, flush=True,
                )
                return 3
            if doc.get("mode") == "done":
                return 0
            if doc.get("mode") == "abort":
                return int(doc.get("code") or 1)
            ctl.epoch = doc["epoch"]
            world = doc["world"]
            assignments = doc["assignments"]
            port = doc.get("port") or port
            mode = doc.get("mode")
            gen = doc.get("attempt", gen + 1)
            continue

        gen_port = port
        if gen_port is None or (gen > 0 and ctl is None):
            # fresh port per generation: the previous coordinator socket
            # may linger in TIME_WAIT after a crash -- honor a pinned
            # --master_port only for the first generation
            gen_port = find_free_port()
        # generation epoch namespaces the step logs: the membership epoch
        # when a store coordinates the fleet, else the local generation
        # counter
        log_epoch = ctl.epoch if ctl is not None else gen
        _gc_stale_step_logs(run_dir, log_epoch)
        extra = {
            "GRAFT_GEN_EPOCH": str(log_epoch),
            "GRAFT_HOST_ID": host_id,
        }
        if mode:
            extra["GRAFT_RECOVERY_MODE"] = mode
        code, n_failed, rcs, outcome = _run_world(
            opt, gen, nproc, rank_base, world, gen_port,
            extra_env=extra, ctl=ctl,
        )
        if ctl is not None:
            try:
                ctl.store.post_result(
                    epoch=ctl.epoch, host_id=host_id, code=code,
                    n_failed=n_failed, rcs=rcs,
                )
            except (OSError, RuntimeError):
                pass
            ctl.report_transitions()

        if outcome == "ok":
            _publish_terminal("done", 0)
            return 0

        _report_flight_records(run_dir)

        # -- follower: the controller decides; adopt its next generation --
        if ctl is not None and not ctl.controller:
            # follower-only wait: the controller never waits on itself --
            # it is the one publishing the generation being waited for
            doc = ctl.store.wait_generation(
                min_epoch=ctl.epoch + 1, timeout_s=gen_timeout_s,
                heartbeat_host=host_id,
            )
            if doc is None:
                return code or 3
            if doc.get("mode") == "done":
                return 0
            if doc.get("mode") == "abort":
                return int(doc.get("code") or code or 1)
            ctl.epoch = doc["epoch"]
            world = doc["world"]
            assignments = doc["assignments"]
            port = doc.get("port") or port
            mode = doc.get("mode")
            gen = doc.get("attempt", gen + 1)
            continue

        # -- controller (or storeless single-node): decide the next world --
        agg_code, total_failed = code, n_failed
        host_rcs: dict[str, list] = {host_id: rcs}
        if ctl is not None:
            agg_code, total_failed, host_rcs = _aggregate_results(
                ctl, assignments, code, n_failed, rcs
            )

        if outcome == "grow":
            new_world = max(
                opt.min_world,
                ctl.store.admissible_capacity(
                    min_healthy_probes=ctl.grow_probes
                ),
            )
            print(
                f"[launch] elastic: growing world {world} -> {new_world} "
                f"(capacity returned)",
                file=sys.stderr, flush=True,
            )
            mode = "grow"
            world = new_world
            assignments = _assign_world(
                ctl.store.admissible_hosts(
                    min_healthy_probes=ctl.grow_probes
                ),
                world,
            )
            ctl.gate.note_reshard()
            gen += 1
            ctl.epoch = ctl.store.bump_epoch(
                world=world, mode="grow", reason="capacity-returned"
            )
            port = find_free_port()
            ctl.store.publish_generation(
                epoch=ctl.epoch, world=world, assignments=assignments,
                port=port, mode=mode, attempt=gen,
            )
            ctl.report_transitions()
            continue

        cls = classify(agg_code)
        if restarts_used >= opt.max_restarts:
            _publish_terminal("abort", agg_code)
            return agg_code
        if cls is OutageClass.DETERMINISTIC:
            print(
                f"[launch] world failed (rc={agg_code}, class="
                f"{cls.value}): restarting cannot help, giving up",
                file=sys.stderr,
                flush=True,
            )
            _publish_terminal("abort", agg_code)
            return agg_code

        # health bookkeeping: attribute each failed host's death
        if ctl is not None:
            for hid, host_rc_list in host_rcs.items():
                if not host_rc_list:
                    continue
                primary = host_rc_list[0]
                try:
                    ctl.store.record_failure(
                        host_id=hid, rc=primary,
                        attributed=attributes_to_host(primary),
                    )
                except (OSError, RuntimeError, ValueError):
                    pass

        restarts_used += 1
        external = any(
            external_termination(rc)
            for rc_list in host_rcs.values() for rc in rc_list
        ) or external_termination(agg_code)
        if opt.elastic and external:
            # ranks were TAKEN (preempted/killed/timed out): the next
            # generation runs with whoever survived, floored at
            # --min_world -- shrink-to-survive instead of giving up
            new_world = max(opt.min_world, world - max(1, total_failed))
        else:
            new_world = world
        if ctl is not None and opt.elastic:
            # never place ranks on quarantined or dead hosts: the
            # admissible capacity caps the next world even when the
            # failure itself was not an external termination
            capacity = ctl.store.admissible_capacity()
            if capacity < opt.min_world:
                capacity = _await_capacity(ctl, opt.min_world, host_id)
            if capacity < opt.min_world:
                print(
                    f"[launch] elastic: admissible capacity {capacity} "
                    f"below --min_world {opt.min_world}; giving up",
                    file=sys.stderr, flush=True,
                )
                _publish_terminal("abort", agg_code)
                return agg_code
            new_world = max(opt.min_world, min(new_world, capacity))
        mode = "shrink" if new_world < world else "retry"
        if mode == "shrink":
            print(
                f"[launch] elastic: shrinking world "
                f"{world} -> {new_world} (rc={agg_code}, "
                f"{total_failed} rank(s) lost)",
                file=sys.stderr,
                flush=True,
            )
        if ctl is not None:
            if new_world != world:
                ctl.gate.note_reshard()
            assignments = _assign_world(
                ctl.store.admissible_hosts(), new_world
            )
        else:
            assignments = [[host_id, new_world]]
        world = new_world
        delay = next(delays, 0.0)
        print(
            f"[launch] world failed (rc={agg_code}, class={cls.value}), "
            f"restart {restarts_used}/{opt.max_restarts} "
            f"in {delay:.1f}s",
            file=sys.stderr,
            flush=True,
        )
        gen += 1
        if ctl is not None:
            ctl.epoch = ctl.store.bump_epoch(
                world=world, mode=mode, reason=f"rc={agg_code}"
            )
            port = find_free_port()
            ctl.store.publish_generation(
                epoch=ctl.epoch, world=world, assignments=assignments,
                port=port, mode=mode, attempt=gen,
            )
            ctl.report_transitions()
        else:
            port = None  # storeless path probes a fresh port next spin
        time.sleep(delay)


def _aggregate_results(
    ctl: _MembershipCtl,
    assignments: list,
    local_code: int,
    local_failed: int,
    local_rcs: list,
) -> tuple[int, int, dict]:
    """Fold every assigned host's posted result into one generation verdict.

    A host that never posts within the grace window has VANISHED -- its
    whole share counts as externally-lost ranks (the launcher died with
    the machine), which is exactly what the shrink math should see.
    """
    grace_s = float(os.environ.get("GRAFT_MEMBERSHIP_RESULT_GRACE_S", "20"))
    expected = {hid for hid, nproc in assignments if nproc > 0}
    deadline = time.monotonic() + grace_s
    results: dict[str, dict] = {}
    while time.monotonic() < deadline:
        try:
            for r in ctl.store.results(epoch=ctl.epoch):
                results[r["host_id"]] = r
        except (OSError, RuntimeError):
            pass
        if expected <= set(results):
            break
        time.sleep(0.2)
    agg_code = local_code
    total_failed = 0
    host_rcs: dict[str, list] = {}
    posted: list[int] = []
    for hid in sorted(expected):
        r = results.get(hid)
        if r is None:
            share = dict(
                (h, n) for h, n in assignments
            ).get(hid, 0)
            total_failed += share
            host_rcs[hid] = [-9]  # vanished: treat as externally killed
            agg_code = agg_code or 1
            continue
        total_failed += int(r.get("n_failed", 0))
        host_rcs[hid] = list(r.get("rcs") or [])
        posted += host_rcs[hid]
        agg_code = agg_code or int(r.get("code", 0))
    # across hosts as _exits orders them on one: a rank that exited 1
    # because its collective raised at a death on another host is that
    # death's victim, and the generation's code is the death's
    causes = [rc for rc in posted if rc != 1]
    if causes and 1 in posted:
        total_failed -= posted.count(1)
        if agg_code == 1:
            agg_code = causes[0]
    return agg_code, total_failed, host_rcs


def _await_capacity(
    ctl: _MembershipCtl, min_world: int, host_id: str
) -> int:
    """Ride out a moment where even --min_world cannot be placed (every
    other host quarantined/dead): wait briefly for capacity to return."""
    timeout_s = float(
        os.environ.get("GRAFT_MEMBERSHIP_CAPACITY_TIMEOUT_S", "30")
    )
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            ctl.store.heartbeat(host_id=host_id)
            capacity = ctl.store.admissible_capacity()
        except (KeyError, OSError, RuntimeError):
            capacity = 0
        if capacity >= min_world:
            return capacity
        time.sleep(0.5)
    try:
        return ctl.store.admissible_capacity()
    except (OSError, RuntimeError):
        return 0


if __name__ == "__main__":
    sys.exit(main())
