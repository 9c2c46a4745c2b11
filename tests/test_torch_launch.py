"""``runtime.launch``, the port's launcher, against JAX's.

The same stdlib child script runs under ``python -m
pytorch_distributedtraining_tpu.runtime.launch`` and under the port's
launcher, with the same flags and ``GRAFT_FAULT_PLAN``. Each child appends
``(attempt, RANK, WORLD_SIZE, GRAFT_RECOVERY_MODE, GRAFT_GEN_EPOCH)`` to a
file, waits until every rank of its generation has (so a sibling's quick
death never races a record), then exits as the case's table says (an exit
code, or ``sleep`` until the launcher kills it). The exit codes, the
children's records (sorted: ranks append in any order) and the launcher's
``[launch]`` decision lines (``restart k/n``, ``shrinking``, ``giving up``,
``growing``) must be equal. The flag checks run in process through both
``main``\\ s. Then the port alone: a flight record reported for a child that
died inside a span, ``spawn`` over two gloo ranks, a child that asks for
the card it cannot see, a fresh interpreter that imports the launcher
and the store without torch, and the order in which the monitor and the
controller judge deaths that come together (a gloo survivor exits 1 right
after its peer's death, where JAX's would hang until torn down).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from pytorch_distributedtraining_tpu.runtime import launch as jlaunch
from pytorch_distributedtraining_tpu_torch.runtime import launch as tlaunch
from test_torch_dist_workers import allreduce_worker, launcher_env

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "pytorch_distributedtraining_tpu", "port": "pytorch_distributedtraining_tpu_torch"}
DECISIONS = re.compile(r"\[launch\] .*(restart \d+/\d+|shrinking world|giving up|growing world)")

CHILD = r'''
import json, os, sys, time
attempt = int(os.environ["GRAFT_RESTART_ATTEMPT"])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["OUT"]
with open(out, "a") as fh:
    fh.write(json.dumps([attempt, rank, world, os.environ.get("GRAFT_RECOVERY_MODE", "-"),
                         os.environ.get("GRAFT_GEN_EPOCH")]) + "\n")
deadline = time.monotonic() + 30
while time.monotonic() < deadline:
    with open(out) as fh:
        if sum(json.loads(ln)[0] == attempt for ln in fh) >= world:
            break
    time.sleep(0.02)
act = json.loads(os.environ["CASE"]).get(f"{attempt},{rank}", 0)
if act == "sleep":
    time.sleep(60)
    sys.exit(99)
sys.exit(int(act))
'''

# the kill and the grow wait long enough for every child of the generation
# to write its record, also on a host the parallel test workers load
KILL_RANK1 = {"faults": [{"site": "launch.worker", "attempt": 0, "rank": 1, "after_s": 3.0}]}
GROW_ENV = {"GRAFT_GROW_PROBES": "2", "GRAFT_GROW_PROBE_INTERVAL_S": "0.3",
            "GRAFT_GROW_MIN_INTERVAL_S": "3"}

# name: (launcher flags, child actions by "attempt,rank", fault plan, extra env)
CASES = {
    "clean world of two": (["--nproc_per_node", "2", "--one_cpu_device_per_rank"], {}, None, {}),
    "own crash retried at the same size": (
        ["--nproc_per_node", "2", "--max_restarts", "1"], {"0,1": 3}, None, {}),
    "launch.worker kill shrinks 2 -> 1": (
        ["--nproc_per_node", "2", "--max_restarts", "1", "--elastic"],
        {"0,0": "sleep", "0,1": "sleep"}, KILL_RANK1, {}),
    "exhausted budget returns the child's rc": (
        ["--nproc_per_node", "2", "--max_restarts", "1"], {"0,1": 1, "1,1": 1}, None, {}),
    "deterministic rc gives up at once": (
        ["--nproc_per_node", "2", "--max_restarts", "2"], {"0,1": 17}, None, {}),
    "stale recovery mode never inherited": (
        ["--nproc_per_node", "1"], {}, None, {"GRAFT_RECOVERY_MODE": "shrink"}),
    "grow back once capacity returns": (
        ["--nproc_per_node", "2", "--max_restarts", "2", "--elastic", "--grow",
         "--membership-dir", "{tmp}/membership"],
        {"0,0": "sleep", "0,1": "sleep", "1,0": "sleep"}, KILL_RANK1, GROW_ENV),
    "a launch.grow veto re-arms the gate": (
        ["--nproc_per_node", "2", "--max_restarts", "2", "--elastic", "--grow"],
        {"0,0": "sleep", "0,1": "sleep", "1,0": "sleep"},
        {"faults": KILL_RANK1["faults"] + [{"site": "launch.grow", "action": "raise"}]},
        GROW_ENV),
}


def _launch(side: str, tmp: Path, flags: list, script: Path, env: dict,
            timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", f"{PACKAGES[side]}.runtime.launch", *flags,
                           str(script)], cwd=tmp, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _run_case(side: str, tmp: Path, name: str) -> tuple:
    flags, actions, plan, extra = CASES[name]
    tmp.mkdir()
    script = tmp / "child.py"
    script.write_text(CHILD)
    out = tmp / "records.jsonl"
    env = launcher_env(tmp, OUT=str(out), CASE=json.dumps(actions), **extra)
    if plan is not None:
        env["GRAFT_FAULT_PLAN"] = json.dumps(plan)
    run = _launch(side, tmp, [f.format(tmp=tmp) for f in flags], script, env)
    records = sorted(tuple(json.loads(ln)) for ln in out.read_text().splitlines())
    decisions = [ln for ln in run.stderr.splitlines() if DECISIONS.search(ln)]
    return run.returncode, records, decisions, run.stderr


# what each case must end in, on both sides: the exit code and the decisions
EXPECT = {
    "clean world of two": (0, []),
    "own crash retried at the same size": (0, ["restart 1/1"]),
    "launch.worker kill shrinks 2 -> 1": (0, ["shrinking world 2 -> 1", "restart 1/1"]),
    "exhausted budget returns the child's rc": (1, ["restart 1/1"]),
    "deterministic rc gives up at once": (17, ["giving up"]),
    "stale recovery mode never inherited": (0, []),
    "grow back once capacity returns": (0, ["shrinking world 2 -> 1", "restart 1/2",
                                            "growing world 1 -> 2"]),
    "a launch.grow veto re-arms the gate": (0, ["shrinking world 2 -> 1", "restart 1/2",
                                                "growing world 1 -> 2"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_launcher_makes_the_jax_launchers_decisions(name, tmp_path):
    jax_rc, jax_records, jax_lines, jax_err = _run_case("jax", tmp_path / "jax", name)
    rc, records, lines, err = _run_case("port", tmp_path / "port", name)
    assert (rc, records, lines) == (jax_rc, jax_records, jax_lines), (err[-2000:],
                                                                      jax_err[-2000:])
    want_rc, want_lines = EXPECT[name]
    assert rc == want_rc and len(lines) == len(want_lines), err[-2000:]
    assert all(w in ln for w, ln in zip(want_lines, lines)), lines


FLAG_ERRORS = [
    (["--max_restarts=-1"], "--max_restarts must be >= 0"),
    (["--nnodes=2"], "--master_port is required"),
    (["--nnodes=2", "--master_port=29573", "--max_restarts=1"], "needs a shared membership"),
    (["--nnodes=2", "--master_port=29573", "--elastic"], "--elastic with --nnodes > 1"),
    (["--nproc_per_node=2", "--elastic"], "--max_restarts"),
    (["--nproc_per_node=2", "--max_restarts=1", "--elastic", "--min_world=3"], "--min_world"),
    (["--nnodes=2", "--node_rank=0", "--master_port=29573", "--nproc_per_node=2",
      "--max_restarts=1", "--elastic", "--membership-dir={tmp}/ms", "--min_world=5"],
     "nnodes*nproc_per_node=4"),
    (["--grow"], "--grow requires --elastic"),
    (["--membership-dir=tcp://127.0.0.1:1", "--serve_membership=0"],
     "--serve_membership needs a directory-backed"),
]


@pytest.mark.parametrize("flags,expect", FLAG_ERRORS, ids=[e for _, e in FLAG_ERRORS])
def test_flag_checks_equal_jax(flags, expect, tmp_path, capsys):
    argv = [f.format(tmp=tmp_path) for f in flags] + ["child.py"]
    lines = []
    for main in (jlaunch.main, tlaunch.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        err = capsys.readouterr().err.strip().splitlines()
        lines.append((e.value.code, err[-1]))
    assert lines[0] == lines[1]
    assert lines[1][0] == 2 and expect in lines[1][1]


def test_observe_raises_naming_the_serving_fleet(tmp_path):
    with pytest.raises(NotImplementedError, match="serving fleet"):
        tlaunch.main(["--observe", "0", str(tmp_path / "child.py")])


FLIGHT_CHILD = r'''
from pytorch_distributedtraining_tpu_torch.observe import trace
from pytorch_distributedtraining_tpu_torch.resilience.faults import fault_point
trace.enable()
with trace.span("step.compute", "compute"):
    fault_point("train.preempt", step=1)
'''


def test_a_dead_childs_flight_record_is_reported(tmp_path):
    """The child is killed inside a span by a ``train.preempt`` fault (whose
    firing flushes ``flightrec-<pid>.json`` into the run dir the launcher
    gave it: by default ``graft-runs/launch-<pid>`` under the temp
    directory); the launcher prints what the rank was doing and consumes
    the file."""
    script = tmp_path / "child.py"
    script.write_text(FLIGHT_CHILD)
    plan = {"faults": [{"site": "train.preempt", "action": "kill"}]}
    run = _launch("port", tmp_path, ["--nproc_per_node", "1"], script,
                  launcher_env(tmp_path, GRAFT_FAULT_PLAN=json.dumps(plan)))
    assert run.returncode == -9 % 256, run.stderr[-2000:]  # sys.exit(-9)
    line = next(ln for ln in run.stderr.splitlines() if "[launch] flight record" in ln)
    assert "rank 0" in line and "(fault:train.preempt)" in line
    assert "was in span 'step.compute' (compute)" in line
    runs = list((tmp_path / "graft-runs").iterdir())
    assert [p.name[:7] for p in runs] == ["launch-"]
    assert not list(runs[0].glob("flightrec-*.json"))  # consumed


def test_spawn_runs_two_gloo_ranks_that_all_reduce(tmp_path):
    tlaunch.spawn(allreduce_worker, args=(str(tmp_path),), nprocs=2)
    got = sorted((tmp_path / f"rank{r}").read_text() for r in range(2))
    assert got == ["3.0 2 cpu-only", "3.0 2 cpu-only"]


def test_a_child_that_asks_for_the_card_it_cannot_see_fails(tmp_path):
    """``--one_cpu_device_per_rank`` hides every card; the ESPCN driver asked
    for ``cuda`` (its default) refuses to fall back to the CPU, and the
    launcher returns its exit code."""
    driver = ROOT / "pytorch_distributedtraining_tpu_torch" / "drivers" / "fairscale_ddp.py"
    run = _launch("port", tmp_path, ["--nproc_per_node", "1", "--one_cpu_device_per_rank"],
                  driver, launcher_env(tmp_path))
    assert run.returncode == 1, run.stderr[-2000:]
    assert "no CUDA device is available" in run.stderr


def test_launcher_and_store_import_without_torch():
    code = ("import sys\n"
            "import pytorch_distributedtraining_tpu_torch.runtime.launch\n"
            "import pytorch_distributedtraining_tpu_torch.runtime.membership\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=60)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"


class _Exited:
    """A child for ``_run_world``: ``poll`` returns ``polls`` in turn, then
    the last one for good."""

    pids = iter(range(10_000, 20_000))

    def __init__(self, polls):
        self.polls, self.pid = list(polls), next(self.pids)

    def poll(self):
        return self.polls.pop(0) if len(self.polls) > 1 else self.polls[0]

    def terminate(self):
        pass

    kill = terminate


DEATHS = {
    # a peer killed (-9), both survivors' collectives raised (rc 1), all
    # seen in one sweep: the kill is the cause, whatever the rank order
    "kill-seen-with-its-survivors": ([[1], [-9], [1]], (-9, 1, [-9])),
    # the kill raced the first pass: rank 0 still looked alive when rank 1,
    # which died of it, was polled
    "kill-that-raced-the-first-pass": ([[None, -9], [1]], (-9, 1, [-9])),
    "a-distinct-code-before-rc-1": ([[1], [3]], (3, 1, [3])),
    "only-rc-1": ([[1], [1]], (1, 1, [1])),
    "clean": ([[0], [0]], (0, 0, [])),
}


@pytest.mark.parametrize("name", list(DEATHS))
def test_the_monitor_judges_a_death_before_the_deaths_it_caused(name, monkeypatch):
    polls, want = DEATHS[name]
    children = iter([_Exited(p) for p in polls])
    monkeypatch.setattr(tlaunch.subprocess, "Popen", lambda *a, **k: next(children))
    monkeypatch.delenv("GRAFT_FAULT_PLAN", raising=False)
    opt = SimpleNamespace(master_addr="127.0.0.1", one_cpu_device_per_rank=True, node_rank=0,
                          script="child.py", script_args=[])
    code, n_failed, rcs, outcome = tlaunch._run_world(opt, 0, len(polls), 0, len(polls), 1)
    assert (code, n_failed, rcs) == want
    assert outcome == ("ok" if code == 0 else "failed")


class _Posted:
    def __init__(self, results):
        self.store = SimpleNamespace(results=lambda epoch: results)
        self.epoch = 1


AGGREGATES = {
    # node 1's rank was killed; node 0's, in a collective with it, raised
    "a-kill-and-its-survivor-on-another-host": (
        1, [{"host_id": "n0", "code": 1, "n_failed": 1, "rcs": [1]},
            {"host_id": "n1", "code": -9, "n_failed": 1, "rcs": [-9]}], (-9, 1)),
    "a-crash-and-its-survivor-on-another-host": (
        1, [{"host_id": "n0", "code": 1, "n_failed": 1, "rcs": [1]},
            {"host_id": "n1", "code": 7, "n_failed": 1, "rcs": [7]}], (7, 1)),
    # no rc-1 victim: JAX's fold, unchanged
    "two-kills": (
        -9, [{"host_id": "n0", "code": -9, "n_failed": 1, "rcs": [-9]},
             {"host_id": "n1", "code": -15, "n_failed": 1, "rcs": [-15]}], (-9, 2)),
    "torn-down-by-a-remote-kill": (
        0, [{"host_id": "n0", "code": 0, "n_failed": 0, "rcs": []},
            {"host_id": "n1", "code": -9, "n_failed": 1, "rcs": [-9]}], (-9, 1)),
}


@pytest.mark.parametrize("name", list(AGGREGATES))
def test_the_controller_counts_a_remote_deaths_survivors_as_victims(name):
    local, results, want = AGGREGATES[name]
    assignments = [["n0", 1], ["n1", 1]]
    code, lost, _ = tlaunch._aggregate_results(_Posted(results), assignments, local,
                                               results[0]["n_failed"], results[0]["rcs"])
    assert (code, lost) == want
    if all(1 not in r["rcs"] for r in results):
        assert jlaunch._aggregate_results(_Posted(results), assignments, local,
                                          results[0]["n_failed"], results[0]["rcs"])[:2] == want
