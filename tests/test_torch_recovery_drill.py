"""``runtime.recovery_drill``, the port's, against JAX's drill under JAX's
launcher, with the plan of JAX's bench recovery arm (K = 4): a ``ckpt.write``
``sleep 600`` on rank 0 at step K-1 leaves that step's staging dir torn,
and a ``train.preempt`` ``kill`` of rank 0 at step K ends generation 0.

The port's drill trains on every rank of a gloo group (JAX's trains on rank
0 over a virtual mesh and keeps rank 1 passive), so a shrink 2 -> 1 and a
grow 1 -> 2 reshard the ZeRO-2 state for real. Compared: each event's kind,
step, attempt, world, mode and torn dirs (JAX's events carry ``fsdp`` too,
which the port's do not have).

- Shrink (tier 1): the two streams are equal, event for event.
- Shrink then grow, the port alone (tier 1): 2 -> 1 -> 2 with
  ``grow_bitwise`` ok, the grow resuming at the step the shrunken
  generation's preemption save committed.
- Shrink then grow against JAX (``slow``: 110 s here, over a minute, because
  the grow waits out a hysteresis long enough for JAX's generation to
  start): where a step count depends on when the launcher's probes fire,
  the streams are compared in shape (runs of steps collapsed), and every
  step that does not is compared as it is.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_dist_workers import launcher_env

ROOT = Path(__file__).resolve().parents[1]
K = 4
PLAN = {"faults": [
    {"site": "ckpt.write", "action": "sleep", "arg": 600, "rank": 0, "attempt": 0,
     "match": {"step": K - 1}},
    {"site": "train.preempt", "action": "kill", "rank": 0, "attempt": 0, "match": {"step": K}},
]}
SIDES = {
    "jax": ("pytorch_distributedtraining_tpu",
            ROOT / "pytorch_distributedtraining_tpu" / "runtime" / "recovery_drill.py"),
    "port": ("pytorch_distributedtraining_tpu_torch",
             ROOT / "pytorch_distributedtraining_tpu_torch" / "runtime" / "recovery_drill.py"),
}
FIELDS = ("event", "step", "attempt", "world", "mode", "torn_dirs", "ok")


def _drill(side: str, tmp: Path, grow: bool, **knobs) -> tuple[list, str]:
    package, script = SIDES[side]
    tmp.mkdir()
    env = launcher_env(tmp, GRAFT_FAULT_PLAN=json.dumps(PLAN),
                       GRAFT_DRILL_OUT=str(tmp / "events.jsonl"),
                       GRAFT_DRILL_CKPT=str(tmp / "ckpt"), GRAFT_DRILL_STEPS=str(K + 2),
                       GRAFT_LAUNCH_ESCALATE_S="5", GRAFT_DRILL_DEVICE="cpu",
                       JAX_PLATFORMS="cpu")
    if grow:
        env.update(GRAFT_DRILL_GROW="1", GRAFT_DRILL_STEP_SLEEP_S="0.25",
                   GRAFT_DRILL_STEPS=str(K + 12), GRAFT_GROW_PROBES="2",
                   GRAFT_GROW_PROBE_INTERVAL_S="0.3", GRAFT_GROW_MIN_INTERVAL_S="3")
    env.update(knobs)
    flags = ["--nproc_per_node", "2", "--max_restarts", "2", "--elastic", "--min_world", "1"]
    if side == "port":
        flags.append("--one_cpu_device_per_rank")
    run = subprocess.run(
        [sys.executable, "-m", f"{package}.runtime.launch", *flags, *(["--grow"] if grow else []),
         str(script)], cwd=tmp, env=env, capture_output=True, text=True, timeout=400)
    assert run.returncode == 0, run.stderr[-3000:]
    events = [json.loads(ln) for ln in (tmp / "events.jsonl").read_text().splitlines()]
    return [{k: ev[k] for k in FIELDS if k in ev} for ev in events], run.stderr


def test_shrink_drill_events_equal_jax(tmp_path):
    want, _ = _drill("jax", tmp_path / "jax", grow=False)
    got, err = _drill("port", tmp_path / "port", grow=False)
    assert got == want, err[-2000:]
    assert [e["event"] for e in got] == ["step"] * (K - 1) + ["resume"] + ["step"] * 4 + ["done"]
    resume = got[K - 1]
    assert resume == {"event": "resume", "step": K - 2, "attempt": 1, "world": 1,
                      "mode": "shrink", "torn_dirs": [f"step_{K - 1:010d}.tmp"]}
    assert got[-1]["step"] == K + 2


def _generations(events: list) -> dict:
    """{attempt: [(kind, [steps])...]} with runs of step events collapsed."""
    gens: dict = {}
    for ev in events:
        runs = gens.setdefault(ev["attempt"], [])
        if ev["event"] == "step" and runs and runs[-1][0] == "step":
            runs[-1][1].append(ev["step"])
        else:
            runs.append((ev["event"], [ev["step"]]))
    return gens


def _check_grow_stream(events: list, total: int = K + 12) -> dict:
    """The shape every grow drill must have, on either side; returns the
    generations for a side-by-side comparison."""
    gens = _generations(events)
    assert sorted(gens) == [0, 1, 2], events
    assert gens[0] == [("step", list(range(1, K)))]
    kinds1 = [k for k, _ in gens[1]]
    assert kinds1 == ["resume", "step", "preempt_exit"], events
    assert gens[1][0][1] == [K - 2]
    exit_step = gens[1][2][1][0]
    assert gens[1][1][1] == list(range(K - 1, exit_step + 1))
    assert [k for k, _ in gens[2]] == ["resume", "grow_bitwise", "step", "done"], events
    assert gens[2][0][1] == [exit_step] and gens[2][1][1] == [exit_step]
    assert gens[2][2][1] == list(range(exit_step + 1, total + 1)) and gens[2][3][1] == [total]
    resumes = [e for e in events if e["event"] == "resume"]
    assert [(e["attempt"], e["world"], e["mode"]) for e in resumes] == [(1, 1, "shrink"),
                                                                        (2, 2, "grow")]
    assert resumes[0]["torn_dirs"] == [f"step_{K - 1:010d}.tmp"]
    assert [e["ok"] for e in events if e["event"] == "grow_bitwise"] == [True]
    assert {e["world"] for e in events if e["event"] == "step" and e["attempt"] != 1} == {2}
    return {a: [k for k, _ in runs] for a, runs in gens.items()}


def test_port_drill_shrinks_then_grows_bitwise(tmp_path):
    # a slow start of the shrunken generation must not turn the grow's
    # SIGTERM into a SIGKILL before its preemption save (escalation 30 s);
    # the writer of a rank whose peer died gives up its commit in 5 s
    events, err = _drill("port", tmp_path / "port", grow=True, GRAFT_LAUNCH_ESCALATE_S="30",
                         GRAFT_CKPT_COMMIT_TIMEOUT="5")
    _check_grow_stream(events)
    assert "[launch] elastic: growing world 1 -> 2 (capacity returned)" in err


@pytest.mark.slow
def test_grow_drill_events_equal_jax(tmp_path):
    # the hysteresis outlasts the start of JAX's shrunken generation (jax
    # import and compile), so both sides train steps at world 1 before the
    # grow; steps dawdle 0.5 s and the run is long enough to outlast it
    knobs = dict(GRAFT_GROW_MIN_INTERVAL_S="20", GRAFT_DRILL_STEP_SLEEP_S="0.5",
                 GRAFT_LAUNCH_ESCALATE_S="30", GRAFT_CKPT_COMMIT_TIMEOUT="5")
    want, _ = _drill("jax", tmp_path / "jax", grow=True, GRAFT_DRILL_STEPS="50", **knobs)
    got, err = _drill("port", tmp_path / "port", grow=True, GRAFT_DRILL_STEPS="50", **knobs)
    assert _check_grow_stream(got, total=50) == _check_grow_stream(want, total=50), err[-2000:]
