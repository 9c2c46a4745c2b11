"""Real training under the port's launcher, over gloo, with a rank killed.

(i) The ESPCN driver (its ``main``, run by a two-line script the launcher
starts as a file) with ``--ckpt --save-every 4`` at world 2: the
``train.preempt`` fault kills rank 1 at step 9 of generation 0, the
launcher (``--max_restarts 1``) relaunches the world, generation 1 resumes
from the committed step 8 (``recovery_mode=retry``) and finishes the
two-epoch schedule. Each rank's final loss equals the unbroken world-2
run's, exactly (held bitwise), and so does the final checkpoint, every
parameter and moment. This is the port's counterpart of JAX's
``test_launch.py::test_elastic_restart_resumes_from_checkpoint``.

(ii) The SwinIR-S driver, run as a file, at the size
``tests/test_torch_dist_launch.py`` runs it on the CPU (``--synthetic
--synthetic-n 20 --batchSize 2``) with ``--portable-ckpt`` under
``--elastic`` at world 2: the ``ckpt.write`` fault kills rank 1 inside
epoch 1's portable save, the launcher shrinks the world to 1, and the
relaunch resumes from ``epoch_0000`` (written by two ranks), resharded onto
one, and commits ``epoch_0001`` at world 1.

(iii) The ESPCN driver at world 3 under ``--elastic``, rank 1 killed in the
middle of training (by ``train.preempt``, in the checkpoint manager's
per-step call, which no save follows): the two survivors' next all-reduce
raises at the death and they exit 1 on their own, at once (the child
script skips the interpreter's teardown), so mostly in the same monitor
sweep as the kill. The launcher judges the kill the cause and the survivors
its victims, as JAX's launcher does with survivors that hang until torn
down: it shrinks the world 3 -> 2, not to 1, and does not retry at 3.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from test_torch_dist_workers import launcher_env

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "pytorch_distributedtraining_tpu_torch" / "drivers"

ESPCN_CHILD = r'''
import os, sys
from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp
loss = fairscale_ddp.main(sys.argv[1:])
with open(os.environ["LOSSES"], "a") as fh:
    fh.write(f"{os.environ['GRAFT_RESTART_ATTEMPT']} {os.environ['RANK']} {loss!r}\n")
'''

# as ESPCN_CHILD, but a rank whose training raised leaves at once, without
# the interpreter's teardown, so a survivor's exit lands in the launcher's
# same 0.1 s sweep as the death that made its collective raise
ESPCN_FAST_EXIT_CHILD = r'''
import os, sys, traceback
from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp
try:
    loss = fairscale_ddp.main(sys.argv[1:])
except Exception:
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)
with open(os.environ["LOSSES"], "a") as fh:
    fh.write(f"{os.environ['GRAFT_RESTART_ATTEMPT']} {os.environ['RANK']} {loss!r}\n")
'''


def _env(tmp: Path, **extra) -> dict:
    return launcher_env(tmp, WANDB_MODE="disabled", GRAFT_LAUNCH_ESCALATE_S="5", **extra)


def _launch(tmp: Path, flags: list, script: Path, args: list, env: dict):
    return subprocess.run(
        [sys.executable, "-m", "pytorch_distributedtraining_tpu_torch.runtime.launch", *flags,
         "--one_cpu_device_per_rank", str(script), *args],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=240)


def _payload(step_dir: Path) -> dict:
    """Every leaf of a portable checkpoint, assembled across its ranks."""
    from pytorch_distributedtraining_tpu_torch.checkpoint_sharded import _assemble_host_tree

    return _assemble_host_tree(str(step_dir))[1]


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    script = tmp_path / "espcn.py"
    script.write_text(ESPCN_CHILD)
    # 95 training images: 48 a rank, 6 steps of 8 an epoch, 12 in all
    args = ["--synthetic", "--synthetic-n", "96", "--epochs", "2", "--batch-size", "8",
            "--workers", "0", "--device", "cpu", "--save-every", "4"]
    runs = {}
    for name, plan in (("unbroken", None),
                       ("killed", {"faults": [{"site": "train.preempt", "action": "kill",
                                               "rank": 1, "attempt": 0, "at": 9}]})):
        work = tmp_path / name
        work.mkdir()
        env = _env(work, LOSSES=str(work / "losses.txt"))
        if plan is not None:
            env["GRAFT_FAULT_PLAN"] = json.dumps(plan)
        run = _launch(work, ["--nproc_per_node", "2", "--max_restarts", "1"], script,
                      args + ["--ckpt", str(work / "ckpt")], env)
        assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
        lines = (work / "losses.txt").read_text().split("\n")
        runs[name] = (run, sorted(ln.split() for ln in lines if ln))
    unbroken, killed = runs["unbroken"][1], runs["killed"][1]
    assert [a for a, _, _ in unbroken] == ["0", "0"] and [a for a, _, _ in killed] == ["1", "1"]
    assert [(r, loss) for _, r, loss in killed] == [(r, loss) for _, r, loss in unbroken]
    run = runs["killed"][0]
    assert "restart 1/1" in run.stderr
    assert run.stdout.count("===> Resumed from checkpoint @ step 8 (recovery_mode=retry)") == 2
    final = [_payload(tmp_path / n / "ckpt" / "step_0000000012") for n in runs]
    assert final[0].keys() == final[1].keys()
    for key in final[0]:
        np.testing.assert_array_equal(final[0][key], final[1][key], err_msg=key)


def test_a_shrink_resumes_the_swinir_driver_at_the_smaller_world(tmp_path):
    ckpt = tmp_path / "portable"
    plan = {"faults": [{"site": "ckpt.write", "action": "kill", "rank": 1, "attempt": 0,
                        "at": 2}]}
    run = _launch(tmp_path, ["--nproc_per_node", "2", "--max_restarts", "1", "--elastic"],
                  DRIVERS / "stoke_ddp.py",
                  ["--synthetic", "--synthetic-n", "20", "--batchSize", "2", "--nEpochs", "2",
                   "--threads", "0", "--device", "cpu", "--portable-ckpt", str(ckpt)],
                  _env(tmp_path, GRAFT_FAULT_PLAN=json.dumps(plan)))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert "[launch] elastic: shrinking world 2 -> 1 (rc=-9, 1 rank(s) lost)" in run.stderr
    resumed = re.findall(r"===> Resumed portable checkpoint (\S+) \(resharded onto this run\), "
                         r"from epoch (\d+) \(recovery_mode=(\w+)\)", run.stdout)
    assert resumed == [(str(ckpt / "epoch_0000"), "1", "shrink")]
    worlds = {d.name: json.loads((d / "manifest.json").read_text())["world_size"]
              for d in sorted(ckpt.iterdir())}
    assert worlds == {"epoch_0000": 2, "epoch_0001": 1}
    losses = re.findall(r"Train Loss after Epoch (\d+) - (\S+) -", run.stdout)
    # epoch 0 on both ranks of generation 0, epoch 1 on the one rank of generation 1
    assert [e for e, _ in losses] == ["0", "0", "1"]
    assert all(np.isfinite(float(v)) for _, v in losses)


def test_a_kill_mid_training_at_world_3_shrinks_to_2(tmp_path):
    script = tmp_path / "espcn.py"
    script.write_text(ESPCN_FAST_EXIT_CHILD)
    # 71 training images: 23 a rank at world 3, 5 steps of 4
    plan = {"faults": [{"site": "train.preempt", "action": "kill", "rank": 1, "attempt": 0,
                        "at": 3}]}
    run = _launch(tmp_path, ["--nproc_per_node", "3", "--max_restarts", "1", "--elastic"],
                  script, ["--synthetic", "--synthetic-n", "72", "--epochs", "1",
                           "--batch-size", "4", "--workers", "0", "--device", "cpu",
                           "--ckpt", str(tmp_path / "ckpt"), "--save-every", "100"],
                  _env(tmp_path, LOSSES=str(tmp_path / "losses.txt"),
                       GRAFT_FAULT_PLAN=json.dumps(plan)))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    decisions = [ln for ln in run.stderr.splitlines()
                 if re.search(r"\[launch\] .*(restart \d+/\d+|shrinking world)", ln)]
    assert decisions == [
        "[launch] elastic: shrinking world 3 -> 2 (rc=-9, 1 rank(s) lost)",
        "[launch] world failed (rc=-9, class=outage), restart 1/1 in 0.1s"], run.stderr[-3000:]
    finished = sorted(ln.split()[:2] for ln in (tmp_path / "losses.txt").read_text().split("\n")
                      if ln)
    assert finished == [["1", "0"], ["1", "1"]]
