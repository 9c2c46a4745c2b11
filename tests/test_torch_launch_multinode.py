"""Two port launchers on localhost form one world: ``--nnodes 2
--nproc_per_node 1 --node_rank {0,1}`` with a pinned ``--master_port`` and
a shared ``--membership-dir``, as the reference's launch line runs once a
node. Each child joins the gloo group through ``runtime.dist`` (global rank
= node_rank * nproc_per_node + local_rank) and all-reduces. Fate-sharing
crosses nodes: when node 1's rank dies (rc 7) after the rendezvous, node 0
(the controller) sees node 1's posted result in the store, requests the
epoch's teardown and stops its own healthy child, which is busy with a
two-minute step of its own and touches no collective that could notice
the death; both launchers return 7 (the follower takes the controller's
``abort``).
"""

import subprocess
import sys
import time
from pathlib import Path

from pytorch_distributedtraining_tpu_torch.runtime.ports import find_free_port
from test_torch_dist_workers import launcher_env

ROOT = Path(__file__).resolve().parents[1]

CHILD = r'''
import os, sys
import torch
torch.set_num_threads(1)
from pytorch_distributedtraining_tpu_torch.runtime import dist
node, local = int(os.environ["GRAFT_NODE_RANK"]), int(os.environ["LOCAL_RANK"])
assert int(os.environ["RANK"]) == node + local, os.environ["RANK"]
assert os.environ["GRAFT_HOST_ID"] == f"node{node}"
dist.initialize(device="cpu")
t = torch.tensor([dist.rank() + 1.0])
torch.distributed.all_reduce(t)
open(os.environ["MARKER"] + os.environ["RANK"], "w").write(f"{t.item()} {dist.world_size()}")
if os.environ.get("FATE") == "1":
    if dist.rank() == 1:
        os._exit(7)  # node 1's rank dies after the rendezvous
    import time
    time.sleep(120)  # node 0's rank is busy with a long step of its own
dist.shutdown()
'''


def _two_launchers(tmp_path, fate: bool) -> list:
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    port = find_free_port()
    env = launcher_env(tmp_path, MARKER=str(tmp_path / "done_"), FATE="1" if fate else "0")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributedtraining_tpu_torch.runtime.launch",
         "--nnodes", "2", "--nproc_per_node", "1", "--node_rank", str(node),
         "--master_port", str(port), "--membership-dir", str(tmp_path / "membership"),
         "--one_cpu_device_per_rank", str(script)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for node in range(2)]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=90)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def test_two_launchers_form_one_world(tmp_path):
    for rc, err in _two_launchers(tmp_path, fate=False):
        assert rc == 0, err[-2000:]
    for r in range(2):
        assert (tmp_path / f"done_{r}").read_text() == "3.0 2"


def test_a_rank_death_on_one_node_tears_the_other_node_down(tmp_path):
    t0 = time.monotonic()
    (rc0, err0), (rc1, err1) = _two_launchers(tmp_path, fate=True)
    elapsed = time.monotonic() - t0
    for r in range(2):
        assert (tmp_path / f"done_{r}").read_text() == "3.0 2"  # both joined first
    assert rc1 == 7, err1[-2000:]
    assert rc0 == 7, err0[-2000:]  # the aggregated verdict: node 1's code
    assert "membership: teardown epoch=1 reason=peer-failure" in err0
    assert elapsed < 60, elapsed  # node 0's child did not sit out its 120 s barrier
