"""Resume across ranks, over gloo.

One launch of two ranks runs the driver's facade (``broadcast_fp16``,
accum 2, clip 0.1) on the toy SwinIR under ZeRO-2 (OSS + SDDP, the
per-leaf chain on leaf shards) and ZeRO-3 (FSDP2): four optimizer steps
unbroken, and the same run saved after two (``Stoke.save`` and
``Stoke.save_portable``), loaded into a fresh facade each way and stepped
to four. The resumed runs equal the unbroken one bitwise: losses,
parameters and every moment. In the same launch the ZeRO-2 portable
checkpoint restores under ZeRO-3 at world 2, and here, in one process, at
world 1 under DDP with the per-leaf chain and with ``FusedAdamW``: each
time the moments equal the ones gathered from the two ranks at the save,
bitwise.

Then the ESPCN driver (``drivers.fairscale_ddp``) under
``torch.distributed.run`` at two ranks with ``--ckpt --save-every 4`` is
killed at its ninth step by the ``train.preempt`` fault site; relaunched
with the same flags it resumes from step 8 and finishes the two epochs
with the unbroken run's last loss, exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from test_torch_dist_workers import (_moments, espcn_driver_worker, facade, full_params,
                                     resume_worker, run_ranks, toy_swinir)

ROOT = Path(__file__).resolve().parents[1]
BATCH = 8  # a global micro-batch: 4 a rank
LAYOUTS = {"zero2": dict(oss=True, sddp=True), "zero3": dict(fsdp=True)}


def _micro(n: int = 8) -> list:
    ds = SyntheticSRDataset(n=n * BATCH, lr_size=8)
    items = [ds[i] for i in range(len(ds))]
    return [tuple(np.stack([it[k] for it in items[j:j + BATCH]]) for k in (0, 1))
            for j in range(0, len(items), BATCH)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("resume"))
    ranks = run_ranks(resume_worker, 2, micro=_micro(), layouts=LAYOUTS, save_dir=save_dir,
                      split=4, reshard_from="zero2", reshard_into=dict(fsdp=True))
    return ranks


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["pt", "portable"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_world2_resume_equals_the_unbroken_run_bitwise(world2, layout, kind):
    for rank in world2:
        runs = rank[layout]
        want, got = runs["unbroken"], runs[kind]
        assert got["opt"] == want["opt"] == "AdamW"
        assert got["step"] == want["step"] == 4
        assert got["losses"] == want["losses"]
        _same(got["params"], want["params"])
        _same(got["moments"], want["moments"])
    # the ranks agree, and the saved moments were not all zero
    _same(world2[0][layout][kind]["params"], world2[1][layout][kind]["params"])
    assert max(np.abs(v).max() for k, v in world2[0][layout]["saved"]["moments"].items()
               if k != "count") > 0


def test_zero2_portable_restores_under_zero3_at_world2(world2):
    saved = world2[0]["zero2"]["saved"]
    for rank in world2:
        got = rank["resharded"]
        assert got["opt"] == "AdamW" and got["step"] == 2
        _same(got["moments"], saved["moments"])
        _same(got["params"], saved["params"])


@pytest.mark.parametrize("fused", [False, True], ids=["ddp-per-leaf", "ddp-fused"])
def test_zero2_portable_restores_at_world1(world2, fused):
    saved = world2[0]["zero2"]["saved"]
    s = facade(toy_swinir(), oss=False, sddp=False, fused_optimizer=fused)
    assert type(s._opt).__name__ == ("FusedAdamW" if fused else "AdamW")
    s.load_resharded(world2[0]["zero2"]["paths"]["portable"])
    assert s.step_count == 2
    _same(_moments(s._opt), saved["moments"])
    _same(full_params(s.model_access), saved["params"])


def test_espcn_driver_killed_and_relaunched_finishes_the_schedule(tmp_path):
    # 95 training images: 48 a rank, 6 steps of 8 an epoch, 12 in all
    argv = ["--synthetic", "--synthetic-n", "96", "--epochs", "2", "--batch-size", "8",
            "--workers", "0", "--device", "cpu", "--save-every", "4"]
    ckpt = tmp_path / "ckpt"
    plan = {"faults": [{"site": "train.preempt", "at": 9, "action": "kill"}]}
    killed = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp", *argv,
         "--ckpt", str(ckpt)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), "GRAFT_FAULT_PLAN": json.dumps(plan)})
    assert killed.returncode != 0, killed.stdout[-2000:]
    committed = sorted(p.name for p in ckpt.iterdir() if (p / "_COMMIT").is_file())
    assert committed == ["step_0000000004", "step_0000000008"]
    manifest = json.loads((ckpt / "step_0000000008" / "manifest.json").read_text())
    assert manifest["world_size"] == 2 and manifest["step"] == 8

    ranks = run_ranks(espcn_driver_worker, 2, argv=argv, ckpts=[None, str(ckpt)])
    for unbroken, resumed in ranks:
        assert unbroken is not None and resumed == unbroken
    committed = sorted(p.name for p in ckpt.iterdir() if (p / "_COMMIT").is_file())
    assert committed[-1] == "step_0000000012"
