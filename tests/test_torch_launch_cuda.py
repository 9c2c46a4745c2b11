"""The port's launcher on the card: ``--nproc_per_node 1`` runs the SwinIR-S
driver as a file, as the reference's launch line does, in an NCCL group of
one; the child launches K1 and K2 (its ``--kernel-launches`` line) and
ends with finite losses.

Marked ``cuda``: the driver trains on the GPU and these skip without one.
On a GPU machine::

    python -m pytest tests/test_torch_launch_cuda.py -q -m cuda --noconftest
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


def test_launcher_runs_the_swinir_driver_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the driver and its kernels run only on the card")
    driver = ROOT / "pytorch_distributedtraining_tpu_torch" / "drivers" / "stoke_ddp.py"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "WANDB_MODE": "disabled",
           "TMPDIR": str(tmp_path)}
    run = subprocess.run(
        [sys.executable, "-m", "pytorch_distributedtraining_tpu_torch.runtime.launch",
         "--nproc_per_node", "1", str(driver), "--synthetic", "--synthetic-n", "100",
         "--batchSize", "18", "--nEpochs", "1", "--threads", "0", "--kernel-launches"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    line = next(ln for ln in run.stdout.splitlines() if ln.startswith("[kernels] "))
    counts = json.loads(line[len("[kernels] "):])
    # the wrappers count a graph's warm-up and capture, never a replay: the
    # split path's first and accumulating programs (24 Swin layers each,
    # forward and backward) and the validation's eval program (forward)
    assert (counts["window_attn_fwd"], counts["window_attn_bwd"]) == (24 * 2 * 3, 24 * 2 * 2)
    losses = [float(v) for v in re.findall(r"Loss after Epoch \d+ - (\S+) -", run.stdout)]
    assert len(losses) == 2 and all(abs(v) < float("inf") for v in losses)
