"""The port's entry points across processes: both drivers under
``torch.distributed.run`` with two gloo ranks, GPT-2 under the JAX
rung's layout (``ZeRO3`` with full remat) at two ranks against the
one-process step on the same global batch, the ladder's ``--policy`` on
the CPU, and at three ranks ``FusedAdamW``'s ZeRO-1 refusal (its padding
does not divide) and ``EvalStep``'s metrics averaged over ranks.

GPT-2 (``GPT2Config.tiny()``, f32) at two ranks takes each rank's batch of
8 sequences; the one-process step takes both at once. The losses agree to
~1e-7 relative (held at 1e-5) and the parameters to ~1e-8 (held at 1e-5).
``wte`` is the model's only vocabulary-shaped parameter on both sides: the
tied head shares the root's unit with the embedding under FSDP2, so its
gradient reaches the same tensor, and the parameter matches the run in
which no sharding could split the tie.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
from pytorch_distributedtraining_tpu_torch.models import GPT2Config
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep
from test_torch_dist_workers import gpt2_worker, run_ranks, toy_swinir, world_worker

ROOT = Path(__file__).resolve().parents[1]


def _launch(tmp_path, module: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), WANDB_MODE="disabled", TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", module, *args, "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)


def test_stoke_driver_runs_under_torch_distributed_run(tmp_path):
    run = _launch(tmp_path, "pytorch_distributedtraining_tpu_torch.drivers.stoke_ddp",
                  "--synthetic", "--synthetic-n", "20", "--batchSize", "2", "--nEpochs", "1",
                  "--threads", "0")
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "[rank 0/2] Starting Epoch 1" in run.stdout
    assert "[rank 1/2]" not in run.stdout  # prints come from rank 0, as Stoke's
    assert run.stdout.count("Checkpoint saved after epoch 0") == 2  # the driver's line, per rank
    assert len(list((tmp_path / "checkpoint").glob("model_0_*.pt"))) == 1  # rank 0 wrote it


def test_fairscale_driver_runs_under_torch_distributed_run(tmp_path):
    run = _launch(tmp_path, "pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp",
                  "--synthetic", "--synthetic-n", "96", "--epochs", "1", "--batch-size", "8",
                  "--workers", "0")
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    epochs = [ln for ln in run.stdout.splitlines() if ln.startswith("For Epoch 0, loss:")]
    assert len(epochs) == 2 and epochs[0] == epochs[1]  # both ranks, one loss
    # 95 training images: 48 a rank (one padded), five steps of 8 each
    assert run.stdout.count("--Shape-- (8, 32, 32, 3) (8, 64, 64, 3)") == 2


def test_gpt2_under_zero3_with_full_remat_matches_one_process():
    ranks = run_ranks(gpt2_worker, 2, policy="zero3", remat="full", steps=3)
    cfg = GPT2Config.tiny()
    model, _, tok0 = ladder.build_lm(cfg, 8, 32, torch.device("cpu"))
    tok1 = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(8, 32)).astype(np.int32)
    step = TrainStep(model, ladder._lm_loss,
                     optim.adamw(model.named_parameters(), lr=3e-4, clip_grad_norm=1.0))
    batch = torch.cat([tok0, torch.from_numpy(tok1)])
    want = [float(step(batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(ranks[0]["params"][name], p.detach().numpy(), atol=1e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(ranks[1]["params"][name], ranks[0]["params"][name])
    assert ranks[0]["vocab_params"] == ["transformer.wte.weight"]


def test_world_of_3_refuses_a_fused_zero1_and_averages_eval_metrics():
    rng = np.random.default_rng(0)
    x, y = rng.random((6, 8, 8, 3), np.float32), rng.random((6, 16, 16, 3), np.float32)
    ranks = run_ranks(world_worker, 3, batch=(x, y))
    assert all("does not divide over 3 ranks" in r["error"] for r in ranks)
    with torch.no_grad():  # the whole batch's MSE, in one process
        want = float(torch.mean((toy_swinir()(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2))
    assert all(r["mse"] == ranks[0]["mse"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["mse"], want, rtol=1e-6)


def test_ladder_runs_the_jax_rung_layout_on_cpu(capsys):
    import json

    assert ladder.main(["--config", "4", "--tiny", "--device", "cpu", "--steps", "2",
                        "--warmup", "1", "--policy", "zero3", "--remat", "full"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["policy"], line["remat"], line["world_size"]) == ("zero3", "full", 1)
    assert line["config"] == "4_gpt2_125m_zero3_flash" and np.isfinite(line["loss"])
