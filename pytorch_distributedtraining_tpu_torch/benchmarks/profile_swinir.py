"""Where the time of a SwinIR-S x2 training step goes, on one GPU.

Counterpart of ``benchmarks/profile_swinir.py`` (which ablates the step on
a TPU). The step is the bench shape of ``bench.py``: SwinIR-S at full
width and depth through the Stoke facade, both built by the driver twin's
``build_model`` and ``build_stoke`` (``feat_loss``, AdamW, clip 0.1,
``grad_accum_steps=2``), batch 18 at LR 64x64 -> HR 128x128, random
weights and images from fixed seeds::

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.profile_swinir

For f32 and bf16 it prints the step time with the profiler off, then
traces a few steps with ``torch.profiler`` and prints the device time by
kernel family (window attention, GEMM, convolution, ...), the device's
busy and idle share of the traced window, and the profiler's overhead.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
from pytorch_distributedtraining_tpu_torch.observe import profiling
from pytorch_distributedtraining_tpu_torch.observe.opcost import device_breakdown
from pytorch_distributedtraining_tpu_torch.stoke import Stoke

BATCH, LR_SIZE, ACCUM = 18, 64, 2


def make_batches(device, batch: int = BATCH,
                 lr_size: int = LR_SIZE) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """One optimizer step's (LR, HR) pairs on ``device``: random HR from
    numpy seed 0, box-downsampled LR."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(ACCUM):
        hr = rng.random((batch, 2 * lr_size, 2 * lr_size, 3), dtype=np.float32)
        lr = hr.reshape(batch, lr_size, 2, lr_size, 2, 3).mean(axis=(2, 4))
        out.append((torch.from_numpy(lr).to(device), torch.from_numpy(hr).to(device)))
    return out


def train_steps(stoke: Stoke, batches, steps: int) -> torch.Tensor:
    """``steps`` optimizer steps of ``grad_accum_steps`` micro-batches each;
    returns the last micro-batch's loss (a device scalar)."""
    loss = None
    for i in range(stoke.grad_accum_steps * steps):
        x, y = batches[i % len(batches)]
        loss = stoke.loss(stoke.model(x), y)
        stoke.backward(loss)
        stoke.step()
    return loss


def profile(stoke: Stoke, batches, steps: int, warmup: int, trace_path: str) -> dict:
    """Step time with the profiler off, then a traced window of ``steps``
    (``observe.profiling.profile_call``) and its device breakdown
    (``observe.opcost.device_breakdown``)."""
    dev = stoke.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    train_steps(stoke, batches, warmup)
    sync()
    t0 = time.perf_counter()
    loss = train_steps(stoke, batches, steps)
    sync()
    plain_ms = (time.perf_counter() - t0) / steps * 1e3

    def window():
        t0 = time.perf_counter()
        train_steps(stoke, batches, steps)
        sync()
        return (time.perf_counter() - t0) / steps * 1e3

    traced_ms, events = profiling.profile_call(window, trace_path)
    result = {
        "precision": stoke.fp16 or "fp32", "step_ms": plain_ms,
        "images_per_s": stoke.grad_accum_steps * stoke.batch_size_per_device / plain_ms * 1e3,
        "traced_step_ms": traced_ms, "loss": float(loss.detach()),
    }
    if dev.type == "cuda":
        result.update(device_breakdown(events))
        for k in ("busy_ms", "window_ms"):
            result[k] /= steps
        result["device_ms_by_family"] = {k: v / steps
                                         for k, v in result["device_ms_by_family"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="optimizer steps timed and traced")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--trace-dir", default="build", help="where the Chrome traces go")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_swinir needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; TF32 off for matmuls and cuDNN", flush=True)
    batches = make_batches("cuda")
    for fp16 in (None, "bf16"):
        stoke = stoke_ddp.build_stoke(stoke_ddp.build_model(), fp16=fp16)
        r = profile(stoke, batches, opt.steps, opt.warmup,
                    f"{opt.trace_dir}/swinir_{fp16 or 'fp32'}.json")
        r["card"] = smi
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
