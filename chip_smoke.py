#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN convolutions, so every f32 number
   below is full f32;
2. build: the window-attention kernels from ``pytorch_distributedtraining_
   tpu_torch/csrc`` with nvcc for sm_90a, with ptxas's register and spill
   counts;
3. kernels: K1 (forward) and K2 (backward) against their plain PyTorch
   versions at every shape the two driven paths below give them: the
   bench shape (q/k/v [1152, 6, 64, 10]: batch 18 at LR 64x64) in f32 and
   bf16, with and without the shift mask, pack 1 and 2; the driver's
   training batches ([288, 6, 64, 10]: batch 18 at LR 32x32) and its
   validation batch ([160, 6, 64, 10]: 10 images) in f32, with and
   without the mask. Errors against the stated tolerance and median
   times (CUDA events) of the kernel, the plain version and one PyTorch
   library call (``scaled_dot_product_attention`` with a float mask of
   bias + mask); then a toy SwinIR on the card against the same model on
   the CPU;
4. driver: ``drivers.stoke_ddp.main`` (full-width SwinIR-S, one epoch of
   synthetic data, two optimizer steps) in a scratch directory: finite
   losses, a checkpoint written, and the launch counts of both kernels;
5. bench shape: the model and facade from the driver's ``build_model``
   and ``build_stoke`` at batch 18, LR 64x64 -> HR 128x128, in f32 and
   bf16: a few optimizer steps, finite loss, moved weights, exactly 24 K1
   and 24 K2 launches per micro-batch, and step time and images/s beside
   the card's name and power limit.

Phases 4 and 5 note the shape, dtype and mask of every launch; the run
fails if one of them was not held against the plain version in phase 3.
The kernels' JSON describes phase 5's f32 run: its launch counts, and the
errors and times of phase 3 at its shape. The last lines are that JSON,
the ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the rest of the repository
beside it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32; dense bf16
TOL = {"float32": 2e-5, "bfloat16": 1e-2}  # max |err| / max(1, max |ref|)
SOURCE = "pytorch_distributedtraining_tpu_torch/csrc/window_attn.cu"
REPLACES = {
    "window_attn_fwd": "pytorch_distributedtraining_tpu/ops/pallas_window_attn.py:35",
    "window_attn_bwd": "pytorch_distributedtraining_tpu/ops/pallas_window_attn.py:58",
}
BATCH, LR_SIZE, HEADS, WINDOW, DIM = 18, 64, 6, 8, 60  # the bench shape
# the driver run of phase 4: 100 synthetic images at LR 32x32 (the driver's
# SyntheticSRDataset), split 90 / 10: five training batches of 18 and one
# validation batch of 10
DRIVER_N, DRIVER_LR, DRIVER_VAL = 100, 32, 10


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(1.0, want.float().abs().max().item())


def bound_ms(bytes_moved: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] torch.cuda: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("[device] set torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    return smi


def phase_build():
    from pytorch_distributedtraining_tpu_torch import csrc

    t0 = time.perf_counter()
    path = csrc.build()
    csrc.load()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", csrc.build_log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", csrc.build_log)]
    print(f"[build] {path.name}: {time.perf_counter() - t0:.1f} s (nvcc {csrc.build_seconds:.1f} s), "
          f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
          f"spill stores max {max(spills, default=0)} bytes")


def launch_signature(kernel: str, q, mask) -> tuple:
    """What a kernel launch depends on: q's shape and dtype, mask windows."""
    return kernel, tuple(q.shape), str(q.dtype), None if mask is None else mask.shape[0]


@contextlib.contextmanager
def record_launches(seen: set):
    """Add the signature of every K1 and K2 launch made inside to ``seen``."""
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    fwd, bwd = twa.kernel_forward, twa.kernel_backward

    def forward(q, k, v, bias, mask):
        seen.add(launch_signature("fwd", q, mask))
        return fwd(q, k, v, bias, mask)

    def backward(q, k, v, bias, mask, do):
        seen.add(launch_signature("bwd", q, mask))
        return bwd(q, k, v, bias, mask, do)

    twa.kernel_forward, twa.kernel_backward = forward, backward
    try:
        yield
    finally:
        twa.kernel_forward, twa.kernel_backward = fwd, bwd


def _attention_inputs(dtype, with_mask: bool, batch: int, lr_size: int, seed: int):
    import torch

    from pytorch_distributedtraining_tpu_torch.models.swinir import _shift_attn_mask

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d = WINDOW * WINDOW, DIM // HEADS
    nw = (lr_size // WINDOW) ** 2
    bn = batch * nw
    q, k, v, do = (torch.randn(bn, HEADS, n, d, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    bias = torch.randn(HEADS, n, n, generator=g, device="cuda") * 0.5
    mask = None
    if with_mask:
        mask = torch.from_numpy(_shift_attn_mask(lr_size, lr_size, WINDOW, WINDOW // 2)).cuda()
    return q, k, v, do, bias, mask


def _kernel_case(dtype, with_mask: bool, pack: int, batch: int, lr_size: int,
                 seed: int) -> dict:
    """One configuration: errors of both kernels and the times of kernel,
    plain version and library call, forward and backward."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    q, k, v, do, bias, mask = _attention_inputs(dtype, with_mask, batch, lr_size, seed)
    checked = {launch_signature(kind, q, mask) for kind in ("fwd", "bwd")} if pack == 1 else set()
    want = [twa.plain_forward(q, k, v, bias, mask),
            *twa.plain_backward(q, k, v, bias, mask, do)]
    if pack == 1:
        args = (q, k, v, bias, mask)
        got = [twa.kernel_forward(*args), *twa.kernel_backward(*args, do)]
    else:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = twa.window_attention_packed(*leaves, mask, pack=pack)
        out.backward(do)
        got = [out.detach()] + [t.grad for t in leaves]
    names = ["o", "dq", "dk", "dv", "dbias"]
    errors = {nm: err(a, b) for nm, a, b in zip(names, got, want)}

    # times at the shapes the kernels see: packed inputs for pack > 1
    if pack > 1:
        _, h, n, d = q.shape
        do = do.reshape(-1, pack, h, n, d).transpose(1, 2).reshape(-1, h, pack * n, d)
        q, k, v, bias, mask = twa.pack_windows(q, k, v, bias, mask, pack)
        do = do.contiguous()
    bn, h, n, d = q.shape
    args = (q, k, v, bias, mask)
    t = {
        "fwd": median_ms(lambda: twa.kernel_forward(*args)),
        "bwd": median_ms(lambda: twa.kernel_backward(*args, do)),
        "plain_fwd": median_ms(lambda: twa.plain_forward(*args)),
        "plain_bwd": median_ms(lambda: twa.plain_backward(*args, do)),
    }
    am = bias[None].expand(bn, h, n, n)
    if mask is not None:
        am = am + mask[torch.arange(bn, device="cuda") % mask.shape[0]][:, None]
    am = am.to(q.dtype).contiguous()
    t["lib_fwd"] = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
    lq, lk, lv, lm = (x.detach().clone().requires_grad_(True) for x in (q, k, v, am))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lm)
    t["lib_bwd"] = median_ms(
        lambda: torch.autograd.grad(lout, (lq, lk, lv, lm), do, retain_graph=True))

    esize = q.element_size()
    side = bias.numel() * 4 + (0 if mask is None else mask.numel() * 4)
    dt = str(q.dtype).split(".")[1]
    fwd_bound = bound_ms(4 * q.numel() * esize + side, 4 * bn * h * n * n * d, dt)
    bwd_bound = bound_ms(7 * q.numel() * esize + side + bias.numel() * 4,
                         10 * bn * h * n * n * d, dt)
    return {"dtype": dt, "mask": with_mask, "pack": pack, "shape": tuple(q.shape),
            "errors": errors, "times": t, "fwd_bound": fwd_bound, "bwd_bound": bwd_bound,
            "checked": checked}


def phase_kernels(smi: str) -> list[dict]:
    import torch

    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    configs = [(dtype, with_mask, pack, BATCH, LR_SIZE)
               for dtype in (torch.float32, torch.bfloat16)
               for with_mask in (False, True) for pack in (1, 2)]
    configs += [(torch.float32, with_mask, 1, batch, DRIVER_LR)
                for batch in (BATCH, DRIVER_VAL) for with_mask in (False, True)]
    cases = []
    for seed, (dtype, with_mask, pack, batch, lr_size) in enumerate(configs):
        c = _kernel_case(dtype, with_mask, pack, batch, lr_size, seed)
        tol = TOL[c["dtype"]]
        worst = max(rel for _, rel in c["errors"].values())
        errs = " ".join(f"{nm} {a:.2e}/{r:.2e}" for nm, (a, r) in c["errors"].items())
        t = c["times"]
        print(f"[kernels] {c['dtype']:8s} q {list(c['shape'])} (batch {batch}, LR {lr_size}) "
              f"mask={int(with_mask)} pack={pack} abs/rel err: {errs} (tol rel {tol:g})")
        print(f"[kernels]   ms fwd {t['fwd']:.4f} bwd {t['bwd']:.4f} | plain fwd "
              f"{t['plain_fwd']:.4f} bwd {t['plain_bwd']:.4f} | library fwd "
              f"{t['lib_fwd']:.4f} bwd {t['lib_bwd']:.4f} | bound fwd "
              f"{c['fwd_bound'][0]:.4f} ({c['fwd_bound'][1]}) bwd "
              f"{c['bwd_bound'][0]:.4f} ({c['bwd_bound'][1]}) | {smi}")
        if not worst <= tol:
            raise SystemExit(f"kernel disagrees with its plain version: {c['errors']}")
        cases.append(c)

    from pytorch_distributedtraining_tpu_torch.models import SwinIR

    model = SwinIR(img_size=16, window_size=8, depths=(2, 2), embed_dim=12, num_heads=(2, 2),
                   generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    want = model(x)
    want.square().mean().backward()
    want_grads = {nm: p.grad.clone() for nm, p in model.named_parameters()}
    model.zero_grad()
    before = twa.fwd_launches, twa.bwd_launches
    got = model.cuda()(x.cuda())
    got.square().mean().backward()
    launched = twa.fwd_launches - before[0], twa.bwd_launches - before[1]
    out_err = err(got.cpu(), want)[1]
    grad_err = max(err(p.grad.cpu(), want_grads[nm])[1] for nm, p in model.named_parameters())
    print(f"[kernels] toy SwinIR card vs CPU: output rel err {out_err:.2e}, worst grad rel err "
          f"{grad_err:.2e}, launches {launched}")
    if launched != (4, 4) or out_err > 1e-4 or grad_err > 1e-4:
        raise SystemExit("toy SwinIR on the card disagrees with the CPU")
    return cases


def phase_driver() -> None:
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    os.environ["WANDB_MODE"] = "disabled"  # offline JSONL sink, no network
    (ROOT / "build").mkdir(exist_ok=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run_dir:
        os.chdir(run_dir)
        try:
            twa.reset_launch_counts()
            t0 = time.perf_counter()
            train_loss, val_loss = stoke_ddp.main([
                "--synthetic", "--synthetic-n", str(DRIVER_N), "--nEpochs", "1",
                "--batchSize", str(BATCH), "--threads", "2",
            ])
            seconds = time.perf_counter() - t0
            launches = twa.fwd_launches, twa.bwd_launches
            ckpts = list(Path(run_dir, "checkpoint").glob("model_0_*.pt"))
        finally:
            os.chdir(cwd)
    print(f"[driver] train loss {train_loss}, val loss {val_loss}, checkpoint "
          f"{[p.name for p in ckpts]}, {seconds:.1f} s, launches fwd {launches[0]} "
          f"bwd {launches[1]}")
    # five training micro-batches (24 layers each, fwd+bwd) and one
    # forward-only validation batch
    train_batches = (DRIVER_N - DRIVER_VAL) // BATCH
    expected = (24 * train_batches + 24, 24 * train_batches)
    if not (train_loss == train_loss and val_loss == val_loss
            and abs(train_loss) < float("inf") and abs(val_loss) < float("inf")):
        raise SystemExit("driver losses are not finite")
    if len(ckpts) != 1:
        raise SystemExit("driver wrote no checkpoint")
    if launches != expected:
        raise SystemExit(f"driver launches {launches}, expected {expected}")


def phase_bench(smi: str, steps: int = 5, warmup: int = 2):
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks.profile_swinir import (
        make_batches, train_steps,
    )
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    batches = make_batches("cuda")
    results = {}
    for fp16 in (None, "bf16"):
        s = stoke_ddp.build_stoke(stoke_ddp.build_model(), fp16=fp16, batch_size=BATCH)
        w0 = s.model_access.conv_first.weight.detach().clone()
        train_steps(s, batches, warmup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        twa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_steps(s, batches, steps)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = twa.fwd_launches, twa.bwd_launches
        loss = loss.item()
        moved = (s.model_access.conv_first.weight - w0).abs().max().item()
        name = fp16 or "fp32"
        micro = s.grad_accum_steps * steps
        step_ms = elapsed / steps * 1e3
        ips = BATCH * micro / elapsed
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[bench] {name}: step {step_ms:.2f} ms, {ips:.1f} images/s (batch {BATCH} x "
              f"accum {s.grad_accum_steps}, LR {LR_SIZE} -> HR {2 * LR_SIZE}, {steps} steps "
              f"after {warmup}), peak {peak:.2f} GiB, loss {loss:.5f}, weights moved "
              f"{moved:.2e}, launches fwd {launches[0]} bwd {launches[1]} | {smi}")
        if launches != (24 * micro, 24 * micro):
            raise SystemExit(f"{name}: launches {launches}, expected 24 of each per micro-batch")
        if not np.isfinite(loss) or not moved > 0:
            raise SystemExit(f"{name}: loss {loss} or weights did not move")
        results[name] = {"step_ms": step_ms, "images_per_s": ips, "launches": launches}
        del s
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    cases = phase_kernels(smi)
    seen: set = set()
    with record_launches(seen):
        phase_driver()
        bench = phase_bench(smi)
    checked = set().union(*(c["checked"] for c in cases))
    print(f"[shapes] phases 4-5 launched {len(seen)} kinds of (kernel, q shape, dtype, mask "
          f"windows): {sorted(seen, key=str)}")
    if seen - checked:
        raise SystemExit(f"launched on a driven path but never held against the plain "
                         f"version: {sorted(seen - checked, key=str)}")

    # the kernels line: phase 5's f32 run, with phase 3's numbers at its
    # shape (errors: worst of masked and unmasked; times: the masked case)
    at_shape = [c for c in cases if c["dtype"] == "float32" and c["pack"] == 1
                and c["shape"][0] == BATCH * (LR_SIZE // WINDOW) ** 2]
    main_case = next(c for c in at_shape if c["mask"])
    t = main_case["times"]
    launches = bench["fp32"]["launches"]
    kernels = []
    for name, key, launched, grads in (
        ("window_attn_fwd", "fwd", launches[0], ("o",)),
        ("window_attn_bwd", "bwd", launches[1], ("dq", "dk", "dv", "dbias")),
    ):
        abs_err = max(c["errors"][g][0] for c in at_shape for g in grads)
        bound = main_case[f"{key}_bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launched, "max_abs_err": abs_err, "ms": t[key],
            "plain_ms": t[f"plain_{key}"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": t[f"lib_{key}"],
        })
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
