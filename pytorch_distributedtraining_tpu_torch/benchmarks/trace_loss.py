"""Where a ``torch.profiler`` session loses device records, on one GPU.

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.trace_loss \\
        --age --reps 3 --observe 4

In a process that has run ``chip_smoke.py``'s earlier phases, CUPTI drops
the first device records of every profiler session (``observe.profiling``'s
docstring). ``--age`` runs ``chip_smoke.py``'s phases 1-16 in this process
first (from the repo root; the script needs the checkout). Then, over
three GPT-2 125M bf16 ``ZeRO3`` steps (phase 17 (b)'s at NCCL world 1),
each warm-up variant of ``VARIANTS`` opens ``--reps`` sessions in turn: a
raw ``torch.profiler`` session, warm-ups of k quick one-element kernels
between ``prepare_trace`` and ``start_trace``, 8 kernels spread over 10 ms,
one 10 ms spin kernel, and ``observe.profiling``'s own session
(``WARMUP_KERNELS``). Each session prints one ``[trace_loss]`` JSON line:
how many launch, copy and set calls lost their device record and where
they lie (``chip_smoke.lost_where``). ``--observe N`` then runs phase 17
itself N times and prints whether each passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's ~1.98 GHz


def warm_up(n: int, gap_s: float = 0.0, spin_cycles: int = 0) -> None:
    """``n`` one-element kernels (``gap_s`` apart on the host), after one
    spin kernel of ``spin_cycles`` when given; then a sync."""
    import torch

    x = torch.zeros(1, device="cuda")
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
    for _ in range(n):
        x.add_(1)
        t = time.perf_counter()
        while time.perf_counter() - t < gap_s:
            pass
    torch.cuda.synchronize()


VARIANTS = {  # name: the warm-up between prepare_trace and start_trace, or a mode
    "raw": None,
    "warm 0": lambda: warm_up(0),
    "warm 8": lambda: warm_up(8),
    "warm 32": lambda: warm_up(32),
    "warm 256": lambda: warm_up(256),
    "warm 8 over 10 ms": lambda: warm_up(8, gap_s=0.00125),
    "spin 10 ms + 1": lambda: warm_up(1, spin_cycles=SPIN_CYCLES),
    "observe.profiling": "guard",
}


def traced(variant, work, path: str) -> None:
    """One session of ``work()`` under ``variant``, written to ``path``."""
    import torch

    from pytorch_distributedtraining_tpu_torch.observe import profiling

    if variant == "guard":
        if not profiling.start_profiler_trace(os.path.dirname(path)):
            raise RuntimeError("a profiler session is already active")
        work()
        profiling.stop_profiler_trace(path)
        return
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.prepare_trace()
    if variant is not None:
        variant()
    prof.start_trace()
    work()
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)


def age(smoke) -> str:
    """``chip_smoke.py``'s phases 1-16, as its ``main`` runs them; returns
    the ``nvidia-smi`` line."""
    smi = smoke.phase_device()
    smoke.phase_build()
    smoke.phase_kernels(smi)
    smoke.phase_flash_kernels(smi)
    seen: set = set()
    with smoke.record_launches(seen):
        smoke.phase_driver()
        smoke.phase_bench(smi)
        lm = smoke.phase_gpt2(smi)
        smoke.phase_bench_config(smi)
        smoke.phase_espcn()
    smoke.phase_optimizer(smi)
    with smoke.record_launches(seen):
        smoke.phase_distributed(smi, lm)
        smoke.phase_swinir_m(smi)
    smoke.phase_image_rungs(smi)
    with smoke.record_launches(seen):
        smoke.phase_serving(smi)
        smoke.phase_resume(smi)
        smoke.phase_health(smi, lm)
    return smi


def sessions(smoke, reps: int, smi: str) -> list[dict]:
    """``reps`` rounds of one session per variant over three GPT-2 steps."""
    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.observe import opcost
    from pytorch_distributedtraining_tpu_torch.runtime import dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.initialize()
    out = []
    try:
        _, step, tokens = ladder.build_lm(GPT2Config.gpt2_125m(), smoke.LM_BATCH, smoke.LM_SEQ,
                                          torch.device("cuda"), policy="zero3")
        step(tokens)
        torch.cuda.synchronize()

        def work():
            for _ in range(3):
                step(tokens)

        with tempfile.TemporaryDirectory() as tmp:
            for rep in range(reps):
                for name, variant in VARIANTS.items():
                    path = os.path.join(tmp, f"{rep}-{len(out)}.json")
                    t0 = time.perf_counter()
                    traced(variant, work, path)
                    row = {"variant": name, "rep": rep,
                           "s": round(time.perf_counter() - t0, 3),
                           **smoke.lost_where(opcost.read_trace(path))}
                    print("[trace_loss]", json.dumps(row), "|", smi, flush=True)
                    out.append(row)
    finally:
        dist.shutdown()
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--age", action="store_true",
                    help="run chip_smoke.py's phases 1-16 in this process first")
    ap.add_argument("--reps", type=int, default=3, help="sessions a variant")
    ap.add_argument("--observe", type=int, default=0,
                    help="then run chip_smoke.py's phase 17 this many times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_loss: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    smi = age(smoke) if args.age else smoke.smi_line()
    rows = sessions(smoke, args.reps, smi)
    passed = 0
    for i in range(args.observe):
        try:
            smoke.phase_observe(smi)
            passed += 1
            print(f"[trace_loss] phase 17 run {i}: passed", flush=True)
        except SystemExit as e:
            print(f"[trace_loss] phase 17 run {i}: failed: {e}", flush=True)
    summary = {}
    for r in rows:
        summary.setdefault(r["variant"], []).append(r["lost"])
    print("[trace_loss] lost by variant", json.dumps(summary),
          f"| phase 17 passed {passed} of {args.observe} | {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
