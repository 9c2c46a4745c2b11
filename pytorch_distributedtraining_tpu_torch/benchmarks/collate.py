"""The loader's host collate at the SR paths' batches: ``np.stack`` against
``csrc.fastpipe.fast_stack``, on the host that feeds the GPU.

A batch is ``batch`` samples of an f32 NHWC LR patch and its HR patch, as
``PatchStore`` with ``PairedRandomAug`` and ``SyntheticSRDataset`` give
them; the collate stacks each field. For each path and each way, the
median of ``--reps`` collates, timed in ``--procs`` processes at once (the
loader's worker count) and in one alone::

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.collate

prints one JSON line per (path, processes) with the median ms of both ways
(the slowest process's median where several ran).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import time

import numpy as np

from pytorch_distributedtraining_tpu_torch.csrc import fastpipe

CASES = (  # path, batch, LR side, scale
    ("SwinIR-M x2, chip_smoke.py phase 12", 16, 48, 2),
    ("SwinIR-S x2, the Stoke driver", 18, 64, 2),
    ("ESPCN x2, the Fairscale driver", 40, 32, 2),
)


def _median_ms(fn, fields, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for f in fields:
            fn(f)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def time_case(args) -> dict:
    batch, lr, scale, reps = args
    g = np.random.default_rng(0)
    fields = [[g.random((s, s, 3), dtype=np.float32) for _ in range(batch)]
              for s in (lr, lr * scale)]
    fastpipe.load()
    for fn in (np.stack, fastpipe.fast_stack):  # warm both
        _median_ms(fn, fields, 5)
    return {"np_stack_ms": _median_ms(np.stack, fields, reps),
            "fast_stack_ms": _median_ms(fastpipe.fast_stack, fields, reps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--procs", type=int, default=4)
    opt = ap.parse_args(argv)
    fastpipe.build()
    ctx = mp.get_context("spawn")
    for path, batch, lr, scale in CASES:
        for procs in sorted({1, opt.procs}):
            with ctx.Pool(procs) as pool:
                runs = pool.map(time_case, [(batch, lr, scale, opt.reps)] * procs)
            print(json.dumps({
                "path": path, "batch": batch, "lr": lr, "hr": lr * scale, "procs": procs,
                "np_stack_ms": max(r["np_stack_ms"] for r in runs),
                "fast_stack_ms": max(r["fast_stack_ms"] for r in runs),
            }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
