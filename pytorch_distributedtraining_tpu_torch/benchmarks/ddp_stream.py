"""What building the ``DistributedDataParallel`` wrapper under a side stream
costs an eager DDP step, on one GPU.

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.ddp_stream --rounds 3

``parallel.create_train_state`` builds the wrapper under a side stream on
a card, so that the parameters' AccumulateGrad nodes, which DDP's reducer
keeps, can join a captured backward (a graphed program runs the bare
module). Every eager backward through the wrapper then waits across
streams once a parameter. This script times eager ``TrainStep`` steps of
SwinIR-S at the bench shape (the driver's ``build_model``, batch 18 at LR
64x64 a micro-batch, ``grad_accum_steps=2``, MSE, per-leaf AdamW, f32 and
bf16 autocast) in an NCCL group of one, with the wrapper built as the
port builds it (``side``) and built on the current stream (``current``,
as before), in turns over ``--rounds`` rounds of ``--steps`` steps after
``--warmup``. It prints one JSON line a precision: each arm's median step
ms, the ratio, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import time

import torch


def _smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _arm(arm: str, precision: str, mesh):
    """An eager ``TrainStep`` over SwinIR-S under DDP, its wrapper built
    under a side stream (``create_train_state``) or on the current stream."""
    from torch.nn.parallel import DistributedDataParallel

    from .. import optim, parallel
    from ..drivers import stoke_ddp
    from ..precision import Policy
    from ..runtime.mesh import data_group

    pol = Policy.from_name(None if precision == "f32" else precision)

    def loss_fn(model, b):
        with pol.autocast(b[0].device):
            out = model(b[0])
        return torch.mean((out.float() - b[1]) ** 2), {}

    tx = functools.partial(optim.adamw, lr=5e-4, clip_grad_norm=0.1)
    if arm == "side":
        st = parallel.create_train_state(stoke_ddp.build_model(), tx, mesh, parallel.DDP())
        model, opt = st.model, st.tx
    else:
        module = stoke_ddp.build_model().cuda()
        model = DistributedDataParallel(module, device_ids=[torch.cuda.current_device()],
                                        process_group=data_group(mesh), broadcast_buffers=False)
        opt = tx(module.named_parameters())
    return parallel.TrainStep(model, loss_fn, opt, mesh, parallel.DDP(), grad_accum_steps=2)


def main(argv=None) -> int:
    from ..runtime import dist
    from ..runtime.mesh import MeshSpec, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.initialize()
    smi = _smi()
    try:
        mesh = make_mesh(MeshSpec.ddp())
        g = torch.Generator(device="cuda").manual_seed(0)
        hr = torch.rand(36, 128, 128, 3, device="cuda", generator=g)
        batch = (hr.reshape(36, 64, 2, 64, 2, 3).mean(dim=(2, 4)), hr)
        for precision in ("f32", "bf16"):
            steps = {arm: _arm(arm, precision, mesh) for arm in ("side", "current")}
            times: dict = {arm: [] for arm in steps}
            for arm, step in steps.items():
                for _ in range(args.warmup):
                    step(batch)
            for _ in range(args.rounds):
                for arm, step in steps.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(args.steps):
                        step(batch)
                    torch.cuda.synchronize()
                    times[arm].append((time.perf_counter() - t0) / args.steps * 1e3)
            med = {arm: statistics.median(v) for arm, v in times.items()}
            print(json.dumps({"ddp_stream": precision, "side_ms": med["side"],
                              "current_ms": med["current"],
                              "side_over_current": med["side"] / med["current"],
                              "rounds_ms": times, "device": smi}))
            del steps
            torch.cuda.empty_cache()
    finally:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
