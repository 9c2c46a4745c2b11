"""The ladder: the image rungs (configs 1, 2, 3 and 5) and the LM rung
(config 4).

Counterpart of ``benchmarks/ladder.py``. Each rung trains a few steps of
its model on seeded random data through ``parallel.TrainStep`` and prints
one JSON line: the rate (``images_per_sec`` or ``tokens_per_sec``) of the
best of three windows of ``--steps`` optimizer steps after ``--warmup``,
the step time, the last loss (checked finite), peak memory and the TF32
settings, under the roofline guard (1 PFLOP/s per device over 6 x
parameters FLOPs per item). On a card TF32 is off for cuBLAS and cuDNN::

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.ladder --config 2

The image rungs mirror ``_run_image`` and ``run_config`` of the JAX
ladder, with its names, sizes and optimizers: softmax cross entropy on
integer labels, normal images and labels from numpy seed 0, AdamW at lr
1e-3 with clip 1.0, as ``optim.FusedAdamW`` where the policy allows a
flat update (``optim.fused_adamw_eligible``) and per leaf otherwise:

======  =========================  ===================  =====  =======  =======  ==============
config  name                       model                batch  image    classes  policy
======  =========================  ===================  =====  =======  =======  ==============
1       1_resnet18_cifar10_single  ResNet-18, CIFAR      128    32x32    10       none (no group)
2       2_resnet50_ddp             ResNet-50            64     224x224  1000     ddp
3       3_resnet50_oss_sddp        ResNet-50            64     224x224  1000     zero2
5       5_vitb16_bf16_fsdp         ViT-B/16, bf16       64     224x224  1000     zero3
======  =========================  ===================  =====  =======  =======  ==============

ZeRO-2 and ZeRO-3 keep leaves under 1024 elements whole
(``min_shard_size``). ViT-B/16 runs the plain ``default_attention``, as
the JAX rung does: 197 tokens are no multiple of the flash blocks.

The LM rung is GPT-2 125M, batch 8 x seq 512 of random tokens from numpy
seed 0, AdamW (lr 3e-4, clip by global norm 1.0), cross entropy of
``logits[:, :-1]`` against ``tokens[:, 1:]``. It differs from the JAX rung
in the attention: the flash ``attn_fn``, the CUDA kernels K3-K5 (the JAX
rung uses XLA's default attention), because that is the kernel path this
rung exists to drive.

``--policy`` picks the layout; it defaults to the rung's own (``none``,
the plain one-device step, for config 4) and any other adds its name to
the config name. ``--policy zero3 --remat full`` is the JAX LM rung's
layout (FSDP2 over the blocks and the root, the whole loss recomputed in
backward). A policy joins the process group (one of its own, of one
rank, when started by hand), and each rank trains on its own batch (data
from numpy seed 0 plus its rank); BatchNorm statistics are the global
batch's (``models.resnet``)::

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.ladder --config 4 \\
        --policy zero3 --remat full

``--trace build/rung.json`` also traces the steps with ``torch.profiler``
and adds the device time per step by kernel family, each flash kernel's
device time and launches per step (K3, K4, K5 by kernel name), the
device's busy time and idle share and, for config 4, the times of the
tied head's GEMMs (vocab 50257, an odd width) to the line.
``idle_share`` is of the traced window, whose steps the profiler's host
cost stretches; the card's idle share of an untraced step is one less
``busy_ms`` over ``step_ms``.

Weights are random, from ``torch.Generator`` seed 0. ``--tiny`` follows
the JAX ladder (with ``--device cpu``, as the tests do): configs 1-3 a
CIFAR ResNet-18 at 32x32, batch 8, 10 classes; config 5
``ViTConfig.tiny()`` at batch 8; config 4 ``GPT2Config.tiny()`` at seq 32.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

import functools
import os

from .. import optim, parallel
from ..models.gpt2 import GPT2, GPT2Config, cross_entropy_loss
from ..models.resnet import ResNet18, ResNet50
from ..models.vit import ViT, ViTConfig
from ..observe import opcost, profiling
from ..ops.flash_attn import make_flash_attn_fn
from ..parallel import TrainStep
from ..runtime import dist
from ..runtime.dist import resolve_device
from ..runtime.mesh import MeshSpec, make_mesh

WINDOWS = 3  # best of N timed windows, as the JAX rung


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(batch) -> torch.device:
    return (batch[0] if isinstance(batch, tuple) else batch).device


def _timed_steps(step: TrainStep, batch, n_steps: int, warmup: int,
                 windows: int = WINDOWS) -> tuple[float, dict]:
    """Seconds of the best of ``windows`` windows of ``n_steps`` steps, and
    the last step's metrics; the loss is checked finite after the clock."""
    device = _device(batch)
    metrics = None
    for _ in range(warmup):
        metrics = step(batch)
    _sync(device)
    best = float("inf")
    for _ in range(max(1, windows)):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            metrics = step(batch)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss after timing: {loss}")
    return best, metrics


def _roofline_guard(result: dict, model: torch.nn.Module) -> dict:
    """Refuse to publish a rate above ``1 PFLOP/s / (6 x n_params)`` per
    device: training costs at least 6 FLOPs per parameter per token, so a
    rate above it is a broken timing loop, never a measurement."""
    n_params = sum(p.numel() for p in model.parameters())
    bound = 1e15 / (6.0 * n_params)
    if result["value"] > bound:
        raise RuntimeError(
            f"ROOFLINE VIOLATION: {result['config']} {result['value']:.0f} {result['unit']} "
            f"exceeds the {bound:.0f} bound (1 device x 1 PFLOP/s / 6x{n_params} FLOP/item)")
    result["roofline"] = round(bound, 1)
    return result


POLICIES = {"none": None, "ddp": parallel.DDP, "zero1": parallel.ZeRO1,
            "zero2": parallel.ZeRO2, "zero3": parallel.ZeRO3}
# config -> (the JAX ladder's name, the rung's own policy, batch, image
# size, classes) at full size
IMAGE_RUNGS = {
    1: ("1_resnet18_cifar10_single", "none", 128, 32, 10),
    2: ("2_resnet50_ddp", "ddp", 64, 224, 1000),
    3: ("3_resnet50_oss_sddp", "zero2", 64, 224, 1000),
    5: ("5_vitb16_bf16_fsdp", "zero3", 64, 224, 1000),
}
TINY_BATCH = 8


def tf32_settings() -> dict:
    return {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}


def _policy(name: str, tiny: bool = False):
    """The policy of ``name``; ZeRO-2/3 keep leaves under ``min_shard_size``
    whole (1024, as the JAX rungs; 1 at tiny sizes)."""
    cls = POLICIES[name]
    return None if cls is None else cls(min_shard_size=1 if tiny else 1024)


def _mesh(pol):
    if pol is None:
        return None
    return make_mesh(MeshSpec.zero() if pol.shard_opt_state else MeshSpec.ddp())


def join_group(device: torch.device) -> None:
    """Join the launcher's process group, or form one of a single rank when
    started by hand, so that a policy has a mesh to run on."""
    if "WORLD_SIZE" in os.environ:
        dist.initialize(device=device.type)
    else:
        dist.initialize(f"127.0.0.1:{dist.find_free_port()}", 1, 0, device=device.type)


def _lm_loss(model, tokens, rng=None):
    """Next-token cross entropy; with a key (``TrainStep`` passes one as
    ``rng``) the model's dropout is on, a no-op at ``cfg.dropout`` 0."""
    logits = model(tokens, deterministic=rng is None, generator=rng)
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:]), {}


def build_lm(cfg: GPT2Config, batch_size: int, seq: int, device: torch.device, seed: int = 0,
             policy: str = "none", remat: str | None = None, numerics: bool = False):
    """The rung's model (flash ``attn_fn``), train step and token batch on
    ``device``: ``(model, step, tokens)``. ``policy`` other than ``"none"``
    needs the process group (:func:`join_group`) and lays the model and
    optimizer out on a mesh of the whole world. The step draws its dropout
    keys from the train state's stream (seed ``seed``); ``numerics`` adds
    the probe's aux to its metrics."""
    model = GPT2(cfg, attn_fn=make_flash_attn_fn(),
                 generator=torch.Generator().manual_seed(seed))
    tx = functools.partial(optim.adamw, lr=3e-4, clip_grad_norm=1.0)
    pol = POLICIES[policy]() if POLICIES[policy] is not None else None
    mesh = _mesh(pol)
    state = parallel.create_train_state(model, tx, mesh, pol, device=device, seed=seed)
    tok = np.random.default_rng(seed + dist.rank()).integers(
        0, cfg.vocab_size, size=(batch_size, seq)).astype(np.int32)
    step = TrainStep(state.model, _lm_loss, state.tx, mesh, pol, remat=remat, rng=state.rng,
                     numerics=numerics)
    return state.module, step, torch.from_numpy(tok).to(device)


def _image_loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y), {}


def image_model(i: int, tiny: bool, seed: int = 0) -> tuple[torch.nn.Module, int, int, int]:
    """Config ``i``'s model (weights from ``seed``), batch, image size and
    classes, as the JAX ladder's ``run_config`` builds them."""
    gen = torch.Generator().manual_seed(seed)
    _, _, batch, img, classes = IMAGE_RUNGS[i]
    batch = TINY_BATCH if tiny else batch
    if i == 5:
        cfg = ViTConfig.tiny() if tiny else ViTConfig.b16()
        return ViT(cfg, generator=gen), batch, cfg.image_size, cfg.num_classes
    if i == 1 or tiny:
        return ResNet18(num_classes=10, small_inputs=True, generator=gen), batch, 32, 10
    return ResNet50(num_classes=classes, generator=gen), batch, img, classes


def build_image(i: int, tiny: bool, device: torch.device, seed: int = 0,
                policy: str | None = None, remat: str | None = None):
    """Image rung ``i``'s model, train step and batch on ``device``:
    ``(model, step, (images, labels))``. The optimizer is ``FusedAdamW``
    where the policy allows a flat update, else the per-leaf chain (AdamW,
    lr 1e-3, clip 1.0). A policy other than ``"none"`` (default: the
    rung's own) needs the process group (:func:`join_group`)."""
    model, batch, img, classes = image_model(i, tiny, seed)
    pol = _policy(IMAGE_RUNGS[i][1] if policy is None else policy, tiny)
    fused = optim.fused_adamw_eligible(pol or parallel.Policy())
    tx = functools.partial(optim.FusedAdamW if fused else optim.adamw, lr=1e-3,
                           clip_grad_norm=1.0)
    mesh = _mesh(pol)
    state = parallel.create_train_state(model, tx, mesh, pol, device=device)
    rng = np.random.default_rng(seed + dist.rank())
    x = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    y = rng.integers(0, classes, size=(batch,))
    step = TrainStep(state.model, _image_loss, state.tx, mesh, pol, remat=remat)
    return state.module, step, (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def _run_image(i: int, tiny: bool, steps: int, warmup: int, device: torch.device,
               trace: str | None = None, policy: str | None = None,
               remat: str | None = None) -> dict:
    name, own = IMAGE_RUNGS[i][:2]
    policy = own if policy is None else policy
    if policy != "none":
        join_group(device)
    model, step, batch = build_image(i, tiny, device, policy=policy, remat=remat)
    dt, metrics = _timed_steps(step, batch, steps, warmup)
    extra = {}
    if trace is not None:
        if device.type != "cuda":
            raise ValueError("--trace reads device time: it needs a card")
        extra = _traced_steps(step, batch, steps, trace)
    n = batch[0].shape[0]
    return _roofline_guard({
        "config": name if policy == own else f"{name}_{policy}",
        "metric": "images_per_sec",
        "value": n * steps / dt,
        "unit": "images/sec",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "steps": steps,
        "step_ms": dt / steps * 1e3,
        "loss": float(metrics["loss"]),
        "batch": n,
        "image": list(batch[0].shape[1:]),
        "policy": policy,
        "optimizer": type(step.tx).__name__,
        "remat": remat or "none",
        "world_size": dist.world_size(),
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
        "tf32": tf32_settings(),
        **extra,
    }, model)


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn`` on the card's stream, with CUDA events."""
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
    return sorted(times)[len(times) // 2]


def _head_gemm_ms(model: GPT2, tokens: int) -> dict:
    """The tied head's GEMMs at the rung's shape, in the model's dtype:
    ``logits = x @ wteᵀ`` ([tokens, n_embd] x [n_embd, vocab]) and the two
    GEMMs of its backward (dx and dwte)."""
    cfg, w = model.cfg, model.transformer.wte.weight
    wd = w.detach().to(cfg.dtype)
    x = torch.randn(tokens, cfg.n_embd, device=w.device, dtype=cfg.dtype)
    g = torch.randn(tokens, cfg.vocab_size, device=w.device, dtype=cfg.dtype)
    return {"fwd": _median_ms(lambda: x @ wd.t()),
            "bwd": _median_ms(lambda: (g @ wd, g.t() @ x))}


FLASH_KERNELS = {"K3": "flash_attn_fwd_kernel", "K4": "flash_attn_dq_kernel",
                 "K5": "flash_attn_dkv_kernel"}


def flash_kernel_ms(trace, n_steps: int) -> dict:
    """Device ms and launches per step of each flash kernel, by its name in
    a Chrome trace written by ``torch.profiler`` (a path, or its events)."""
    return {kid: {"ms": r["ms"] / n_steps, "launches": r["launches"] / n_steps}
            for kid, r in opcost.kernel_stats(trace, FLASH_KERNELS).items()}


def _traced_steps(step: TrainStep, batch, n_steps: int, trace_path: str) -> dict:
    """Device time per step by kernel family and the device's busy and idle
    shares, from a ``torch.profiler`` trace of ``n_steps`` steps on a card
    (``observe.profiling.profile_call``, ``observe.opcost.device_breakdown``)."""

    def window():
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(batch)
        _sync(_device(batch))
        return (time.perf_counter() - t0) / n_steps * 1e3

    traced_ms, events = profiling.profile_call(window, trace_path)
    r = opcost.device_breakdown(events)
    return {
        "traced_step_ms": traced_ms,
        "device_ms_by_family": {k: v / n_steps for k, v in r["device_ms_by_family"].items()},
        "top_kernels_ms": [(k, v / n_steps) for k, v in r["top_kernels_ms"]],
        "flash_kernels": flash_kernel_ms(events, n_steps),
        "kernels_per_step": r["kernels"] / n_steps,
        "busy_ms": r["busy_ms"] / n_steps,
        "idle_share": r["idle_share"],
        "host_wait_ms": {k: v / n_steps for k, v in r["host_wait_ms"].items()},
        "top_host_ops_ms": [(k, v / n_steps) for k, v in r["top_host_ops_ms"]],
    }


def _run_lm(name: str, cfg: GPT2Config, batch_size: int, seq: int, steps: int, warmup: int,
            device: torch.device, trace: str | None = None, policy: str = "none",
            remat: str | None = None) -> dict:
    model, step, tokens = build_lm(cfg, batch_size, seq, device, policy=policy, remat=remat)
    dt, metrics = _timed_steps(step, tokens, steps, warmup)
    extra = {}
    if trace is not None:
        if device.type != "cuda":
            raise ValueError("--trace reads device time: it needs a card")
        extra = _traced_steps(step, tokens, steps, trace)
        if policy == "none":  # the head's weight whole on the card (not an FSDP2 shard)
            extra["head_gemm_ms"] = _head_gemm_ms(model, batch_size * seq)
    return _roofline_guard({
        "config": name,
        "metric": "tokens_per_sec",
        "value": batch_size * seq * steps / dt,
        "unit": "tokens/sec",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "steps": steps,
        "step_ms": dt / steps * 1e3,
        "loss": float(metrics["loss"]),
        "policy": policy,
        "remat": remat or "none",
        "world_size": dist.world_size(),
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
        "tf32": tf32_settings(),
        **extra,
    }, model)


def run_config(i: int, tiny: bool, steps: int, warmup: int, device="cuda",
               trace: str | None = None, policy: str | None = None,
               remat: str | None = None) -> dict:
    device = resolve_device(device)
    if i == 4:
        policy = policy or "none"
        cfg = GPT2Config.tiny() if tiny else GPT2Config.gpt2_125m()
        if policy != "none":
            join_group(device)
        name = "4_gpt2_125m_one_gpu_flash" if policy == "none" else f"4_gpt2_125m_{policy}_flash"
        return _run_lm(name, cfg, 8, 32 if tiny else 512, steps, warmup, device, trace,
                       policy, remat)
    if i in IMAGE_RUNGS:
        return _run_image(i, tiny, steps, warmup, device, trace, policy, remat)
    raise ValueError(f"config {i} not in 1..5")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="the sharding policy (default: the rung's own; none, the plain "
                         "one-device step, for config 4, where zero3 with --remat full is "
                         "the JAX rung's layout)")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots", "names", "offload"],
                    help="activation rematerialisation of the loss (parallel.remat)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="also trace --steps steps into this Chrome trace and add the device "
                         "time by kernel family and the idle share (needs a card)")
    opt = ap.parse_args(argv)
    if opt.device.startswith("cuda"):  # full f32: cuBLAS and cuDNN (the convolutions)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        result = run_config(opt.config, opt.tiny, opt.steps, opt.warmup, opt.device, opt.trace,
                            opt.policy, opt.remat)
    finally:
        dist.shutdown()
    if dist.rank() == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
