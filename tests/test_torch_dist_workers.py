"""Rank workers for the port's multi-process tests, and the launcher that
runs them over gloo.

No test lives here: the functions below run inside ranks that
``torch.multiprocessing`` starts with the ``spawn`` method, which import
this module by name. It imports torch, numpy and the port only, never
JAX, so a rank starts in seconds. :func:`run_ranks` gives the rendezvous,
every rank and the join a timeout, and returns each rank's result (or
raises with the failing rank's traceback).
"""

from __future__ import annotations

import functools
import os
import queue
import traceback
from pathlib import Path

import numpy as np
import torch

from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.runtime import dist

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2),
           embed_dim=12, num_heads=(2, 2), mlp_ratio=2.0)
RANK_TIMEOUT_S = 120.0


def _entry(rank: int, world: int, port: int, device: str, fn, kwargs: dict, results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        dist.initialize(device=device, timeout_s=60)
        results.put((rank, True, fn(rank, world, **kwargs)))
    except Exception:  # the parent reports it
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.shutdown()


def run_ranks(fn, world: int, timeout_s: float = RANK_TIMEOUT_S, group_device: str = "cpu",
              **kwargs) -> list:
    """``fn(rank, world, **kwargs)`` on ``world`` spawned ranks (gloo, or
    NCCL with ``group_device="cuda"``); returns the results in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = dist.find_free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, group_device, fn, kwargs, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = results.get(timeout=timeout_s)
            (out.__setitem__(rank, value) if ok else errors.append(f"rank {rank}:\n{value}"))
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(out))} gave no result in "
                      f"{timeout_s} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]


def toy_swinir(state: dict | None = None, toy: dict = TOY) -> SwinIR:
    """The toy SwinIR of ``tests/test_torch_swinir.py`` (or ``toy``), weights
    from seed 0 or from ``state`` (numpy arrays by name)."""
    model = SwinIR(**toy, generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=False)
    return model


def sr_batches(steps: int, n: int = 8, seed: int = 0) -> list:
    """``steps`` global batches of ``n`` (LR 8x8, HR 16x16) NHWC images:
    random HR from numpy ``seed``, box-downsampled LR."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        hr = rng.random((n, 16, 16, 3)).astype(np.float32)
        out.append((hr.reshape(n, 8, 2, 8, 2, 3).mean(axis=(2, 4)), hr))
    return out


def named_numpy(model) -> dict:
    return {n: p.detach().float().cpu().numpy().copy() for n, p in model.named_parameters()}


def mse_loss_fn(model, batch):
    x, y = batch
    return torch.mean((model(x) - y) ** 2), {}


POLICIES = {"none": None, "ddp": "DDP", "zero1": "ZeRO1", "zero2": "ZeRO2", "zero3": "ZeRO3"}


def make_tx(name: str, **kw):
    if name == "fused":
        return functools.partial(optim.FusedAdamW, **kw)
    return functools.partial(optim.adamw, **kw)


def train_step_worker(rank: int, world: int, *, policy: str, opt: str, batches: list,
                      state: dict | None = None, toy: dict = TOY, accum: int = 2,
                      remat=None, lr: float = 1e-3, clip: float | None = 0.1,
                      device: str = "cpu") -> dict:
    """``TrainStep`` on a toy SwinIR under ``policy`` at this world: rank r
    takes rows ``r::world`` of each global batch (``DistributedSampler``'s
    unshuffled order). Returns losses, grad norms and the final parameters."""
    from pytorch_distributedtraining_tpu_torch import parallel
    from pytorch_distributedtraining_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    if device == "cuda":  # the same arithmetic in every process: no TF32, fixed algorithms
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    pol = getattr(parallel, POLICIES[policy])() if POLICIES[policy] else None
    mesh = make_mesh(MeshSpec.zero() if policy.startswith("zero") else MeshSpec.ddp()) \
        if pol is not None else None
    tx = make_tx(opt, lr=lr, betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4,
                 clip_grad_norm=clip)
    st = parallel.create_train_state(toy_swinir(state, toy), tx, mesh, pol, device=device)
    step = parallel.TrainStep(st.model, mse_loss_fn, st.tx, mesh, pol, grad_accum_steps=accum,
                              remat=remat)
    losses, norms = [], []
    for x, y in batches:
        m = step((torch.from_numpy(x[rank::world]).to(device),
                  torch.from_numpy(y[rank::world]).to(device)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    bound = None
    if opt == "fused":  # every parameter and grad still a view of the flat buffers
        bound = all(_inside(p, st.tx.flat_param) and _inside(p.grad, st.tx.flat_grad)
                    for p in st.module.parameters())
    return {"losses": losses, "norms": norms, "params": full_params(st.module),
            "views_bound": bound, "backend": dist.backend()}


def _inside(t, flat) -> bool:
    start = flat.data_ptr()
    end = start + flat.numel() * flat.element_size()
    return start <= t.data_ptr() < end


def full_params(module) -> dict:
    """Every parameter whole (FSDP2 shards gathered: a collective), as numpy."""
    out = {}
    for n, p in module.named_parameters():
        full = p.full_tensor() if hasattr(p, "full_tensor") else p
        out[n] = full.detach().float().cpu().numpy().copy()
    return out


FACADE_OPT = {"lr": 1e-3, "betas": (0.9, 0.99), "eps": 1e-8, "weight_decay": 1e-4}


def facade(model, oss=True, sddp=True, fsdp=False, batch=4, **extra):
    """The Stoke facade as ``drivers/stoke_ddp.py`` builds it (``feat_loss``,
    AdamW, clip 0.1, accum 2, ``broadcast_fp16``), on the CPU."""
    from pytorch_distributedtraining_tpu_torch import losses, stoke

    return stoke.Stoke(
        model=model, optimizer=stoke.StokeOptimizer("AdamW", dict(FACADE_OPT)),
        loss=losses.FeatLoss(), batch_size_per_device=batch, gpu=True,
        distributed="ddp", fairscale_oss=oss, fairscale_sddp=sddp, fairscale_fsdp=fsdp,
        grad_accum_steps=2,
        configs=[stoke.AMPConfig(init_scale=2.0**14), stoke.DDPConfig(local_rank=None),
                 stoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=stoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0), device="cpu",
        **extra)


def facade_worker(rank: int, world: int, *, micro: list, lrs: list, state: dict | None = None,
                  layouts: list[dict] = ({},), save_dir: str | None = None) -> list[dict]:
    """The facade at this world under each of ``layouts`` (``facade``
    flags): micro-batch i (rows ``r::world`` of the global one) at
    ``lrs[i // 2]``. Returns per layout the losses averaged over ranks
    (``detach_and_sync_loss``), the whole parameters, and, for the first
    layout with ``save_dir``, the checkpoint path and how many files this
    rank wrote."""
    from pytorch_distributedtraining_tpu_torch import checkpoint

    out = []
    for flags in layouts:
        s = facade(toy_swinir(state), **flags)
        losses = []
        for i, (x, y) in enumerate(micro):
            s.optimizer.lr = lrs[i // 2]
            loss = s.loss(s.model(x[rank::world]), y[rank::world])
            s.backward(loss)
            s.step()
            losses.append(float(s.detach_and_sync_loss(loss)))
        result = {"losses": losses, "params": full_params(s.model_access),
                  "opt": type(s._opt).__name__, "wire": str(s._opt.update_wire_dtype)}
        if save_dir is not None and not out:
            written, save = [], checkpoint.save_checkpoint

            def counting(*args, **kwargs):
                written.append(args)
                return save(*args, **kwargs)

            checkpoint.save_checkpoint = counting
            try:
                result["path"], _ = s.save(save_dir, "world")
            finally:
                checkpoint.save_checkpoint = save
            result["written"] = len(written)
        out.append(result)
    return out


def train_steps_worker(rank: int, world: int, *, runs: list[dict], **common) -> list[dict]:
    """:func:`train_step_worker` for each of ``runs`` (keyword sets) in one
    launch of the ranks."""
    return [train_step_worker(rank, world, **common, **run) for run in runs]


def world_worker(rank: int, world: int, *, batch: tuple) -> dict:
    """``FusedAdamW`` over the world's group on the toy (the error it raises,
    or "" when it shards), and ``EvalStep``'s MSE of the toy on rows
    ``r::world`` of ``batch`` under a ZeRO mesh."""
    from pytorch_distributedtraining_tpu_torch.parallel import EvalStep
    from pytorch_distributedtraining_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    error = ""
    try:
        optim.FusedAdamW(toy_swinir().named_parameters(),
                         shard_group=torch.distributed.group.WORLD)
    except ValueError as e:
        error = str(e)
    step = EvalStep(toy_swinir(), lambda m, b: {"mse": mse_loss_fn(m, b)[0]},
                    make_mesh(MeshSpec.zero()))
    x, y = (torch.from_numpy(a[rank::world]) for a in batch)
    return {"error": error, "mse": float(step((x, y))["mse"])}


def gpt2_worker(rank: int, world: int, *, policy: str, remat: str, steps: int) -> dict:
    """The ladder's LM step on the tiny GPT-2 (seq 32, batch 8 a rank,
    tokens from seed 0 plus the rank) under ``policy`` and ``remat``:
    losses, the whole parameters, and the parameters of vocabulary shape."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config

    cfg = GPT2Config.tiny()
    model, step, tokens = ladder.build_lm(cfg, 8, 32, torch.device("cpu"), policy=policy,
                                          remat=remat)
    losses = [float(step(tokens)["loss"]) for _ in range(steps)]
    vocab = [n for n, p in model.named_parameters() if tuple(p.shape) == (cfg.vocab_size,
                                                                          cfg.n_embd)]
    return {"losses": losses, "params": full_params(model), "vocab_params": vocab}


# the tiny image models of tests/test_torch_resnet.py and test_torch_vit.py
TINY_RESNET = dict(stage_sizes=(1, 1), num_classes=10, num_filters=8, small_inputs=True)


def tiny_image_model(kind: str, state: dict | None = None):
    """The tiny CIFAR ResNet (Basic blocks) or ``ViTConfig.tiny()``, weights
    from seed 0 or from ``state`` (numpy arrays by state-dict name)."""
    from pytorch_distributedtraining_tpu_torch.models import ResNet, ViT, ViTConfig

    gen = torch.Generator().manual_seed(0)
    model = ResNet(**TINY_RESNET, generator=gen) if kind == "resnet" else ViT(
        ViTConfig.tiny(), generator=gen)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def image_steps_worker(rank: int, world: int, *, runs: list[dict], batches: list,
                       states: dict) -> list[dict]:
    """``TrainStep`` with softmax cross entropy (clip 1.0, lr 1e-3) on a
    tiny image model for each of ``runs`` (``kind``, ``policy``, ``opt``,
    ``accum``): rank r takes rows ``r::world`` of each global batch. Returns
    per run the losses, the whole parameters and the buffers (BatchNorm
    running statistics)."""
    from pytorch_distributedtraining_tpu_torch import parallel
    from pytorch_distributedtraining_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    out = []
    for run in runs:
        pol = getattr(parallel, POLICIES[run["policy"]])(min_shard_size=1)
        mesh = make_mesh(MeshSpec.zero() if pol.shard_opt_state else MeshSpec.ddp())
        tx = make_tx(run["opt"], lr=1e-3, clip_grad_norm=1.0)
        st = parallel.create_train_state(tiny_image_model(run["kind"], states[run["kind"]]), tx,
                                         mesh, pol, device="cpu")

        def loss_fn(model, batch):
            return torch.nn.functional.cross_entropy(model(batch[0]), batch[1].long()), {}

        step = parallel.TrainStep(st.model, loss_fn, st.tx, mesh, pol,
                                  grad_accum_steps=run["accum"])
        losses = [float(step((torch.from_numpy(x[rank::world]),
                              torch.from_numpy(y[rank::world])))["loss"]) for x, y in batches]
        out.append({"losses": losses, "params": full_params(st.module),
                    "buffers": {n: b.numpy().copy() for n, b in st.module.named_buffers()},
                    "opt": type(st.tx).__name__, "wrapped": type(st.model).__name__})
    return out


def _moments(opt) -> dict:
    """Every optimizer moment whole, by parameter name (a collective when
    sharded): ``{"mu/<name>": array, "nu/<name>": array, "count": n}``."""
    sd = (opt.leaf_state_dict() if isinstance(opt, optim.FusedAdamW) else
          opt.full_state_dict())
    out = {"count": int(sd["count"])}
    for key in ("mu", "nu"):
        vals = sd[key]
        items = vals.items() if isinstance(vals, dict) else zip(opt.names, vals)
        out.update({f"{key}/{n}": v.detach().float().cpu().numpy().copy() for n, v in items})
    return out


def _facade_steps(s, micro: list, rank: int, world: int) -> list[float]:
    losses = []
    for x, y in micro:
        loss = s.loss(s.model(x[rank::world]), y[rank::world])
        s.backward(loss)
        s.step()
        losses.append(float(s.detach_and_sync_loss(loss)))
    return losses


def resume_worker(rank: int, world: int, *, micro: list, layouts: dict, save_dir: str,
                  split: int, reshard_from: str | None = None,
                  reshard_into: dict | None = None) -> dict:
    """At this world, for each ``layouts`` entry (``facade`` flags): the
    facade run through ``micro`` unbroken, and the same run saved after
    micro-batch ``split`` (``Stoke.save`` and ``Stoke.save_portable``),
    loaded into a fresh facade each way and run to the end. Returns per
    layout the losses, whole parameters and whole moments of the three
    runs, and the paths written. Then, with ``reshard_from`` (a layout
    name) and ``reshard_into`` (flags), the portable checkpoint of that
    layout is restored into a fresh facade of those flags, whose whole
    moments and parameters are returned under ``"resharded"``."""
    out = {}
    for name, flags in layouts.items():
        a = facade(toy_swinir(), **flags)
        unbroken = _facade_steps(a, micro, rank, world)
        b = facade(toy_swinir(), **flags)
        first = _facade_steps(b, micro[:split], rank, world)
        pt, _ = b.save(save_dir, f"{name}_w{world}")
        portable = b.save_portable(os.path.join(save_dir, f"{name}_w{world}_portable"))
        runs = {"unbroken": (unbroken, a)}
        for kind in ("pt", "portable"):
            c = facade(toy_swinir(), **flags)
            c.load(pt) if kind == "pt" else c.load_resharded(portable)
            runs[kind] = (first + _facade_steps(c, micro[split:], rank, world), c)
        out[name] = {k: {"losses": losses, "params": full_params(s.model_access),
                         "moments": _moments(s._opt), "opt": type(s._opt).__name__,
                         "step": s.step_count}
                     for k, (losses, s) in runs.items()}
        out[name]["paths"] = {"pt": pt, "portable": portable}
        out[name]["saved"] = {"moments": _moments(b._opt), "params": full_params(b.model_access)}
    if reshard_from is not None:
        s = facade(toy_swinir(), **reshard_into)
        s.load_resharded(out[reshard_from]["paths"]["portable"])
        out["resharded"] = {"moments": _moments(s._opt), "params": full_params(s.model_access),
                            "opt": type(s._opt).__name__, "step": s.step_count}
    return out


def espcn_driver_worker(rank: int, world: int, *, argv: list, ckpts: list) -> list:
    """The ESPCN driver's ``main(argv)`` in this rank of the group, once for
    each of ``ckpts`` (``--ckpt`` that dir, or none for None): the last
    loss of each run."""
    from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp

    return [fairscale_ddp.main(argv + (["--ckpt", c] if c else [])) for c in ckpts]


def numerics_worker(rank: int, world: int, *, runs: list[dict], batches: list,
                    inject: str | None = None) -> list[list[dict]]:
    """For each run (``policy``: none, zero2, zero3) a toy SwinIR through
    ``TrainStep(numerics=NumericsProbe(inject=...))`` with the per-leaf
    AdamW: each step's probe summary, decoded on this rank (rank r takes
    rows ``r::world`` of each global batch)."""
    from pytorch_distributedtraining_tpu_torch import parallel
    from pytorch_distributedtraining_tpu_torch.observe import numerics
    from pytorch_distributedtraining_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    out = []
    for run in runs:
        policy = run["policy"]
        pol = getattr(parallel, POLICIES[policy])() if POLICIES[policy] else None
        mesh = make_mesh(MeshSpec.zero()) if pol is not None else None
        st = parallel.create_train_state(toy_swinir(), make_tx("adamw", lr=1e-3,
                                                               clip_grad_norm=0.1),
                                         mesh, pol, device="cpu")
        probe = numerics.NumericsProbe(inject=inject or "")
        step = parallel.TrainStep(st.model, mse_loss_fn, st.tx, mesh, pol, rng=st.rng,
                                  numerics=probe)
        summaries = []
        for x, y in batches:
            m = step((torch.from_numpy(x[rank::world]), torch.from_numpy(y[rank::world])))
            summaries.append(probe.observe(m["numerics"], step=step.rng.step, loss=m["loss"]))
        out.append(summaries)
    return out


def comms_worker(rank: int, world: int, *, batch: tuple, policies: list[str], capture_dir: str,
                 inject: str) -> dict:
    """For each of ``policies``: one traced ``TrainStep`` of the toy SwinIR
    with the per-leaf AdamW (``trace_comms``: its collectives) and its
    ``comm_cost``, with every parameter's full shape. Then the facade (the
    driver's flags) with the capture armed and the op-cost plane on
    (``GRAFT_CAPTURE``/``GRAFT_OPCOST``) over two seeded steps, the first
    poisoned by ``GRAFT_NUMERICS_INJECT``: the capture's summary and its
    ingested table."""
    from pytorch_distributedtraining_tpu_torch import parallel
    from pytorch_distributedtraining_tpu_torch.observe import capture, opcost
    from pytorch_distributedtraining_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    x, y = (torch.from_numpy(a[rank::world]) for a in batch)
    out = {}
    for policy in policies:
        pol = getattr(parallel, POLICIES[policy])()
        mesh = make_mesh(MeshSpec.zero() if policy.startswith("zero") else MeshSpec.ddp())
        st = parallel.create_train_state(toy_swinir(), make_tx("adamw", lr=1e-3), mesh, pol,
                                         device="cpu")
        step = parallel.TrainStep(st.model, mse_loss_fn, st.tx, mesh, pol)
        step((x, y))  # DDP's first step builds its buckets
        wires = step.trace_comms((x, y))
        shapes = {n: tuple(p.shape) for n, p in st.module.named_parameters()}
        out[policy] = {"wires": [(w.kind, w.dtype, w.elems, w.in_elems, w.group_size)
                                 for w in wires],
                       "comm_cost": step.comm_cost(), "shapes": shapes}
    env = {"GRAFT_CAPTURE": capture_dir, "GRAFT_OPCOST": "1", "GRAFT_NUMERICS": "1",
           "GRAFT_NUMERICS_ACTION": "rollback", "GRAFT_NUMERICS_INJECT": inject}
    os.environ.update(env)
    try:
        capture.reset()
        opcost.reset()
        s = facade(toy_swinir(), oss=False, sddp=False, batch=2)
        for _ in range(2 * 5):  # five optimizer steps of two micro-batches
            s.backward(s.loss(s.model(x), y))
            s.step()
        result = s.opcost_result
        out["facade"] = {
            "summary": s.capture.summary(),
            "tables_built": opcost.runtime_stats["tables_built"],
            "table": None if result is None else result["table"],
            "wires": None if result is None else [(w.kind, w.elems) for w in result["wires"]],
            "bandwidth": None if result is None else result["bandwidth"]}
    finally:
        for k in env:
            os.environ.pop(k, None)
    return out


def allreduce_worker(rank: int, out_dir: str) -> None:
    """A rank started by ``runtime.launch.spawn``: joins the gloo group from
    the env contract, all-reduces ``rank + 1`` and writes the sum, the world
    size and whether the launcher hid the cards to ``out_dir/rank<r>``."""
    torch.set_num_threads(1)
    dist.initialize(device="cpu")
    try:
        t = torch.tensor([rank + 1.0])
        torch.distributed.all_reduce(t)
        hidden = "cpu-only" if os.environ.get("CUDA_VISIBLE_DEVICES") == "" else "sees cards"
        with open(os.path.join(out_dir, f"rank{rank}"), "w") as fh:
            fh.write(f"{t.item()} {dist.world_size()} {hidden}")
    finally:
        dist.shutdown()


def rendezvous_worker(rank: int, out_dir: str, half_made: bool) -> None:
    """A rank started by ``runtime.launch.spawn`` that joins through
    ``dist.initialize``'s retry. With ``half_made`` the first
    ``init_process_group`` forms the group and then raises torch's
    refused-connection error, as a failure after the group registered
    would; the retry must start clean. Then it all-reduces, trips the
    ``collective.barrier`` site if the plan has one, and writes what it saw
    to ``out_dir/rank<r>.json``."""
    import json

    import torch.distributed as tdist

    from pytorch_distributedtraining_tpu_torch.resilience import faults

    torch.set_num_threads(1)
    calls = []
    real = tdist.init_process_group

    def flaky(*args, **kwargs):
        calls.append(tdist.is_initialized())
        real(*args, **kwargs)
        if half_made and len(calls) == 1:
            raise tdist.DistNetworkError("The client socket has timed out after 1000ms while "
                                         "trying to connect to (127.0.0.1, 1).")

    tdist.init_process_group = flaky
    try:
        dist.initialize(device="cpu")
    finally:
        tdist.init_process_group = real
    try:
        t = torch.tensor([rank + 1.0])
        tdist.all_reduce(t)
        barrier = None
        try:
            dist.coordination_barrier("after-join", timeout_s=30)
        except faults.InjectedFault as e:
            barrier = str(e)
        plan = faults.active_plan()
        hits = {site: [r.hits for r in plan.rules_for(site)] for site in
                ("dist.rendezvous", "collective.barrier")} if plan else {}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump({"sum": t.item(), "calls": calls, "hits": hits, "barrier": barrier}, fh)
    finally:
        dist.shutdown()


LAUNCH_CONTRACT = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                   "GRAFT_FAULT_PLAN", "GRAFT_RECOVERY_MODE", "GRAFT_RUN_DIR")


def launcher_env(tmp, **extra) -> dict:
    """The environment of a launcher run in a test: this process's, without
    a rank contract, a fault plan, a recovery mode or a run dir it may
    carry, with the repo on the path, ``tmp`` as the temp directory (the
    launcher's default run dir lands there), one thread a rank and a 0.1 s
    restart backoff; then ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_CONTRACT}
    env.update(PYTHONPATH=str(Path(__file__).resolve().parents[1]), TMPDIR=str(tmp),
               OMP_NUM_THREADS="1", GRAFT_RESTART_BACKOFF="0.1", **extra)
    return env
