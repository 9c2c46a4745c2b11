"""Elastic recovery drill: the launcher's own end-to-end exercise.

Counterpart of ``pytorch_distributedtraining_tpu/runtime/recovery_drill.py``
(train mode). Run under ``runtime/launch.py --elastic`` with a fault plan
that tears a checkpoint write and then kills rank 0, this script exercises
the whole recovery path end to end: async checkpointing with commit
markers, the launcher's shrink-to-survive (or retry) decision, and a
resharded resume from the newest COMMITTED step on the next generation's
world, reported step by step as a JSONL event stream (the first step after
the resume minus the last step before the kill is the time to recover).

With ``GRAFT_DRILL_GROW=1`` (and the launcher run with ``--grow``) it also
exercises grow-back: the shrunken generation trains slowly enough for the
launcher's capacity probes to fire, takes the graceful SIGTERM teardown
(the manager's handler forces a preemption save, agreed across ranks), and
the next generation resumes with ``GRAFT_RECOVERY_MODE=grow`` on the larger
world, where it proves the grow reshard BITWISE faithful: the grown
state, gathered whole (the module's state and every optimizer moment),
must equal the same committed step restored into a group-less state
(event ``grow_bitwise``).

The trainer is JAX's: ESPCN ``Net(upscale_factor=2)`` under ``ZeRO2`` with
the per-leaf AdamW (lr 1e-3, clip 1.0), on one seeded batch of eight 8x8
-> 16x16 images, checkpointed by ``CheckpointManager(save_every=1,
keep=10, handle_sigterm=True, async_save=True)``.

Topology, one change by design: JAX trains on rank 0 alone, over a local
virtual mesh of ``min(4, 2 * world)`` devices, and keeps the other ranks
as passive stdlib workers, because that image's CPU backend refuses
cross-process collectives. torch's gloo does not, so here EVERY rank
trains, in one group of ``WORLD_SIZE`` ranks (gloo on the CPU, NCCL on
cards), each on its contiguous slice of the batch (eight images over the
world: the world must divide 8). A shrink from 2 to 1 and a grow from 1
to 2 then reshard the ZeRO-2 moments through the portable format for
real. Rank 0 writes the events; they carry ``world``, not JAX's ``fsdp``.

Env contract (all inherited through the launcher):

- ``RANK`` / ``WORLD_SIZE`` / ``GRAFT_RESTART_ATTEMPT``: launcher contract.
- ``GRAFT_RECOVERY_MODE``: the launcher's retry/shrink/grow decision.
- ``GRAFT_DRILL_OUT``: JSONL event file (appended across generations).
- ``GRAFT_DRILL_CKPT``: checkpoint root shared across generations.
- ``GRAFT_DRILL_STEPS``: total train steps to reach (default 6).
- ``GRAFT_DRILL_GROW``: exercise grow-back (see above).
- ``GRAFT_DRILL_STEP_SLEEP_S``: per-step dawdle so the shrunken
  generation survives until the launcher's grow probes fire.
- ``GRAFT_DRILL_DEVICE``: ``cuda`` (the default: the process's card) or
  ``cpu``; a drill asked for ``cuda`` without a card fails.
- ``GRAFT_FAULT_PLAN``: the chaos schedule (``ckpt.write`` tear +
  ``train.preempt`` kill), consumed inside the checkpoint layer.

Events: ``step``, ``resume`` (with ``torn_dirs``, the staging dirs the
resume skipped), ``grow_bitwise``, ``preempt_exit``, ``done``, ``error``,
and ``skip`` where torch itself cannot be imported. The serve-failover
mode (``GRAFT_DRILL_MODE=serve_failover``) belongs to the serving fleet,
which is not ported yet, and raises.

    GRAFT_DRILL_OUT=events.jsonl GRAFT_DRILL_CKPT=ckpt python -m \\
        pytorch_distributedtraining_tpu_torch.runtime.launch --nproc_per_node 1 \\
        --elastic --max_restarts 1 pytorch_distributedtraining_tpu_torch/runtime/recovery_drill.py
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time


def _emit(path: str, **event) -> None:
    """Append one JSONL event; O_APPEND keeps generations from clobbering."""
    event.setdefault("t", time.time())
    line = json.dumps(event) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


BATCH = 8  # the global batch: eight 8x8 -> 16x16 images


def drill_batch(rank: int, world: int) -> tuple:
    """This rank's contiguous slice of JAX's seeded batch (numpy, NHWC)."""
    import numpy as np

    if BATCH % world:
        raise ValueError(f"the drill's batch of {BATCH} does not split over {world} ranks")
    rng = np.random.default_rng(0)
    hr = rng.random((BATCH, 16, 16, 3)).astype(np.float32)
    lo = hr.reshape(BATCH, 8, 2, 8, 2, 3).mean(axis=(2, 4))
    n = BATCH // world
    return lo[rank * n:(rank + 1) * n], hr[rank * n:(rank + 1) * n]


def make_state(device, with_group: bool):
    """The drill's train state: seeded ESPCN, per-leaf AdamW (lr 1e-3, clip
    1.0); under ``ZeRO2`` over the process group's mesh, or group-less."""
    import functools

    import torch

    from .. import optim
    from ..models import Net
    from ..parallel import ZeRO2, create_train_state
    from ..parallel.policy import Policy
    from .mesh import MeshSpec, make_mesh

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Net(upscale_factor=2)
    tx = functools.partial(optim.adamw, lr=1e-3, clip_grad_norm=1.0)
    if not with_group:
        return create_train_state(model, tx, None, Policy(), device=device)
    policy = ZeRO2(min_shard_size=1)
    return create_train_state(model, tx, make_mesh(MeshSpec.zero()), policy, device=device)


def _whole(state) -> dict:
    """The module's state and the optimizer's, gathered whole, on the host
    (the gather is a collective: every rank calls it)."""
    sd = state.tx.full_state_dict()
    out = {f"params/{k}": v.detach().cpu() for k, v in state.module.state_dict().items()}
    out["opt_state/count"] = int(sd["count"])
    for key in state.tx.STATE:
        for name, t in zip(sd["names"], sd[key] or []):
            out[f"opt_state/{key}/{name}"] = t.detach().cpu()
    return out


def bitwise_check(ckpt_root: str, step: int, state, device) -> list:
    """Prove the grow reshard changed no bits: restore the same committed
    step into a group-less state and compare every leaf of the resumed
    (grown, sharded) state, gathered whole, against it. Returns the
    differing leaf paths (empty = bitwise identical)."""
    import torch

    from ..checkpoint_sharded import reshard_restore

    got = _whole(state)
    ref_state = make_state(device, with_group=False)
    reshard_restore(os.path.join(ckpt_root, f"step_{step:010d}"), ref_state)
    want = _whole(ref_state)
    bad = []
    for key, a in got.items():
        b = want.get(key)
        if isinstance(a, int) or isinstance(b, int):
            same = a == b
        else:
            same = (b is not None and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b))
        if not same:
            bad.append(key)
    return bad + sorted(set(want) - set(got))


def _trainer_main(out: str, ckpt_root: str) -> int:
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    attempt = int(os.environ.get("GRAFT_RESTART_ATTEMPT", "0"))
    mode = os.environ.get("GRAFT_RECOVERY_MODE", "")
    total_steps = int(os.environ.get("GRAFT_DRILL_STEPS", "6"))
    step_sleep_s = float(os.environ.get("GRAFT_DRILL_STEP_SLEEP_S", "0"))
    grow_drill = os.environ.get("GRAFT_DRILL_GROW", "") == "1"
    device_name = os.environ.get("GRAFT_DRILL_DEVICE", "cuda")
    lead = rank == 0

    def emit(**event):
        if lead:
            _emit(out, **event)

    # a graceful teardown (grow, or a remote host's failure) arrives as
    # SIGTERM: the manager's handler (chained onto this one) forces the
    # preemption save, and this flag tells the loop to leave cleanly after
    # it instead of dawdling until the launcher escalates to SIGKILL
    sigterm_seen = {"flag": False}

    def _note_sigterm(signum, frame):
        sigterm_seen["flag"] = True

    signal.signal(signal.SIGTERM, _note_sigterm)

    try:
        import torch

        from .. import checkpoint_sharded
        from ..checkpoint_sharded import CheckpointManager
        from ..losses import mse_loss
        from ..parallel import TrainStep
        from . import dist
    except ImportError as e:
        emit(event="skip", attempt=attempt, reason=f"{type(e).__name__}: {e}"[:300])
        return 0

    torch.set_num_threads(1)
    device = dist.resolve_device(device_name)
    dist.initialize(device=device.type)
    try:
        state = make_state(device, with_group=True)

        def loss_fn(model, batch):
            lr_img, hr = batch
            return mse_loss(model(lr_img), hr), {}

        step_fn = TrainStep(state.model, loss_fn, state.tx, state.mesh, state.policy)
        batch = tuple(torch.from_numpy(a).to(device) for a in drill_batch(rank, world))

        mgr = CheckpointManager(ckpt_root, save_every=1, keep=10, handle_sigterm=True,
                                async_save=True)
        try:
            start = 0
            if attempt > 0:
                torn = sorted(d for d in os.listdir(ckpt_root) if d.endswith(".tmp"))
                resumed = mgr.restore_latest(state)
                if resumed is None:
                    emit(event="error", attempt=attempt,
                         detail="no committed checkpoint to resume from")
                    return 1
                start = resumed[0]
                emit(event="resume", step=start, attempt=attempt, world=world, mode=mode,
                     torn_dirs=torn)
                if grow_drill and mode == "grow":
                    # the grown world must carry EXACTLY the bits the
                    # checkpoint holds: compare against a group-less read
                    bad = bitwise_check(ckpt_root, start, state, device)
                    emit(event="grow_bitwise", step=start, attempt=attempt, world=world,
                         ok=not bad, differing=bad[:8])
                    if bad:
                        return 1

            for _ in range(start, total_steps):
                step_fn(batch)
                step = int(state.tx.count)
                forced = checkpoint_sharded.runtime_stats["forced_saves"]
                # train.preempt (kill) and ckpt.write (tear) both fire in
                # here, per the installed GRAFT_FAULT_PLAN
                mgr.maybe_save(step, state)
                emit(event="step", step=step, attempt=attempt, world=world)
                if sigterm_seen["flag"] or checkpoint_sharded.runtime_stats[
                        "forced_saves"] > forced:
                    # the preemption save above already committed on every
                    # rank (forced-save path); leave before the launcher
                    # has to escalate
                    mgr.wait()
                    emit(event="preempt_exit", step=step, attempt=attempt, world=world)
                    return 0
                if step_sleep_s > 0:
                    time.sleep(step_sleep_s)
            mgr.wait()
            committed = mgr.all_steps()
        finally:
            mgr.close()
        emit(event="done", step=total_steps, attempt=attempt, world=world, committed=committed)
        return 0
    finally:
        dist.shutdown()


def main() -> int:
    out = os.environ.get("GRAFT_DRILL_OUT")
    ckpt_root = os.environ.get("GRAFT_DRILL_CKPT")
    if not out or not ckpt_root:
        print("recovery_drill: GRAFT_DRILL_OUT and GRAFT_DRILL_CKPT required", file=sys.stderr)
        return 2
    if os.environ.get("GRAFT_DRILL_MODE") == "serve_failover":
        raise NotImplementedError(
            "the serve_failover drill (a replica fleet behind a router) comes with the serving "
            "fleet, which the port does not have yet")
    os.makedirs(ckpt_root, exist_ok=True)
    return _trainer_main(out, ckpt_root)


if __name__ == "__main__":
    # the launcher runs this file as a plain script (no -m), so the repo
    # root is not on sys.path: add it, and run the module under its package
    # name so its relative imports resolve
    _root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if _root not in sys.path:
        sys.path.insert(0, _root)
    from pytorch_distributedtraining_tpu_torch.runtime import recovery_drill

    sys.exit(recovery_drill.main())
