"""ESPCN super-resolution training under the ZeRO-2 layout, on one GPU or many.

Counterpart of ``drivers/fairscale_ddp.py`` (the reference's
``Fairscale-DDP.py``), structure for structure: datasets, a 0.99 split,
``DistributedSampler``s with ``num_replicas`` and rank from
``runtime.dist``, loaders, the probe batch, ``Net(upscale_factor=2)`` with
MSE, ``TrainStep`` under ``ZeRO2`` (Fairscale OSS + ShardedDDP) with the
per-leaf AdamW (lr 1e-3, betas (0.9, 0.99), eps 1e-8, weight decay 1e-4),
a loss print every 25 iterations and one line per epoch::

    python -m pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp \\
        --synthetic --epochs 1 --workers 2

    python -m pytorch_distributedtraining_tpu_torch.runtime.launch --nproc_per_node N \\
        pytorch_distributedtraining_tpu_torch/drivers/fairscale_ddp.py --synthetic

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp --synthetic

Under a launcher (the port's ``runtime.launch``, which runs the driver as
a file, or ``torch.distributed.run``) it joins the process group (NCCL on
the GPU, gloo with ``--device cpu``) and shards optimizer state and
gradients over the launcher's world (the JAX driver's ``WORLD_SIZE = 4``
becomes it); started by hand it trains one process, with the same update. ZeRO-2 is not a
layout for the flat ``FusedAdamW``, so the update is the per-leaf chain,
as in the JAX driver. The reference bugs that the JAX driver fixes stay
fixed: ``num_replicas`` is not hard-coded to 4, the sampler's epoch
advances (the loader sets it), and the computed rank is used.

``--ckpt DIR`` checkpoints the train state through
``checkpoint_sharded.CheckpointManager`` every ``--save-every`` steps
(keeping the last three, portable format, ``--ckpt-async`` to write in a
background thread) and at a SIGTERM, and resumes from the newest committed
checkpoint under ``DIR``, at this run's world size whatever the one that
saved it: the resume finishes the original ``--epochs`` schedule, skipping
the iterations the checkpoint already covers (one optimizer step an
iteration; the loader's epoch is set so the data order is the unbroken
run's). A resume under the port's launcher prints the launcher's
``GRAFT_RECOVERY_MODE`` (``retry``, ``shrink`` or ``grow``) beside the
step; with ``--max_restarts K`` (and ``--elastic`` to go on with the
survivors) the launcher relaunches a killed world onto the same ``--ckpt``::

    python -m pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp \
        --synthetic --ckpt ckpt/espcn --save-every 100

``--numerics [halt|rollback|degrade]`` (env twins ``GRAFT_NUMERICS``,
``GRAFT_NUMERICS_ACTION``) runs the numerics probe in the step and the
watchdog over it every step: ``halt`` raises ``NumericsDivergence`` on a
trip, ``rollback`` restores the newest committed ``--ckpt`` checkpoint
(the step stream too) and trains on from there, ``degrade`` sets
``GRAFT_WIRE=fp32`` for a relaunch. A step the probe finds non-finite is
not checkpointed. ``--trace [DIR]`` (``GRAFT_TRACE``; ``GRAFT_TELEMETRY=0``
turns it off) records the step, input and checkpoint spans and, at exit,
writes the Chrome trace under ``DIR`` (or the run dir) and prints the
goodput breakdown and the MFU (``observe.goodput``; ESPCN has no analytic
FLOP count, so its MFU is not given). ``--capture [DIR]``
(``GRAFT_CAPTURE``) arms the anomaly-triggered profiler capture
(``observe.capture``) on the step loop, polled after each step's numerics;
with ``--opcost`` (``GRAFT_OPCOST``) a landed capture is parsed into the op
table and the per-axis collective bandwidth (``observe.opcost``, with the
mesh's axes)::

    GRAFT_NUMERICS_INJECT="conv1.weight@3" python -m \
        pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp --synthetic \
        --epochs 2 --numerics rollback --ckpt ckpt/espcn --save-every 2 --trace

It runs on the GPU (``--device cuda``, the default) and refuses to start
without one unless ``--device cpu`` is given. When the data folders are
absent it trains on synthetic data. ``--remat`` (else ``$GRAFT_REMAT``,
else ``none``) is the step's activation-checkpointing policy,
``ZeRO2(remat=)``, as in JAX (ESPCN tags no activation, so ``names`` and
``offload`` recompute as ``full`` does); ``--device-prefetch N`` (default
2, 0 for none) is how many batches both loaders copy to the device ahead
of the step (``DataLoader(device_prefetch=)``). The JAX driver's flags
whose modules are not ported (``--pp``, ``--pp-schedule``, ``--wire``,
``--hier``, ``--plan``, ``--analyze``) are not defined.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    # run as a file (the launcher's way): the repository root is not on the
    # path, only this file's directory
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.checkpoint_sharded import CheckpointManager
from pytorch_distributedtraining_tpu_torch.data import (
    CustomDataset,
    DataLoader,
    DistributedSampler,
    SyntheticSRDataset,
    random_split,
)
from pytorch_distributedtraining_tpu_torch.drivers import observe_flags
from pytorch_distributedtraining_tpu_torch.losses import mse_loss
from pytorch_distributedtraining_tpu_torch.models import Net
from pytorch_distributedtraining_tpu_torch.observe import numerics
from pytorch_distributedtraining_tpu_torch.observe import trace as telemetry
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, ZeRO2, create_train_state
from pytorch_distributedtraining_tpu_torch.runtime import dist
from pytorch_distributedtraining_tpu_torch.runtime.mesh import MeshSpec, make_mesh, mesh_shape

# reference constants (Fairscale-DDP.py:57,118)
BATCH_SIZE = 40
EPOCHS = 2

# the reference's Flickr2K patch folders (Fairscale-DDP.py:32-33), relative
# to the working directory rather than on the reference authors' share
INPUT_PATH = "Dataset/Flickr2K/Patches/LRPatch_256/"
TARGET_PATH = "Dataset/Flickr2K/Patches/512/"



def _line(*parts) -> None:
    """``print(*parts)`` as one write: under a launcher every rank shares the
    output, and a line written in pieces can interleave with another rank's."""
    sys.stdout.write(" ".join(str(p) for p in parts) + "\n")
    sys.stdout.flush()

def build_model(seed: int = 0) -> Net:
    """``Net(upscale_factor=2)`` with weights from ``seed`` (the global RNG
    is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Net(upscale_factor=2)


def loss_fn(model: Net, batch):
    inputs, targets = batch
    return mse_loss(model(inputs), targets), {}


def train(opt: argparse.Namespace, model: Net | None = None) -> float | None:
    """Train ``model`` (default: ``build_model()``) for ``opt.epochs`` epochs
    on ``opt.device``, over the launcher's world when there is one; returns
    the last step's loss."""
    device = dist.resolve_device(opt.device)
    joined = not dist.is_initialized()
    dist.initialize(device=device.type)  # a no-op when started by hand on one device
    try:
        return _train(opt, device, model)
    finally:
        if joined:
            dist.shutdown()


def _train(opt: argparse.Namespace, device: torch.device, model: Net | None) -> float | None:

    print("===> Loading datasets")
    print("--Input Directory--", opt.input_dir)
    if opt.synthetic or not os.path.isdir(opt.input_dir):
        if not opt.synthetic:
            print("(dataset dirs absent -> synthetic SR data)")
        full_dataset = SyntheticSRDataset(n=opt.synthetic_n, lr_size=32, scale=2)
    else:
        full_dataset = CustomDataset(opt.input_dir, opt.target_dir)

    train_size = int(0.99 * len(full_dataset))
    test_size = len(full_dataset) - train_size
    train_dataset, val_dataset = random_split(full_dataset, [train_size, test_size])

    # fixed: num_replicas and rank from the runtime, not hardcoded 4 (:47,53)
    train_sampler = DistributedSampler(train_dataset, num_replicas=dist.world_size(),
                                       rank=dist.rank())
    val_sampler = DistributedSampler(val_dataset, num_replicas=dist.world_size(),
                                     rank=dist.rank())

    # persistent workers: the probe batch's half-read epoch is reset, not
    # torn down mid-flight, and the epochs reuse the same processes
    context = "spawn" if opt.workers > 0 else None
    # --device-prefetch batches staged on the device ahead of the step, so
    # the copy overlaps the running step
    training_dataloader = DataLoader(
        train_dataset, batch_size=opt.batch_size, sampler=train_sampler,
        num_workers=opt.workers, drop_last=True, device=device,
        persistent_workers=True, multiprocessing_context=context,
        device_prefetch=opt.device_prefetch,
    )
    # built as the reference builds it; the loop below never reads it
    DataLoader(val_dataset, batch_size=opt.batch_size, sampler=val_sampler,
               num_workers=min(8, opt.workers), drop_last=True, device=device,
               multiprocessing_context=context, device_prefetch=opt.device_prefetch)

    try:
        # probe batch (Fairscale-DDP.py:67-71)
        x, y = next(iter(training_dataloader))
        _line("Length of Training dataset - ", len(train_dataset))
        _line("--Shape--", tuple(x.shape), tuple(y.shape))

        print("===> Building model")
        # OSS(AdamW) + ShardedDDP (:78-89): ZeRO-2 over the world's ranks;
        # --remat/$GRAFT_REMAT picks the activation-checkpointing policy
        remat = opt.remat if opt.remat is not None else os.environ.get("GRAFT_REMAT", "none")
        policy = ZeRO2(remat=remat)
        mesh = make_mesh(MeshSpec.zero()) if dist.is_initialized() else None
        tx = functools.partial(optim.adamw, lr=1e-3, betas=(0.9, 0.99), eps=1e-8,
                               weight_decay=1e-4)
        state = create_train_state(build_model() if model is None else model, tx, mesh,
                                   policy, device=device)
        # --numerics: the probe in the step, the watchdog over its aux
        probe = numerics.probe_from_env()
        watchdog = numerics.watchdog_from_env() if probe is not None else None
        step = TrainStep(state.model, loss_fn, state.tx, mesh, policy, rng=state.rng,
                         numerics=probe)
        # --capture: the anomaly-triggered profiler on this loop
        capture = observe_flags.armed_capture(
            None if mesh is None else mesh_shape(mesh), device.type)

        mgr, start_step = None, 0
        if opt.ckpt:
            mgr = CheckpointManager(opt.ckpt, save_every=opt.save_every, keep=3,
                                    async_save=opt.ckpt_async)
            resumed = mgr.restore_latest(state)
            if resumed is not None:
                start_step = resumed[0]
                mode = os.environ.get("GRAFT_RECOVERY_MODE", "")
                _line(f"===> Resumed from checkpoint @ step {start_step}"
                      + (f" (recovery_mode={mode})" if mode else ""))
        # a resume finishes the original schedule: the epochs and iterations
        # the checkpoint covers are skipped, not trained again
        steps_per_epoch = len(training_dataloader)
        start_epoch, skip = divmod(start_step, steps_per_epoch) if steps_per_epoch else (0, 0)
        if start_epoch >= opt.epochs:
            _line(f"===> Checkpoint step {start_step} already covers the {opt.epochs}-epoch "
                  "schedule; nothing left to train")
        training_dataloader.set_epoch(training_dataloader.epoch + start_epoch)

        loss, global_step, taken = None, start_step, 0
        try:
            for e in range(start_epoch, opt.epochs):
                for iteration, batch in enumerate(training_dataloader, 1):
                    if e == start_epoch and iteration <= skip:
                        continue
                    metrics = step(batch)
                    loss = metrics["loss"]
                    global_step += 1
                    taken += 1
                    clean = True
                    if probe is not None:
                        summary = probe.observe(metrics["numerics"], step=global_step,
                                                loss=loss, watchdog=watchdog)
                        # a non-finite step poisoned the parameters: saving it
                        # would make the rollback target divergent itself
                        clean = not summary["nonfinite"]
                        verdict = summary.get("verdict")
                        if verdict is not None:
                            rolled = watchdog.apply_action(verdict, manager=mgr, template=state)
                            if rolled is not None:
                                global_step = rolled[0]
                                _line(f"===> numerics watchdog {verdict['kind']} @ step "
                                      f"{verdict['step']}: rolled back to committed step "
                                      f"{global_step}")
                    if capture is not None:
                        capture.note_step()
                    if mgr is not None and clean:
                        mgr.maybe_save(global_step, state)
                    if iteration % 25 == 0:
                        print(float(loss))
                if loss is not None:
                    _line("For Epoch {}, loss: {:.2f}".format(e, float(loss)))
        finally:
            if mgr is not None:
                mgr.close()
    finally:
        training_dataloader.shutdown_workers()
    if telemetry.enabled():
        observe_flags.report(opt.trace, taken, None, device)
    return None if loss is None else float(loss)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ZeRO-2 SR training")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    parser.add_argument("--input-dir", type=str, default=INPUT_PATH)
    parser.add_argument("--target-dir", type=str, default=TARGET_PATH)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--device-prefetch", type=int, default=2,
                        help="batches staged on the device ahead of the step (0 = none)")
    parser.add_argument("--remat", type=str, default=None,
                        help="activation remat policy for the step: none/full/dots/names/"
                             "offload (default: $GRAFT_REMAT or none)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic SR data (no dataset needed)")
    parser.add_argument("--synthetic-n", type=int, default=512)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="train on the GPU (default; fails without one) or the CPU")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint root dir: save every --save-every steps (and at a "
                             "SIGTERM), resume from the newest committed checkpoint there")
    parser.add_argument("--ckpt-async", action="store_true",
                        help="write checkpoints in a background thread (the step pays only "
                             "the copy to host memory)")
    parser.add_argument("--save-every", type=int, default=100,
                        help="checkpoint cadence in steps (with --ckpt)")
    observe_flags.add_arguments(parser)
    return parser


def main(argv=None, model: Net | None = None) -> float | None:
    opt = build_parser().parse_args(argv)
    observe_flags.apply(opt)
    return train(opt, model)


if __name__ == "__main__":
    main()

