"""SwinIR-S x2 training through the Stoke facade, on one GPU or many.

Counterpart of ``drivers/stoke_ddp.py``: the same functions (``train_log``,
``val_log``, ``train``, ``validate``, ``save_checkpoint``, ``main``) and the
reference CLI flag for flag, plus ``--synthetic``, ``--synthetic-n``,
``--pretrained``, ``--fp16`` and ``--device``::

    python -m pytorch_distributedtraining_tpu_torch.drivers.stoke_ddp \\
        --synthetic --nEpochs 1 --batchSize 18 --threads 2

On N GPUs, one process each (NCCL; ``--device cpu`` for gloo ranks),
under the port's launcher, which runs the driver as a file as the
reference's ``torch.distributed.launch`` line does, or under
``torch.distributed.run``::

    python -m pytorch_distributedtraining_tpu_torch.runtime.launch --nproc_per_node N \\
        pytorch_distributedtraining_tpu_torch/drivers/stoke_ddp.py --synthetic

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m pytorch_distributedtraining_tpu_torch.drivers.stoke_ddp --synthetic

The launcher's ``--max_restarts K`` relaunches a failed world (with
``--portable-ckpt`` the relaunch resumes from the newest committed epoch),
``--elastic`` relaunches with the survivors, and on the CPU
``--one_cpu_device_per_rank`` hides the cards from ranks started with
``--device cpu``.

The facade's flags are the reference's, DDP with Fairscale OSS and
ShardedDDP (ZeRO-2) and ``broadcast_fp16``; each rank trains on its own
shard of the data, the facade's loader copies two batches ahead to the
device (``$GRAFT_DEVICE_PREFETCH``), and rank 0 writes the checkpoints.
``--remat`` checkpoints each Swin layer under a named policy, as the JAX
driver's does.

``--portable-ckpt DIR`` also writes the whole train state each epoch as a
portable checkpoint ``DIR/epoch_NNNN`` (``Stoke.save_portable``, with the
epoch and both schedulers' state), and at start resumes from the newest
committed one there, resharded onto this run's process group and policy
whatever world size wrote it (``Stoke.load_resharded``), then trains the
epochs after it::

    python -m pytorch_distributedtraining_tpu_torch.drivers.stoke_ddp \
        --synthetic --nEpochs 10 --portable-ckpt ckpt/swinir

``--numerics [halt|rollback|degrade]`` and ``--trace [DIR]`` thread the
facade's numerics plane and telemetry through their env twins
(``GRAFT_NUMERICS``/``GRAFT_NUMERICS_ACTION``, ``GRAFT_TELEMETRY``/
``GRAFT_TRACE``), as the JAX driver does: the facade probes each
optimizer step's gradients and a ``halt`` verdict raises
``NumericsDivergence``; at exit the Chrome trace is written and the
goodput breakdown and MFU (SwinIR's analytic FLOPs at the training crops'
size, ``observe.goodput``) printed.

``--kernel-launches`` prints, after each epoch, each rank's launches of
the port's kernels so far (one ``[kernels] {json}`` line);
``--deterministic`` asks cuDNN for its deterministic algorithms, so a
resume reproduces the unbroken run.
``--capture [DIR]`` and ``--opcost`` thread the anomaly-triggered
capture and the op-cost plane through ``GRAFT_CAPTURE`` and
``GRAFT_OPCOST``: the facade arms an ``observe.capture.OnDemandProfiler``
at construction, polled after each optimizer step's numerics, and a
landed capture is parsed into the op table and the per-axis collective
bandwidth (``observe.opcost``).

It runs on the GPU (``--device cuda``, the default) and refuses to start
without one unless ``--device cpu`` is given. The TPU-only flags of the
JAX driver (``--scan-layers``, ``--pp``, ``--wire``,
``--fp8``, ``--plan``, ``--analyze``) are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    # run as a file (the launcher's way): the repository root is not on the
    # path, only this file's directory
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from pytorch_distributedtraining_tpu_torch import metrics
from pytorch_distributedtraining_tpu_torch.checkpoint_sharded import is_committed_dir
from pytorch_distributedtraining_tpu_torch.data import (
    CustomDataset,
    DistributedSampler,
    SyntheticSRDataset,
    random_split,
)
from pytorch_distributedtraining_tpu_torch.drivers import observe_flags
from pytorch_distributedtraining_tpu_torch.losses import feat_loss
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.observe import goodput, wandb
from pytorch_distributedtraining_tpu_torch.optim import OneCycleLR, ReduceLROnPlateau
from pytorch_distributedtraining_tpu_torch.parallel.remat import resolve_remat
from pytorch_distributedtraining_tpu_torch.runtime import dist
from pytorch_distributedtraining_tpu_torch.stoke import (
    AMPConfig,
    ClipGradNormConfig,
    DDPConfig,
    DistributedOptions,
    FairscaleOSSConfig,
    Stoke,
    StokeOptimizer,
)


def train_log(loss, example_ct, epoch):
    wandb.init()  # tolerated; a no-op once a run exists
    wandb.log({"epoch": epoch, "train_loss": float(loss)})
    print("Loss after " + str(example_ct).zfill(5) + f" examples: {float(loss):.3f}")


def val_log(loss, avg_mae, avg_psnr, example_ct, epoch):
    wandb.init()
    wandb.log({
        "epoch": epoch, "val_loss": float(loss),
        "PSNR": float(avg_psnr), "MAE": float(avg_mae),
    })
    print(
        "-----VALIDATION Loss after " + str(example_ct).zfill(5)
        + f" examples: {float(loss):.3f}--------"
    )


def train(train_dataloader, stoke_model: Stoke, scheduler1, scheduler2, epoch: int):
    example_ct = 0
    batch_ct = 0
    sum_loss = 0.0

    stoke_model.print_on_devices(f"Starting Epoch {epoch + 1}")
    stoke_model.model_access.train()

    for idx, (inputs, targets) in enumerate(train_dataloader):
        outputs = stoke_model.model(inputs)
        train_loss = stoke_model.loss(outputs, targets)

        stoke_model.print_ema_loss(prepend_msg=f"Step {idx+1} -- EMA Loss")

        stoke_model.backward(loss=train_loss)
        stoke_model.step()
        scheduler1.step()
        # scheduler2 (plateau) steps on the validation loss in main()

        # a device scalar: the sum stays on the device until the epoch ends
        sum_loss += stoke_model.detach_and_sync_loss(loss=train_loss)

        example_ct += len(inputs)
        batch_ct += 1

        if ((batch_ct + 1) % 50) == 0:
            train_log(stoke_model.detach_and_sync_loss(train_loss), example_ct, epoch)

    if batch_ct == 0:
        raise ValueError(
            "train dataloader yielded no batches: the dataset split is smaller than "
            f"one batch (len(dataset)={len(train_dataloader.dataset)}, "
            f"batch={train_dataloader.batch_size}); lower --batchSize or provide more data"
        )
    return float(sum_loss / max(1, len(train_dataloader)))  # one host read per epoch


def validate(val_dataloader, stoke_model: Stoke, epoch):
    stoke_model.model_access.eval()
    eval_step = stoke_model.eval_step({"mae": metrics.mae, "psnr": metrics.psnr})

    totals, example_ct, batches = None, 0, 0
    for inputs, targets in val_dataloader:
        example_ct += len(inputs)
        m = eval_step(inputs, targets)
        totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
        batches += 1

    n = max(1, batches)
    host = {} if totals is None else {k: float(v) for k, v in totals.items()}
    val_avg_loss = host.get("loss", 0.0) / n
    avg_mae = host.get("mae", 0.0) / n
    avg_psnr = host.get("psnr", 0.0) / n

    val_log(val_avg_loss, avg_mae, avg_psnr, example_ct, epoch)
    stoke_model.print_on_devices(
        msg=f"Current Average Validation Loss: {val_avg_loss}, PSNR : {avg_psnr}"
    )
    return val_avg_loss


def save_checkpoint(stoke_model, epoch, train_loss, val_loss, portable_dir=None,
                    extras=None):
    os.makedirs("checkpoint/", exist_ok=True)
    path, tag = stoke_model.save(
        path="checkpoint/",
        name="model_{}_{:.2f}_{:.2f}".format(epoch, train_loss, val_loss),
    )
    print("Checkpoint saved after epoch {}".format(epoch))
    if portable_dir:
        # the topology-independent twin: restores at another world size or
        # policy through Stoke.load_resharded
        p = stoke_model.save_portable(os.path.join(portable_dir, "epoch_{:04d}".format(epoch)),
                                      extras={"epoch": epoch, **(extras or {})})
        print("Portable (reshardable) checkpoint saved: {}".format(p))
    return path, tag


def latest_portable(root: str) -> str | None:
    """The newest committed portable checkpoint under ``root`` (staging
    ``.tmp`` dirs and marker-less dirs are never candidates), or None."""
    if not root or not os.path.isdir(root):
        return None
    cands = sorted(os.path.join(root, d) for d in os.listdir(root))
    return next((p for p in reversed(cands) if is_committed_dir(p)), None)


def build_parser():
    parser = argparse.ArgumentParser(description="PyTorch-W&B-Training")
    parser.add_argument("--projectName", default="Stoke-4K-2X-DDP", type=str, help="Project Name for W&B")
    parser.add_argument("--batchSize", type=int, default=18, help="Training batch size")
    parser.add_argument("--nEpochs", type=int, default=10, help="Number of epochs to train for")
    parser.add_argument("--start-epoch", default=1, type=int, help="Manual epoch number (useful on restarts)")
    parser.add_argument("--lr", type=float, default=0.001, help="Learning Rate. Default=0.1")
    parser.add_argument("--weight_decay", "--wd", default=1e-4, type=float, help="Weight decay, Default: 1e-4")
    parser.add_argument("--grad_clip", type=float, default=0.1, help="Clipping Gradients. Default=0.1")
    parser.add_argument("--local_rank", default=-1, type=int, help="rank (default: 0)")
    parser.add_argument("--threads", type=int, default=16, help="Number of threads for data loader to use, Default: 4")
    parser.add_argument("--inputDir", type=str, default="/opt/hubshare/vectorly-share/shared/Image_Superresolution/Dataset/Flickr2K/Patches/LRPatch_128/", help="Training Dataset Path")
    parser.add_argument("--targetDir", type=str, default="/opt/hubshare/vectorly-share/shared/Image_Superresolution/Dataset/Flickr2K/Patches/HR_256/", help="Training Dataset Path")
    parser.add_argument("--synthetic", action="store_true", help="use synthetic SR data")
    parser.add_argument("--synthetic-n", type=int, default=256)
    parser.add_argument("--pretrained", type=str, default=None,
                        help="checkpoint to load (nested 'params' key supported)")
    parser.add_argument("--portable-ckpt", type=str, default=None,
                        help="also write a portable checkpoint per epoch under DIR, and "
                             "resume from the newest committed one there, resharded onto "
                             "this run's world size and policy")
    parser.add_argument("--fp16", type=str, default=None, choices=[None, "amp", "bf16"],
                        help="precision: amp (fp16+scaler) or bf16")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="train on the GPU (default; fails without one) or the CPU")
    parser.add_argument("--remat", type=str, default=None,
                        help="activation remat policy per Swin layer: none/full/dots/offload "
                             "(default: $GRAFT_REMAT or none)")
    parser.add_argument("--deterministic", action="store_true",
                        help="cuDNN's deterministic algorithms (torch.backends.cudnn."
                             "deterministic), so a resumed run reproduces the unbroken one "
                             "bitwise on the GPU")
    parser.add_argument("--kernel-launches", action="store_true",
                        help="after each epoch, print this rank's launches of each of the "
                             "port's kernels (K1-K5) so far as one line: [kernels] {json}")
    observe_flags.add_arguments(parser)
    return parser


def build_model(seed: int = 0, remat: str | None = None) -> SwinIR:
    """SwinIR-S x2 as the reference driver configures it, weights from
    ``seed``, each Swin layer under the ``remat`` policy."""
    return SwinIR(
        upscale=2, in_chans=3, img_size=64, window_size=8,
        img_range=1.0, depths=[6, 6, 6, 6], embed_dim=60,
        num_heads=[6, 6, 6, 6], mlp_ratio=2,
        upsampler="pixelshuffledirect", resi_connection="1conv", remat=remat,
        generator=torch.Generator().manual_seed(seed),
    )


def build_stoke(model: torch.nn.Module, *, lr: float = 0.001, weight_decay: float = 1e-4,
                grad_clip: float = 0.1, batch_size: int = 18, fp16: str | None = None,
                device: str = "cuda", verbose: bool = True, oss: bool = True,
                sddp: bool = True, fsdp: bool = False) -> Stoke:
    """The driver's facade: ``feat_loss``, AdamW, global-norm clip,
    ``grad_accum_steps=2``, DDP with OSS and SDDP (ZeRO-2) and
    ``broadcast_fp16``, over the process group when there is one.
    ``oss``/``sddp``/``fsdp`` set the Fairscale flags for another layout."""
    local_rank = os.getenv("LOCAL_RANK")
    ddp_config = DDPConfig(
        local_rank=int(local_rank) if local_rank not in (None, "None") else None,
        convert_to_sync_batch_norm=True,
    )
    optimizer = StokeOptimizer(
        optimizer="AdamW",
        optimizer_kwargs={
            "lr": lr,
            "betas": (0.9, 0.99),
            "eps": 1e-8,
            "weight_decay": weight_decay,
        },
    )
    return Stoke(
        model=model,
        verbose=verbose,
        optimizer=optimizer,
        loss=feat_loss,
        batch_size_per_device=batch_size,
        gpu=True,
        fp16=fp16,
        distributed=DistributedOptions.ddp.value,
        fairscale_oss=oss,
        fairscale_sddp=sddp,
        fairscale_fsdp=fsdp,
        grad_accum_steps=2,
        configs=[AMPConfig(init_scale=2.0**14), ddp_config,
                 FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=ClipGradNormConfig(max_norm=grad_clip, norm_type=2.0),
        device=device,
    )


def main(argv=None):
    opt = build_parser().parse_args(argv)
    observe_flags.apply(opt)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or opt.deterministic
    joined = not dist.is_initialized()
    dist.initialize(device=opt.device)  # a no-op when started by hand on one device
    try:
        return _main(opt)
    finally:
        if joined:
            dist.shutdown()
        torch.backends.cudnn.deterministic = deterministic


def _main(opt):
    epochs = opt.nEpochs
    steps = 0

    print("===> Building model")
    remat = resolve_remat(opt.remat if opt.remat is not None
                          else os.environ.get("GRAFT_REMAT", "none"))
    if remat != "none":
        print(f"===> remat={remat}")
    stoke_model = build_stoke(
        build_model(remat=remat), lr=opt.lr, weight_decay=opt.weight_decay, grad_clip=opt.grad_clip,
        batch_size=opt.batchSize, fp16=opt.fp16, device=opt.device,
    )

    print("===> Loading datasets")
    print("--Input Directory--", opt.inputDir)
    if opt.synthetic or not os.path.isdir(opt.inputDir):
        if not opt.synthetic:
            print("(dataset dirs absent -> synthetic SR data)")
        full_dataset = SyntheticSRDataset(n=opt.synthetic_n, lr_size=32, scale=2)
    else:
        full_dataset = CustomDataset(opt.inputDir, opt.targetDir)

    if opt.pretrained:
        stoke_model.load_model_state(opt.pretrained, strict=True, param_key="params")

    train_size = int(0.9 * len(full_dataset))
    test_size = len(full_dataset) - train_size
    train_dataset, val_dataset = random_split(full_dataset, [train_size, test_size])

    train_sampler = DistributedSampler(dataset=train_dataset, num_replicas=None, rank=None)
    val_sampler = DistributedSampler(val_dataset, num_replicas=None, rank=None)

    workers = opt.threads > 0
    train_dataloader = stoke_model.DataLoader(
        dataset=train_dataset,
        sampler=train_sampler,
        num_workers=opt.threads,
        multiprocessing_context="spawn" if workers else None,
        persistent_workers=workers,
    )
    val_dataloader = stoke_model.DataLoader(
        dataset=val_dataset,
        sampler=val_sampler,
        num_workers=min(8, opt.threads),
        multiprocessing_context="spawn" if workers else None,
        persistent_workers=workers,
        drop_last=False,  # a small val split must not become zero batches
    )

    scheduler1 = OneCycleLR(
        stoke_model.optimizer, max_lr=0.01, pct_start=0.9,
        steps_per_epoch=max(1, len(train_dataloader)), epochs=epochs,
    )
    # factor mode: the plateau cut feeds scheduler1.lr_scale so OneCycle's
    # per-batch writes do not clobber it; min_factor keeps lr >= 5e-5
    scheduler2 = ReduceLROnPlateau(
        mode="min", factor=0.2, patience=2, verbose=True,
        min_factor=min(1.0, 5e-5 / max(opt.lr, 1e-12)),
    )

    config = dict(
        epochs=opt.nEpochs, batch_size=opt.batchSize, learning_rate=opt.lr,
        dataset="DemoVal", architecture="4K-2X-DDP",
    )
    wandb.init(project=opt.projectName, config=config, reinit=True)

    # resume: the newest committed portable checkpoint, resharded onto this
    # run's group; the epochs it covers are not trained again
    start_epoch = 0
    latest = latest_portable(opt.portable_ckpt)
    if latest is not None:
        meta = stoke_model.load_resharded(latest)
        scheduler1.load_state_dict(meta["scheduler1"])
        scheduler2.load_state_dict(meta["scheduler2"])
        start_epoch = int(meta["epoch"]) + 1
        mode = os.environ.get("GRAFT_RECOVERY_MODE", "")
        print("===> Resumed portable checkpoint {} (resharded onto this run), from epoch "
              "{}{}".format(latest, start_epoch,
                            f" (recovery_mode={mode})" if mode else ""))

    print("===> Training")
    train_loss = val_loss = float("nan")
    try:
        for epoch in range(start_epoch, epochs):
            before = stoke_model.step_count
            train_loss = train(train_dataloader, stoke_model, scheduler1, scheduler2, epoch)
            steps += stoke_model.step_count - before
            val_loss = validate(val_dataloader, stoke_model, epoch)
            scheduler1.lr_scale = scheduler2.step(val_loss)
            save_checkpoint(stoke_model, epoch, train_loss, val_loss,
                            portable_dir=opt.portable_ckpt,
                            extras={"scheduler1": scheduler1.state_dict(),
                                    "scheduler2": scheduler2.state_dict()})
            print("--------Train Loss after Epoch {} - {} --------".format(epoch, train_loss))
            print("--------Val Loss after Epoch {} - {} --------".format(epoch, val_loss))
            if opt.kernel_launches:
                observe_flags.print_launches(epoch)
    finally:
        wandb.finish()
        train_dataloader.shutdown_workers()
        val_dataloader.shutdown_workers()
    if stoke_model.telemetry:
        lr_size = full_dataset[0][0].shape[0]  # one optimizer step: accum x batch crops
        flops = goodput.model_train_flops(
            stoke_model.model_access, opt.batchSize * stoke_model.grad_accum_steps,
            input_hw=(lr_size, lr_size))
        observe_flags.report(stoke_model.trace_dir, steps, flops, stoke_model.device)
    return train_loss, val_loss


if __name__ == "__main__":
    main()
