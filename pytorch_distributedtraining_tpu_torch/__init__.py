"""PyTorch/CUDA port of ``pytorch_distributedtraining_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: each module here names
its counterpart there, keeps the same public layouts (NHWC images,
``[B*nW, heads, n, d]`` attention tiles) and is held against it by the CPU
tests in ``tests/test_torch_*.py``. The port imports neither JAX nor the JAX
package. Its Pallas kernels become hand-written CUDA kernels under
``csrc/``, built at first use; every kernel has a plain PyTorch version
that CPU tensors take.

The port covers the two reference drivers and all five ladder rungs, on
one GPU or, one process each, on many: SwinIR-S x2 through the Stoke
facade (``drivers.stoke_ddp``; SwinIR's classical and real-SR tails and
the VGG-16 perceptual loss too), ESPCN through ``parallel.TrainStep``
(``drivers.fairscale_ddp``), and through ``benchmarks.ladder`` ResNet-18
on CIFAR-10, ResNet-50 under DDP and ZeRO-2 (BatchNorm synchronous over
the data group), GPT-2 125M and ViT-B/16 in bf16 under ZeRO-3, with
``ops``, ``models`` (GPT-2 and ViT with dropout, whose masks a
``parallel.rng`` key fixes, and per-block remat), ``interop``, ``losses``, ``metrics``, ``optim``
(per-leaf AdamW and SGD, the flat ``FusedAdamW``, the schedules, all
shardable), ``precision``, ``runtime`` (the process group and the device
mesh), ``parallel`` (the DDP and ZeRO-1/2/3 policies, remat, the train
state and the steps), ``data`` (patch stores, paired augmentation,
device prefetch; the patch store's u8 normalisation in
``csrc/fastpipe.cpp``, built with ``g++``), ``checkpoint`` and
``checkpoint_sharded`` (the consolidated, sharded and portable formats
and ``CheckpointManager``: a run resumes at any world size, through
``Stoke.load``/``load_resharded`` and both drivers), ``observe`` (sinks,
span telemetry, request-lifecycle SLOs, the training numerics probe and
divergence watchdog, the goodput ledger with analytic FLOPs and MFU, and
device memory accounting: ``TrainStep(numerics=, detect_anomaly=)``,
``TrainStep.memory_analysis``, the drivers' ``--numerics`` and
``--trace``), ``resilience`` (fault injection,
the outage classifier and retry policy) and ``stoke``. It serves too:
``serve`` runs GPT-2 decode with continuous batching over a paged KV
cache (and speculative decode) and SwinIR super-resolution in tiles
batched across requests, through
``Stoke.serve`` or ``serve.build_engine``; ``models.generate`` decodes one
batch. ``python -m torch.distributed.run --standalone
--nproc_per_node N -m pytorch_distributedtraining_tpu_torch.drivers.
stoke_ddp`` trains on N GPUs over NCCL (``--device cpu``: gloo ranks).

On the CPU, ``python -m pytest tests/test_torch_*.py -q`` holds each part
against the JAX package (the optimizers in ``tests/test_torch_optim.py``,
the ESPCN driver in ``tests/test_torch_fairscale_driver.py``). On a GPU,
``python3 chip_smoke.py`` at the repository root builds the kernels,
holds them against their plain versions and drives every path above.
"""
