#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN convolutions, so every f32 number
   below is full f32;
2. build: both kernel libraries from ``pytorch_distributedtraining_
   tpu_torch/csrc`` (window attention and flash attention), one nvcc each
   for sm_90a, started together, with ptxas's register and spill counts
   and, where the toolkit has ``cuobjdump``, the tensor-core (HMMA)
   instructions in each kernel's SASS: every body of K1-K5 must hold some
   in every type (f32 as 3xTF32), as ``uses_tensor_cores(dtype, kernel)``
   of each module says; no kernel may spill;
3. kernels: K1 (forward) and K2 (backward) against their plain PyTorch
   versions at every shape the two SwinIR paths below give them: the
   bench shape (q/k/v [1152, 6, 64, 10]: batch 18 at LR 64x64) in f32 and
   bf16, with and without the shift mask, pack 1 and 2, and in f16 (phase
   15's fp16 amp run) at pack 1; the driver's
   training batches ([288, 6, 64, 10]: batch 18 at LR 32x32) and its
   validation batch ([160, 6, 64, 10]: 10 images) in f32, with and
   without the mask; phase 12's SwinIR-M shapes (head dim 30: [576, 6, 64,
   30], batch 16 at LR 48x48, and [288, 6, 128, 30] at pack 2) in f32 and
   bf16, with and without the mask. At pack 2 neither K1 nor K2 may be
   slower than its plain version. Errors against the stated tolerance and device
   times (CUDA events around ten calls queued behind a spin kernel, so
   host-side launch cost is excluded) of the kernel, the plain version and
   one PyTorch library call (``scaled_dot_product_attention`` with a float
   mask of bias + mask), and each kernel's ratio to that call; then a toy
   SwinIR on the card against the same model on the CPU;
4. flash kernels: K3 (forward), K4 (dq) and K5 (dk/dv) against their
   plain versions at the GPT-2 phase's shape, q/k/v [8, 512, 12, 64] as
   views of one fused projection, causal in bf16 (the path), f32 and f16,
   one non-causal bf16 case, and K4 and K5 in a non-causal f32 case.
   Errors, device times of kernel, plain version and library
   (``scaled_dot_product_attention(is_causal=...)`` for K3; its autograd
   backward, one call, stands for K4 and K5 together), the bound from
   bytes and operations at the tensor cores' rate (``flash_bounds``), and
   the ratios of K3 to SDPA's forward and of K4, K5 and K4 + K5 to its
   backward. No kernel may be slower than its plain
   version (``flash_speed_faults``); then a tiny f32 GPT-2 on the card
   against the same model on the CPU;
5. driver: ``drivers.stoke_ddp.main`` (full-width SwinIR-S, one epoch of
   synthetic data, two optimizer steps) in a scratch directory, traced:
   finite losses, a checkpoint written, K1 and K2 in the trace's device
   records (the split path's graphs' warm-ups and replays, and the
   validation's eval graph, its warm-up and replay: ``traced_call``,
   retaken up to ``GRAPH_TAKES`` takes when short) and the wrappers'
   counts (the three captures: ``capture_launches``), both exact;
6. bench shape: the model and facade from the driver's ``build_model``
   and ``build_stoke`` at batch 18, LR 64x64 -> HR 128x128, in f32 and
   bf16, through ``profile_swinir.train_steps`` (no loss read inside a
   window: the window program, one captured graph): a few optimizer
   steps, finite loss, moved weights, exactly 48 K1 and 48 K2 in a traced
   step's device records and the window's one capture in the wrappers'
   counts, and step time, images/s and the peak with the graph's pool
   beside the card's name and power limit;
7. GPT-2: the ladder twin's config 4 (``benchmarks.ladder.build_lm``):
   GPT-2 125M at full width and depth, bf16, flash ``attn_fn``, batch 8 x
   seq 512, AdamW: a first loss near ln(vocab), a few optimizer steps
   after warm-up, finite loss, moved weights, exactly 12 K3, 12 K4 and 12
   K5 launches per step, and tokens/s, step ms and peak memory beside the
   card's name and power limit;
8. bench configuration: SwinIR-S through ``TrainStep`` and
   ``FusedAdamW(lr=5e-4, clip_grad_norm=0.1)``, the optimizer ``bench.py``
   builds, MSE, batch 18 a micro-batch at LR 64x64, ``grad_accum_steps=2``,
   in f32 and bf16 autocast: finite loss, moved weights, exactly 24 K1 and
   24 K2 launches per micro-batch, step ms and images/s beside the card's
   name and power limit;
9. ESPCN driver: ``drivers.fairscale_ddp.main`` (``Net`` + MSE, per-leaf
   AdamW, one epoch of 1024 synthetic images, two loader workers): a
   finite loss, moved weights and the run's seconds;
10. optimizer: ``optim.FusedAdamW`` against the per-leaf ``optim.AdamW`` on
   the card, over two parameter lists (SwinIR-S from the driver's
   ``build_model``, 910 152 parameters in 330 tensors; GPT-2 125M from
   ``benchmarks.ladder.build_lm``, 124 439 808 in 148), five steps of the
   same seeded gradients with clip 1.0: the parameters within 1e-6 of the
   per-leaf run's and of the same fused code's run on the CPU (``err``'s
   relative value), and a step on an ``inf`` gradient, gated by the
   scaler's finite flag with no read on the host (CUDA's sync debug mode
   set to error), leaves parameters, moments and count bitwise as they
   were (``gated_step_faults``). Device times of one step of each and of
   ``torch._fused_adamw_`` on the same flat tensor (the library reference,
   without a clip), device activities a step from a ``torch.profiler``
   trace, and the bytes bound (``optimizer_bound_ms``). It runs after
   every timed step, since it holds GPT-2-sized buffers on the card and
   runs the same update on the CPU;
11. distributed: a process group of one rank over NCCL
   (``runtime.dist.initialize`` with ``MASTER_ADDR``/``MASTER_PORT``,
   ``RANK=0``, ``WORLD_SIZE=1``), through which the sharded code runs as
   on many GPUs: a shard of one is the whole leaf, and every all-reduce,
   reduce-scatter and all-gather still goes through NCCL. SwinIR-S from
   the driver's ``build_model``/``build_stoke`` at the bench shape under
   four layouts (DDP + ``FusedAdamW``; OSS + ``FusedAdamW``; OSS + SDDP
   with the per-leaf chain and ``broadcast_fp16``, the driver's; FSDP),
   in f32 with cuDNN deterministic, and the driver's layout in bf16: each
   loss trajectory against the same facade without a group (f32 within
   ``DIST_F32_TOL`` relative, bf16 within ``DIST_BF16_TOL``), step ms
   and, from a traced step, device busy ms and activities against the
   group-less run's, NCCL kernels a step, peak memory with the graphs'
   pools, 48 K1 and 48 K2 in a traced step's device records (each loss is
   read after its ``.step()``: the split path's three graphs, each
   captured once, ZeRO-3's too; a layout the facade runs uncaptured,
   ``graph_refusal``, would count 24 a micro-batch in the wrappers), and a
   checkpoint saved through the group
   (gathered, written by rank 0, a barrier) that loads strictly. Then
   GPT-2 125M under
   ``ZeRO3(remat="full")``, the JAX rung's layout (``benchmarks.ladder.
   build_lm(..., policy="zero3", remat="full")``): a first loss near
   ln(vocab), moved weights, the loss after the same seven steps as phase
   7's within ``DIST_BF16_TOL`` of phase 7's, tokens/s, and K3 twice a
   layer a step (the recompute), K4 and K5 once. Then the ESPCN driver
   for one epoch under ``python -m torch.distributed.run --standalone
   --nproc_per_node 1``, whose exit code must be 0;
12. SwinIR-M: classical SwinIR-M x2 at full width (official
   ``001_classicalSR_DIV2K_s48w8_SwinIR-M_x2``: depths 6x6, embed 180, 6
   heads, window 8, the ``'pixelshuffle'`` tail; weights from seed 0)
   through the driver's facade (AdamW, clip 0.1, one micro-batch a step)
   and ``VGGFeatLoss()`` (seed 0), on batches of 16 LR 48x48 crops from a
   ``PatchStore`` of 512 seeded uint8 patches (written with ``np.save``)
   through ``PairedRandomAug`` (the store's ``fastpipe`` normalisation,
   which must build) and the facade's loader (four spawned workers,
   device prefetch 2): f32 and bf16 (5 steps after 2 each), and one step
   under ``remat="full"`` for its peak, every run on epoch 0's batches.
   Each step is the window program's replay (the facade's ``.loss`` is
   ``VGGFeatLoss``): finite losses, moved weights, exactly 36 K1 and 36 K2
   a step in a traced step's device records (72 K1 under full remat), one
   capture, and the losses of full remat against the run without
   (``M_SAME_LOSSES``); step ms, images/s, peak GiB with the graph's pool,
   first and
   last loss, a traced step's device busy ms and idle share, the prefetcher's
   ``staged`` and ``overlap_fraction`` and the batch wait a step, beside
   the card's name and power limit;
13. image rungs: tiny ResNets (the CIFAR and the ImageNet stem, Basic and
   Bottleneck blocks) and the tiny ViT in f32 and bf16 on the card
   against the CPU (outputs, gradients and running statistics within
   ``IMAGE_CARD_TOL``); then the ladder twin's image rungs at full width
   through its own builder (``benchmarks.ladder.build_image``) in a
   process group of one over NCCL: ``1_resnet18_cifar10_single``
   (ResNet-18, CIFAR stem, batch 128 of 32x32, no group, ``FusedAdamW``),
   ``2_resnet50_ddp`` (ResNet-50, batch 64 of 224x224, DDP,
   ``FusedAdamW``), ``3_resnet50_oss_sddp`` (ZeRO-2, per-leaf AdamW) and
   ``5_vitb16_bf16_fsdp`` (ViT-B/16 in bf16, ZeRO-3 over FSDP2, per-leaf
   AdamW), each 2 warm-up and 5 timed steps: images/s, step ms, peak GiB,
   the first loss against ln(classes), a finite last loss, moved weights,
   moved BatchNorm running statistics (ResNets), a traced step's device
   busy ms and ms by kernel family, and no launch of K1-K5 (no kernel of
   the port lies on these paths), beside the card's name and power limit;
14. serving: GPT-2 125M at full width and depth (weights from seed 0) in f32
   and bf16 through ``Stoke.serve``, which builds the continuous-batching
   ``ServeEngine`` at the JAX engine's defaults (4 slots, page 16, 257
   pages, prefill chunk 32, buckets 8/16/32), over 24 seeded greedy
   requests arriving at once (prompts of 16, 48, 100 and 200 tokens, 32-96
   new): every request delivered in full, no steady recompile, every page
   free again, no launch of K1-K5; in f32 the tokens equal
   ``generate(kv_layout="contiguous")``'s for each prompt on the card and
   those of the same trace at ``spec_k=4`` (``held_tokens``: where two runs
   part, the step must be a tie within ``TIE_TOL``); in bf16 finite logits
   and the share of tokens equal to f32's, reported. Decode tokens/s,
   TTFT and latency p50/p99, the tick's ms, prefill ms per bucket, the
   spec accept rate, peak GiB and a traced decode-only tick's device busy
   ms and idle share. Then SwinIR-M x2 (phase 12's model, seed 0) through
   ``serve.build_engine``'s ``SwinIRTileServer`` (tile 48, overlap 8, 4
   tiles a batch) in f32 and bf16 over six seeded images (40x30, which is
   reflect-padded, 64x64, 96x128, 128x200, 256x256, 48x48): exactly 36 K1
   and no K2 a tile batch, every request at its upscaled size, no steady
   recompile, and one batch against the same model on the CPU within
   ``TILE_CARD_TOL``; tiles/s, output megapixels/s, request latency
   p50/p99 and peak GiB, beside the card's name and power limit;
15. resume: the driver's facade (``build_model``/``build_stoke``: SwinIR-S,
   ``feat_loss``, AdamW, clip 0.1, accum 2) at the bench shape on eight
   seeded micro-batches, with cuDNN deterministic, for each of
   ``RESUME_RUNS`` (f32 and fp16 ``amp`` under the driver's OSS + SDDP
   flags, the per-leaf chain; f32 under DDP flags, ``FusedAdamW``): four
   optimizer steps unbroken, against two steps, ``Stoke.save``, a fresh
   facade's ``Stoke.load`` and two more. Every loss, parameter and moment
   (and the loss scale) must equal the unbroken run's bitwise
   (``resume_mismatch`` names the first that does not); 48 K1 and 48 K2
   in the device records of a traced step after the unbroken run, and
   the split path's two captures in the wrappers' counts; the
   checkpoint's bytes and the save and load
   seconds. Then the driver's flags through an NCCL group of one:
   ``Stoke.save_portable`` at step 2, ``Stoke.load_resharded`` into a
   facade with no group (parameters and moments bitwise the saved ones)
   and one step there, whose losses must agree with the group's next step
   within ``DIST_F32_TOL``; bytes and seconds, beside the card's name and
   power limit;
16. training health: (a) GPT-2 125M at full width and depth with dropout
   0.1, an untied head and full remat (``GPT2Config(dropout=0.1,
   tie_word_embeddings=False, remat=True)``) through phase 7's builder
   (``benchmarks.ladder.build_lm(..., numerics=True)``: weights from seed
   0, the flash ``attn_fn``, AdamW, ``TrainStep`` with the probe and the
   train state's step stream), bf16, batch 8 x 512: 2 warm-up and 5 timed
   steps, the
   first loss within 0.5 of ln(vocab) + 1/2 (the untied head's lecun_normal
   init gives the first logits a variance of ~1), finite losses, no
   non-finite leaf in the probe, a moved head, 24 K3 (the recompute), 12
   K4 and 12 K5 launches a step; step ms, tokens/s, MFU by
   ``observe.goodput`` (JAX's ``gpt2_train_flops`` over the H100's 989
   TFLOP/s), the allocator's peak through ``observe.memory``, a traced
   step's device busy ms and families, and phase 7's MFU beside it; (b)
   one forward and backward at that shape with and without remat from
   one dropout key: the gradients within
   ``REMAT_GRAD_TOL`` of the largest (bitwise is expected) and the same
   loss, and another key's loss different; (c) the numerics drill on
   SwinIR-S at the bench shape (batch 18, LR 64, f32, per-leaf AdamW,
   MSE, cuDNN deterministic): the step ms without the probe and with it
   decoded every step; ``GRAFT_NUMERICS_INJECT``-style poisoning of
   ``DRILL_LEAF`` at step ``DRILL_INJECT_AT``, blamed by name at row 0;
   the ``rollback`` watchdog restoring the committed step
   (``CheckpointManager``, saves every ``DRILL_SAVE_EVERY``) and the run
   after it equal to an unbroken run's, bitwise; ``detect_anomaly=True``
   raising on the poisoned step with the parameters bitwise unchanged;
   (d) ``tune_batch_size`` over ``TrainStep.memory_analysis`` for SwinIR-S
   f32 against ``device_hbm_budget()`` between ``TUNE_START`` and
   ``TUNE_MAX`` images: the batch chosen, its projected peak and the
   allocator's peak of a real step there (which must give a finite loss),
   and K1/K2 held against their plain versions at every probed batch
   (``window_shape_checks``), beside the card's name and power limit.
   After it, ``mfu_lines`` prints the MFU of phases 6, 7, 8, 13's ViT and
   16(a) by ``observe.goodput``;
17. observe part 2, in a process group of one over NCCL: (a) the driver's
   facade (``build_model``/``build_stoke`` with DDP flags: SwinIR-S,
   ``FusedAdamW``, ``feat_loss``, f32, batch 18 at LR 64, accum 2) with
   ``GRAFT_OPCOST=1``, ``GRAFT_CAPTURE`` (a build directory) and the
   numerics plane on, ``DRILL_LEAF`` poisoned at step ``CAPTURE_INJECT_AT``
   (``GRAFT_NUMERICS_INJECT``, action ``rollback``): the armed capture must
   fire once, from the ``numerics`` source, and its ingested op table must
   hold ``window_attn_fwd_kernel`` and ``window_attn_bwd_kernel`` at 48
   launches each per optimizer step it covers (``table_launches``), with
   ``opcost.runtime_stats["tables_built"]`` grown, one graph launch (the
   window's replay) a captured step, the wrappers counting none over
   them, and no launch in the capture lacking its device record
   (``lost_launches``, which cannot see a record lost inside a replay; a
   lossy capture is not retaken); a replay makes no c10d call, so one
   all-reduce record of the flat gradient a step (its bandwidth at one
   rank: not measured) is read from one step of the window program run
   uncaptured (``Stoke.uncaptured``); the same steps
   under a raw ``torch.profiler`` session, without the guard's warm-up,
   print how many launches such a session loses in this process; the µs
   of an idle armed ``poll()`` over ``IDLE_POLLS`` calls and its share of
   an untraced step; (b) GPT-2 125M bf16 under ``ZeRO3`` (FSDP2, no
   remat) through ``observe.profiler_trace`` over ``GPT2_TRACED_STEPS``
   steps, with a second ``profiler_trace`` inside it that must be a no-op
   with a warning: ``opcost.ingest_trace`` must count K3, K4 and K5 at 12
   launches a step, the trace must lose no device record, and the
   inventory must list one all-gather record for each all-gather FSDP2 issued (``fsdp_all_gathers``; FSDP2 skips its
   collectives at one rank on torch 2.13), and reduce-scatter records if it
   issued any, and ``calibrate`` prints its ``mfu_flops`` row
   (``observe.goodput``'s analytic FLOPs at the H100's peak against the
   trace's compute seconds a step), beside the card's name and power limit;
18. the launcher on the card, the reference's launch line: (a)
   ``python -m pytorch_distributedtraining_tpu_torch.runtime.launch
   --nproc_per_node 1`` runs the SwinIR-S driver as a file (NCCL group of
   one, phase 5's ``DRIVER_N`` images at batch ``BATCH``, ``LAUNCH_EPOCHS``
   epochs, ``--portable-ckpt``, ``--deterministic``, ``--kernel-launches``);
   (b) the same with ``--max_restarts 1`` and a ``ckpt.write`` kill of
   attempt 0 at hit ``LAUNCH_KILL_AT`` (inside epoch 2's portable save):
   the launcher must say ``restart 1/1`` once and exit 0, the portable dir
   must hold ``epoch_0000``, ``epoch_0001`` and the torn ``epoch_0002.tmp``
   and nothing else when it says so, generation 1 must run as attempt 1 and
   resume from ``epoch_0001`` (``recovery_mode=retry``), and its final
   train and validation losses must equal (a)'s within ``LAUNCH_TOL``
   relative (the difference printed); (w) is (a) with phase 5's two loader
   workers a loader (``--threads 2``: spawn workers, which run the driver
   file again as ``__mp_main__``), whose losses must equal (a)'s too and
   whose workers must be the same processes at every epoch's end; every
   generation of (a), (b) and (w) must have launched K1 and K2 (each
   child's own counters, printed after each epoch), (a) and (w) exactly
   the split path's two captures (its first and accumulating programs;
   every later training micro-batch is a replay, which no wrapper
   counts) and the validation's eval program's one capture (every later
   epoch replays it); the restart's cost, (b)'s wall seconds minus
   (a)'s, each generation's start and (a)'s and (w)'s epoch times are
   printed; (c) the recovery
   drill (``runtime/recovery_drill.py``) under ``--elastic --max_restarts 1
   --min_world 1`` with JAX's bench plan (``DRILL_K`` = 4: a ``ckpt.write``
   sleep leaves step 3 torn, a ``train.preempt`` kill at step 4): the
   events must be steps 1-3, one ``resume`` at step 2 past
   ``step_0000000003.tmp`` in mode ``retry`` (world 1 cannot shrink), steps
   3-6 and ``done`` at 6; the time to recover (the first step after the
   resume minus the last before the kill, the drill's own clock) is
   printed beside the card's name and power limit. The children run in
   their own processes, so their launches reach neither
   ``record_launches`` nor the kernels line; their shapes are phase 5's;
19. the CUDA-graph step, under cuDNN's and torch's deterministic
   algorithms (``warn_only``, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``): (a)
   SwinIR-S at the bench shape in f32 and bf16 through
   ``MultiStep(k=GRAPH_K)`` over phase 8's ``TrainStep`` + ``FusedAdamW``
   against the same steps run eagerly from the same weights, over
   ``GRAPH_WINDOWS`` windows of seeded batches, and through
   ``Stoke.fused_step`` (the driver's facade with DDP flags: ``feat_loss``,
   accum 2, ``FusedAdamW``, in an NCCL group of one with NCCL's async
   error handling off) against the same facade's ``TrainStep`` run eagerly
   and its Stoke-style loop; (b) GPT-2 125M bf16 (phase 7's builder)
   through ``MultiStep`` with dropout 0 and 0.1 against its eager steps;
   (c) ``fp16='amp'`` ``fused_step`` with step 1's targets poisoned (inf):
   the update skipped and the scale halved on both paths, the graphed
   parameters equal to the eager ones; (d) ``tune_multi_step_k`` at
   SwinIR-S bf16 over ``GRAPH_TUNE_KS``. Graphed against eager must be
   bitwise or, printed, within ``GRAPH_TOL`` (``graph_faults``). Each case
   prints the step ms eager and graphed, a traced step's (or window's)
   device busy ms and idle share, the graph launches and K1-K5 kernels a
   step read from the replay's device records (``replay_counts``: the
   ``observe.opcost`` op table of a ``cudaGraphLaunch``; a case fails
   unless it holds 48 K1 and 48 K2, or 12 K3, K4 and K5, a step; a trace
   that counts fewer, as one that lost device records would, is printed
   and taken again, ``GRAPH_TAKES`` takes at most: ``replay_traced``), the
   peak GiB eager and graphed (a replay's allocator peak plus the graph's
   private pool, whose segments a replay uses without allocating), beside the
   card's name and power limit. The wrappers' counters see a graph's
   kernels at its warm-up and its capture, never at a replay. (e) the
   graphed Stoke-style window: the driver's facade (``build_stoke``, seed
   0, through the NCCL group) in f32 and bf16 under each of
   ``WINDOW_CASES``: the window program (``_stoke_style``: no loss read
   inside a window) under the driver's ZeRO-2 flags and under DDP flags
   (``FusedAdamW``), and the driver's own loop (``_driver_style``: each
   loss read right after ``.step()``, the split path's three programs)
   under ZeRO-2, each over ``WINDOW_HELD`` steps against the same programs
   run uncaptured (``Stoke.uncaptured``) from the same state, bitwise
   expected, then ``WINDOW_TIMED`` steps timed each way, a graphed step
   traced (48 K1 and 48 K2 a step in the replays' device records, one
   graph launch a program; the uncaptured twin is timed, not traced), one
   capture a program, and the peaks, the graphed one with the facade's
   shared pool. (f) every training program graphed, in the same group:
   the driver's facade in f32 and bf16 under each of ``LAYOUT_CASES``
   (ZeRO-3 through ``FairscaleFSDPConfig``, FSDP2's hooks, copies and
   streams inside the capture; plain DDP with the per-leaf chain, a
   ``DistributedDataParallel`` model whose programs run the bare module;
   each through the window program and the driver's split loop) as (e)
   runs its cases, bitwise required; the cold programs of the ZeRO-3
   facade (``_cold_case``: a handle read alone, a loss read before
   ``.backward()``, eval-mode ``.model``, ``eval_step`` over a batch and
   a partial one of ``COLD_EVAL_N``): one capture a signature, a replay
   every later call, bitwise their uncaptured twin, ``COLD_KERNELS`` (24
   K1, no K2) in a forward's replay; GPT-2 125M bf16 under
   ``ZeRO3(remat="full")`` and ViT-B/16 bf16 under ZeRO-3 (ladder config
   5, batch 64 at 224x224) through ``MultiStep(k=GRAPH_K)`` against their
   eager ``TrainStep``, bitwise required, GPT-2 with 24 K3, 12 K4 and 12
   K5 a step in the replay's device records;
20. host offload and named remat, under phase 19's deterministic
   settings: first the card's pinned copy rates (``pinned_rates``: a
   ``OFFLOAD_PROBE_MIB`` MiB pinned buffer each way, CUDA events); (a)
   SwinIR-S at the bench shape (one micro-batch of ``BATCH``) through
   ``TrainStep`` + ``FusedAdamW`` in f32 and bf16 under each of
   ``REMAT_POLICIES`` (the model's per-layer ``remat``), ``REMAT_STEPS``
   steps from one seed: step ms, the allocator's peak, and K1/K2 a step in
   a traced step's device records, which must be ``remat_kernels`` of the
   policy (the recompute runs K1 again under every policy but ``none``:
   ``names`` and ``offload`` save the tag after K1, not its residuals);
   losses and parameters against ``none``'s, bitwise expected, within
   ``GRAPH_TOL``; (b) GPT-2 125M bf16 with dropout 0.1 (the ladder's
   ``build_lm``) under ``names`` and ``offload`` against ``none`` the same way,
   K3 twice a step under remat, K4 and K5 once; (c) GPT-2 125M bf16 under
   ``ZeRO1(offload_opt_state=True)`` and then ``ZeRO1(offload_params=
   True)``, each with the per-leaf ``AdamW`` and ``FusedAdamW``, against
   the resident run of the same optimizer over ``OFFLOAD_STEPS`` steps:
   losses and parameters bitwise equal, every offloaded tensor on the host
   and pinned, ``torch.cuda.memory_allocated()`` between steps lower by the
   offloaded bytes within ``OFFLOAD_MEM_TOL``, step ms and peak beside the
   resident's and the step ms the copy rates predict; then the parameter
   arm's steps again as one ``MultiStep(k=OFFLOAD_STEPS)`` replay from the
   same state, bitwise equal to them; (d) the driver's facade with
   ``DeepspeedConfig(zero_optimization=DeepspeedZeROConfig(stage=2),
   offload_optimizer=DeepspeedOffloadOptimizerConfig(device="cpu"))``:
   the per-leaf state on the host, pinned, finite losses, moved weights,
   48 K1 and 48 K2 a step in a replay's device records; (e) the ESPCN
   driver with ``--remat names --device-prefetch 2``.

Phases 5-9, 11, 12, 14-17, 19 and 20 note the shape, dtype and mask (or causality) of
every launch; the run fails if one of them was not held against the plain
version in phase 3 or 4 (phase 3 holds phase 14's tile batch, q/k/v [144,
6, 64, 30], in f32 and bf16 with and without the mask) or, for phase 16's
memory probes, in phase 16 itself. The kernels' JSON
lists all five kernels: K1/K2 from phase
6's f32 run (the wrappers' counts over it: the window graph's warm-up and
capture, which is where the wrappers launch on that graphed path; and the
errors and times of phase 3 at
its shape), K3-K5 from phase 7 (its launch counts, and phase 4's numbers
for the causal bf16 case), and K1 at the tile server's shape in each type
(phase 14's launches over its run, phase 3's numbers). The line before it, ``{"swinir_m_kernels":
[...]}``, holds K1/K2 at phase 12's shapes (each type, and pack 2, which
phase 12 does not launch: phase 3's errors and times, phase 12's kernels
a step in a traced replay's device records). The last lines are that JSON, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the rest of the repository
beside it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# the card's peaks outside the tensor cores for f32 (bound_ms's default);
# no kernel body of the port runs at this rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# a tensor-core body's rate (every body of K1-K5): f32 runs as 3xTF32,
# three TF32 products (495 TFLOP/s) per product
TENSOR_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
TOL = {"float32": 2e-5, "bfloat16": 1e-2, "float16": 2e-3}  # max |err| / max(1, max |ref|)
CALLS_PER_EVENT = 10  # calls timed back to back between two CUDA events
SPIN_HZ = 2.0e9  # above the H100's SM clock, so a spin of n cycles lasts at least n / SPIN_HZ s
SOURCES = {
    "window_attn": "pytorch_distributedtraining_tpu_torch/csrc/window_attn.cu",
    "flash_attn": "pytorch_distributedtraining_tpu_torch/csrc/flash_attn.cu",
}
REPLACES = {
    "window_attn_fwd": "pytorch_distributedtraining_tpu/ops/pallas_window_attn.py:35",
    "window_attn_bwd": "pytorch_distributedtraining_tpu/ops/pallas_window_attn.py:58",
    "flash_attn_fwd": "pytorch_distributedtraining_tpu/ops/pallas_attn.py:43",
    "flash_attn_dq": "pytorch_distributedtraining_tpu/ops/pallas_attn.py:86",
    "flash_attn_dkv": "pytorch_distributedtraining_tpu/ops/pallas_attn.py:127",
}
BATCH, LR_SIZE, HEADS, WINDOW, DIM = 18, 64, 6, 8, 60  # the bench shape
# phase 12: classical SwinIR-M x2 (official 001_classicalSR_DIV2K_s48w8_SwinIR-M_x2),
# batch 16 of LR 48x48 crops (36 windows an image) from a PatchStore of 512 LR
# 64x64 / HR 128x128 patches
M_BATCH, M_LR, M_DIM, M_STORE_N, M_STORE_LR = 16, 48, 180, 512, 64
SWINIR_M = dict(upscale=2, in_chans=3, img_size=M_LR, window_size=WINDOW, img_range=1.0,
                depths=[6] * 6, embed_dim=M_DIM, num_heads=[HEADS] * 6, mlp_ratio=2,
                upsampler="pixelshuffle", resi_connection="1conv")
M_LAYERS = 36
# runs that take the same batches (epoch 0) and the same math, so their
# losses agree: full remat recomputes the f32 forward (sums in the same
# order). (run, run it follows, max relative difference)
M_SAME_LOSSES = (("f32 remat full", "f32", 1e-4),)
M_RUNS = (  # name, precision, remat, timed steps, warm-up steps
    ("f32", None, "none", 5, 2),
    ("bf16", "bf16", "none", 5, 2),
    ("f32 remat full", None, "full", 1, 1),
)
# the driver run of phase 4: 100 synthetic images at LR 32x32 (the driver's
# SyntheticSRDataset), split 90 / 10: five training batches of 18 and one
# validation batch of 10
DRIVER_N, DRIVER_LR, DRIVER_VAL = 100, 32, 10
# the GPT-2 phase: GPT-2 125M, batch 8 x seq 512 (12 heads of 64)
LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM, LM_LAYERS = 8, 512, 12, 64, 12
# the optimizer phase: five steps of seeded gradients, clip 1.0
OPT_STEPS, OPT_CLIP, OPT_TOL = 5, 1.0, 1e-6
# one AdamW step an element: f32 reads of p, g, mu, nu and writes of p, mu,
# nu (EMA: one more read and write), and ~20 operations (norm, clip, the
# moments, bias correction, sqrt, divide, decay, lr, add)
OPT_BYTES, OPT_EMA_BYTES, OPT_FLOPS = 28, 36, 20
ESPCN_N = 1024  # 1013 training images: 25 batches of 40, one loss print
# phase 13: the ladder's image rungs (benchmarks.ladder.IMAGE_RUNGS); the tiny
# models' card-against-CPU tolerances (output, grads: relative to the largest
# CPU value), f32 a sum order apart; bf16 on the seeded input agrees exactly in
# the output and to 1.8e-5 in the gradients (H100, torch 2.11), so a path that
# lost precision (bf16 accumulation, a cast of the gradients) fails
IMAGE_CONFIGS = (1, 2, 3, 5)
IMAGE_CARD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 1e-3)}
# phase 11: loss trajectories with a group of one against none; bf16 at
# the noise ROADMAP.md C.1 records between the bf16 and f32 losses
DIST_F32_TOL, DIST_BF16_TOL = 1e-6, 1.6e-3
# phase 14: serving. GPT-2 125M through Stoke.serve at the JAX engine's
# defaults (4 slots, page 16, 1 + 4 * 1024 / 16 pages, chunk 32, buckets
# 8/16/32); 24 seeded requests, all arriving at 0
SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW = 24, (16, 48, 100, 200), (32, 96)
SERVE_SLOTS, SERVE_PAGE, SERVE_PAGES, SERVE_CHUNK, SERVE_BUCKETS = 4, 16, 257, 32, (8, 16, 32)
SERVE_SPEC_K = 4
# greedy tokens are held equal in f32; where two runs part, the step must be
# a tie: the two tokens' logits (the full forward's, on the card) within this
TIE_TOL = 1e-4
# the tile server: SwinIR-M x2 (phase 12's model), six seeded images (40x30
# reflect-padded up to the tile), tile 48, overlap 8, 4 tiles a batch: K1 at
# [4 * 36, 6, 64, 30], 36 launches a batch; one batch on the card against the
# same model on the CPU (relative to the largest CPU value; bf16 against f32)
TILE_IMAGES = ((40, 30), (64, 64), (96, 128), (128, 200), (256, 256), (48, 48))
TILE, TILE_OVERLAP, TILE_BATCH = 48, 8, 4
TILE_CARD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# phase 15: resume. The driver's facade at the bench shape, RESUME_STEPS
# optimizer steps unbroken against a save at step RESUME_SPLIT and a load
# into a fresh facade, compared bitwise (cuDNN deterministic); label, fp16,
# build_stoke flags
RESUME_STEPS, RESUME_SPLIT = 4, 2
RESUME_PER_STEP = {"K1": 48, "K2": 48}  # two micro-batches of 24 layers
RESUME_RUNS = (
    ("f32, the driver's OSS + SDDP flags", None, {}),
    ("fp16 amp, the driver's OSS + SDDP flags", "amp", {}),
    ("f32, DDP flags", None, dict(oss=False, sddp=False)),
)
DIST_LAYOUTS = (  # name, build_stoke flags, precision
    ("ddp+fused", dict(oss=False, sddp=False), None),
    ("oss+fused", dict(oss=True, sddp=False), None),
    ("oss+sddp (driver)", dict(oss=True, sddp=True), None),
    ("fsdp", dict(oss=True, sddp=True, fsdp=True), None),
    ("oss+sddp (driver)", dict(oss=True, sddp=True), "bf16"),
)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the median over ``reps`` of
    CALLS_PER_EVENT calls timed between two CUDA events. A spin kernel
    (``torch.cuda._sleep``) goes first and lasts twice as long as queuing
    those calls took, so the host has queued them all before the card
    reaches the first event: a call's host-side cost (a wrapper's checks,
    ``ctypes``, autograd's engine) does not count, and a hand kernel and a
    library call are compared on the card's work alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS_PER_EVENT):
        fn()
    torch.cuda.synchronize()
    spin = int(2 * (time.perf_counter() - t0) * SPIN_HZ)
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(CALLS_PER_EVENT):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS_PER_EVENT)
    return statistics.median(times)


def err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(1.0, want.float().abs().max().item())


def bound_ms(bytes_moved: float, flops: float, dtype: str,
             peak: dict = PEAK_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / peak[dtype]
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
    paths = csrc.build_all()
    for name in paths:
        csrc.load(name)
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = csrc.build_log.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        smem = [int(s) for s in re.findall(r"(\d+) bytes smem", log)]
        print(f"[build] {path.name}: nvcc {csrc.build_seconds.get(name, 0.0):.1f} s, "
              f"{len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"spill stores max {max(spills, default=0)} bytes, static smem max "
              f"{max(smem, default=0)} bytes")
        check_build(name, log, path)


PTX_TYPES = {"f": "f32", "6__half": "f16", "13__nv_bfloat16": "bf16"}  # mangled


def kernel_key(entry: str) -> str:
    """A kernel's key from its mangled name: ``"fwd bf16 D=64"`` for a flash
    kernel (K3-K5), ``"wfwd f32 N=64 D=16"`` for K1 and ``"wbwd bf16 N=64
    D=16"`` for K2 (padded keys and columns), ``"dbias_reduce"``; else the
    name."""
    types = "(f|6__half|13__nv_bfloat16)"
    kind = re.search(rf"flash_attn_(fwd|dq|dkv)_kernelI{types}Li(\d+)E", entry)
    if kind is not None:
        return f"{kind.group(1)} {PTX_TYPES[kind.group(2)]} D={kind.group(3)}"
    kind = re.search(rf"window_attn_(fwd|bwd)_kernelI{types}Li(\d+)ELi(\d+)E", entry)
    if kind is not None:
        return (f"w{kind.group(1)} {PTX_TYPES[kind.group(2)]} N={kind.group(3)} "
                f"D={kind.group(4)}")
    if "dbias_reduce_kernel" in entry:
        return "dbias_reduce"
    return entry


def ptxas_entries(log: str) -> dict:
    """``{kernel (kind, type, head dim): (registers, spill store bytes)}``
    from ptxas's -v report."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[kernel_key(entry)] = (int(m.group(1)), spill)
    return out


def sass_hmma_counts(lib: Path) -> dict | None:
    """``{kernel: HMMA instructions in its SASS}`` by ``cuobjdump -sass``,
    or None where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = kernel_key(m.group(1))
            out[entry] = 0
        elif entry is not None and re.search(r"\bHMMA\.", line):
            out[entry] += 1
    return out


DTYPES = {"f32": "float32", "bf16": "bfloat16", "f16": "float16"}


def _build_faults(regs: dict, hmma: dict | None, uses) -> list[str]:
    """Kernels of ``regs`` (``{key: (registers, spill bytes)}``) that spill,
    or (where ``hmma`` was counted) whose HMMA use disagrees with
    ``uses(key)``."""
    faults = [f"{k}: {spill} bytes spill stores" for k, (_, spill) in sorted(regs.items())
              if spill > 0]
    if hmma is not None:
        faults += [f"{k}: {hmma.get(k, 0)} HMMA" for k in sorted(regs)
                   if (hmma.get(k, 0) > 0) != uses(k)]
    return faults


def flash_build_faults(regs: dict, hmma: dict | None) -> list[str]:
    """What in the flash kernels' build (``{"dq bf16 D=64": (registers,
    spill bytes)}``) is not as designed: a kernel that spills, and (where
    ``hmma`` was counted) a body whose HMMA use disagrees with the
    wrappers' ``uses_tensor_cores`` for its kernel and type: HMMA in every
    body of K3, K4 and K5."""
    import torch

    from pytorch_distributedtraining_tpu_torch.ops.flash_attn import uses_tensor_cores

    def uses(key: str) -> bool:
        kind, dtype = key.split()[:2]
        return uses_tensor_cores(getattr(torch, DTYPES[dtype]), kind)

    return _build_faults(regs, hmma, uses)


def window_build_faults(regs: dict, hmma: dict | None) -> list[str]:
    """The same for the window-attention kernels (``{"wbwd bf16 N=64
    D=16": ...}``): no spill anywhere; HMMA as ``ops.window_attn.
    uses_tensor_cores`` says: in every body of K1 and K2, none in the dbias
    reduction."""
    import torch

    from pytorch_distributedtraining_tpu_torch.ops.window_attn import uses_tensor_cores

    def uses(key: str) -> bool:
        kind = key.split()[0]
        return kind in ("wfwd", "wbwd") and uses_tensor_cores(
            getattr(torch, DTYPES[key.split()[1]]), kind[1:])

    return _build_faults(regs, hmma, uses)


FAMILIES = {  # library -> (its kernels' key prefixes, build-fault check)
    "flash_attn": (("fwd", "dq", "dkv"), flash_build_faults),
    "window_attn": (("wfwd", "wbwd", "dbias_reduce"), window_build_faults),
}


def check_build(name: str, log: str, lib: Path) -> None:
    """Print each kernel's registers, spills and HMMA count; fail where the
    library's build check finds a fault."""
    prefixes, faults_of = FAMILIES[name]
    regs = {k: v for k, v in ptxas_entries(log).items() if k.split()[0] in prefixes}
    hmma = sass_hmma_counts(lib)
    for key in sorted(regs):
        nregs, spill = regs[key]
        count = "cuobjdump absent" if hmma is None else f"{hmma.get(key, 0)} HMMA"
        print(f"[build]   {key}: {nregs} registers, {spill} bytes spill stores, {count}")
    faults = faults_of(regs, hmma)
    if faults:
        raise SystemExit(f"{name} kernels not built as designed: {faults}")


def launch_signature(kernel: str, q, mask) -> tuple:
    """What a kernel launch depends on: q's shape and dtype, mask windows."""
    return kernel, tuple(q.shape), str(q.dtype), None if mask is None else mask.shape[0]


def flash_signature(kernel: str, q, causal: bool) -> tuple:
    """What a flash launch depends on: q's shape and dtype, causality."""
    return kernel, tuple(q.shape), str(q.dtype), bool(causal)


@contextlib.contextmanager
def record_launches(seen: set):
    """Add the signature of every K1-K5 launch made inside to ``seen``."""
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    fwd, bwd = twa.kernel_forward, twa.kernel_backward
    flash = tfa.kernel_forward, tfa.kernel_dq, tfa.kernel_dkv

    def forward(q, k, v, bias, mask):
        seen.add(launch_signature("fwd", q, mask))
        return fwd(q, k, v, bias, mask)

    def backward(q, k, v, bias, mask, do):
        seen.add(launch_signature("bwd", q, mask))
        return bwd(q, k, v, bias, mask, do)

    def recorded(name, fn):
        def launch(q, *args):
            seen.add(flash_signature(name, q, args[-1]))
            return fn(q, *args)
        return launch

    twa.kernel_forward, twa.kernel_backward = forward, backward
    tfa.kernel_forward, tfa.kernel_dq, tfa.kernel_dkv = (
        recorded(n, fn) for n, fn in zip(("flash_fwd", "flash_dq", "flash_dkv"), flash))
    try:
        yield
    finally:
        twa.kernel_forward, twa.kernel_backward = fwd, bwd
        tfa.kernel_forward, tfa.kernel_dq, tfa.kernel_dkv = flash


def _attention_inputs(dtype, with_mask: bool, batch: int, lr_size: int, seed: int,
                      dim: int = DIM):
    import torch

    from pytorch_distributedtraining_tpu_torch.models.swinir import _shift_attn_mask

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d = WINDOW * WINDOW, dim // HEADS
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
                 seed: int, dim: int = DIM) -> dict:
    """One configuration: errors of both kernels and the times of kernel,
    plain version and library call, forward and backward. ``checked`` holds
    the launch signatures the errors cover (at pack > 1, the packed shape
    the kernels see)."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    q, k, v, do, bias, mask = _attention_inputs(dtype, with_mask, batch, lr_size, seed, dim)
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
    checked = {launch_signature(kind, q, mask) for kind in ("fwd", "bwd")}
    bn, h, n, d = q.shape
    args = (q, k, v, bias, mask)
    t = {
        "fwd": device_ms(lambda: twa.kernel_forward(*args)),
        "bwd": device_ms(lambda: twa.kernel_backward(*args, do)),
        "plain_fwd": device_ms(lambda: twa.plain_forward(*args)),
        "plain_bwd": device_ms(lambda: twa.plain_backward(*args, do)),
    }
    am = bias[None].expand(bn, h, n, n)
    if mask is not None:
        am = am + mask[torch.arange(bn, device="cuda") % mask.shape[0]][:, None]
    am = am.to(q.dtype).contiguous()
    t["lib_fwd"] = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
    lq, lk, lv, lm = (x.detach().clone().requires_grad_(True) for x in (q, k, v, am))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lm)
    t["lib_bwd"] = device_ms(
        lambda: torch.autograd.grad(lout, (lq, lk, lv, lm), do, retain_graph=True))

    esize = q.element_size()
    side = bias.numel() * 4 + (0 if mask is None else mask.numel() * 4)
    dt = str(q.dtype).split(".")[1]
    fwd_bound = bound_ms(4 * q.numel() * esize + side, 4 * bn * h * n * n * d, dt,
                         TENSOR_PEAK_FLOPS)
    bwd_bound = bound_ms(7 * q.numel() * esize + side + bias.numel() * 4,
                         10 * bn * h * n * n * d, dt, TENSOR_PEAK_FLOPS)
    return {"dtype": dt, "mask": with_mask, "pack": pack, "shape": tuple(q.shape),
            "batch": batch, "model": "SwinIR-M" if dim == M_DIM else "SwinIR-S",
            "errors": errors, "times": t, "fwd_bound": fwd_bound, "bwd_bound": bwd_bound,
            "checked": checked}


def phase_kernels(smi: str) -> list[dict]:
    import torch

    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    configs = [(dtype, with_mask, pack, BATCH, LR_SIZE, DIM)
               for dtype in (torch.float32, torch.bfloat16)
               for with_mask in (False, True) for pack in (1, 2)]
    configs += [(torch.float32, with_mask, 1, batch, DRIVER_LR, DIM)
                for batch in (BATCH, DRIVER_VAL) for with_mask in (False, True)]
    # phase 15's fp16 amp run: the bench shape in float16
    configs += [(torch.float16, with_mask, 1, BATCH, LR_SIZE, DIM) for with_mask in (False, True)]
    # phase 12's SwinIR-M x2: head dim 30, the kernels' DP = 32 instantiations
    configs += [(dtype, with_mask, pack, M_BATCH, M_LR, M_DIM)
                for dtype in (torch.float32, torch.bfloat16)
                for with_mask in (False, True) for pack in (1, 2)]
    # phase 14's tile server: SwinIR-M at TILE_BATCH tiles of 48x48
    configs += [(dtype, with_mask, 1, TILE_BATCH, TILE, M_DIM)
                for dtype in (torch.float32, torch.bfloat16) for with_mask in (False, True)]
    cases = []
    for seed, (dtype, with_mask, pack, batch, lr_size, dim) in enumerate(configs):
        c = _kernel_case(dtype, with_mask, pack, batch, lr_size, seed, dim)
        tol = TOL[c["dtype"]]
        worst = max(rel for _, rel in c["errors"].values())
        errs = " ".join(f"{nm} {a:.2e}/{r:.2e}" for nm, (a, r) in c["errors"].items())
        t = c["times"]
        print(f"[kernels] {c['model']} {c['dtype']:8s} q {list(c['shape'])} (batch {batch}, "
              f"LR {lr_size}) "
              f"mask={int(with_mask)} pack={pack} abs/rel err: {errs} (tol rel {tol:g})")
        print(f"[kernels]   ms fwd {t['fwd']:.4f} bwd {t['bwd']:.4f} | plain fwd "
              f"{t['plain_fwd']:.4f} bwd {t['plain_bwd']:.4f} | library fwd "
              f"{t['lib_fwd']:.4f} bwd {t['lib_bwd']:.4f} | bound fwd "
              f"{c['fwd_bound'][0]:.4f} ({c['fwd_bound'][1]}) bwd "
              f"{c['bwd_bound'][0]:.4f} ({c['bwd_bound'][1]}) | {smi}")
        if not worst <= tol:
            raise SystemExit(f"kernel disagrees with its plain version: {c['errors']}")
        for kind, name in (("fwd", "K1"), ("bwd", "K2")):
            if pack > 1 and t[kind] > t[f"plain_{kind}"]:
                raise SystemExit(f"{name} at pack {pack} ({t[kind]:.4f} ms) is slower than its "
                                 f"plain version ({t[f'plain_{kind}']:.4f} ms)")
        if pack == 1:
            print(f"[kernels]   K1 / SDPA's forward: {t['fwd'] / t['lib_fwd']:.3f}, "
                  f"K2 / SDPA's backward: {t['bwd'] / t['lib_bwd']:.3f}")
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


def flash_bounds(shape: tuple, dtype: str, causal: bool) -> dict:
    """K3-K5's bounds at q/k/v ``shape`` [B, T, H, D] in ``dtype``: each
    input read once, each output written once (lse and delta f32), and the
    score pairs the mask keeps (T(T+1)/2 a row block when causal) at the
    tensor cores' rate, where every body runs."""
    b, t, h, d = shape
    tensor, stats = b * t * h * d * ELEMENT_BYTES[dtype], b * h * t * 4
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    work = {"fwd": (4 * tensor + stats, 4 * pairs * d),
            "dq": (5 * tensor + 2 * stats, 6 * pairs * d),
            "dkv": (6 * tensor + 2 * stats, 8 * pairs * d)}
    return {kernel: bound_ms(moved, flops, dtype, TENSOR_PEAK_FLOPS)
            for kernel, (moved, flops) in work.items()}


FLASH_OUTPUTS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}  # K3, K4, K5


def flash_speed_faults(times: dict) -> list[str]:
    """The kernels of one phase-4 case (``times`` as ``_flash_case`` gives
    them, for the kernels it ran) that are slower than their plain version."""
    return [f"{kernel} {times[kernel]:.4f} ms > plain {times['plain_' + kernel]:.4f} ms"
            for kernel in FLASH_OUTPUTS
            if kernel in times and times[kernel] > times["plain_" + kernel]]


def _flash_case(dtype, causal: bool, seed: int, kernels=tuple(FLASH_OUTPUTS)) -> dict:
    """K3-K5 (or those of ``kernels``) at the GPT-2 phase's shape: errors
    against the plain versions (on the same lse and delta), and the times
    of kernel, plain version and library call."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa

    b, t, h, d = LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM
    g = torch.Generator(device="cuda").manual_seed(seed)
    # q/k/v as the path gives them: views of one fused [B, T, 3*H*D] projection
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(dtype)
    q, k, v = (a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1))
    do = torch.randn(b, t, h, d, generator=g, device="cuda").to(dtype)
    checked = {flash_signature(f"flash_{kernel}", q, causal) for kernel in kernels}

    o, lse = tfa.plain_forward(q, k, v, causal)
    grad_args = (do, lse, tfa.delta_rows(o, do), causal)
    runs = {  # kernel: (its launch, its plain version), each giving FLASH_OUTPUTS[kernel]
        "fwd": (lambda: tfa.kernel_forward(q, k, v, causal),
                lambda: tfa.plain_forward(q, k, v, causal)),
        "dq": (lambda: (tfa.kernel_dq(q, k, v, *grad_args),),
               lambda: (tfa.plain_dq(q, k, v, *grad_args),)),
        "dkv": (lambda: tfa.kernel_dkv(q, k, v, *grad_args),
                lambda: tfa.plain_dkv(q, k, v, *grad_args)),
    }
    errors, times = {}, {}
    for kernel in kernels:
        launch, plain = runs[kernel]
        errors.update(zip(FLASH_OUTPUTS[kernel], map(err, launch(), plain())))
        times[kernel] = device_ms(launch)
        times["plain_" + kernel] = device_ms(plain)
    lq, lk, lv = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    ldo = do.transpose(1, 2).contiguous()
    if "fwd" in kernels:
        with torch.no_grad():
            times["lib_fwd"] = device_ms(
                lambda: F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal))
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    times["lib_bwd"] = device_ms(
        lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True))

    dt = str(dtype).split(".")[1]
    return {"dtype": dt, "causal": causal, "shape": tuple(q.shape), "errors": errors,
            "times": times, "bounds": flash_bounds(tuple(q.shape), dt, causal),
            "checked": checked}


def phase_flash_kernels(smi: str) -> list[dict]:
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa

    cases = []
    all3 = tuple(FLASH_OUTPUTS)
    for seed, (dtype, causal, kernels) in enumerate(
            [(torch.bfloat16, True, all3), (torch.float32, True, all3),
             (torch.float16, True, all3), (torch.bfloat16, False, all3),
             (torch.float32, False, ("dq", "dkv"))]):
        c = _flash_case(dtype, causal, seed, kernels)
        tol = TOL[c["dtype"]]
        worst = max(rel for nm, (_, rel) in c["errors"].items() if nm != "lse")
        errs = " ".join(f"{nm} {a:.2e}/{r:.2e}" for nm, (a, r) in c["errors"].items())
        t, bd = c["times"], c["bounds"]
        ms = " ".join(f"{kn} {t[kn]:.4f}" for kn in kernels)
        plain = " ".join(f"{kn} {t['plain_' + kn]:.4f}" for kn in kernels)
        lib = " ".join(f"{nm} {t[key]:.4f}" for nm, key in
                       (("fwd", "lib_fwd"), ("bwd (dq+dkv)", "lib_bwd")) if key in t)
        bound = " ".join(f"{kn} {bd[kn][0]:.4f} ({bd[kn][1]})" for kn in kernels)
        print(f"[flash] {c['dtype']:8s} q {list(c['shape'])} causal={int(causal)} abs/rel err: "
              f"{errs} (tol rel {tol:g}; lse f32, tol rel {TOL['float32']:g})")
        print(f"[flash]   ms {ms} | plain {plain} | library {lib} | bound {bound} | {smi}")
        if not (worst <= tol and c["errors"].get("lse", (0, 0))[1] <= TOL["float32"]):
            raise SystemExit(f"flash kernel disagrees with its plain version: {c['errors']}")
        if "fwd" in kernels:
            print(f"[flash]   K3 / SDPA's forward: {t['fwd'] / t['lib_fwd']:.3f}, K3 / its "
                  f"bound: {t['fwd'] / bd['fwd'][0]:.3f}")
        for kn, name in (("dq", "K4"), ("dkv", "K5")):
            print(f"[flash]   {name} / SDPA's backward: {t[kn] / t['lib_bwd']:.3f}, {name} / its "
                  f"bound: {t[kn] / bd[kn][0]:.3f}")
        print(f"[flash]   (K4 + K5) / SDPA's backward: "
              f"{(t['dq'] + t['dkv']) / t['lib_bwd']:.3f}")
        slow = flash_speed_faults(t)
        if slow:
            raise SystemExit(f"{c['dtype']} causal={int(causal)}: slower than the plain "
                             f"version: {slow}")
        cases.append(c)

    cfg = GPT2Config.tiny(n_embd=128, n_head=2, n_positions=128)
    model = GPT2(cfg, attn_fn=tfa.make_flash_attn_fn(), generator=torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)))
    want = model(tok)
    want.square().mean().backward()
    want_grads = {nm: p.grad.clone() for nm, p in model.named_parameters()}
    model.zero_grad()
    before = tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches
    got = model.cuda()(tok.cuda())
    got.square().mean().backward()
    launched = tuple(a - b for a, b in zip((tfa.fwd_launches, tfa.dq_launches,
                                           tfa.dkv_launches), before))
    out_err = err(got.cpu(), want)[1]
    grad_err = max(err(p.grad.cpu(), want_grads[nm])[1] for nm, p in model.named_parameters())
    print(f"[flash] tiny GPT-2 card vs CPU: logits rel err {out_err:.2e}, worst grad rel err "
          f"{grad_err:.2e}, launches {launched}")
    if launched != (2, 2, 2) or out_err > 1e-4 or grad_err > 1e-4:
        raise SystemExit("tiny GPT-2 on the card disagrees with the CPU")
    return cases


def phase_driver() -> None:
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    os.environ["WANDB_MODE"] = "disabled"  # offline JSONL sink, no network
    (ROOT / "build").mkdir(exist_ok=True)
    cwd = os.getcwd()
    # five training micro-batches (24 layers each, fwd+bwd) through the
    # split path (the driver reads each loss after .step()): the first and
    # the accumulating programs, each captured once (a warm-up runs its
    # kernels, the capture records them) and replayed; one forward-only
    # validation batch, the eval program, captured and replayed the same way
    train_batches = (DRIVER_N - DRIVER_VAL) // BATCH
    want = {"K1": 24 * (train_batches + 2) + 2 * 24, "K2": 24 * (train_batches + 2)}
    expected = (capture_launches(3, 24), capture_launches(2, 24))
    runs = []

    def run():
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as run_dir:
            os.chdir(run_dir)
            try:
                twa.reset_launch_counts()
                t0 = time.perf_counter()
                losses = stoke_ddp.main([
                    "--synthetic", "--synthetic-n", str(DRIVER_N), "--nEpochs", "1",
                    "--batchSize", str(BATCH), "--threads", "2",
                ])
                runs.append((losses, time.perf_counter() - t0,
                             (twa.fwd_launches, twa.bwd_launches),
                             list(Path(run_dir, "checkpoint").glob("model_0_*.pt"))))
            finally:
                os.chdir(cwd)

    traced = traced_call(run, want)
    (train_loss, val_loss), seconds, launches, ckpts = runs[-1]
    print(f"[driver] train loss {train_loss}, val loss {val_loss}, checkpoint "
          f"{[p.name for p in ckpts]}, {seconds:.1f} s (traced), the wrappers' launches fwd "
          f"{launches[0]} bwd {launches[1]} (expected {expected}: the two training captures "
          f"and the validation's), device records {traced['kernels']['K1']} K1 and "
          f"{traced['kernels']['K2']} K2 (expected {want}, take {traced['takes']})")
    if faults := kernel_faults("driver", traced["kernels"], want):
        raise SystemExit("; ".join(faults))
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
        # the counts from the first step on: the window program's capture
        # calls the wrappers, its replays do not
        twa.reset_launch_counts()
        train_steps(s, batches, warmup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
        peak = torch.cuda.max_memory_allocated() / 2**30 + pools_gib(s)
        per_step = {"K1": 24 * s.grad_accum_steps, "K2": 24 * s.grad_accum_steps}
        traced = traced_call(lambda: train_steps(s, batches, 1), per_step)
        graphs = {kind: (g.captures, g.replays) for (kind, _), g in s._graphs.items()}
        print(f"[bench] {name}: step {step_ms:.2f} ms, {ips:.1f} images/s (batch {BATCH} x "
              f"accum {s.grad_accum_steps}, LR {LR_SIZE} -> HR {2 * LR_SIZE}, {steps} steps "
              f"after {warmup}), peak {peak:.2f} GiB with the graphs' pools, loss {loss:.5f}, "
              f"weights moved {moved:.2e}; the window's graph: (captures, replays) {graphs}, "
              f"the wrappers' launches fwd {launches[0]} bwd {launches[1]} (its capture); a "
              f"traced step: device busy {traced['busy_ms']:.2f} ms, K1 "
              f"{traced['kernels']['K1']} K2 {traced['kernels']['K2']} in its device records "
              f"(take {traced['takes']}) | {smi}")
        faults = kernel_faults(name, traced["kernels"], per_step)
        if launches != (capture_launches(1, 24 * s.grad_accum_steps),) * 2:
            faults.append(f"{name}: the wrappers counted {launches}, expected one capture of "
                          f"the window program")
        if {k: v[0] for k, v in graphs.items()} != {"window": 1}:
            faults.append(f"{name}: graphs {graphs}, expected one capture of the window")
        if faults:
            raise SystemExit("; ".join(faults))
        if not np.isfinite(loss) or not moved > 0:
            raise SystemExit(f"{name}: loss {loss} or weights did not move")
        results[name] = {"step_ms": step_ms, "images_per_s": ips, "launches": launches,
                         "kernels": traced["kernels"], "busy_ms": traced["busy_ms"]}
        del s
    return results


def phase_gpt2(smi: str, steps: int = 5, warmup: int = 2) -> dict:
    import math

    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa

    cfg = GPT2Config.gpt2_125m()
    model, step, tokens = ladder.build_lm(cfg, LM_BATCH, LM_SEQ, torch.device("cuda"))
    w = model.transformer.h[0].attn.c_attn.weight
    w0 = w.detach().clone()
    first = step(tokens)["loss"].item()
    for _ in range(warmup - 1):
        step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(tokens)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches
    loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
    moved = (w - w0).abs().max().item()
    step_ms = elapsed / steps * 1e3
    tps = LM_BATCH * LM_SEQ * steps / elapsed
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[gpt2] GPT-2 125M ({n_params} parameters), bf16, flash attn_fn, batch {LM_BATCH} x "
          f"seq {LM_SEQ}: step {step_ms:.2f} ms, {tps:.1f} tokens/s ({steps} steps after "
          f"{warmup}), peak {peak:.2f} GiB, first loss {first:.4f} (ln vocab "
          f"{math.log(cfg.vocab_size):.4f}), loss {loss:.4f}, grad norm {gnorm:.4f}, weights "
          f"moved {moved:.2e}, launches K3 {launches[0]} K4 {launches[1]} K5 {launches[2]} "
          f"| {smi}")
    if abs(first - math.log(cfg.vocab_size)) > 0.5:
        raise SystemExit(f"first loss {first} is not near ln(vocab): the model is wrong")
    if launches != (LM_LAYERS * steps,) * 3:
        raise SystemExit(f"launches {launches}, expected {LM_LAYERS} of each per step")
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or not moved > 0:
        raise SystemExit(f"loss {loss}, grad norm {gnorm} or weights did not move")
    return {"step_ms": step_ms, "tokens_per_s": tps, "launches": launches, "loss": loss}


def optimizer_bound_ms(n_params: int, ema: bool = False) -> tuple[float, str]:
    """The least time one AdamW step over ``n_params`` f32 parameters can
    take: each of p, g, mu, nu (and the EMA) read once and p, mu, nu (and
    the EMA) written once at the memory rate, beside its operations at the
    f32 rate outside the tensor cores."""
    per = OPT_EMA_BYTES if ema else OPT_BYTES
    return bound_ms(per * n_params, OPT_FLOPS * n_params, "float32")


def gated_step_faults(before: dict, after: dict) -> list[str]:
    """The buffers (``{"params": ..., "mu": ..., "count": ...}``) that a
    gated-off step changed; a skipped step must leave each bitwise as it was."""
    import torch

    return [name for name in before if not torch.equal(before[name], after[name])]


def traced_call(fn, want: dict | None = None) -> dict:
    """One call of ``fn`` under the port's guarded profiler
    (``observe.profiling.profile_call``): its device activities (kernels,
    copies, sets), the device's busy ms, the NCCL kernels among them (names
    beginning ``nccl``), the host's ms in blocking CUDA calls, the device
    ms by kernel family (``observe.opcost.device_breakdown``) and K1-K5's
    kernels in its device records (``kernels``, ``observe.opcost``'s op
    table: a graph's replays run kernels the wrappers never count). With
    ``want`` (``{id: kernels}``), a take that counts fewer of one, as a
    take that lost device records would (ROADMAP C.6: a replay's kernels
    share its launch's correlation id), is printed and taken again, up to
    ``GRAPH_TAKES`` takes (``takes``); the caller checks the last take's
    counts exactly."""
    from pytorch_distributedtraining_tpu_torch.observe import opcost, profiling

    # CUPTI now and then hands back a trace with no device activity at all;
    # such a capture is retaken (up to twice), never read as zero work
    for take in range(1, GRAPH_TAKES + 1):
        for attempt in range(3):
            _, events = profiling.profile_call(fn)
            if attempt < 2 and not any(e.get("cat") in opcost.DEVICE_CATS for e in events):
                print(f"[trace] capture {attempt + 1} held no device activity; retaken")
                continue
            r = opcost.device_breakdown(events)
            break
        kernels = table_launches(opcost.op_table(events, top=1000),
                                 {**WINDOW_KERNELS, **FLASH_KERNELS})
        short = {k: kernels[k] for k, n in (want or {}).items() if kernels[k] < n}
        if not short or take == GRAPH_TAKES:
            break
        print(f"[trace] take {take} lost device records: {short}, expected {want}; taken again")
    nccl = sum(1 for e in events
               if e.get("cat") == "kernel" and e.get("name", "").lower().startswith("nccl"))
    return {"activities": r["kernels"], "busy_ms": r["busy_ms"], "nccl": nccl,
            "wait_ms": sum(r["host_wait_ms"].values()), "families": r["device_ms_by_family"],
            "kernels": kernels, "takes": take}


def kernel_faults(name: str, got: dict, want: dict) -> list[str]:
    """The kernels of ``want`` (``{id: n}``) whose device-record count in
    ``got`` is not exactly ``n``."""
    return [f"{name}: {k} {got.get(k, 0):g} in the device records, expected {n:g}"
            for k, n in want.items() if got.get(k, 0) != n]


def capture_launches(graphs: int, per_call: int) -> int:
    """The wrappers' count of a kernel over ``graphs`` captures of programs
    that call it ``per_call`` times: each runs ``parallel.graph.WARMUP``
    times and once more inside the capture; a replay calls no wrapper."""
    from pytorch_distributedtraining_tpu_torch.parallel import graph

    return graphs * (graph.WARMUP + 1) * per_call


def kernels_per_call(fn) -> int:
    """Device activities (kernels, copies, sets) of one call of ``fn``, from
    a ``torch.profiler`` trace."""
    return traced_call(fn)["activities"]


def _optimizer_case(name: str, named: list, smi: str) -> dict:
    """FusedAdamW against AdamW on the card and against itself on the CPU,
    over the parameters ``named`` (``(name, CPU tensor)`` pairs)."""
    import torch

    from pytorch_distributedtraining_tpu_torch import optim
    from pytorch_distributedtraining_tpu_torch.precision import DynamicLossScaler

    def params(device):
        return [(nm, p.detach().to(device).clone().requires_grad_(True)) for nm, p in named]

    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, clip_grad_norm=OPT_CLIP)
    fused = optim.FusedAdamW(params("cuda"), **kw)
    on_cpu = optim.FusedAdamW(params("cpu"), **kw)
    leaf = optim.AdamW(params("cuda"), **kw)
    n = fused.numel
    sizes = [p.numel() for p in leaf.params]

    def packed(ps):
        return torch.cat([p.detach().reshape(-1) for p in ps])

    def set_grads(opt, g):  # into the views of the flat grad buffer
        for p, a in zip(opt.params, g.split(sizes)):
            p.grad.copy_(a.view_as(p))

    for step in range(OPT_STEPS):
        # grad norms near 1 for SwinIR-S: the clip fires from the second step
        g = torch.randn(n, generator=torch.Generator().manual_seed(step)) * (1e-3 * (step + 1))
        set_grads(on_cpu, g)
        on_cpu.apply_tree()
        g = g.cuda()
        set_grads(fused, g)
        fused.apply_tree()
        grads = [a.view_as(p) for a, p in zip(g.split(sizes), leaf.params)]
        leaf.step(grads)
    vs_leaf = err(packed(fused.params), packed(leaf.params))
    vs_cpu = max(err(getattr(fused.state, b).cpu(), getattr(on_cpu.state, b))[1]
                 for b in ("mu", "nu"))
    vs_cpu = max(vs_cpu, err(fused.flat_param.cpu(), on_cpu.flat_param)[1])
    count_ok = int(fused.state.count) == int(on_cpu.state.count) == OPT_STEPS

    # an inf gradient under the scaler's gate: nothing moves, nothing is read
    fused.flat_grad[0] = float("inf")
    before = {"params": fused.flat_param.clone(), **{k: v.clone() for k, v in
                                                       fused.state._asdict().items()
                                                       if v is not None}}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, finite = fused.apply_tree(scaler=DynamicLossScaler(init_scale=2.0**14))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = {"params": fused.flat_param, **fused.state._asdict()}
    gate_faults = gated_step_faults(before, after) + ([] if not bool(finite) else ["finite"])
    set_grads(fused, g)

    lib = [packed(fused.params), g.clone(), torch.zeros_like(g), torch.zeros_like(g),
           torch.zeros((), device="cuda")]

    def library():  # torch/optim/adam.py's fused path: the step count first
        torch._foreach_add_([lib[4]], 1)
        torch._fused_adamw_([lib[0]], [lib[1]], [lib[2]], [lib[3]], [], [lib[4]], lr=1e-3,
                            beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
                            amsgrad=False, maximize=False)

    runs = {"fused": lambda: fused.apply_tree(), "per_leaf": lambda: leaf.step(grads),
            "library": library}
    times = {k: device_ms(fn) for k, fn in runs.items()}
    launches = {k: kernels_per_call(fn) for k, fn in runs.items()}
    bound = optimizer_bound_ms(n)
    print(f"[optim] {name}: {n} parameters in {len(sizes)} tensors; after {OPT_STEPS} steps "
          f"FusedAdamW vs AdamW abs/rel {vs_leaf[0]:.2e}/{vs_leaf[1]:.2e}, vs its CPU run rel "
          f"{vs_cpu:.2e} (tol {OPT_TOL:g}); gated inf step moved {gate_faults or 'nothing'}")
    print(f"[optim]   ms a step: FusedAdamW {times['fused']:.4f} | AdamW {times['per_leaf']:.4f} "
          f"| torch._fused_adamw_ {times['library']:.4f} | bound {bound[0]:.4f} ({bound[1]}) | "
          f"device activities a step {launches['fused']} / {launches['per_leaf']} / "
          f"{launches['library']} | {smi}")
    if not (vs_leaf[1] <= OPT_TOL and vs_cpu <= OPT_TOL and count_ok):
        raise SystemExit(f"{name}: FusedAdamW disagrees (vs AdamW {vs_leaf}, vs CPU {vs_cpu}, "
                         f"count {int(fused.state.count)})")
    if gate_faults:
        raise SystemExit(f"{name}: a gated-off step changed {gate_faults}")
    return {"params": n, "tensors": len(sizes), "times": times, "launches": launches,
            "bound": bound, "vs_leaf": vs_leaf, "vs_cpu": vs_cpu}


def phase_optimizer(smi: str) -> dict:
    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config

    out = {"swinir_s": _optimizer_case(
        "SwinIR-S", list(stoke_ddp.build_model().named_parameters()), smi)}
    gpt2 = ladder.build_lm(GPT2Config.gpt2_125m(), LM_BATCH, LM_SEQ, torch.device("cpu"))[0]
    out["gpt2_125m"] = _optimizer_case("GPT-2 125M", list(gpt2.named_parameters()), smi)
    return out


def phase_bench_config(smi: str, steps: int = 5, warmup: int = 2) -> dict:
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch import optim
    from pytorch_distributedtraining_tpu_torch.benchmarks.profile_swinir import make_batches
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.losses import mse_loss
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.parallel import TrainStep
    from pytorch_distributedtraining_tpu_torch.precision import Policy

    accum = 2
    batch = tuple(torch.cat(parts) for parts in zip(*make_batches("cuda")))  # 2 x 18 images
    results = {}
    for fp16 in (None, "bf16"):
        model = stoke_ddp.build_model().cuda()
        policy = Policy.from_name(fp16)

        def loss_fn(m, b):
            with policy.autocast(b[0].device):
                out = m(b[0])
            return mse_loss(out.float(), b[1]), {}

        tx = optim.FusedAdamW(model.named_parameters(), lr=5e-4, clip_grad_norm=0.1)
        step = TrainStep(model, loss_fn, tx, grad_accum_steps=accum)
        w0 = model.conv_first.weight.detach().clone()
        for _ in range(warmup):
            step(batch)
        torch.cuda.synchronize()
        twa.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step(batch)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = twa.fwd_launches, twa.bwd_launches
        loss = metrics["loss"].item()
        moved = (model.conv_first.weight - w0).abs().max().item()
        name = fp16 or "fp32"
        step_ms = elapsed / steps * 1e3
        ips = BATCH * accum * steps / elapsed
        print(f"[bench-config] {name}: TrainStep + FusedAdamW(lr=5e-4, clip 0.1), MSE: step "
              f"{step_ms:.2f} ms, {ips:.1f} images/s (batch {BATCH} x accum {accum}, LR "
              f"{LR_SIZE} -> HR {2 * LR_SIZE}, {steps} steps after {warmup}), loss {loss:.5f}, "
              f"weights moved {moved:.2e}, launches fwd {launches[0]} bwd {launches[1]} | {smi}")
        if launches != (24 * accum * steps,) * 2:
            raise SystemExit(f"{name}: launches {launches}, expected 24 of each per micro-batch")
        if not np.isfinite(loss) or not moved > 0:
            raise SystemExit(f"{name}: loss {loss} or weights did not move")
        results[name] = {"step_ms": step_ms, "images_per_s": ips, "launches": launches}
        del model, step, tx
    return results


def phase_espcn() -> dict:
    import math

    from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp

    model = fairscale_ddp.build_model()
    w0 = model.conv1.weight.detach().clone()
    t0 = time.perf_counter()
    loss = fairscale_ddp.main(["--synthetic", "--synthetic-n", str(ESPCN_N), "--epochs", "1",
                               "--workers", "2"], model=model)
    seconds = time.perf_counter() - t0
    moved = (model.conv1.weight.detach().cpu() - w0).abs().max().item()
    print(f"[espcn] drivers.fairscale_ddp: one epoch of {ESPCN_N} synthetic images at batch "
          f"{fairscale_ddp.BATCH_SIZE} in {seconds:.1f} s (data, probe batch and model set-up "
          f"included), last loss {loss}, weights moved {moved:.2e}, on "
          f"{model.conv1.weight.device}")
    if loss is None or not math.isfinite(loss) or not moved > 0:
        raise SystemExit(f"ESPCN driver: loss {loss} or weights did not move")
    if model.conv1.weight.device.type != "cuda":
        raise SystemExit("ESPCN driver did not train on the card")
    return {"seconds": seconds, "loss": loss}


def _swinir_run(flags: dict, fp16, batches, steps: int, warmup: int,
                save_dir: str | None = None) -> dict:
    """The driver's facade under ``flags`` at the bench shape: per-micro-batch
    losses of every step, the median step ms of the timed steps, peak
    memory, the K1/K2 launches of the timed steps, and a traced step after
    them (device activities, busy ms and NCCL kernels). With ``save_dir``
    it then saves a checkpoint there (gathered, rank 0 writes, a barrier)
    and loads it back strictly into a fresh SwinIR-S."""
    import torch

    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    s = stoke_ddp.build_stoke(stoke_ddp.build_model(), fp16=fp16, batch_size=BATCH,
                              verbose=False, **flags)
    losses = []

    def one_step():
        for i in range(s.grad_accum_steps):
            x, y = batches[i % len(batches)]
            loss = s.loss(s.model(x), y)
            s.backward(loss)
            s.step()
            losses.append(loss.detach())

    for _ in range(warmup):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    twa.reset_launch_counts()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = twa.fwd_launches, twa.bwd_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"losses": [v.item() for v in losses], "step_ms": statistics.median(times),
           "peak_gib": peak + pools_gib(s), "launches": launches, "opt": type(s._opt).__name__,
           "micro": s.grad_accum_steps * steps,
           "graphs": {kind: g.captures for (kind, _), g in s._graphs.items()},
           "refused": s.graph_refusal is not None,
           **traced_call(one_step, {"K1": 24 * s.grad_accum_steps,
                                    "K2": 24 * s.grad_accum_steps})}
    if save_dir is not None:
        from pytorch_distributedtraining_tpu_torch import checkpoint

        path, _ = s.save(save_dir, "dist")
        checkpoint.load_params_dict(checkpoint.load_file(path),
                                    stoke_ddp.build_model().state_dict(), strict=True)
    return out


def phase_distributed(smi: str, lm: dict, steps: int = 5, warmup: int = 2) -> dict:
    import math

    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.benchmarks.profile_swinir import make_batches
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
    from pytorch_distributedtraining_tpu_torch.runtime import dist

    t_phase = time.perf_counter()
    batches = make_batches("cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the trajectories are compared at 1e-6
    try:
        alone = [_swinir_run(flags, fp16, batches, steps, warmup)
                 for _, flags, fp16 in DIST_LAYOUTS]
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        dist.initialize()
        print(f"[dist] process group: backend {dist.backend()}, world {dist.world_size()}, "
              f"rank {dist.rank()}, torch {torch.__version__}")
        if dist.backend() != "nccl":
            raise SystemExit(f"the group came up on {dist.backend()}, not NCCL")
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
            grouped = [_swinir_run(flags, fp16, batches, steps, warmup, ckpt_dir)
                       for _, flags, fp16 in DIST_LAYOUTS]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out = {}
    try:
        for (name, _, fp16), a, g in zip(DIST_LAYOUTS, alone, grouped):
            tol = DIST_BF16_TOL if fp16 else DIST_F32_TOL
            rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(g["losses"], a["losses"]))
            label = f"{name} {fp16 or 'f32'}"
            print(f"[dist] SwinIR-S {label}, {g['opt']}: step {g['step_ms']:.2f} ms (no group "
                  f"{a['step_ms']:.2f} ms), {BATCH * 2 * 1e3 / g['step_ms']:.1f} images/s; a "
                  f"traced step: device busy {g['busy_ms']:.2f} ms (no group "
                  f"{a['busy_ms']:.2f}), device activities {g['activities']} (no group "
                  f"{a['activities']}), host blocked {g['wait_ms']:.2f} ms (no group "
                  f"{a['wait_ms']:.2f}), NCCL kernels {g['nccl']}; peak {g['peak_gib']:.2f} GiB "
                  f"(no group {a['peak_gib']:.2f}), losses vs no group max rel {rel:.2e} (tol "
                  f"{tol:g}), last loss {g['losses'][-1]:.6f}; the split path's graphs "
                  f"(captures) {g['graphs']}, a traced step's device records K1 "
                  f"{g['kernels']['K1']} K2 {g['kernels']['K2']} (take {g['takes']}) | {smi}")
            if not rel <= tol:
                raise SystemExit(f"{label}: the trajectory with a group departs from the one "
                                 f"without: {g['losses']} vs {a['losses']}")
            per_step = {"K1": 48, "K2": 48}
            faults = kernel_faults(label, g["kernels"], per_step) + kernel_faults(
                f"{label} (no group)", a["kernels"], per_step)
            # a layout the facade runs uncaptured (graph_refusal) would
            # show in the wrappers' counts: every micro-batch
            graphs, launches = ({"first": 0, "acc": 0, "apply": 0}, (24 * g["micro"],) * 2) \
                if g["refused"] else ({"first": 1, "acc": 1, "apply": 1}, (0, 0))
            if g["launches"] != launches or g["graphs"] != graphs:
                faults.append(f"{label}: the wrappers counted {g['launches']} over the timed "
                              f"steps, expected {launches}; captures {g['graphs']}, expected "
                              f"{graphs}")
            if faults:
                raise SystemExit("; ".join(faults))
            out[label] = {"step_ms": g["step_ms"], "alone_ms": a["step_ms"], "rel": rel,
                          "busy_ms": g["busy_ms"], "nccl": g["nccl"], "peak_gib": g["peak_gib"]}

        cfg = GPT2Config.gpt2_125m()
        model, step, tokens = ladder.build_lm(cfg, LM_BATCH, LM_SEQ, torch.device("cuda"),
                                              policy="zero3", remat="full")
        w = model.transformer.h[0].attn.c_attn.weight
        w0 = w.full_tensor().detach().clone()
        first = step(tokens)["loss"].item()
        for _ in range(warmup - 1):
            step(tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tfa.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step(tokens)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches
        loss = metrics["loss"].item()
        moved = (w.full_tensor() - w0).abs().max().item()
        peak = torch.cuda.max_memory_allocated() / 2**30
        traced = traced_call(lambda: step(tokens))
        rel = abs(loss - lm["loss"]) / abs(lm["loss"])
        per = tuple(n / steps for n in launches)
        print(f"[dist] GPT-2 125M ZeRO3(remat='full'), FSDP2 over 12 blocks and the root: step "
              f"{elapsed / steps * 1e3:.2f} ms (unsharded, phase 7: {lm['step_ms']:.2f} ms), "
              f"{LM_BATCH * LM_SEQ * steps / elapsed:.1f} tokens/s, peak {peak:.2f} GiB; a "
              f"traced step: device busy {traced['busy_ms']:.2f} ms, device activities "
              f"{traced['activities']}, host blocked {traced['wait_ms']:.2f} ms, NCCL kernels "
              f"{traced['nccl']}; first loss {first:.4f} "
              f"(ln vocab "
              f"{math.log(cfg.vocab_size):.4f}), loss after {warmup + steps} steps {loss:.7f} "
              f"(unsharded {lm['loss']:.7f}, rel {rel:.2e}, tol {DIST_BF16_TOL:g}), weights "
              f"moved {moved:.2e}, launches a step K3 {per[0]:g} K4 {per[1]:g} K5 {per[2]:g} "
              f"| {smi}")
        if abs(first - math.log(cfg.vocab_size)) > 0.5:
            raise SystemExit(f"ZeRO-3 first loss {first} is not near ln(vocab)")
        if not (math.isfinite(loss) and moved > 0 and rel <= DIST_BF16_TOL):
            raise SystemExit(f"ZeRO-3 loss {loss} (unsharded {lm['loss']}) or weights moved "
                             f"{moved}")
        if launches != (2 * LM_LAYERS * steps, LM_LAYERS * steps, LM_LAYERS * steps):
            raise SystemExit(f"ZeRO-3 with full remat launched {launches}, expected K3 twice a "
                             "layer and K4, K5 once")
        out["gpt2_zero3"] = {"step_ms": elapsed / steps * 1e3, "loss": loss, "rel": rel,
                             "launches": per, "peak_gib": peak, **traced}
        del model, step
    finally:
        dist.shutdown()

    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "pytorch_distributedtraining_tpu_torch.drivers.fairscale_ddp", "--synthetic",
         "--synthetic-n", str(ESPCN_N), "--epochs", "1", "--workers", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    seconds = time.perf_counter() - t0
    last = [ln for ln in run.stdout.splitlines() if ln.startswith("For Epoch")]
    print(f"[dist] torch.distributed.run --nproc_per_node 1 drivers.fairscale_ddp: exit "
          f"{run.returncode} in {seconds:.1f} s, {last[-1] if last else 'no epoch line'}")
    if run.returncode != 0:
        raise SystemExit(f"the ESPCN driver under torch.distributed.run failed:\n"
                         f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    out["espcn_launch_s"] = seconds
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _write_patch_store(path: Path, seed: int = 0) -> None:
    """A PatchStore of M_STORE_N seeded uint8 patches, LR M_STORE_LR and HR
    twice that, written with np.save (PatchStore.build decodes images, and
    the card's machine has no PIL)."""
    import numpy as np

    g = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    lr = M_STORE_LR
    np.save(path / "lr.npy", g.integers(0, 256, (M_STORE_N, lr, lr, 3), dtype=np.uint8))
    np.save(path / "hr.npy", g.integers(0, 256, (M_STORE_N, 2 * lr, 2 * lr, 3), dtype=np.uint8))


def _swinir_m_run(ds, loader, loss, fp16, remat: str, steps: int,
                  warmup: int) -> tuple[dict, object]:
    """SwinIR-M x2 at full width through the driver's facade (AdamW, clip
    0.1, one micro-batch a step) under ``loss`` on batches of ``loader``, or, when it is
    None, of a new facade loader over ``ds`` (four spawned persistent
    workers, prefetching 2): step ms, images/s, peak GiB, losses, weights
    moved, K1/K2 launches of the timed steps, the batch wait, and a traced
    step's device busy ms; and the loader, for the next run."""
    import torch

    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.models import SwinIR
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    model = SwinIR(**SWINIR_M, remat=remat, generator=torch.Generator().manual_seed(0))
    s = stoke_ddp.build_stoke(model, fp16=fp16, batch_size=M_BATCH, grad_clip=0.1,
                              verbose=False, loss=loss)  # VGGFeatLoss for feat_loss
    s.grad_accum_steps = 1  # the driver accumulates two; a step here is one batch
    if loader is None:
        loader = s.DataLoader(ds, num_workers=4, multiprocessing_context="spawn",
                              persistent_workers=True, device_prefetch=2)
    w0 = s.model_access.conv_first.weight.detach().clone()
    t_iter = time.perf_counter()
    loader.set_epoch(0)  # every run takes the same batches, so their losses compare
    it = iter(loader)
    losses, waits = [], []

    def one_step():
        t0 = time.perf_counter()
        x, y = next(it)
        waits.append(time.perf_counter() - t0)
        loss_ = s.loss(s.model(x), y)
        s.backward(loss_)
        s.step()
        losses.append(loss_.detach())

    for _ in range(warmup):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    twa.reset_launch_counts()
    timed_from, waited = len(waits), it.wait_s
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    timed_wait = it.wait_s - waited
    launches = twa.fwd_launches, twa.bwd_launches
    peak = torch.cuda.max_memory_allocated() / 2**30 + pools_gib(s)
    # one K1 and one K2 per Swin layer a step (one micro-batch); full remat
    # runs each forward twice
    want = {"K1": (2 if remat == "full" else 1) * M_LAYERS, "K2": M_LAYERS}
    traced = traced_call(one_step, want)
    out = {
        "step_ms": elapsed / steps * 1e3, "images_per_s": M_BATCH * steps / elapsed,
        "peak_gib": peak, "losses": [v.item() for v in losses], "launches": launches,
        "kernels": traced["kernels"], "want": want, "takes": traced["takes"],
        "graphs": {kind: g.captures for (kind, _), g in s._graphs.items()},
        "moved": (s.model_access.conv_first.weight - w0).abs().max().item(),
        "wait_ms": sum(waits[timed_from:timed_from + steps]) / steps * 1e3,
        "staged": it.staged, "overlap": it.overlap_fraction(time.perf_counter() - t_iter),
        "timed_overlap": 1 - timed_wait / elapsed,
        "busy_ms": traced["busy_ms"], "activities": traced["activities"], "steps": steps,
        "families": traced["families"],
        "params": sum(p.numel() for p in model.parameters()), "remat": remat,
        "dtype": "bfloat16" if fp16 == "bf16" else "float32",
    }
    it.close()
    return out, loader


def phase_swinir_m(smi: str) -> dict:
    """Phase 12: classical SwinIR-M x2 at full width, trained through the
    facade from a PatchStore with PairedRandomAug, the facade's loader
    (four spawned workers, device prefetch 2) and
    VGGFeatLoss, in f32 and bf16, and one step under full remat for its
    peak."""
    import math

    import torch

    from pytorch_distributedtraining_tpu_torch.csrc import fastpipe
    from pytorch_distributedtraining_tpu_torch.data import PairedRandomAug, PatchStore
    from pytorch_distributedtraining_tpu_torch.losses import VGGFeatLoss

    t_phase = time.perf_counter()
    if not fastpipe.available():
        fastpipe.build()  # raises with g++'s output
    (ROOT / "build").mkdir(exist_ok=True)
    results = {}
    loader = None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_dir:
        _write_patch_store(Path(store_dir))
        ds = PatchStore(store_dir, PairedRandomAug(scale=2, crop_lr=M_LR))
        loss = VGGFeatLoss(seed=0)
        try:
            for name, fp16, remat, steps, warmup in M_RUNS:
                r, loader = _swinir_m_run(ds, loader, loss, fp16, remat, steps, warmup)
                torch.cuda.empty_cache()
                idle = 1 - r["busy_ms"] / r["step_ms"]
                print(f"[swinir-m] {name}: {r['params']} parameters, step {r['step_ms']:.2f} ms, "
                      f"{r['images_per_s']:.1f} images/s (batch {M_BATCH}, LR {M_LR} -> HR "
                      f"{2 * M_LR}, {steps} steps after {warmup}), peak {r['peak_gib']:.2f} GiB, "
                      f"loss first {r['losses'][0]:.6f} last {r['losses'][-1]:.6f}, weights "
                      f"moved {r['moved']:.2e}; a traced step: device busy {r['busy_ms']:.2f} "
                      f"ms, {r['activities']} device activities, idle share {idle:.3f}; "
                      f"peak with the window graph's pool; K1 {r['kernels']['K1']:g} K2 "
                      f"{r['kernels']['K2']:g} in the traced step's device records (take "
                      f"{r['takes']}), captures {r['graphs']}, the wrappers' launches over the "
                      f"timed steps {r['launches']} (replays); prefetcher staged "
                      f"{r['staged']}, overlap_fraction {r['overlap']:.3f} since its first batch "
                      f"was asked for ({r['timed_overlap']:.3f} over the timed steps), batch "
                      f"wait {r['wait_ms']:.3f} ms a step | {smi}")
                top = ", ".join(f"{k} {v:.2f}" for k, v in list(r["families"].items())[:6])
                print(f"[swinir-m]   {name}: device ms of the traced step by family: {top}")
                if not all(math.isfinite(v) for v in r["losses"]) or not r["moved"] > 0:
                    raise SystemExit(f"SwinIR-M {name}: losses {r['losses']} or weights moved "
                                     f"{r['moved']}")
                faults = kernel_faults(f"SwinIR-M {name}", r["kernels"], r["want"])
                if r["launches"] != (0, 0) or r["graphs"] != {"window": 1}:
                    faults.append(f"SwinIR-M {name}: the wrappers counted {r['launches']} over "
                                  f"the timed steps (replays: expected none), captures "
                                  f"{r['graphs']}")
                if faults:
                    raise SystemExit("; ".join(faults))
                results[name] = {**r, "idle": idle}
        finally:
            if loader is not None:
                loader.shutdown_workers()
    for name, ref, tol in M_SAME_LOSSES:
        got = results[name]["losses"]
        want = results[ref]["losses"][:len(got)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[swinir-m] {name} against {ref} on the same batches: losses max rel {rel:.2e} "
              f"(tol {tol:g})")
        if not rel <= tol:
            raise SystemExit(f"SwinIR-M {name} departs from {ref}: {got} vs {want}")
    print(f"[swinir-m] phase {time.perf_counter() - t_phase:.1f} s")
    return results


def swinir_m_kernels(cases: list[dict], runs: dict) -> list[dict]:
    """The kernels line's entries at phase 12's shapes, one per (kernel,
    type, pack): phase 3's errors (worst of masked and unmasked) and times
    (the masked case), and the launches a step of the phase-12 run of that
    type, from a traced step's device records (the step is a graph's
    replay; 0 at pack 2, which the model does not run)."""
    out = []
    for c in cases:
        if c["model"] != "SwinIR-M" or not c["mask"] or c["batch"] != M_BATCH:
            continue
        pair = [d for d in cases if d["model"] == "SwinIR-M" and d["dtype"] == c["dtype"]
                and d["pack"] == c["pack"] and d["batch"] == M_BATCH]
        run = next((r for r in runs.values() if r["dtype"] == c["dtype"]
                    and c["pack"] == 1 and r["remat"] == "none"), None)
        t = c["times"]
        for name, key, grads, i in (("window_attn_fwd", "fwd", ("o",), 0),
                                    ("window_attn_bwd", "bwd", ("dq", "dk", "dv", "dbias"), 1)):
            bound = c[f"{key}_bound"]
            out.append({
                "name": name, "route": "cuda", "source": SOURCES["window_attn"],
                "replaces": REPLACES[name], "dtype": c["dtype"], "pack": c["pack"],
                "shape": list(c["shape"]),
                "launches": 0 if run is None else run["kernels"][("K1", "K2")[i]],
                "max_abs_err": max(d["errors"][g][0] for d in pair for g in grads),
                "ms": t[key], "plain_ms": t[f"plain_{key}"], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": t[f"lib_{key}"],
            })
    return out


def _card_against_cpu(model, x, out_rel: float, grad_rel: float) -> tuple[float, float, float]:
    """Forward and parameter gradients of ``model`` (training mode) on the
    card against the same model on the CPU, from the same running
    statistics: (output error, gradient error, statistics error), each
    relative to the largest CPU value of its kind; raises past the
    tolerances."""
    import torch

    start = [b.clone() for b in model.buffers()]
    want = model(x)
    want.square().mean().backward()
    want_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    cpu_buffers = {n: b.clone() for n, b in model.named_buffers()}
    model.zero_grad()
    with torch.no_grad():
        for b, v in zip(model.buffers(), start):
            b.copy_(v)
    got = model.to("cuda")(x.to("cuda"))
    got.square().mean().backward()
    out_err = err(got.cpu(), want)[1]
    scale = max(g.abs().max().item() for g in want_grads.values())
    grad_err = max((p.grad.cpu() - want_grads[n]).abs().max().item()
                   for n, p in model.named_parameters()) / scale
    stats_err = max([(b.cpu() - cpu_buffers[n]).abs().max().item()
                     for n, b in model.named_buffers() if b.is_floating_point()], default=0.0)
    if not (out_err <= out_rel and grad_err <= grad_rel and stats_err <= 1e-5):
        raise SystemExit(f"{type(model).__name__} on the card departs from the CPU: output "
                         f"{out_err:.2e} (tol {out_rel:g}), grads {grad_err:.2e} (tol "
                         f"{grad_rel:g}), statistics {stats_err:.2e} (tol 1e-05)")
    return out_err, grad_err, stats_err


def image_card_checks() -> None:
    """Tiny ResNets (both stems, Basic and Bottleneck; every last BatchNorm
    scale moved off zero) and the tiny ViT in f32 and bf16 on the card
    against the CPU, within ``IMAGE_CARD_TOL``."""
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch.models import ViT, ViTConfig, resnet

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32))
    for small in (True, False):
        for block in (resnet.BasicBlock, resnet.BottleneckBlock):
            model = resnet.ResNet((1, 1), block, num_classes=10, num_filters=8,
                                  small_inputs=small, generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                for m in model.modules():
                    if isinstance(m, resnet.BatchNorm):
                        m.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(1))
            errs = _card_against_cpu(model, x, *IMAGE_CARD_TOL["float32"])
            print(f"[images] tiny ResNet ({'cifar' if small else 'imagenet'} stem, "
                  f"{block.__name__}) card vs CPU, f32: output {errs[0]:.2e}, grads "
                  f"{errs[1]:.2e}, running statistics {errs[2]:.2e} (tol "
                  f"{IMAGE_CARD_TOL['float32']}, 1e-05)")
    for dtype in (torch.float32, torch.bfloat16):
        model = ViT(ViTConfig.tiny(dtype=dtype), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():  # the init zeroes the head
            model.heads.head.weight.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(1))
        tol = IMAGE_CARD_TOL[str(dtype).split(".")[1]]
        errs = _card_against_cpu(model, x[:3], *tol)
        print(f"[images] tiny ViT card vs CPU, {dtype}: output {errs[0]:.2e}, grads "
              f"{errs[1]:.2e} (tol {tol})")


def phase_image_rungs(smi: str, steps: int = 5, warmup: int = 2) -> dict:
    """The ladder twin's image rungs at full width through its own
    builder (``benchmarks.ladder.build_image``), in a process group of one
    over NCCL."""
    import math

    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.parallel.sync_bn import batch_norm_state
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.runtime import dist

    t_phase = time.perf_counter()
    image_card_checks()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.initialize()
    out = {}
    try:
        for i in IMAGE_CONFIGS:
            name, policy, _, _, classes = ladder.IMAGE_RUNGS[i]
            twa.reset_launch_counts()
            tfa.reset_launch_counts()
            model, step, batch = ladder.build_image(i, False, torch.device("cuda"))
            batch_size, img = batch[0].shape[:2]
            w = next(model.parameters())
            w0 = (w.full_tensor() if hasattr(w, "full_tensor") else w).detach().clone()
            stats = [t for t in batch_norm_state(model) if t.is_floating_point()]
            stats0 = [t.clone() for t in stats]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            first = step(batch)["loss"].item()
            for _ in range(warmup - 1):
                step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                metrics = step(batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            loss = metrics["loss"].item()
            peak = torch.cuda.max_memory_allocated() / 2**30
            moved = ((w.full_tensor() if hasattr(w, "full_tensor") else w) - w0).abs().max().item()
            stats_moved = max([(a - b).abs().max().item() for a, b in zip(stats, stats0)],
                              default=None)
            traced = traced_call(lambda: step(batch))
            launches = (twa.fwd_launches, twa.bwd_launches, tfa.fwd_launches, tfa.dq_launches,
                        tfa.dkv_launches)
            step_ms = elapsed / steps * 1e3
            ips = batch_size * steps / elapsed
            families = sorted(traced["families"].items(), key=lambda kv: -kv[1])
            print(f"[images] {name}: {type(model).__name__} "
                  f"({sum(p.numel() for p in model.parameters())} parameters), batch "
                  f"{batch_size} x {img}x{img}x3, {classes} classes, policy {policy}, "
                  f"{type(step.tx).__name__}: step {step_ms:.2f} ms, {ips:.1f} images/s ({steps} "
                  f"steps after {warmup}), peak {peak:.2f} GiB, first loss {first:.4f} (ln "
                  f"classes {math.log(classes):.4f}), loss after {warmup + steps} steps "
                  f"{loss:.4f}, weights moved {moved:.2e}, running statistics moved "
                  f"{'n/a (no BatchNorm)' if stats_moved is None else f'{stats_moved:.2e}'}; "
                  f"a traced step: device busy {traced['busy_ms']:.2f} ms, activities "
                  f"{traced['activities']}, NCCL kernels {traced['nccl']}, by family "
                  f"{[(k, round(v, 3)) for k, v in families]}; launches K1-K5 {launches} "
                  f"| {smi}")
            if abs(first - math.log(classes)) > 1.0 or not math.isfinite(loss):
                raise SystemExit(f"{name}: first loss {first} (ln classes "
                                 f"{math.log(classes)}) or last loss {loss}")
            if not moved > 0 or (stats_moved is not None and not stats_moved > 0):
                raise SystemExit(f"{name}: weights moved {moved}, statistics moved {stats_moved}")
            if stats_moved is None and i != 5:
                raise SystemExit(f"{name}: a ResNet without BatchNorm statistics")
            if any(launches):
                raise SystemExit(f"{name}: launched window or flash kernels {launches}; no "
                                 "kernel of the port lies on the image rungs")
            out[name] = {"step_ms": step_ms, "images_per_s": ips, "peak_gib": peak,
                         "first_loss": first, "loss": loss, "busy_ms": traced["busy_ms"],
                         "families": traced["families"]}
            del model, step, batch, w, w0, stats, stats0
            torch.cuda.empty_cache()
    finally:
        dist.shutdown()
    print(f"[images] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _serve_requests(vocab: int) -> list:
    """Phase 14's trace: SERVE_REQUESTS seeded greedy requests, all arriving
    at 0, each prompt length of SERVE_PROMPTS equally often, 32-96 new tokens."""
    import numpy as np

    from pytorch_distributedtraining_tpu_torch.serve.scheduler import Request

    rng = np.random.default_rng(0)
    lens = rng.permutation(np.repeat(SERVE_PROMPTS, SERVE_REQUESTS // len(SERVE_PROMPTS)))
    news = rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1, SERVE_REQUESTS)
    return [Request(i, rng.integers(0, vocab, int(n)).astype(np.int32), int(m))
            for i, (n, m) in enumerate(zip(lens, news))]


def _ttft_s(life: dict) -> float:
    """A lifecycle's seconds from enqueue to the end of its last prefill
    chunk, the one that samples the first token."""
    return max(b for ph, _, b, _ in life["intervals"] if ph == "prefill") - life["t_start"]


def _pct(values: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), q))


def held_tokens(name: str, model, reqs: list, got: dict, want: dict) -> tuple[int, list]:
    """Greedy tokens of two runs held equal: (requests equal, [(rid, step,
    gap)] where two part). A parting must be a tie: the two tokens' logits
    from the full forward of the shared prefix (``model``, decode, on the
    card) within TIE_TOL; else the run fails."""
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch.models.generate import init_cache

    equal, parted = 0, []
    for r in reqs:
        a, b = got[r.rid], want[r.rid]
        if a == b:
            equal += 1
            continue
        d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:  # one is a prefix of the other: lengths differ
            parted.append((r.rid, min(len(a), len(b)), float("inf")))
            continue
        prefix = np.concatenate([r.prompt, np.asarray(b[:d], np.int32)])[None]
        cache = init_cache(model, 1, prefix.shape[1])
        with torch.inference_mode():
            logits = model(torch.from_numpy(prefix).cuda(), cache)[0, -1]
        parted.append((r.rid, d, abs(logits[a[d]] - logits[b[d]]).item()))
    print(f"[serve]   {name}: {equal} of {len(reqs)} requests token-identical; parted "
          f"(rid, step, |logit gap|): {parted} (a tie: gap <= {TIE_TOL:g})")
    bad = [p for p in parted if not p[2] <= TIE_TOL]
    if bad:
        raise SystemExit(f"{name}: tokens part where the logits are no tie: {bad}")
    return equal, parted


def _serve_gpt2_run(stoke, reqs: list, smi: str, label: str, **kw) -> dict:
    """One engine through ``Stoke.serve`` over ``reqs``: warm-up, the
    steady mark, the run (launch counts from 0, spans on, every dispatch's
    logits checked finite), then prefill ms per bucket and an untraced and
    a traced decode-only tick."""
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch.observe import trace
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.serve.scheduler import Request

    eng = stoke.serve(**kw)
    layout = (eng.n_slots, eng.page_size, eng.num_pages, eng.prefill_chunk, eng.prefill_buckets)
    if layout != (SERVE_SLOTS, SERVE_PAGE, SERVE_PAGES, SERVE_CHUNK, SERVE_BUCKETS):
        raise SystemExit(f"{label}: engine layout {layout}, not JAX's defaults")
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    eng.mark_steady()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    twa.reset_launch_counts()
    tfa.reset_launch_counts()
    # every prefill, decode and verify dispatch of the served trace leaves a
    # device-side "all logits finite" flag (two small kernels, no sync)
    flags, forward = [], eng._forward

    def checked_forward(*args):
        logits = forward(*args)
        flags.append(torch.isfinite(logits).all())
        return logits

    eng._forward = checked_forward
    trace.enable(crash_handler=False)
    trace.clear()
    try:
        t0 = time.perf_counter()
        recs = list(eng.run(reqs, realtime=False))
        wall = time.perf_counter() - t0
        spans = trace.records()
    finally:
        trace.disable()
        trace.clear()
        del eng._forward
    served_finite = bool(flags) and bool(torch.stack(flags).all())
    if not served_finite:
        raise SystemExit(f"{label}: non-finite logits in the served trace's "
                         f"{len(flags)} dispatches")
    launches = (twa.fwd_launches, twa.bwd_launches, tfa.fwd_launches, tfa.dq_launches,
                tfa.dkv_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = eng.metrics()
    recompiles = eng.steady_recompiles()
    eng.pool.check_invariants()
    if len(recs) != len(reqs) or any(r["new_tokens"] != q.max_new_tokens
                                     for r, q in zip(sorted(recs, key=lambda r: r["rid"]), reqs)):
        raise SystemExit(f"{label}: {len(recs)} of {len(reqs)} requests delivered in full")
    if recompiles or eng.pool.available != eng.pool.capacity:
        raise SystemExit(f"{label}: {recompiles} steady recompiles, {eng.pool.in_use} pages "
                         "still in use")
    if any(launches):
        raise SystemExit(f"{label}: launched K1-K5 {launches}; no kernel of the port lies on "
                         "GPT-2 decode")
    tick_kind = "serve.spec_verify.dispatch" if eng.spec_k else "serve.decode.dispatch"
    lives = list(eng.ledger.completed)
    ttft = [_ttft_s(life) for life in lives]
    lat = [life["wall_s"] for life in lives]
    out = {
        "tokens": {r["rid"]: r["tokens"] for r in recs}, "wall_s": wall,
        "decode_tokens_per_s": m["decode_tokens_per_sec"],
        "tokens_per_s": sum(r["new_tokens"] for r in recs) / wall,
        "ttft_p50": _pct(ttft, 50), "ttft_p99": _pct(ttft, 99),
        "latency_p50": _pct(lat, 50), "latency_p99": _pct(lat, 99),
        "tick_ms": statistics.median(r["dur"] for r in spans if r["name"] == tick_kind) * 1e3,
        "accept_rate": m["spec"]["accept_rate"], "spec_ticks": m["spec"]["ticks"],
        "ticks": m["ticks"], "programs": m["compiled_programs"], "peak_gib": peak,
    }

    # one chunk of each bucket against the null page (the warmed programs)
    null_row, zero = np.zeros((1, eng.max_pages), np.int32), np.zeros((1,), np.int32)
    prefill_ms = {}
    for b in SERVE_BUCKETS:
        chunk = np.arange(b, dtype=np.int32)[None]
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._forward(f"prefill_{b}", chunk, null_row, zero)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prefill_ms[b] = statistics.median(times)
    # decode-only ticks: every slot resident, prefill done; five untraced
    # (host clock, each ends in the tokens' host read) and one traced
    for i in range(SERVE_SLOTS):
        eng.submit(Request(1000 + i, reqs[i].prompt[:16], 64))
    while eng.sched.next_prefill() is not None or eng.sched.queue:
        eng.tick(0.0)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.tick(0.0)
        walls.append((time.perf_counter() - t0) * 1e3)
    traced = traced_call(lambda: eng.tick(0.0))
    eng.run([], realtime=False)
    if eng.steady_recompiles():
        raise SystemExit(f"{label}: steady recompiles {eng.steady_recompiles()} after the "
                         "extra ticks")
    out.update(warm_s=warm_s, prefill_ms=prefill_ms, decode_tick_ms=statistics.median(walls),
               busy_ms=traced["busy_ms"], activities=traced["activities"],
               families=traced["families"])
    out["idle"] = 1 - traced["busy_ms"] / out["decode_tick_ms"]
    decode_tick_ms, tick_ms = out["decode_tick_ms"], out["tick_ms"]
    print(f"[serve] GPT-2 125M {label}: {len(recs)} requests, {sum(r['new_tokens'] for r in recs)} "
          f"new tokens in {wall:.2f} s ({out['tokens_per_s']:.1f} tokens/s end to end; decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s over the decode ticks), {m['ticks']} ticks, "
          f"{m['compiled_programs']} programs, 0 steady recompiles, finite logits in all "
          f"{len(flags)} dispatches, warm-up {warm_s:.2f} s; TTFT "
          f"p50 {out['ttft_p50']:.3f} s p99 {out['ttft_p99']:.3f} s, latency p50 "
          f"{out['latency_p50']:.3f} s p99 {out['latency_p99']:.3f} s; {tick_kind} median "
          f"{tick_ms:.3f} ms; prefill ms by bucket {prefill_ms}; spec accept rate "
          f"{out['accept_rate']:.4f} over {out['spec_ticks']} verify ticks; peak {peak:.2f} GiB; "
          f"a decode-only tick {decode_tick_ms:.3f} ms untraced, traced device busy "
          f"{traced['busy_ms']:.3f} ms, {traced['activities']} device activities, idle share "
          f"{out['idle']:.3f} | {smi}")
    top = ", ".join(f"{k} {v:.3f}" for k, v in sorted(traced["families"].items(),
                                                       key=lambda kv: -kv[1])[:6])
    print(f"[serve]   {label}: device ms of the traced tick by family: {top}")
    del eng
    torch.cuda.empty_cache()
    return out


def _tile_run(model, compute_dtype, smi: str) -> dict:
    """The tile server over TILE_IMAGES on the card: launch counts from 0
    around the run, every request at its upscaled size, one batch against
    ``model`` (f32) on the CPU."""
    import numpy as np
    import torch

    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.serve import build_engine
    from pytorch_distributedtraining_tpu_torch.serve.tiles import TileRequest

    dt = "bfloat16" if compute_dtype is torch.bfloat16 else "float32"
    srv = build_engine(model, tile=TILE, overlap=TILE_OVERLAP, tile_batch=TILE_BATCH,
                       compute_dtype=compute_dtype, device="cuda")
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [TileRequest(i, rng.random((h, w, 3)).astype(np.float32))
            for i, (h, w) in enumerate(TILE_IMAGES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    twa.reset_launch_counts()
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    recs = srv.run(reqs)
    wall = time.perf_counter() - t0
    launches = (twa.fwd_launches, twa.bwd_launches, tfa.fwd_launches, tfa.dq_launches,
                tfa.dkv_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = srv.metrics()
    tiles = sum(r["tiles"] for r in recs)
    if launches != (M_LAYERS * m["ticks"], 0, 0, 0, 0):
        raise SystemExit(f"tile server {dt}: launches K1-K5 {launches} over {m['ticks']} tile "
                         f"batches, expected {M_LAYERS} K1 a batch and nothing else")
    shapes = {r["rid"]: r["image"].shape for r in recs}
    want = {i: (2 * h, 2 * w, 3) for i, (h, w) in enumerate(TILE_IMAGES)}
    if shapes != want or not all(np.isfinite(r["image"]).all() for r in recs):
        raise SystemExit(f"tile server {dt}: delivered {shapes}, expected {want}, finite")
    if m["steady_recompiles"] or srv.programs != {((TILE_BATCH, TILE, TILE, 3), "float32")}:
        raise SystemExit(f"tile server {dt}: programs {srv.programs}")
    # one batch (four tiles of the 96x128 image) on the card against the CPU
    img = reqs[2].image
    batch = np.stack([img[y:y + TILE, x:x + TILE] for y, x in ((0, 0), (0, 40), (48, 0),
                                                                (48, 80))])
    got = srv._apply(batch)
    with torch.no_grad():
        ref = model(torch.from_numpy(batch)).numpy()
    rel = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    lat = [life["wall_s"] for life in srv.ledger.completed]
    mpix = sum(4 * h * w for h, w in TILE_IMAGES) / 1e6
    out = {"tiles": tiles, "ticks": m["ticks"], "wall_s": wall, "tiles_per_s": tiles / wall,
           "mpix_per_s": mpix / wall, "latency_p50": _pct(lat, 50), "latency_p99": _pct(lat, 99),
           "peak_gib": peak, "launches": launches[0], "cpu_rel_err": rel, "dtype": dt,
           "warm_s": warm_s, "occupancy": m["mean_batch_occupancy"]}
    print(f"[serve] SwinIR-M x2 tile server {dt}: {len(recs)} requests, {tiles} tiles in "
          f"{m['ticks']} batches of {TILE_BATCH} (occupancy {m['mean_batch_occupancy']:.3f}) in "
          f"{wall:.3f} s: {out['tiles_per_s']:.1f} tiles/s, {out['mpix_per_s']:.3f} output "
          f"megapixels/s; request latency p50 {out['latency_p50']:.3f} s p99 "
          f"{out['latency_p99']:.3f} s; peak {peak:.2f} GiB; warm-up {warm_s:.2f} s; K1 "
          f"{launches[0]} ({M_LAYERS} a batch), K2 0; one batch against the CPU's f32: rel err "
          f"{rel:.2e} (tol {TILE_CARD_TOL[dt]:g}) | {smi}")
    if not rel <= TILE_CARD_TOL[dt]:
        raise SystemExit(f"tile server {dt}: a batch departs from the CPU's by {rel:.2e}")
    del srv
    torch.cuda.empty_cache()
    return out


def phase_serving(smi: str) -> dict:
    """Phase 14: GPT-2 125M through ``Stoke.serve`` (f32 and bf16, vanilla
    and speculative) and SwinIR-M x2 through the tile server (f32, bf16)."""
    import torch

    from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config, SwinIR
    from pytorch_distributedtraining_tpu_torch.models.gpt2 import cross_entropy_loss
    from pytorch_distributedtraining_tpu_torch.models.generate import generate
    from pytorch_distributedtraining_tpu_torch.stoke import Stoke, StokeOptimizer

    t_phase = time.perf_counter()
    out = {}
    reqs = None
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        cfg = GPT2Config(dtype=dtype)
        reqs = reqs or _serve_requests(cfg.vocab_size)
        stoke = Stoke(GPT2(cfg, generator=torch.Generator().manual_seed(0)),
                      StokeOptimizer(optimizer="AdamW"), loss=cross_entropy_loss)
        out[dt] = _serve_gpt2_run(stoke, reqs, smi, dt)
        if dtype is torch.float32:
            out["spec"] = _serve_gpt2_run(stoke, reqs, smi, f"{dt} spec_k={SERVE_SPEC_K}",
                                          spec_k=SERVE_SPEC_K)
            gen = GPT2(cfg, decode=True).cuda()
            gen.load_state_dict(stoke.model_access.state_dict())
            t0 = time.perf_counter()
            ref = {r.rid: generate(gen, r.prompt[None], r.max_new_tokens,
                                   temperature=0.0)[0, r.prompt_len:].tolist() for r in reqs}
            gen_s = time.perf_counter() - t0
            print(f"[serve]   generate(kv_layout='contiguous'), one request at a time: "
                  f"{sum(map(len, ref.values()))} tokens in {gen_s:.2f} s")
            out["f32_vs_generate"] = held_tokens("f32 engine vs generate", gen, reqs,
                                                 out[dt]["tokens"], ref)
            out["spec_vs_vanilla"] = held_tokens(f"f32 spec_k={SERVE_SPEC_K} vs vanilla", gen,
                                                 reqs, out["spec"]["tokens"], out[dt]["tokens"])
            del gen
        del stoke
        torch.cuda.empty_cache()
    same = sum(a == b for r in reqs for a, b in zip(out["bfloat16"]["tokens"][r.rid],
                                                     out["float32"]["tokens"][r.rid]))
    total = sum(r.max_new_tokens for r in reqs)
    out["bf16_same_share"] = same / total
    print(f"[serve] bf16 tokens equal to the f32 run's, position by position: {same} of {total} "
          f"({same / total:.3f}; not gated: batched and sequential GEMMs round differently)")

    model = SwinIR(**SWINIR_M, generator=torch.Generator().manual_seed(0))
    out["tiles"] = {}
    for dtype in (None, torch.bfloat16):
        r = _tile_run(model, dtype, smi)
        out["tiles"][r["dtype"]] = r
    print(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def serving_kernels(cases: list[dict], serving: dict) -> list[dict]:
    """The kernels line's K1 entries at the tile server's shape, one per
    type: phase 3's errors (worst of masked and unmasked) and times (the
    masked case), phase 14's launches over its run."""
    out = []
    for dt, run in serving["tiles"].items():
        pair = [c for c in cases if c["batch"] == TILE_BATCH and c["model"] == "SwinIR-M"
                and c["dtype"] == dt and c["pack"] == 1]
        c = next(c for c in pair if c["mask"])
        bound = c["fwd_bound"]
        out.append({
            "name": "window_attn_fwd", "route": "cuda", "source": SOURCES["window_attn"],
            "replaces": REPLACES["window_attn_fwd"], "path": "tile server", "dtype": dt,
            "shape": list(c["shape"]), "launches": run["launches"],
            "max_abs_err": max(d["errors"]["o"][0] for d in pair), "ms": c["times"]["fwd"],
            "plain_ms": c["times"]["plain_fwd"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": c["times"]["lib_fwd"],
        })
    return out


def resume_batches(n_micro: int, seed: int = 15) -> list:
    """``n_micro`` bench-shape micro-batches on the card, each its own: random
    HR 128x128 from numpy ``seed``, box-downsampled LR 64x64."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_micro):
        hr = rng.random((BATCH, 2 * LR_SIZE, 2 * LR_SIZE, 3), dtype=np.float32)
        lr = hr.reshape(BATCH, LR_SIZE, 2, LR_SIZE, 2, 3).mean(axis=(2, 4))
        out.append((torch.from_numpy(lr).cuda(), torch.from_numpy(hr).cuda()))
    return out


def resume_snapshot(stoke, losses: list) -> dict:
    """A run's losses, its parameters and its optimizer moments (whole, by
    parameter name, and the step count) on the host."""
    import torch

    from pytorch_distributedtraining_tpu_torch import optim

    opt = stoke._opt
    sd = opt.leaf_state_dict() if isinstance(opt, optim.FusedAdamW) else opt.full_state_dict()
    moments = {"count": torch.tensor(int(sd["count"]))}
    for key in ("mu", "nu"):
        vals = sd[key]
        items = vals.items() if isinstance(vals, dict) else zip(opt.names, vals)
        moments.update({f"{key}/{n}": v.detach().cpu().clone() for n, v in items})
    params = {n: p.detach().cpu().clone() for n, p in stoke.model_access.named_parameters()}
    return {"losses": list(losses), "params": params, "moments": moments}


def resume_mismatch(a: dict, b: dict) -> tuple[float, str | None]:
    """The largest absolute difference between two runs (``resume_snapshot``'s
    losses, parameters and moments), and the first entry, in that order,
    that is not bitwise equal: None when every entry is. A missing entry, a
    shape that differs or a NaN counts as an infinite difference."""
    import torch

    worst, first = 0.0, None
    for group in ("losses", "params", "moments"):
        xa, xb = a[group], b[group]
        if group == "losses":
            xa = {f"loss {i}": v for i, v in enumerate(xa)}
            xb = {f"loss {i}": v for i, v in enumerate(xb)}
        for name in list(xa) + [k for k in xb if k not in xa]:
            if name in xa and name in xb:
                ta = torch.as_tensor(xa[name], dtype=torch.float64)
                tb = torch.as_tensor(xb[name], dtype=torch.float64)
                if ta.shape == tb.shape and torch.equal(ta, tb):
                    continue
                d = (ta - tb).abs().max().item() if ta.shape == tb.shape and ta.numel() else \
                    float("inf")
                d = float("inf") if d != d else d
            else:
                d = float("inf")
            worst = max(worst, d)
            first = first or (name if group == "losses" else f"{group}/{name}")
    return worst, first


def _resume_steps(stoke, batches) -> list[float]:
    """One micro-batch of ``batches`` after another through the facade; the
    losses, read after the last."""
    losses = []
    for x, y in batches:
        loss = stoke.loss(stoke.model(x), y)
        stoke.backward(loss)
        stoke.step()
        losses.append(loss.detach())
    return [v.item() for v in losses]


def phase_resume(smi: str) -> dict:
    """Phase 15: a SwinIR-S run saved at step RESUME_SPLIT, loaded into a
    fresh facade and stepped on, against the unbroken run (bitwise), for
    each of RESUME_RUNS; then a ZeRO-2 portable checkpoint written through
    an NCCL group of one and resharded into a facade with no group."""
    import torch

    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.runtime import dist

    t_phase = time.perf_counter()
    batches = resume_batches(2 * RESUME_STEPS)
    split = 2 * RESUME_SPLIT
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # resumed and unbroken runs compared bitwise
    (ROOT / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
            for i, (label, fp16, flags) in enumerate(RESUME_RUNS):
                def build():
                    return stoke_ddp.build_stoke(stoke_ddp.build_model(), fp16=fp16,
                                                 batch_size=BATCH, verbose=False, **flags)

                a = build()
                twa.reset_launch_counts()
                unbroken = resume_snapshot(a, _resume_steps(a, batches))
                launches = twa.fwd_launches, twa.bwd_launches
                scale = None if a.loss_scaler is None else a.loss_scaler.state_dict()
                opt = type(a._opt).__name__
                # after the snapshot: one more step, traced (a replay)
                traced = traced_call(lambda: _resume_steps(a, batches[:2]), RESUME_PER_STEP)
                del a
                b = build()
                first = _resume_steps(b, batches[:split])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path, _ = b.save(ckpt_dir, f"resume_{i}")
                save_s = time.perf_counter() - t0
                nbytes = os.path.getsize(path)
                del b
                c = build()
                t0 = time.perf_counter()
                c.load(path)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                resumed = resume_snapshot(c, first + _resume_steps(c, batches[split:]))
                worst, differs = resume_mismatch(unbroken, resumed)
                scale_c = None if c.loss_scaler is None else c.loss_scaler.state_dict()
                del c
                print(f"[resume] SwinIR-S {label} ({opt}), batch {BATCH} x accum 2 at LR "
                      f"{LR_SIZE}: {RESUME_STEPS} steps unbroken vs save at step "
                      f"{RESUME_SPLIT}, load into a fresh facade, {RESUME_STEPS - RESUME_SPLIT}"
                      f" more: largest difference {worst:.3e} over {len(unbroken['losses'])} "
                      f"losses, {len(unbroken['params'])} parameters and "
                      f"{len(unbroken['moments'])} moments (first differing: {differs}), "
                      f"scaler {scale} vs {scale_c}, last loss {resumed['losses'][-1]:.6f}; "
                      f"checkpoint {nbytes} bytes, save {save_s:.3f} s, load {load_s:.3f} s; "
                      f"the wrappers' launches fwd {launches[0]} bwd {launches[1]} (the split "
                      f"path's captures), a traced step's device records K1 {traced['kernels']['K1']} "
                      f"K2 {traced['kernels']['K2']} (take {traced['takes']}) | {smi}")
                faults = kernel_faults(label, traced["kernels"], RESUME_PER_STEP)
                if launches != (capture_launches(2, 24),) * 2:
                    faults.append(f"{label}: the wrappers counted {launches}, expected the "
                                  f"split path's two captures (each loss is read after .step())")
                if faults:
                    raise SystemExit("; ".join(faults))
                if differs is not None or scale != scale_c:
                    raise SystemExit(f"{label}: the resumed run departs from the unbroken one at "
                                     f"{differs} (largest difference {worst:.3e})")
                if not all(abs(v) < float("inf") for v in unbroken["losses"]):
                    raise SystemExit(f"{label}: losses {unbroken['losses']} are not finite")
                out[label] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                              "max_diff": worst, "kernels": traced["kernels"]}

            # the driver's OSS + SDDP (ZeRO-2) over NCCL at world 1, portable
            # checkpoint, resharded into a facade with no group
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                              RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
            dist.initialize()
            try:
                if dist.backend() != "nccl":
                    raise SystemExit(f"the group came up on {dist.backend()}, not NCCL")
                g = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH,
                                          verbose=False)
                _resume_steps(g, batches[:split])
                t0 = time.perf_counter()
                portable = g.save_portable(os.path.join(ckpt_dir, "portable"))
                save_s = time.perf_counter() - t0
                saved = resume_snapshot(g, [])
                grouped = _resume_steps(g, batches[split:split + 2])
                del g
            finally:
                dist.shutdown()
            nbytes = sum(f.stat().st_size for f in Path(portable).iterdir())
            u = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH, verbose=False)
            t0 = time.perf_counter()
            u.load_resharded(portable)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            worst, differs = resume_mismatch(saved, resume_snapshot(u, []))
            alone = _resume_steps(u, batches[split:split + 2])
            rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(alone, grouped))
            print(f"[resume] portable: ZeRO-2 (OSS + SDDP) through NCCL at world 1, saved at "
                  f"step {RESUME_SPLIT} ({nbytes} bytes in {len(list(Path(portable).iterdir()))} "
                  f"files, save {save_s:.3f} s), resharded into a facade with no group (load "
                  f"{load_s:.3f} s): parameters and moments differ by {worst:.3e} (first "
                  f"differing: {differs}); the next step's losses {alone} vs the group's "
                  f"{grouped}, max rel {rel:.2e} (tol {DIST_F32_TOL:g}) | {smi}")
            if differs is not None:
                raise SystemExit(f"the resharded restore differs from the saved state at {differs}")
            if not rel <= DIST_F32_TOL:
                raise SystemExit(f"the resharded facade's step departs from the group's: {alone} "
                                 f"vs {grouped}")
            out["portable"] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s, "rel": rel}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"[resume] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 16: training health. (a) GPT-2 125M with dropout 0.1, an untied head
# and full remat through TrainStep(numerics=True), bf16, phase 7's batch;
# (b) the same forward and backward with and without remat from one dropout
# key; (c) the numerics drill on SwinIR-S at the bench shape, f32, per-leaf
# AdamW, MSE; (d) tune_batch_size(TrainStep.memory_analysis) for (c)'s step
HEALTH_STEPS, HEALTH_WARMUP, HEALTH_DROPOUT = 5, 2, 0.1
REMAT_GRAD_TOL = 1e-6  # (b): max |grad difference| / max |grad|
DRILL_STEPS, DRILL_SAVE_EVERY, DRILL_INJECT_AT = 6, 2, 2  # (c): poison step 2 (0-based)
DRILL_LEAF = "layers.2.residual_group.blocks.3.attn.qkv.weight"
TUNE_START, TUNE_MAX = BATCH, 16 * BATCH  # (d): the search's bounds, images a step


def window_shape_checks(batch: int, seed: int = 700) -> set:
    """K1 and K2 against their plain versions at SwinIR-S's shape for a
    ``batch`` of LR 64x64 crops in f32, with and without the shift mask
    (errors within ``TOL``; no timing): the launch signatures covered."""
    import torch

    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

    checked = set()
    for with_mask in (False, True):
        q, k, v, do, bias, mask = _attention_inputs(torch.float32, with_mask, batch, LR_SIZE,
                                                    seed)
        want = [twa.plain_forward(q, k, v, bias, mask),
                *twa.plain_backward(q, k, v, bias, mask, do)]
        got = [twa.kernel_forward(q, k, v, bias, mask),
               *twa.kernel_backward(q, k, v, bias, mask, do)]
        worst = max(err(a, b)[1] for a, b in zip(got, want))
        if not worst <= TOL["float32"]:
            raise SystemExit(f"K1/K2 at batch {batch} (mask {with_mask}) disagree with their "
                             f"plain versions: rel err {worst:.3e}")
        checked |= {launch_signature(kind, q, mask) for kind in ("fwd", "bwd")}
        del q, k, v, do, bias, mask, want, got
    torch.cuda.empty_cache()
    return checked


def phase_health(smi: str, lm: dict) -> dict:
    """Phase 16: training health (module docstring)."""
    import functools
    import math

    import torch

    from pytorch_distributedtraining_tpu_torch import optim
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.checkpoint_sharded import CheckpointManager
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.losses import mse_loss
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.observe import goodput, memory, numerics
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, create_train_state
    from pytorch_distributedtraining_tpu_torch.parallel.rng import DropoutKey

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    out = {}

    # (a) GPT-2 125M, dropout, untied head, full remat, the probe on
    cfg = GPT2Config(dropout=HEALTH_DROPOUT, tie_word_embeddings=False, remat=True)
    model, step, tokens = ladder.build_lm(cfg, LM_BATCH, LM_SEQ, torch.device("cuda"),
                                          numerics=True)
    w = model.lm_head.weight
    w0 = w.detach().clone()
    m = step(tokens)
    first = m["loss"].item()
    for _ in range(HEALTH_WARMUP - 1):
        step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(HEALTH_STEPS):
        m = step(tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches
    hbm = memory.record_hbm_stats()
    traced = traced_call(lambda: step(tokens))
    families = sorted(traced["families"].items(), key=lambda kv: -kv[1])[:6]
    summary = step.numerics.observe(m["numerics"], step=step.rng.step, loss=m["loss"])
    losses = [v.item() for v in losses]
    moved = (w - w0).abs().max().item()
    step_ms = elapsed / HEALTH_STEPS * 1e3
    flops = goodput.gpt2_train_flops(cfg, LM_BATCH, seq=LM_SEQ)
    mfu = goodput.mfu(flops, step_ms / 1e3, 1, "gpu", kind)
    mfu7 = goodput.mfu(goodput.gpt2_train_flops(GPT2Config(), LM_BATCH, seq=LM_SEQ),
                       lm["step_ms"] / 1e3, 1, "gpu", kind)
    per_step = tuple(n // HEALTH_STEPS for n in launches)
    # the untied head starts as flax's lecun_normal (variance 1 / n_embd), so
    # the first logits of the unit-variance final features have variance
    # ~1, and the first loss sits ~1/2 above ln(vocab) (the tied head's
    # normal(0.02) gives 768 * 0.02^2 / 2 = 0.15 above, phase 7's)
    expected_first = math.log(cfg.vocab_size) + 0.5
    print(f"[health] (a) GPT-2 125M, dropout {HEALTH_DROPOUT}, untied head, remat full, "
          f"TrainStep(numerics=True), bf16, batch {LM_BATCH} x seq {LM_SEQ}: step {step_ms:.2f} "
          f"ms, {LM_BATCH * LM_SEQ / (step_ms / 1e3):.1f} tokens/s ({HEALTH_STEPS} steps after "
          f"{HEALTH_WARMUP}), MFU {mfu:.4f} ({flops:.4g} FLOP a step, peak "
          f"{goodput.peak_flops('gpu', kind):.4g}), peak {hbm['hbm_high_water_bytes'] / 2**30:.2f}"
          f" GiB, first loss {first:.4f} (ln vocab + 1/2 {expected_first:.4f}), losses "
          f"{[round(v, 4) for v in losses]}, probe grad norm {summary['grad_norm']:.4f} param "
          f"norm {summary['param_norm']:.2f} max update ratio {summary['update_ratio_max']:.3e} "
          f"nonfinite {summary['nonfinite']}, lm_head moved {moved:.2e}, launches a step K3 "
          f"{per_step[0]} K4 {per_step[1]} K5 {per_step[2]}; a traced step: device busy "
          f"{traced['busy_ms']:.2f} ms (idle {1 - traced['busy_ms'] / step_ms:.3f} of the "
          f"untraced step), activities {traced['activities']}, by family "
          f"{[(k, round(v, 2)) for k, v in families]} | {smi}")
    print(f"[health] (a) phase 7's step (tied, no dropout, no remat): {lm['step_ms']:.2f} ms, "
          f"MFU {mfu7:.4f} | {smi}")
    if abs(first - expected_first) > 0.5:
        raise SystemExit(f"first loss {first} is not near ln(vocab) + 1/2 = {expected_first}")
    if not all(math.isfinite(v) for v in losses) or summary["nonfinite"] or not moved > 0:
        raise SystemExit(f"losses {losses}, probe nonfinite {summary['nonfinite']} or the head "
                         "did not move")
    if launches != (2 * LM_LAYERS * HEALTH_STEPS, LM_LAYERS * HEALTH_STEPS,
                    LM_LAYERS * HEALTH_STEPS):
        raise SystemExit(f"launches {launches}: expected K3 twice a layer (the recompute), K4 "
                         "and K5 once, a step")
    out["gpt2"] = {"step_ms": step_ms, "mfu": mfu, "mfu_phase7": mfu7, "launches": per_step,
                   "peak_bytes": hbm["hbm_high_water_bytes"], "losses": losses,
                   "busy_ms": traced["busy_ms"]}
    del model, step, tokens, m, w, w0
    torch.cuda.empty_cache()

    # (b) the same masks under remat: one forward and backward each
    grads, seeded = {}, {}
    for remat in (True, False):
        model, _, tokens = ladder.build_lm(GPT2Config(
            dropout=HEALTH_DROPOUT, tie_word_embeddings=False, remat=remat), LM_BATCH, LM_SEQ,
            torch.device("cuda"))
        loss, _ = ladder._lm_loss(model, tokens, DropoutKey(0))
        loss.backward()
        seeded[remat] = loss.item()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        if remat:
            with torch.no_grad():
                other = ladder._lm_loss(model, tokens, DropoutKey(1))[0].item()
        del model, tokens, loss
    diff = max((grads[True][n] - grads[False][n]).abs().max().item() for n in grads[True])
    scale = max(g.abs().max().item() for g in grads[False].values())
    bitwise = all(torch.equal(grads[True][n], grads[False][n]) for n in grads[True])
    print(f"[health] (b) dropout under remat: loss {seeded[True]:.6f} (remat) vs "
          f"{seeded[False]:.6f}, gradients max diff {diff:.3e} of max {scale:.3e} (tol "
          f"{REMAT_GRAD_TOL:g} of it), bitwise {bitwise}; another key's loss {other:.6f}")
    if not diff <= REMAT_GRAD_TOL * scale or seeded[True] != seeded[False]:
        raise SystemExit("a recomputed forward drew other dropout masks than the forward")
    if other == seeded[True]:
        raise SystemExit("a second dropout key gave the same loss")
    out["remat_dropout"] = {"max_diff": diff, "bitwise": bitwise}
    del grads
    torch.cuda.empty_cache()

    # (c) the numerics drill on SwinIR-S, f32, per-leaf AdamW
    batches = resume_batches(DRILL_STEPS, seed=16)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # runs compared bitwise

    def mse(model, b):
        return mse_loss(model(b[0]), b[1]), {}

    def drill_state():
        return create_train_state(stoke_ddp.build_model(), functools.partial(
            optim.adamw, lr=5e-4, clip_grad_norm=0.1), device="cuda")

    def timed(step, observe):
        for b in batches[:HEALTH_WARMUP]:
            step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[:HEALTH_STEPS]:
            m = step(b)
            if observe:
                step.numerics.observe(m["numerics"], step=step.rng.step, loss=m["loss"])
            else:
                m["loss"].item()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / HEALTH_STEPS * 1e3

    try:
        st = drill_state()
        twa.reset_launch_counts()
        plain_ms = timed(TrainStep(st.model, mse, st.tx, rng=st.rng), False)
        probe_ms = timed(TrainStep(st.model, mse, st.tx, rng=st.rng, numerics=True), True)
        drill_launches = twa.fwd_launches, twa.bwd_launches
        del st
        # the unbroken run
        st = drill_state()
        step = TrainStep(st.model, mse, st.tx, rng=st.rng, numerics=True)
        unbroken = [step(b)["loss"].item() for b in batches]
        want = {n: p.detach().clone() for n, p in st.module.named_parameters()}
        del st, step
        # poisoned at DRILL_INJECT_AT, rolled back to the last committed step
        st = drill_state()
        probe = numerics.NumericsProbe(inject=f"{DRILL_LEAF}@{DRILL_INJECT_AT}")
        step = TrainStep(st.model, mse, st.tx, rng=st.rng, numerics=probe)
        watchdog = numerics.NumericsWatchdog("rollback")
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
            mgr = CheckpointManager(root, save_every=DRILL_SAVE_EVERY, keep=3)
            losses, blame, rolled, i = {}, None, None, 0
            while i < len(batches):
                m = step(batches[i])
                i += 1
                summary = probe.observe(m["numerics"], step=step.rng.step, loss=m["loss"],
                                        watchdog=watchdog)
                if summary["nonfinite"] and blame is None:
                    blame = summary["blame"]
                verdict = summary.get("verdict")
                if verdict is not None:
                    rolled = watchdog.apply_action(verdict, manager=mgr, template=st)[0]
                    i = rolled
                    probe.inject_spec = None  # the drill's fault is one-shot
                    continue
                losses[i] = summary["loss"]
                if not summary["nonfinite"]:
                    mgr.maybe_save(step.rng.step, st)
            mgr.close()
        after = [losses[j + 1] for j in range(rolled, len(batches))] if rolled is not None else []
        same_losses = after == unbroken[rolled:] if rolled is not None else False
        differs = [n for n, p in st.module.named_parameters() if not torch.equal(p, want[n])]
        del st, step
        # detect_anomaly on the poisoned step: raises, parameters untouched
        st = drill_state()
        step = TrainStep(st.model, mse, st.tx, rng=st.rng, detect_anomaly=True,
                         numerics=numerics.NumericsProbe(inject=f"{DRILL_LEAF}@0"))
        before = {n: p.detach().clone() for n, p in st.module.named_parameters()}
        try:
            step(batches[0])
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        untouched = all(torch.equal(p, before[n]) for n, p in st.module.named_parameters())
        del st, step, before, want
    finally:
        torch.backends.cudnn.deterministic = deterministic
    overhead = probe_ms / plain_ms - 1
    print(f"[health] (c) SwinIR-S f32, per-leaf AdamW, MSE, batch {BATCH} LR {LR_SIZE}: step "
          f"{plain_ms:.2f} ms without the probe, {probe_ms:.2f} ms with it decoded every step "
          f"(overhead {overhead:+.3f}); blame of the poisoned step {blame} (injected "
          f"{DRILL_LEAF!r} at step {DRILL_INJECT_AT}); rollback to committed step {rolled}, "
          f"the losses after it {'equal' if same_losses else 'differ from'} the unbroken "
          f"run's bitwise ({after} vs {unbroken[rolled or 0:]}), parameters differing "
          f"{len(differs)}; detect_anomaly raised {raised is not None} ({raised}), parameters "
          f"untouched {untouched}; launches fwd {drill_launches[0]} bwd {drill_launches[1]} | "
          f"{smi}")
    if blame is None or blame["leaf"] != DRILL_LEAF or blame["layer"] != 0:
        raise SystemExit(f"the probe blamed {blame}, not {DRILL_LEAF} row 0")
    if rolled != DRILL_SAVE_EVERY or not same_losses or differs:
        raise SystemExit(f"rollback to {rolled}: the run after it departs from the unbroken one "
                         f"(losses {after} vs {unbroken}, parameters {differs[:3]})")
    if raised is None or DRILL_LEAF not in raised or not untouched:
        raise SystemExit(f"detect_anomaly: raised {raised}, parameters untouched {untouched}")
    if drill_launches != (24 * 2 * (HEALTH_WARMUP + HEALTH_STEPS),) * 2:
        raise SystemExit(f"drill launches {drill_launches}, expected 24 of each a step")
    out["drill"] = {"plain_ms": plain_ms, "probe_ms": probe_ms, "overhead": overhead,
                    "rolled_back_to": rolled}

    # (d) the largest batch whose measured peak fits the card
    st = create_train_state(stoke_ddp.build_model(), functools.partial(
        optim.adamw, lr=5e-4, clip_grad_norm=0.1), device="cuda")
    step = TrainStep(st.model, mse, st.tx, rng=st.rng)
    budget = memory.device_hbm_budget()
    probed: dict = {}

    def crops(b: int):
        g = torch.Generator(device="cuda").manual_seed(b)
        hr = torch.rand(b, 2 * LR_SIZE, 2 * LR_SIZE, 3, generator=g, device="cuda")
        return hr.reshape(b, LR_SIZE, 2, LR_SIZE, 2, 3).mean(dim=(2, 4)), hr

    def peak(b: int):
        stats = step.memory_analysis(crops(b))
        return None if stats is None else stats.peak_bytes

    t0 = time.perf_counter()
    chosen = memory.tune_batch_size(peak, budget_bytes=budget, start=TUNE_START,
                                    max_batch=TUNE_MAX, cache=probed)
    tune_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = step(crops(chosen))
    real_loss = m["loss"].item()
    real_peak = torch.cuda.max_memory_allocated()
    del st, step, m
    torch.cuda.empty_cache()
    checked = set()
    for b in sorted(probed):
        checked |= window_shape_checks(b)
    print(f"[health] (d) tune_batch_size(TrainStep.memory_analysis), SwinIR-S f32 at LR "
          f"{LR_SIZE}, budget {budget / 2**30:.2f} GiB x 0.9, batches {TUNE_START}..{TUNE_MAX}: "
          f"probed {{{', '.join(f'{b}: {v / 2**30:.2f} GiB' for b, v in sorted(probed.items()))}}}"
          f" in {tune_s:.1f} s, chosen batch {chosen} (projected peak "
          f"{probed[chosen] / 2**30:.2f} GiB), a step there: loss {real_loss:.5f}, "
          f"max_memory_allocated {real_peak / 2**30:.2f} GiB; K1/K2 held against their plain "
          f"versions at every probed batch | {smi}")
    if not math.isfinite(real_loss):
        raise SystemExit(f"the step at the chosen batch {chosen} gave loss {real_loss}")
    out["memory"] = {"batch": chosen, "projected": probed[chosen], "real_peak": real_peak,
                     "probed": probed}
    out["checked"] = checked
    print(f"[health] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 17: observe part 2. (a) the flagship facade under DDP over NCCL at
# world 1 with the capture armed, tripped by a poisoned gradient at optimizer
# step CAPTURE_INJECT_AT (0-based): the numerics plane sees it on the next
# step, the capture then traces the armed profiler's default window of three
# optimizer steps (it lands after step 5 of at most CAPTURE_MAX_STEPS);
# IDLE_POLLS polls of an armed, idle profiler.
# (b) GPT-2 125M bf16 under ZeRO3 (no remat), GPT2_TRACED_STEPS traced steps.
CAPTURE_INJECT_AT, CAPTURE_MAX_STEPS, IDLE_POLLS = 1, 8, 10_000
GPT2_TRACED_STEPS, OPCOST_TOP = 3, 40
WINDOW_KERNELS = {"K1": "window_attn_fwd_kernel", "K2": "window_attn_bwd_kernel"}
FLASH_KERNELS = {"K3": "flash_attn_fwd_kernel", "K4": "flash_attn_dq_kernel",
                 "K5": "flash_attn_dkv_kernel"}


def table_launches(table: dict, kernels: dict) -> dict:
    """``{id: events}`` of the op table's compute row for each kernel
    (``observe.opcost.op_table`` groups a kernel's template instantiations
    under its name); 0 for a kernel with no row."""
    rows = {r["op"]: r["events"] for r in table["ops"] if r["class"] == "compute"}
    return {k: rows.get(name, 0) for k, name in kernels.items()}


def wire_counts(wires) -> dict:
    """``{kind: records}`` of a collective inventory (``observe.comms``)."""
    out: dict = {}
    for w in wires:
        out[w.kind] = out.get(w.kind, 0) + 1
    return out


def fsdp_all_gathers(events) -> int:
    """The all-gathers FSDP2 issued in a trace: its ``FSDP::all_gather (<module>)``
    annotations (FSDP2 skips the collective, annotation and all, at one rank
    on torch 2.13)."""
    return sum(1 for e in events if e.get("cat") == "user_annotation"
               and str(e.get("name", "")).split(" (")[0] == "FSDP::all_gather")


LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")


def lost_launches(events) -> list:
    """The correlation ids of a trace's CUDA launch, copy and set calls
    (``cuda_runtime``/``cuda_driver`` events) whose device activity is not
    in it: the device records the profiler lost."""
    devices = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    return [e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and any(k in e.get("name", "") for k in LAUNCH_CALLS)
            and "correlation" in e.get("args", {}) and e["args"]["correlation"] not in devices]


def lost_where(events) -> dict:
    """Where a trace's lost launches (``lost_launches``) lie: their count
    among all launch, copy and set calls, their first and last index in
    time order, their offsets in ms from the first call and to the last,
    their call names, the host threads that made them beside all threads
    that launched, and the host ops (by external id) they came from."""
    calls = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and any(k in e.get("name", "") for k in LAUNCH_CALLS)
                    and "correlation" in e.get("args", {})), key=lambda e: e["ts"])
    lost = set(lost_launches(events))
    idx = [i for i, e in enumerate(calls) if e["args"]["correlation"] in lost]
    if not idx:
        return {"lost": 0, "of": len(calls)}
    t0, t1 = calls[0]["ts"], calls[-1]["ts"]
    ops = {e["args"].get("External id"): e.get("name") for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    picked = [calls[i] for i in idx]
    return {"lost": len(idx), "of": len(calls), "first": idx[0], "last": idx[-1],
            "from_first_ms": [round((picked[0]["ts"] - t0) / 1e3, 3),
                              round((picked[-1]["ts"] - t0) / 1e3, 3)],
            "to_last_ms": [round((t1 - picked[-1]["ts"]) / 1e3, 3),
                           round((t1 - picked[0]["ts"]) / 1e3, 3)],
            "names": sorted({e["name"] for e in picked}),
            "tids": sorted({str(e.get("tid")) for e in picked}),
            "all_tids": sorted({str(e.get("tid")) for e in calls}),
            "ops": sorted({str(ops.get(e["args"].get("External id"))) for e in picked})[:8]}


def launch_faults(launches: dict, per_step: int, steps: int) -> list[str]:
    """The kernels whose launches over ``steps`` steps are not ``per_step``
    a step."""
    return [f"{k}: {n} launches over {steps} steps, expected {per_step} a step"
            for k, n in launches.items() if n != per_step * steps]


def phase_observe(smi: str) -> dict:
    """Phase 17: observe part 2 (module docstring)."""
    import warnings

    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.benchmarks.profile_swinir import make_batches
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.observe import (capture, comms, goodput, numerics,
                                                               opcost, profiling)
    from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
    from pytorch_distributedtraining_tpu_torch.runtime import dist
    from pytorch_distributedtraining_tpu_torch.runtime.mesh import mesh_shape

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    env = {"GRAFT_OPCOST": "1", "GRAFT_NUMERICS": "1", "GRAFT_NUMERICS_ACTION": "rollback",
           "GRAFT_NUMERICS_INJECT": f"{DRILL_LEAF}@{CAPTURE_INJECT_AT}"}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.initialize()
    try:
        if dist.backend() != "nccl":
            raise SystemExit(f"the group came up on {dist.backend()}, not NCCL")
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as cap_root:
            # (a) the flagship path: the facade under DDP, tripped by numerics
            os.environ.update(env, GRAFT_CAPTURE=cap_root)
            try:
                capture.reset()
                numerics.reset()
                tables0 = opcost.runtime_stats["tables_built"]
                s = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH,
                                          verbose=False, oss=False, sddp=False)
            finally:
                for k in (*env, "GRAFT_CAPTURE"):
                    os.environ.pop(k, None)
            batches = make_batches("cuda")
            times, fired, landed, window0, counted = [], None, None, None, None
            while landed is None and len(times) < CAPTURE_MAX_STEPS:
                t0 = time.perf_counter()
                for x, y in batches:
                    s.backward(s.loss(s.model(x), y))
                    s.step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                now = {"K1": twa.fwd_launches, "K2": twa.bwd_launches}
                if fired is None and s.capture.capturing is not None:
                    fired, window0 = len(times), now
                elif fired is not None and s.capture.capturing is None:
                    landed = len(times)
                    counted = {k: v - window0[k] for k, v in now.items()}
            summary, result = s.capture.summary(), s.opcost_result
            cap_events = (opcost.load_trace_events(summary["capture_dirs"][-1])[0]
                          if summary["capture_dirs"] else [])
            where = lost_where(cap_events) if summary["capture_dirs"] else None
            lost = where and where["lost"]
            replays = sum(1 for e in cap_events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                          and "GraphLaunch" in e.get("name", ""))
            # a replay makes no c10d call for observe.comms to read, so the
            # window program's collectives are read from one step of it run
            # uncaptured (Stoke.uncaptured: the same function)
            def uncaptured_step():
                with s.uncaptured():
                    for x, y in batches:
                        s.backward(s.loss(s.model(x), y))
                        s.step()

            twin_wires = comms.wire_inventory(profiling.profile_call(uncaptured_step)[1],
                                              group_size=1)
            # the same steps under a raw torch.profiler session, without the
            # guard's warm-up: what it loses is the fault the warm-up absorbs
            raw = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                     torch.profiler.ProfilerActivity.CUDA])
            with raw:
                for _ in range(s.capture.capture_steps):
                    for x, y in batches:
                        s.backward(s.loss(s.model(x), y))
                        s.step()
                torch.cuda.synchronize()
            raw.export_chrome_trace(os.path.join(cap_root, "raw.json"))
            raw_where = lost_where(opcost.read_trace(os.path.join(cap_root, "raw.json")))
            raw_lost = raw_where["lost"]
            for _ in range(2):  # untraced steps after the capture, for its cost
                t0 = time.perf_counter()
                for x, y in batches:
                    s.backward(s.loss(s.model(x), y))
                    s.step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            step_ms = statistics.median(times[-2:])
            grad_elems = s._opt.flat_grad.numel()
            idle = capture.OnDemandProfiler(trace_dir=os.path.join(cap_root, "idle")).arm()
            t0 = time.perf_counter()
            for _ in range(IDLE_POLLS):
                idle.poll()
            poll_us = (time.perf_counter() - t0) / IDLE_POLLS * 1e6
            del s
        torch.cuda.empty_cache()
        if landed is None or result is None:
            raise SystemExit(f"phase 17 (a): no capture landed an op table in "
                             f"{CAPTURE_MAX_STEPS} steps (fired after step {fired}, landed "
                             f"after step {landed}; capture {summary}, tables built "
                             f"{opcost.runtime_stats['tables_built'] - tables0})")
        table = result["table"]
        launches = table_launches(table, WINDOW_KERNELS)
        reduces = [w for w in twin_wires if w.kind == "all-reduce"]
        grad_reduces = [w for w in reduces if w.elems == grad_elems]
        band = result["bandwidth"] or {}
        rates = {ax: ("not measured (no NCCL kernel ran: a one-rank collective is a copy)"
                      if row["bytes_per_s"] is None else f"{row['bytes_per_s']:.4g} B/s")
                 for ax, row in band.items()}
        top_rows = [(r["op"][:60], r["class"], r["events"], round(r["s"] * 1e3, 3))
                    for r in table["ops"][:8]]
        print(f"[observe] (a) SwinIR-S facade, DDP + FusedAdamW over NCCL world 1, f32, batch "
              f"{BATCH} LR {LR_SIZE} accum 2, feat_loss, GRAFT_OPCOST=1 GRAFT_CAPTURE=<build "
              f"dir>, GRAFT_NUMERICS_INJECT={DRILL_LEAF}@{CAPTURE_INJECT_AT} (rollback): capture "
              f"source {summary['last_trigger'] and summary['last_trigger']['source']}, fired "
              f"after step {fired}, landed after step {landed}, dir "
              f"{summary['capture_dirs']}, tables built "
              f"{opcost.runtime_stats['tables_built'] - tables0}; op table: total "
              f"{table['total_s'] * 1e3:.2f} ms over {result['steps']} steps, classes "
              f"{ {k: round(v['seconds'] * 1e3, 3) for k, v in table['classes'].items()} } ms, "
              f"top rows (op, class, launches, ms) {top_rows}; K1/K2 launches {launches} "
              f"({launches['K1'] / result['steps']:g} and {launches['K2'] / result['steps']:g} "
              f"a step; the wrappers counted {counted}: every step a replay); launches without "
              f"their device record: "
              f"{lost} in the capture ({where}), {raw_lost} in a raw torch.profiler session of "
              f"as many steps ({raw_where}); graph launches in the capture {replays} (a replay "
              f"a step); collectives in the capture {wire_counts(result['wires'])}, in one step "
              f"run uncaptured {wire_counts(twin_wires)}: {len(grad_reduces)} all-reduce "
              f"records of the flat gradient ({grad_elems} f32 elements, {4 * grad_elems} B a "
              f"step) among {len(reduces)}, bandwidth {rates}; untraced step {step_ms:.2f} ms; "
              f"an armed "
              f"idle poll {poll_us:.3f} us ({poll_us / (step_ms * 1e3):.2e} of the step) | {smi}")
        faults = launch_faults(launches, 2 * 24, result["steps"])
        if counted != {"K1": 0, "K2": 0} or lost != 0:
            faults.append(f"the wrappers counted {counted} over the captured steps (replays: "
                          f"expected none), or {lost} launches have no device record ({where})")
        if summary["captures"] != 1 or summary["last_trigger"]["source"] != "numerics":
            faults.append(f"capture {summary}: expected one, by the numerics plane")
        if opcost.runtime_stats["tables_built"] != tables0 + 1:
            faults.append("opcost.runtime_stats['tables_built'] did not grow by the capture's "
                          "table")
        if replays != result["steps"]:
            faults.append(f"{replays} graph launches in the capture of {result['steps']} steps: "
                          f"expected the window's replay a step")
        if len(grad_reduces) != 1:
            faults.append(f"{len(grad_reduces)} all-reduces of the {grad_elems}-element "
                          f"gradient in one step of the window program: {reduces}")
        if any(row["bytes_per_s"] == 0 for row in band.values()):
            faults.append(f"a bandwidth of 0 B/s: {band}")
        if faults:
            raise SystemExit("phase 17 (a): " + "; ".join(faults))
        out["capture"] = {"launches": launches, "poll_us": poll_us, "step_ms": step_ms,
                          "grad_bytes": 4 * grad_elems, "bandwidth": band}

        # (b) GPT-2 125M under ZeRO3 through profiler_trace
        cfg = GPT2Config.gpt2_125m()
        model, step, tokens = ladder.build_lm(cfg, LM_BATCH, LM_SEQ, torch.device("cuda"),
                                              policy="zero3")
        step(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GPT2_TRACED_STEPS):
            step(tokens)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) / GPT2_TRACED_STEPS * 1e3
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as logdir:
            second = os.path.join(logdir, "second")
            with profiling.trace(os.path.join(logdir, "run")):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with profiling.trace(second):
                        pass
                for _ in range(GPT2_TRACED_STEPS):
                    step(tokens)
            reentrant = [str(w.message) for w in caught if w.category is RuntimeWarning]
            second_made = os.path.exists(second)
            events, _ = opcost.load_trace_events(os.path.join(logdir, "run"))
            fsdp_gathers = fsdp_all_gathers(events)
            where_b = lost_where(events)
            lost_b = where_b["lost"]
            opcost_ok = True
            try:
                res = opcost.ingest_trace(os.path.join(logdir, "run"),
                                          mesh_axes=mesh_shape(step.mesh),
                                          steps=GPT2_TRACED_STEPS, top=OPCOST_TOP,
                                          device="cuda")
            except RuntimeError as e:
                opcost_ok, res = str(e), None
        if res is None:
            raise SystemExit(f"phase 17 (b): no op table from the GPT-2 trace ({opcost_ok})")
        flash = table_launches(res["table"], FLASH_KERNELS)
        gpt2_counts = wire_counts(res["wires"])
        flops = goodput.gpt2_train_flops(cfg, LM_BATCH, seq=LM_SEQ)
        compute_s = res["table"]["classes"]["compute"]["seconds"] / GPT2_TRACED_STEPS
        calib = opcost.calibrate({"mfu_flops": {
            "analytic": flops / goodput.peak_flops("gpu", kind), "measured": compute_s,
            "unit": "s"}})
        ag = [w for w in res["wires"] if w.kind == "all-gather"]
        rs = [w for w in res["wires"] if w.kind == "reduce-scatter"]
        print(f"[observe] (b) GPT-2 125M bf16 ZeRO3 (FSDP2) at NCCL world 1, batch {LM_BATCH} x "
              f"seq {LM_SEQ}, profiler_trace over {GPT2_TRACED_STEPS} steps: K3/K4/K5 launches "
              f"{flash} ({', '.join(f'{k} {n / GPT2_TRACED_STEPS:g}' for k, n in flash.items())}"
              f" a step; {lost_b} launches without their device record: {where_b}); FSDP2's all-gathers (its FSDP::all_gather annotations) "
              f"{fsdp_gathers}; collective records {gpt2_counts} (all-gather elements "
              f"{sum(w.elems for w in ag)}, reduce-scatter input elements "
              f"{sum(w.in_elems for w in rs)}, dtypes {sorted({w.dtype for w in ag + rs})}); "
              f"op classes {({k: round(v['seconds'] * 1e3, 3) for k, v in res['table']['classes'].items()})} "
              f"ms; a second profiler_trace inside: no-op {not second_made}, warning "
              f"{reentrant}; calibrate mfu_flops {calib.get('mfu_flops')} (analytic "
              f"{flops:.4g} FLOP over {goodput.peak_flops('gpu', kind):.4g} FLOP/s; measured: "
              f"compute seconds a step of the trace; untraced step {untraced_ms:.2f} ms) | {smi}")
        faults = launch_faults(flash, LM_LAYERS, GPT2_TRACED_STEPS)
        if lost_b:
            faults.append(f"the trace lost the device records of {lost_b} launches ({where_b})")
        if len(ag) != fsdp_gathers or (fsdp_gathers and not rs):
            faults.append(f"FSDP2 issued {fsdp_gathers} all-gathers (its FSDP::all_gather "
                          f"annotations), the inventory holds {gpt2_counts}")
        if second_made or not any("already active" in m for m in reentrant):
            faults.append(f"the second entrant was not a no-op with a warning: made "
                          f"{second_made}, warnings {reentrant}")
        if "mfu_flops" not in calib:
            faults.append(f"no mfu_flops row: {calib}")
        if faults:
            raise SystemExit("phase 17 (b): " + "; ".join(faults))
        out["gpt2"] = {"launches": flash, "counts": gpt2_counts, "calibration": calib,
                       "untraced_ms": untraced_ms}
        del model, step, tokens
    finally:
        dist.shutdown()
    torch.cuda.empty_cache()
    print(f"[observe] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 18: the launcher on the card. The reference's launch line (python -m
# torch.distributed.launch --nproc_per_node=4 Stoke-DDP.py) as the port runs
# it: runtime.launch starts the SwinIR-S driver as a file, one rank, in an
# NCCL group of one, with phase 5's arguments (DRIVER_N synthetic images,
# batch BATCH; no loader workers in (a) and (b), whose start each generation
# would pay; (w) runs (a) with phase 5's two a loader and times its epochs), so
# the children launch K1/K2 at phase 5's shapes, which phase 3 holds against
# the plain versions: q/k/v [BATCH * 16, 6, 64, 10] for training,
# [DRIVER_VAL * 16, ...] for validation.
# The children's launches are counted by their own wrappers and printed after
# each epoch (the driver's --kernel-launches line), so a killed generation
# shows the epochs it finished.
LAUNCH_EPOCHS = 3
# (b) kills generation 0 inside epoch 2's portable save. One portable save
# makes one ckpt.write hit a rank (in the writer, after its staging dir
# exists) and no checkpoint.write hit (that site is on the sharded and
# CheckpointManager paths only, as in JAX), so the kill is the third ckpt.write
# hit, attempt 0: epoch_0002.tmp is left torn, and the relaunch resumes from
# epoch_0001
LAUNCH_KILL_AT = 3
LAUNCH_TOL = 1e-6  # (b)'s final losses against (a)'s, relative; bitwise expected
# (c): JAX's bench recovery arm (bench.py): K = 4, GRAFT_DRILL_STEPS = K + 2
DRILL_K = 4
LAUNCH_MODULE = "pytorch_distributedtraining_tpu_torch.runtime.launch"
INHERITED_CONTRACT = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launch_env(run_dir: str, **extra) -> dict:
    """The environment of a launcher run: this process's, without a group's
    contract or any GRAFT_* knob an earlier phase left, plus ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if k not in INHERITED_CONTRACT and not k.startswith("GRAFT_")}
    env.update(PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1", WANDB_MODE="disabled",
               TMPDIR=run_dir, GRAFT_RESTART_BACKOFF="0.1", **extra)
    return env


def timed_lines(cmd: list, cwd: str, env: dict, timeout: float,
                on_line=None) -> tuple[int | None, list, float]:
    """Run ``cmd`` (stderr into stdout) in a process group of its own and
    return its exit code (None when it outlived ``timeout`` and the whole
    group was killed: the launcher and every child it started), each output
    line with the seconds since the start at which it arrived, and the wall
    seconds. ``on_line(line, pid)`` sees each line as it arrives, with the
    pid of ``cmd``'s process."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
            if on_line is not None:
                on_line(lines[-1][1], proc.pid)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    rc = None
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # strays of a finished run too
        proc.wait()
        reader.join(timeout=10)
    return rc, lines, time.perf_counter() - t0


def grandchildren(pid: int) -> list:
    """``(pid, start ticks)`` of the children of ``pid``'s children, from
    ``/proc``: the launcher's ranks' own processes (loader workers)."""
    parent, start = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", encoding="utf-8") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        parent[int(d)], start[int(d)] = int(fields[1]), int(fields[19])
    ranks = {p for p, pp in parent.items() if pp == pid}
    return sorted((p, start[p]) for p, pp in parent.items() if pp in ranks)


def parse_driver_run(lines: list) -> dict:
    """The stoke driver's final losses, its ``[kernels]`` lines by attempt,
    its resume lines, the launcher's restart lines and the seconds at which
    each generation reached its training loop."""
    text = [ln for _, ln in lines]
    kernels: dict = {}
    for ln in text:
        if ln.startswith("[kernels] "):
            doc = json.loads(ln[len("[kernels] "):])
            kernels.setdefault(doc["attempt"], []).append(doc)
    train = re.findall(r"Train Loss after Epoch (\d+) - (\S+) -", "\n".join(text))
    val = re.findall(r"Val Loss after Epoch (\d+) - (\S+) -", "\n".join(text))
    return {
        "train": [(int(e), float(v)) for e, v in train], "val": [(int(e), float(v)) for e, v in val],
        "kernels": kernels,
        "resumed": [ln for ln in text if ln.startswith("===> Resumed portable checkpoint")],
        "restarts": [ln for ln in text if re.search(r"restart \d+/\d+", ln)],
        "training_at": [t for t, ln in lines if ln.startswith("===> Training")],
        "epochs_at": [round(t, 2) for t, ln in lines if "Val Loss after Epoch" in ln],
        "restart_at": [t for t, ln in lines if re.search(r"restart \d+/\d+", ln)],
    }


def phase_launch(smi: str) -> dict:
    """Phase 18: the launcher on the card (module docstring)."""
    t_phase = time.perf_counter()
    driver = ROOT / "pytorch_distributedtraining_tpu_torch" / "drivers" / "stoke_ddp.py"
    drill = ROOT / "pytorch_distributedtraining_tpu_torch" / "runtime" / "recovery_drill.py"
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        runs = {}
        for name, restarts, plan, threads in (
                ("a", 0, None, 0),
                ("b", 1, {"faults": [{"site": "ckpt.write", "action": "kill", "attempt": 0,
                                      "at": LAUNCH_KILL_AT}]}, 0),
                ("w", 0, None, 2)):
            run_dir = os.path.join(work, name)
            portable = os.path.join(run_dir, "portable")
            os.makedirs(run_dir)
            env = launch_env(run_dir)
            if plan is not None:
                env["GRAFT_FAULT_PLAN"] = json.dumps(plan)
            # the portable dir as the launcher decides the restart (the
            # relaunch's start, ~10 s, comes before its first write), and
            # the ranks' loader workers at each epoch's end
            at_restart, workers = [], []

            def on_line(line, pid, portable=portable, at_restart=at_restart,
                        workers=workers):
                if re.search(r"restart \d+/\d+", line) and not at_restart:
                    at_restart.append(sorted(os.listdir(portable)))
                elif "Val Loss after Epoch" in line:
                    workers.append(grandchildren(pid))

            rc, lines, wall = timed_lines(
                [sys.executable, "-m", LAUNCH_MODULE, "--nproc_per_node", "1",
                 "--max_restarts", str(restarts), str(driver), "--synthetic", "--synthetic-n",
                 str(DRIVER_N), "--batchSize", str(BATCH), "--nEpochs", str(LAUNCH_EPOCHS),
                 "--threads", str(threads), "--deterministic", "--kernel-launches",
                 "--portable-ckpt", portable], run_dir, env, timeout=300, on_line=on_line)
            with open(os.path.join(run_dir, "output.log"), "w") as fh:
                fh.writelines(f"{t:9.3f} {ln}\n" for t, ln in lines)
            parsed = parse_driver_run(lines)
            parsed.update(rc=rc, wall=wall, tail=[ln for _, ln in lines[-30:]],
                          at_restart=at_restart, workers=workers)
            runs[name] = parsed
        a, b, w = runs["a"], runs["b"], runs["w"]
        faults = []
        for name, run in runs.items():
            if run["rc"] != 0:
                faults.append(f"({name}) the launcher exited {run['rc']}: {run['tail']}")
        last = LAUNCH_EPOCHS - 1
        final = {name: (dict(run["train"]).get(last), dict(run["val"]).get(last))
                 for name, run in runs.items()}
        rel, rel_w = ([abs(x - y) / max(abs(y), 1e-30) for x, y in zip(final[n], final["a"])
                       if x is not None and y is not None] for n in ("b", "w"))
        # an epoch's seconds: from the training loop's start, then from the
        # previous epoch's end
        epoch_s = {n: [round(t1 - t0, 2) for t0, t1 in zip(
            runs[n]["training_at"][:1] + runs[n]["epochs_at"], runs[n]["epochs_at"])]
            for n in ("a", "w")}
        per_gen = {name: {att: (docs[-1]["window_attn_fwd"], docs[-1]["window_attn_bwd"])
                          for att, docs in run["kernels"].items()} for name, run in runs.items()}
        # the driver's loop reads each loss after .step(): the split path's
        # first and accumulating programs are captured once in the process
        # (their warm-ups and captures are what the wrappers count; every
        # training micro-batch after is a replay), and so is the validation's
        # eval program (every later epoch's validation batch replays it)
        full = (capture_launches(3, 24), capture_launches(2, 24))
        gen_start = {"a gen 0": a["training_at"][:1], "b gen 0": b["training_at"][:1],
                     "b gen 1": [t - b["restart_at"][0] for t in b["training_at"][1:2]]
                     if b["restart_at"] else []}
        restart_cost = b["wall"] - a["wall"]
        print(f"[launch] (a) {LAUNCH_MODULE} --nproc_per_node 1 stoke_ddp.py (SwinIR-S x2, NCCL "
              f"world 1, f32, {DRIVER_N} synthetic images, batch {BATCH}, {LAUNCH_EPOCHS} epochs, "
              f"--deterministic): rc {a['rc']}, {a['wall']:.1f} s; final train {final['a'][0]!r}"
              f", val {final['a'][1]!r}; K1/K2 launches by generation {per_gen['a']}; its "
              f"training loop at {a['training_at']} s, epochs done at {a['epochs_at']} s | {smi}")
        print(f"[launch] (b) the same with --max_restarts 1 and a ckpt.write kill at hit "
              f"{LAUNCH_KILL_AT} of attempt 0 (inside epoch 2's portable save): rc {b['rc']}, "
              f"{b['wall']:.1f} s; launcher {b['restarts']}; {b['resumed']}; final train "
              f"{final['b'][0]!r}, val {final['b'][1]!r}; relative difference to (a) "
              f"{[f'{r:.3e}' for r in rel]} (tol {LAUNCH_TOL:g}); K1/K2 launches by generation "
              f"{per_gen['b']}; training loops at {b['training_at']} s, epochs done at "
              f"{b['epochs_at']} s, restart line at {b['restart_at']} s | {smi}")
        print(f"[launch] restart cost on the card: (b) - (a) = {restart_cost:.1f} s of wall; a "
              f"generation's start (launch or restart line to its '===> Training') "
              f"{ {k: [round(t, 2) for t in v] for k, v in gen_start.items()} } s; the "
              f"portable dir at the restart line {b['at_restart']} | {smi}")
        worker_sets = [[p for p, _ in ws] for ws in w["workers"]]
        print(f"[launch] (w) (a) with --threads 2 (two spawn loader workers a loader): rc "
              f"{w['rc']}, {w['wall']:.1f} s; final train {final['w'][0]!r}, val "
              f"{final['w'][1]!r}, relative difference to (a) {[f'{r:.3e}' for r in rel_w]}; "
              f"K1/K2 {per_gen['w']}; training loop at {w['training_at']} s; epoch seconds "
              f"(w) {epoch_s['w']} against (a) {epoch_s['a']}; the rank's child processes "
              f"(pid, start ticks) at each epoch's end {w['workers']} | {smi}")
        if len(b["restarts"]) != 1 or "restart 1/1" not in b["restarts"][0]:
            faults.append(f"(b) expected one 'restart 1/1', the launcher said {b['restarts']}")
        if b["at_restart"] != [["epoch_0000", "epoch_0001", "epoch_0002.tmp"]]:
            faults.append(f"(b) generation 0 did not leave epoch_0002.tmp torn past the "
                          f"committed epoch_0001: the portable dir at the restart line held "
                          f"{b['at_restart']}")
        if len(b["resumed"]) != 1 or "epoch_0001 (resharded onto this run), from epoch 2 " \
                "(recovery_mode=retry)" not in b["resumed"][0]:
            faults.append(f"(b) generation 1 did not resume past the torn epoch_0002.tmp from "
                          f"epoch_0001 with recovery_mode=retry: {b['resumed']}")
        if sorted(per_gen["b"]) != [0, 1]:
            faults.append(f"(b) generation 1 saw no GRAFT_RESTART_ATTEMPT=1 (attempts "
                          f"{sorted(per_gen['b'])} in its [kernels] lines)")
        if len(rel) != 2 or max(rel) > LAUNCH_TOL:
            faults.append(f"(b)'s final losses {final['b']} depart from (a)'s {final['a']}")
        for name in ("a", "w"):
            if per_gen[name].get(0) != full:
                faults.append(f"({name}) launched K1/K2 {per_gen[name]}, expected {full} over "
                              f"the run")
        if len(rel_w) != 2 or max(rel_w) > LAUNCH_TOL:
            faults.append(f"(w)'s final losses {final['w']} depart from (a)'s {final['a']}")
        if len(worker_sets) != LAUNCH_EPOCHS or not worker_sets[0] or any(
                ws != worker_sets[0] for ws in worker_sets):
            faults.append(f"(w)'s loader workers did not persist across the epochs: "
                          f"{w['workers']}")
        for name, gens in per_gen.items():
            if not gens or any(f == 0 or k2 == 0 for f, k2 in gens.values()):
                faults.append(f"({name}) a generation launched no K1 or no K2: {gens}")
        if faults:
            raise SystemExit("phase 18: " + "; ".join(faults))
        out["driver"] = {"final": final, "rel": rel, "rel_w": rel_w,
                         "walls": (a["wall"], b["wall"], w["wall"]),
                         "restart_cost_s": restart_cost, "gen_start_s": gen_start,
                         "epoch_s": epoch_s, "launches": per_gen}

        # (c) the recovery drill, JAX's bench plan, at world 1 on the card
        run_dir = os.path.join(work, "drill")
        os.makedirs(run_dir)
        events_path = os.path.join(run_dir, "events.jsonl")
        plan = {"faults": [
            {"site": "ckpt.write", "action": "sleep", "arg": 600, "rank": 0, "attempt": 0,
             "match": {"step": DRILL_K - 1}},
            {"site": "train.preempt", "action": "kill", "rank": 0, "attempt": 0,
             "match": {"step": DRILL_K}}]}
        env = launch_env(run_dir, GRAFT_FAULT_PLAN=json.dumps(plan), GRAFT_DRILL_OUT=events_path,
                         GRAFT_DRILL_CKPT=os.path.join(run_dir, "ckpt"),
                         GRAFT_DRILL_STEPS=str(DRILL_K + 2), GRAFT_LAUNCH_ESCALATE_S="5")
        rc, lines, wall = timed_lines(
            [sys.executable, "-m", LAUNCH_MODULE, "--nproc_per_node", "1", "--elastic",
             "--max_restarts", "1", "--min_world", "1", str(drill)], run_dir, env, timeout=240)
        events = []
        if os.path.exists(events_path):
            with open(events_path, encoding="utf-8") as fh:
                events = [json.loads(ln) for ln in fh]
        shape = [(e["event"], e.get("step"), e.get("attempt"), e.get("world"), e.get("mode"),
                  tuple(e.get("torn_dirs", ()))) for e in events]
        want = ([("step", s, 0, 1, None, ()) for s in range(1, DRILL_K)]
                + [("resume", DRILL_K - 2, 1, 1, "retry", (f"step_{DRILL_K - 1:010d}.tmp",))]
                + [("step", s, 1, 1, None, ()) for s in range(DRILL_K - 1, DRILL_K + 3)]
                + [("done", DRILL_K + 2, 1, 1, None, ())])
        before = [e["t"] for e in events if e["event"] == "step" and e["attempt"] == 0]
        after = [e["t"] for e in events if e["event"] == "step" and e["attempt"] == 1]
        recover_s = after[0] - before[-1] if before and after else None
        restarts = [ln for _, ln in lines if "[launch]" in ln and "restart" in ln]
        print(f"[launch] (c) recovery drill (ESPCN, ZeRO-2, NCCL world 1) under --elastic "
              f"--max_restarts 1 --min_world 1, ckpt.write sleep at step {DRILL_K - 1} and "
              f"train.preempt kill at step {DRILL_K}: rc {rc}, {wall:.1f} s; launcher "
              f"{restarts}; events {[(e[0], e[1], e[2]) for e in shape]}; time to recover "
              f"(first step after the resume - last step before the kill, the drill's clock) "
              f"{recover_s if recover_s is None else round(recover_s, 3)} s | {smi}")
        if rc != 0 or shape != want:
            raise SystemExit(f"phase 18 (c): rc {rc}, events {shape}, expected {want}; "
                             f"tail {[ln for _, ln in lines[-20:]]}")
        out["drill"] = {"wall": wall, "recover_s": recover_s, "resume_step": DRILL_K - 2}
    print(f"[launch] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 19: the CUDA-graph step. Each case runs the same steps eagerly and as
# captured graphs from the same weights and batches, under cuDNN's and
# torch's deterministic algorithms, and holds the graphed run against the
# eager one: bitwise expected; else the largest difference is printed and
# must stay within GRAPH_TOL of the largest change the eager run made (the
# losses relative to the loss).
GRAPH_K = 4  # steps a MultiStep window
GRAPH_WINDOWS = 2  # windows held against the eager steps
GRAPH_TIMED = 1  # windows (and their steps, eagerly) timed after them
GRAPH_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "float16": 1e-3}
GRAPH_TUNE_KS, GRAPH_TUNE_STEPS = (1, 2, 4, 8), 8
GRAPH_TAKES = 3  # traces of a replay before a short kernel count is a fault
LM_DROPOUTS = (0.0, 0.1)


def graph_mismatch(got: list, want: list, start: list) -> tuple[float, float]:
    """The largest ``|got - want|`` over paired tensors and that over the
    largest ``|want - start|`` (the change the reference run made)."""
    diff = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    moved = max(float((w.float() - s.float()).abs().max()) for w, s in zip(want, start))
    return diff, diff / moved if moved > 0 else float("inf") if diff else 0.0


def graph_faults(name: str, losses: tuple, params: tuple, start: list, dtype: str,
                 exact: bool = False) -> list:
    """Print how far the graphed run (first of each pair) lies from the
    eager one and return the faults: any difference above ``GRAPH_TOL``,
    or with ``exact`` any difference at all."""
    import math

    got, want = losses
    loss_rel = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
    p_abs, p_rel = graph_mismatch(params[0], params[1], start)
    bitwise = loss_rel == 0.0 and p_abs == 0.0
    print(f"[graphs]   {name}: {'bitwise equal' if bitwise else 'not bitwise'}: losses rel "
          f"{loss_rel:.3e}, parameters max |diff| {p_abs:.3e} ({p_rel:.3e} of the largest "
          f"change), tolerance {GRAPH_TOL[dtype]:g}")
    tol = GRAPH_TOL[dtype]
    if not all(math.isfinite(v) for v in got + want):
        return [f"{name}: non-finite losses {got} / {want}"]
    if exact and not bitwise:
        return [f"{name}: graphed differs from its uncaptured twin (losses {loss_rel:.3e}, "
                f"parameters {p_abs:.3e}), bitwise expected"]
    return [] if loss_rel <= tol and p_rel <= tol else [f"{name}: graphed differs from eager "
                                                        f"(losses {loss_rel:.3e}, parameters "
                                                        f"{p_rel:.3e} > {tol:g})"]


def local_params(module) -> list:
    """A copy of each parameter of ``module``, this rank's shard of an FSDP2
    ``DTensor``."""
    return [(p.to_local() if hasattr(p, "to_local") else p).detach().clone()
            for p in module.parameters()]


def replay_counts(events, steps: int, group_size: int | None = None) -> dict:
    """From a trace of ``steps`` steps: the graph launches, K1-K5's kernels
    (``observe.opcost.op_table``'s rows) and the device busy ms, each a
    step; the launches whose device records are missing (``lost``); with
    ``group_size``, the collectives ``observe.comms`` reads, by kind."""
    from pytorch_distributedtraining_tpu_torch.observe import comms, opcost

    table = opcost.op_table(events, top=1000)
    kernels = table_launches(table, {**WINDOW_KERNELS, **FLASH_KERNELS})
    graphs = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "GraphLaunch" in e.get("name", ""))
    busy = opcost.device_breakdown(events)["busy_ms"]
    out = {"graph_launches": graphs / steps, "busy_ms": busy / steps,
           "lost": len(lost_launches(events)), **{k: v / steps for k, v in kernels.items()}}
    if group_size is not None:
        out["collectives"] = wire_counts(comms.wire_inventory(events, group_size=group_size))
    return out


def replay_traced(name: str, fn, steps: int, per_step: dict,
                  group_size: int | None = None) -> dict:
    """``replay_counts`` of a trace of ``fn``, one call that replays a graph
    over ``steps`` steps. A replay runs every kernel its graph captured, the
    same ones each time, and a trace can lose device records (ROADMAP C.6)
    but never add one: a take that counts fewer of a ``per_step`` kernel is
    printed and traced again, up to ``GRAPH_TAKES`` takes. The counts of the
    last take (``takes``: how many) go to ``graph_report``, which fails on
    any count but the expected one."""
    from pytorch_distributedtraining_tpu_torch.observe import profiling

    for take in range(1, GRAPH_TAKES + 1):
        counts = replay_counts(profiling.profile_call(fn)[1], steps, group_size)
        short = {k: counts[k] for k, n in per_step.items() if counts[k] < n}
        if not short or take == GRAPH_TAKES:
            break
        print(f"[graphs]   {name}: take {take} of the replay's trace lost device records: "
              f"{short} a step, expected {per_step}; traced again")
    return {**counts, "takes": take}


def _timed(fn, calls: int) -> float:
    """Seconds for ``calls`` calls of ``fn``, ended by a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def pool_bytes(*graphs) -> int:
    """The bytes of the segments of the graphs' private pools (each
    ``torch.cuda.CUDAGraph``), which a replay uses without allocating."""
    import torch

    pools = {tuple(g.pool()) for g in graphs}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) in pools)


def pools_gib(stoke) -> float:
    """:func:`pool_bytes` of every captured graph of a Stoke facade's
    deferred window (the window and the split path's), in GiB."""
    return pool_bytes(*facade_graphs(stoke)) / 2**30


def facade_graphs(stoke) -> list:
    """The captured ``torch.cuda.CUDAGraph`` of each of a facade's
    programs."""
    return [g.graph for g in stoke._graphs.values() if g.graph is not None]


def _peak_gib(fn, *graphs) -> float:
    """The allocator's peak over one call of ``fn``, plus the segments of
    the private pools of ``graphs`` (:func:`pool_bytes`)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() + (pool_bytes(*graphs) if graphs else 0)) / 2**30


def graph_report(name: str, smi: str, eager: dict, graphed: dict, per_step: dict) -> tuple:
    """Print a case's eager and graphed numbers; faults if a kernel the case
    runs is missing from the replay's device records. An eager run without
    ``counts`` was not traced: its busy ms and idle share print as such."""
    counts = eager.get("counts")
    row = {"eager_ms": eager["ms"], "graphed_ms": graphed["ms"],
           "eager_busy_ms": None if counts is None else counts["busy_ms"], "graphed_busy_ms":
           graphed["counts"]["busy_ms"], "eager_peak_gib": eager["peak"],
           "graphed_peak_gib": graphed["peak"], "counts": graphed["counts"]}
    for k in ("eager", "graphed"):
        busy = row[f"{k}_busy_ms"]
        row[f"{k}_idle"] = None if busy is None else 1.0 - busy / row[f"{k}_ms"]

    def shown(v, spec):
        return "not traced" if v is None else format(v, spec)

    kern = " ".join(f"{k} {graphed['counts'][k]:g}" for k in per_step)
    wires = (f"; collectives read (observe.comms) eager "
             f"{shown(counts and counts['collectives'], '')}, replay "
             f"{graphed['counts']['collectives']}" if "collectives" in graphed["counts"] else "")
    print(f"[graphs] {name}: step {eager['ms']:.2f} ms eager, {graphed['ms']:.2f} ms graphed; "
          f"device busy {shown(row['eager_busy_ms'], '.2f')} / {row['graphed_busy_ms']:.2f} ms, "
          f"idle {shown(row['eager_idle'], '.3f')} / {row['graphed_idle']:.3f}; graph launches "
          f"a step {graphed['counts']['graph_launches']:g}, kernels a step in the replay: "
          f"{kern} (take {graphed['counts'].get('takes', 1)} of its trace), launches without a "
          f"device record {shown(counts and counts['lost'], '')} / "
          f"{graphed['counts']['lost']}{wires}; peak {eager['peak']:.2f} / "
          f"{graphed['peak']:.2f} GiB | {smi}")
    faults = [f"{name}: {k} {graphed['counts'][k]:g} a step in the replay's device records, "
              f"expected {n}" for k, n in per_step.items() if graphed["counts"][k] != n]
    return row, faults


def _multi_case(name: str, smi: str, build, batches: list, per_step: dict, dtype: str,
                exact: bool = False) -> tuple:
    """``build() -> (model, TrainStep)`` from one seed: the eager steps of
    ``batches``, then, from the same state restored, ``MultiStep(GRAPH_K)``
    over the same batches stacked (``exact``: bitwise required); then both
    timed, traced and measured."""
    import torch

    from pytorch_distributedtraining_tpu_torch.observe import profiling
    from pytorch_distributedtraining_tpu_torch.parallel import MultiStep

    k, n = GRAPH_K, GRAPH_K * GRAPH_WINDOWS
    model, step = build()
    start = local_params(model)
    snapshot = step.state_snapshot()
    eager_losses = [float(step(b)["loss"]) for b in batches[:n]]
    eager_params = local_params(model)
    step.restore_state(snapshot)
    multi = MultiStep(step, k)
    stack = (lambda bs: torch.stack(bs)) if isinstance(batches[0], torch.Tensor) else (
        lambda bs: tuple(torch.stack(xs) for xs in zip(*bs)))
    wins = [stack(batches[w * k:(w + 1) * k]) for w in range(len(batches) // k)]
    graph_losses = []
    for w in wins[:GRAPH_WINDOWS]:
        graph_losses += multi(w)["loss"].tolist()
    faults = graph_faults(name, (graph_losses, eager_losses),
                          (local_params(model), eager_params), start, dtype, exact)
    timed = wins[GRAPH_WINDOWS:GRAPH_WINDOWS + GRAPH_TIMED]
    eager = {"ms": _timed(lambda: [step(b) for b in batches[n:n + GRAPH_TIMED * k]], 1)
             / (GRAPH_TIMED * k) * 1e3}
    graphed = {"ms": _timed(lambda: [multi(w) for w in timed], 1) / (GRAPH_TIMED * k) * 1e3}
    eager["counts"] = replay_counts(profiling.profile_call(lambda: step(batches[0]))[1], 1)
    graphed["counts"] = replay_traced(name, lambda: multi(wins[0]), k, per_step)
    eager["peak"] = _peak_gib(lambda: step(batches[0]))
    graphed["peak"] = _peak_gib(lambda: multi(wins[0]), multi.graph.graph)
    row, more = graph_report(name, smi, eager, graphed, per_step)
    row.update(captures=multi.graph.captures, replays=multi.graph.replays)
    if multi.graph.captures != 1:
        more.append(f"{name}: {multi.graph.captures} captures, expected 1")
    return row, faults + more


def _swinir_batches(n: int, seed: int) -> list:
    """``n`` global batches of the bench shape (2 x BATCH images, LR
    LR_SIZE), random HR on the card, box-downsampled LR."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        hr = torch.rand(2 * BATCH, 2 * LR_SIZE, 2 * LR_SIZE, 3, device="cuda", generator=g)
        out.append((hr.reshape(2 * BATCH, LR_SIZE, 2, LR_SIZE, 2, 3).mean(dim=(2, 4)), hr))
    return out


def _stoke_style(s, b):
    """One step of the Stoke-style loop on the global batch ``b`` (two
    micro-batches of ``BATCH``), no loss read inside it (the window
    program); the step's loss, the mean of its micro-batches'."""
    losses = []
    for i in range(2):
        losses.append(s.loss(s.model(b[0][i * BATCH:(i + 1) * BATCH]),
                             b[1][i * BATCH:(i + 1) * BATCH]))
        s.backward(losses[-1])
        s.step()
    return (losses[0].detach() + losses[1].detach()) / 2


def _driver_style(s, b):
    """:func:`_stoke_style` as the driver's loop runs it: each micro-batch's
    loss read (``detach_and_sync_loss``) right after its ``.step()`` (the
    split path's three programs)."""
    total = 0.0
    for i in range(2):
        loss = s.loss(s.model(b[0][i * BATCH:(i + 1) * BATCH]), b[1][i * BATCH:(i + 1) * BATCH])
        s.backward(loss)
        s.step()
        total = total + s.detach_and_sync_loss(loss)
    return total / 2


def _facade_case(name: str, smi: str, fp16, batches: list, dtype: str) -> tuple:
    """``Stoke.fused_step`` (the driver's facade with DDP flags, through
    the NCCL group) against the same facade's ``TrainStep`` called eagerly
    (bitwise expected) and its Stoke-style loop run uncaptured
    (``Stoke.uncaptured``, within ``GRAPH_TOL``), each from the driver's
    seed-0 weights (a snapshot restored between the runs) over
    ``batches``."""
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.observe import profiling

    def stoke_style(s, b):  # the eager twin: the window program uncaptured
        with s.uncaptured():
            return _stoke_style(s, b)

    def params():
        return [p.detach().clone() for p in s.model_access.parameters()]

    n = GRAPH_K
    s = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH, verbose=False,
                              oss=False, sddp=False, fp16=fp16)
    step = s._fused_step_runner()[0]
    start, snapshot = params(), step.state_snapshot()
    graph_losses = [float(s.fused_step(*b)["loss"]) for b in batches[:n]]
    graph_params = params()
    step.restore_state(snapshot)
    eager_losses = [float(step(b, s.optimizer.lr)["loss"]) for b in batches[:n]]
    faults = graph_faults(f"{name} vs TrainStep", (graph_losses, eager_losses),
                          (graph_params, params()), start, dtype)
    step.restore_state(snapshot)
    s.zero_grad()  # the eager TrainStep left its last gradients; the Stoke-style loop adds to .grad
    styled_losses = [float(stoke_style(s, b)) for b in batches[:n]]
    faults += graph_faults(f"{name} vs Stoke-style", (graph_losses, styled_losses),
                           (graph_params, params()), start, dtype)
    timed = batches[n:n + GRAPH_TIMED * GRAPH_K]
    eager = {"ms": _timed(lambda: [stoke_style(s, b) for b in timed], 1) / len(timed) * 1e3}
    graphed = {"ms": _timed(lambda: [s.fused_step(*b) for b in timed], 1) / len(timed) * 1e3}
    eager["counts"] = replay_counts(profiling.profile_call(
        lambda: stoke_style(s, batches[0]))[1], 1, group_size=1)
    per_step = {"K1": 48, "K2": 48}
    graphed["counts"] = replay_traced(name, lambda: s.fused_step(*batches[0]), 1, per_step,
                                      group_size=1)
    eager["peak"] = _peak_gib(lambda: stoke_style(s, batches[0]))
    graphed["peak"] = _peak_gib(lambda: s.fused_step(*batches[0]), s._fused_graph.graph)
    row, more = graph_report(name, smi, eager, graphed, per_step)
    graph = s._fused_graph
    row.update(captures=graph.captures, replays=graph.replays)
    if graph.captures != 1:
        more.append(f"{name}: {graph.captures} captures, expected 1")
    return row, faults + more


WINDOW_HELD = 3  # 19 (e): steps held against the uncaptured twin
WINDOW_TIMED = 2  # and timed each way after them
WINDOW_CASES = (  # label, build_stoke flags, loop, the programs it captures
    ("Stoke-style window, ZeRO-2 (the driver's flags)", {}, "_stoke_style", ("window",)),
    ("Stoke-style window, DDP flags (FusedAdamW)", dict(oss=False, sddp=False), "_stoke_style",
     ("window",)),
    ("the driver's loop (split path), ZeRO-2", {}, "_driver_style", ("first", "acc", "apply")),
)


def _window_case(name: str, smi: str, fp16, flags: dict, loop, programs: tuple,
                 batches: list, dtype: str, exact: bool = False) -> tuple:
    """19 (e): the driver's facade (``build_stoke`` with ``flags``, seed 0,
    in the NCCL group of one) through ``loop`` (:func:`_stoke_style`: the
    window program; :func:`_driver_style`: the split path), graphed,
    against the same programs run uncaptured (``Stoke.uncaptured``) from
    the same state (its snapshot restored), bitwise expected (required with
    ``exact``); then both timed, a graphed step traced (48 K1 and 48 K2 a
    step in the replays' device records, one graph launch a program), and
    the peaks, the graphed one with every graph's pool. 19 (f) runs it on
    ZeRO-3 and on a DDP model (``flags`` then carry ``configs`` and
    ``fused_optimizer``)."""
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp

    def params():
        return local_params(s.model_access)

    def uncaptured(bs):
        with s.uncaptured():
            return [loop(s, b) for b in bs]

    s = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH, verbose=False,
                              fp16=fp16, **flags)
    start, snapshot = params(), s.state_snapshot()
    graph_losses = [float(loop(s, b)) for b in batches[:WINDOW_HELD]]
    graph_params = params()
    s.restore_state(snapshot)
    s._step_count = 0
    eager_losses = [float(v) for v in uncaptured(batches[:WINDOW_HELD])]
    faults = graph_faults(name, (graph_losses, eager_losses), (graph_params, params()), start,
                          dtype, exact)
    timed = batches[WINDOW_HELD:WINDOW_HELD + WINDOW_TIMED]
    eager = {"ms": _timed(lambda: uncaptured(timed), 1) / len(timed) * 1e3}
    graphed = {"ms": _timed(lambda: [loop(s, b) for b in timed], 1) / len(timed) * 1e3}
    per_step = {"K1": 48, "K2": 48}
    # the uncaptured twin is timed, not traced (phase 19 (a) traces the
    # facade's eager twin; a trace here costs seconds a case)
    graphed["counts"] = replay_traced(name, lambda: loop(s, batches[0]), 1, per_step,
                                      group_size=1)
    eager["peak"] = _peak_gib(lambda: uncaptured(batches[:1]))
    graphed["peak"] = _peak_gib(lambda: loop(s, batches[0]), *facade_graphs(s))
    row, more = graph_report(name, smi, eager, graphed, per_step)
    caps = {kind: g.captures for (kind, _), g in s._graphs.items()}
    row.update(captures=caps, replays={kind: g.replays for (kind, _), g in s._graphs.items()})
    if caps != dict.fromkeys(programs, 1):
        more.append(f"{name}: captures {caps}, expected one of each of {programs}")
    if graphed["counts"]["graph_launches"] != len(programs):
        more.append(f"{name}: {graphed['counts']['graph_launches']:g} graph launches a step, "
                    f"expected {len(programs)}")
    del s
    return row, faults + more


def _amp_case(smi: str, batches: list) -> list:
    """(c): ``fp16='amp'`` ``fused_step`` with step 1's inputs poisoned
    (NaN): the update skipped and the scale halved on the device, the
    graphed run equal to the same facade's ``TrainStep`` run eagerly from
    the same state (a snapshot restored)."""
    import torch

    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp

    poisoned = [b if i != 1 else (torch.full_like(b[0], float("nan")), b[1])
                for i, b in enumerate(batches[:3])]
    s = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH, verbose=False,
                              oss=False, sddp=False, fp16="amp")
    step = s._fused_step_runner()[0]
    snapshot = step.state_snapshot()
    runs = []
    for graphed in (True, False):
        step.restore_state(snapshot)
        scales, skipped = [], None
        for i, b in enumerate(poisoned):
            before = [p.detach().clone() for p in s.model_access.parameters()]
            if graphed:
                s.fused_step(*b)
            else:
                step(b, s.optimizer.lr)
            scales.append(float(s.loss_scaler.scale))
            if i == 1:
                skipped = all(torch.equal(p, q) for p, q in zip(s.model_access.parameters(),
                                                                before))
        runs.append((scales, skipped, [p.detach().clone() for p in s.model_access.parameters()]))
    (scales, skipped, got), (escales, eskipped, want) = runs
    diff, _ = graph_mismatch(got, want, got)
    print(f"[graphs] (c) fp16 amp fused_step, step 1 poisoned: scales graphed {scales}, eager "
          f"{escales}; update skipped graphed {skipped}, eager {eskipped}; parameters max "
          f"|graphed - eager| {diff:.3e} | {smi}")
    faults = []
    if not (skipped and eskipped) or scales != escales or scales[0] != 2 * scales[1]:
        faults.append(f"(c): the poisoned step was not skipped with the scale halved on both "
                      f"paths (scales {scales} / {escales}, skipped {skipped} / {eskipped})")
    if diff > 0:
        faults.append(f"(c): graphed parameters differ from eager by {diff:.3e}")
    return faults


LAYOUT_CASES = (  # 19 (f): label, layout, loop, the programs it captures
    ("ZeRO-3 (FairscaleFSDPConfig) window", "fsdp", "_stoke_style", ("window",)),
    ("ZeRO-3 (FairscaleFSDPConfig), the driver's loop", "fsdp", "_driver_style",
     ("first", "acc", "apply")),
    ("DDP model (per-leaf AdamW) window", "ddp", "_stoke_style", ("window",)),
    ("DDP model (per-leaf AdamW), the driver's loop", "ddp", "_driver_style",
     ("first", "acc", "apply")),
)
COLD_EVAL_N = 10  # 19 (f): the partial last eval batch (the driver's validation batch)
COLD_KERNELS = {"K1": 24, "K2": 0}  # a forward of SwinIR-S's 24 Swin layers


def layout_flags(layout: str) -> dict:
    """19 (f)'s ``build_stoke`` flags: ZeRO-3 (``fairscale_fsdp`` with
    ``FairscaleFSDPConfig``) or plain DDP with the per-leaf chain (a
    ``DistributedDataParallel`` model)."""
    from pytorch_distributedtraining_tpu_torch.stoke import FairscaleFSDPConfig

    if layout == "fsdp":
        return {"fsdp": True, "configs": (FairscaleFSDPConfig(),)}
    return {"oss": False, "sddp": False, "fused_optimizer": False}


def cold_expected(reads: int) -> list:
    """19 (f): ``(program, batch, captures, replays)`` of the cold
    programs after ``reads`` graphed rounds of :func:`_cold_case`: one
    capture a program and signature, and a replay every call (the forward
    program twice a round: the handle read alone and the loss's)."""
    return sorted([("forward", BATCH, 1, 2 * reads), ("loss", BATCH, 1, reads),
                   ("eval_forward", BATCH, 1, reads), (str(("eval", ())), BATCH, 1, reads),
                   (str(("eval", ())), COLD_EVAL_N, 1, reads)])


def cold_counts(stoke) -> list:
    """``(program, batch, captures, replays)`` of each of a facade's
    graphs: the program's name and its first input's batch size."""
    return sorted((str(kind), sig[0][0][0], g.captures, g.replays)
                  for (kind, sig), g in stoke._graphs.items())


def _cold_case(smi: str, batches: list) -> tuple:
    """19 (f): the cold programs of the ZeRO-3 facade (f32, SwinIR-S): a
    handle read alone and a loss read before ``.backward()`` at the bench
    shape, eval-mode ``.model`` there and ``eval_step`` over a batch of
    ``BATCH`` and a partial one of ``COLD_EVAL_N`` at the driver's shape
    (LR 32); two graphed rounds then one uncaptured, every value bitwise
    the same, one capture a signature (:func:`cold_expected`), and a
    traced replay of the handle read and of the eval forward each counting
    ``COLD_KERNELS``."""
    import torch

    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp

    s = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH, verbose=False,
                              **layout_flags("fsdp"))
    x, y = batches[0][0][:BATCH], batches[0][1][:BATCH]
    g = torch.Generator(device="cuda").manual_seed(23)
    dy = torch.rand(BATCH, 64, 64, 3, device="cuda", generator=g)
    dx = dy.reshape(BATCH, 32, 2, 32, 2, 3).mean(dim=(2, 4))
    ev = s.eval_step()

    def eval_model():
        s.model_access.eval()
        try:
            return s.model(x)
        finally:
            s.model_access.train()

    def one_round():
        return [s.model(x).detach(), s.loss(s.model(x), y).detach(), eval_model(),
                ev(dx, dy)["loss"], ev(dx[:COLD_EVAL_N], dy[:COLD_EVAL_N])["loss"]]

    t0 = time.perf_counter()
    rounds = [one_round(), one_round()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    with s.uncaptured():
        twin = one_round()
    counts = cold_counts(s)
    equal = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*rounds, twin))
    graphed_ms = _timed(eval_model, 3) / 3 * 1e3
    with s.uncaptured():
        eager_ms = _timed(eval_model, 3) / 3 * 1e3
    traced = {"handle": replay_traced("(f) cold: a handle read alone",
                                      lambda: s.model(x).detach(), 1, COLD_KERNELS),
              "eval": replay_traced("(f) cold: eval-mode .model", eval_model, 1, COLD_KERNELS)}
    print(f"[graphs] (f) cold programs of the ZeRO-3 facade, SwinIR-S f32: graphed rounds and "
          f"the uncaptured one {'bitwise equal' if equal else 'NOT bitwise equal'}; (program, "
          f"batch, captures, replays) {counts}; two rounds with their captures "
          f"{first_s:.2f} s; eval-mode .model {graphed_ms:.2f} ms graphed, {eager_ms:.2f} ms "
          f"uncaptured; kernels a replay: handle read K1 {traced['handle']['K1']:g} K2 "
          f"{traced['handle']['K2']:g}, eval forward K1 {traced['eval']['K1']:g} K2 "
          f"{traced['eval']['K2']:g} | {smi}")
    faults = [] if equal else ["(f) cold: graphed and uncaptured values differ"]
    if counts != cold_expected(2):
        faults.append(f"(f) cold: graphs {counts}, expected {cold_expected(2)}")
    for what, c in traced.items():
        if {k: c[k] for k in COLD_KERNELS} != COLD_KERNELS:
            faults.append(f"(f) cold {what}: {c['K1']:g} K1 and {c['K2']:g} K2 a replay, "
                          f"expected {COLD_KERNELS}")
    row = {"counts": counts, "eval_ms": graphed_ms, "eval_uncaptured_ms": eager_ms,
           "kernels": {k: {n: c[n] for n in COLD_KERNELS} for k, c in traced.items()}}
    del s
    return row, faults


def _graph_layouts(smi: str, batches: list) -> tuple:
    """19 (f): every training program graphed on ZeRO-3 and a DDP model
    (module docstring), in the NCCL group of one."""
    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config

    t0 = time.perf_counter()
    out, faults = {}, []
    for fp16 in (None, "bf16"):
        dtype = "bfloat16" if fp16 else "float32"
        for i, (label, layout, loop, programs) in enumerate(LAYOUT_CASES):
            row, f = _window_case(f"(f) SwinIR-S {dtype} {label} (NCCL world 1)", smi, fp16,
                                  layout_flags(layout), globals()[loop], programs, batches,
                                  dtype, exact=True)
            out[f"layout_{layout}_{loop.strip('_')}_{dtype}"], faults = row, faults + f
            torch.cuda.empty_cache()
    row, f = _cold_case(smi, batches)
    out["cold"], faults = row, faults + f
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(29)
    n = GRAPH_K * (GRAPH_WINDOWS + GRAPH_TIMED)
    tokens = [torch.randint(0, GPT2Config().vocab_size, (LM_BATCH, LM_SEQ), device="cuda",
                            generator=g) for _ in range(n)]

    def build_lm():
        model, step, _ = ladder.build_lm(GPT2Config(), LM_BATCH, LM_SEQ, torch.device("cuda"),
                                         policy="zero3", remat="full")
        return model, step

    row, f = _multi_case(f"(f) GPT-2 125M bf16 ZeRO3(remat='full') MultiStep(k={GRAPH_K})",
                         smi, build_lm, tokens, {"K3": 24, "K4": 12, "K5": 12}, "bfloat16",
                         exact=True)
    out["gpt2_zero3_multistep"], faults = row, faults + f
    del tokens
    torch.cuda.empty_cache()

    def build_vit():
        model, step, _ = ladder.build_image(5, False, torch.device("cuda"))
        return model, step

    _, _, batch, img, classes = ladder.IMAGE_RUNGS[5]
    images = [(torch.randn(batch, img, img, 3, device="cuda", generator=g),
               torch.randint(0, classes, (batch,), device="cuda", generator=g))
              for _ in range(n)]
    row, f = _multi_case(f"(f) ViT-B/16 bf16 ZeRO3 MultiStep(k={GRAPH_K}) (ladder config 5)",
                         smi, build_vit, images, {}, "bfloat16", exact=True)
    del images
    out["vit_zero3_multistep"], faults = row, faults + f
    torch.cuda.empty_cache()
    print(f"[graphs] (f) {time.perf_counter() - t0:.1f} s")
    return out, faults


def phase_graphs(smi: str) -> dict:
    """Phase 19: the CUDA-graph step (module docstring)."""
    import torch

    from pytorch_distributedtraining_tpu_torch import optim
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.losses import mse_loss
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, tune_multi_step_k
    from pytorch_distributedtraining_tpu_torch.precision import Policy
    from pytorch_distributedtraining_tpu_torch.runtime import dist

    t_phase = time.perf_counter()
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False  # no extra fills in the timings
    out, faults = {}, []
    try:
        n = GRAPH_K * (GRAPH_WINDOWS + GRAPH_TIMED)
        batches = _swinir_batches(n, seed=19)
        swinir_steps = {"K1": 48, "K2": 48}
        for fp16 in (None, "bf16"):
            dtype = "bfloat16" if fp16 else "float32"
            policy = Policy.from_name(fp16)

            def loss_fn(m, b, policy=policy):
                with policy.autocast(b[0].device):
                    out_ = m(b[0])
                return mse_loss(out_.float(), b[1]), {}

            def build():
                model = stoke_ddp.build_model().cuda()
                tx = optim.FusedAdamW(model.named_parameters(), lr=5e-4, clip_grad_norm=0.1)
                return model, TrainStep(model, loss_fn, tx, grad_accum_steps=2)

            row, f = _multi_case(f"(a) SwinIR-S {dtype} MultiStep(k={GRAPH_K})", smi, build,
                                 batches, swinir_steps, dtype)
            out[f"swinir_multistep_{dtype}"], faults = row, faults + f
        # the facade's cases through an NCCL group of one (dist.initialize
        # turns NCCL's async error handling off for the graphs' collectives)
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.find_free_port()),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        dist.initialize()
        try:
            if dist.backend() != "nccl":
                raise SystemExit(f"the group came up on {dist.backend()}, not NCCL")
            if os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING") != "0":
                raise SystemExit("dist.initialize left NCCL's async error handling on")
            for fp16 in (None, "bf16"):
                dtype = "bfloat16" if fp16 else "float32"
                row, f = _facade_case(f"(a) SwinIR-S {dtype} Stoke.fused_step (NCCL world 1)",
                                      smi, fp16, batches, dtype)
                out[f"swinir_fused_step_{dtype}"], faults = row, faults + f
            faults += _amp_case(smi, batches)
            for fp16 in (None, "bf16"):
                dtype = "bfloat16" if fp16 else "float32"
                for i, (label, flags, loop, programs) in enumerate(WINDOW_CASES):
                    row, f = _window_case(f"(e) SwinIR-S {dtype} {label} (NCCL world 1)", smi,
                                          fp16, flags, globals()[loop], programs, batches, dtype)
                    out[f"swinir_window_{i}_{dtype}"], faults = row, faults + f
                    torch.cuda.empty_cache()
            more, f = _graph_layouts(smi, batches)
            out.update(more)
            faults += f
        finally:
            dist.shutdown()
        g = torch.Generator(device="cuda").manual_seed(7)
        tokens = [torch.randint(0, GPT2Config().vocab_size, (LM_BATCH, LM_SEQ), device="cuda",
                                generator=g) for _ in range(n)]
        for rate in LM_DROPOUTS:
            cfg = GPT2Config(dropout=rate)  # 125M

            def build_lm(cfg=cfg):
                model, step, _ = ladder.build_lm(cfg, LM_BATCH, LM_SEQ, torch.device("cuda"))
                return model, step

            row, f = _multi_case(f"(b) GPT-2 125M bf16 dropout {rate} MultiStep(k={GRAPH_K})",
                                 smi, build_lm, tokens, {"K3": 12, "K4": 12, "K5": 12}, "bfloat16")
            out[f"gpt2_multistep_dropout_{rate}"], faults = row, faults + f
        del tokens
        policy = Policy.from_name("bf16")

        def tune_loss(m, b):
            with policy.autocast(b[0].device):
                out_ = m(b[0])
            return mse_loss(out_.float(), b[1]), {}

        model = stoke_ddp.build_model().cuda()
        tx = optim.FusedAdamW(model.named_parameters(), lr=5e-4, clip_grad_norm=0.1)
        best, rates, state = tune_multi_step_k(TrainStep(model, tune_loss, tx, grad_accum_steps=2),
                                               batches[0], ks=GRAPH_TUNE_KS,
                                               steps_per_arm=GRAPH_TUNE_STEPS)
        print(f"[graphs] (d) tune_multi_step_k, SwinIR-S bf16 TrainStep + FusedAdamW over "
              f"{GRAPH_TUNE_KS}, {GRAPH_TUNE_STEPS} steps an arm: best k {best}, steps/s "
              + ", ".join(f"k={k} {r:.2f}" for k, r in rates.items())
              + f", {state['step']} steps taken | {smi}")
        out["tune"] = {"best_k": best, "rates": rates}
        if set(rates) != set(GRAPH_TUNE_KS) or not all(r > 0 for r in rates.values()):
            faults.append(f"(d): rates {rates}")
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])
        torch.utils.deterministic.fill_uninitialized_memory = saved[2]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        torch.cuda.empty_cache()
    print(f"[graphs] phase {time.perf_counter() - t_phase:.1f} s")
    if faults:
        raise SystemExit("phase 19: " + "; ".join(faults))
    return out


REMAT_POLICIES = ("none", "full", "dots", "names", "offload")
REMAT_STEPS = 3
OFFLOAD_STEPS = 4
OFFLOAD_MEM_TOL = 0.05  # the between-step memory drop against the offloaded bytes
OFFLOAD_PROBE_MIB = 256
SWINIR_LAYERS = 24  # SwinIR-S: 6 residual groups of 4 Swin layers


def remat_kernels(policy: str) -> dict:
    """K1/K2 a SwinIR-S step (one micro-batch) under ``policy``: every
    policy but ``none`` recomputes each Swin layer's forward in backward,
    K1 included, since none of them saves K1's residuals (``names`` and
    ``offload`` save the ``attn_out`` tag after it)."""
    return {"K1": SWINIR_LAYERS * (1 if policy == "none" else 2), "K2": SWINIR_LAYERS}


def pinned_rates() -> dict:
    """GB/s of a pinned host buffer of ``OFFLOAD_PROBE_MIB`` MiB copied to the
    card and back, each the best of three timed with CUDA events."""
    import torch

    n = OFFLOAD_PROBE_MIB * 2**20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = {}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        best = float("inf")
        for _ in range(3):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            dst.copy_(src, non_blocking=True)
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1))
        out[name] = n / best / 1e6
    return out


def _compare(name: str, run: dict, ref: dict, dtype: str) -> tuple[bool, list]:
    """Whether ``run``'s losses and parameters equal the reference run's
    (from the same start, ``ref["start"]``) bitwise, and ``graph_faults``'
    faults: a difference above ``GRAPH_TOL`` of the reference's change."""
    import torch

    bitwise = run["losses"] == ref["losses"] and all(
        torch.equal(a, b) for a, b in zip(run["params"], ref["params"]))
    return bitwise, graph_faults(name, (run["losses"], ref["losses"]),
                                 (run["params"], ref["params"]), ref["start"], dtype)


def _remat_swinir(policy: str, fp16, batches: list) -> dict:
    """Phase 20 (a): SwinIR-S (the driver's ``build_model``, seed 0) with its
    layers under ``policy``, ``TrainStep`` + ``FusedAdamW``, the steps of
    ``batches``: losses, parameters, step ms, peak, a traced step's K1/K2."""
    import torch

    from pytorch_distributedtraining_tpu_torch import optim
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.losses import mse_loss
    from pytorch_distributedtraining_tpu_torch.parallel import TrainStep
    from pytorch_distributedtraining_tpu_torch.precision import Policy

    prec = Policy.from_name(fp16)

    def loss_fn(m, b):
        with prec.autocast(b[0].device):
            out_ = m(b[0])
        return mse_loss(out_.float(), b[1]), {}

    model = stoke_ddp.build_model(remat=policy).cuda()
    start = [p.detach().clone() for p in model.parameters()]
    step = TrainStep(model, loss_fn, optim.FusedAdamW(model.named_parameters(), lr=5e-4,
                                                      clip_grad_norm=0.1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(step(b)["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = [p.detach().clone() for p in model.parameters()]
    traced = traced_call(lambda: step(batches[0]), remat_kernels(policy))
    return {"losses": [v.item() for v in losses], "params": params, "start": start,
            "step_ms": statistics.median(times[1:]), "peak_gib": peak,
            "kernels": traced["kernels"], "takes": traced["takes"]}


def _remat_lm(policy: str, tokens: list) -> dict:
    """Phase 20 (b): GPT-2 125M bf16, dropout 0.1, per-block ``policy``
    (the ladder's ``build_lm``, seed 0), the steps of ``tokens``."""
    import torch

    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config

    model, step, _ = ladder.build_lm(GPT2Config(dropout=0.1, remat=policy), LM_BATCH, LM_SEQ,
                                     torch.device("cuda"))
    start = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for t in tokens:
        t0 = time.perf_counter()
        losses.append(step(t)["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = [p.detach().clone() for p in model.parameters()]
    want = {"K3": LM_LAYERS * (1 if policy == "none" else 2), "K4": LM_LAYERS, "K5": LM_LAYERS}
    traced = traced_call(lambda: step(tokens[0]), want)
    return {"losses": [v.item() for v in losses], "params": params, "want": want, "start": start,
            "step_ms": statistics.median(times[1:]), "peak_gib": peak,
            "kernels": traced["kernels"], "takes": traced["takes"]}


def _offload_arm(opt: str, what: str | None, tokens: list, multi: bool = False) -> dict:
    """Phase 20 (c): GPT-2 125M bf16 (flash attention, seed 0) under
    ``ZeRO1`` with ``what`` ("state", "params" or None: resident) offloaded,
    ``opt`` ("adamw" per leaf or "fused"), the steps of ``tokens``: losses,
    parameters on the host, step ms, peak, the between-step allocation
    (``memory_allocated`` after the steps less before the build, less the
    device copies a ``multi`` snapshot holds; the peak likewise), the
    offloaded tensors' bytes and whether each is on the host and pinned;
    with ``multi``, the same steps again from the same state as one
    ``MultiStep`` replay (its losses, parameters and captures)."""
    import functools

    import torch

    from pytorch_distributedtraining_tpu_torch import optim, parallel
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder
    from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = GPT2(GPT2Config(), attn_fn=tfa.make_flash_attn_fn(),
                 generator=torch.Generator().manual_seed(0))
    factory = optim.adamw if opt == "adamw" else optim.FusedAdamW
    policy = parallel.ZeRO1(offload_opt_state=what == "state", offload_params=what == "params")
    st = parallel.create_train_state(model, functools.partial(factory, lr=3e-4,
                                                              clip_grad_norm=1.0),
                                     None, policy, device="cuda")
    step = parallel.TrainStep(st.model, ladder._lm_loss, st.tx)
    tx = st.tx
    offloaded = ((tx._host_params or []) if what == "params" else
                 [t for v in tx._state().values() for t in v] if what == "state" else [])
    snapshot = step.state_snapshot() if multi else None
    kept = sum(t.numel() * t.element_size() for t in (snapshot or {}).get("tensors", [])
               if t.is_cuda)  # the snapshot's device copies (the moments), not the step's
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for t in tokens:
        t0 = time.perf_counter()
        losses.append(step(t)["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": [v.item() for v in losses], "step_ms": statistics.median(times[1:]),
           "peak_gib": (torch.cuda.max_memory_allocated() - kept) / 2**30,
           "held_gib": (torch.cuda.memory_allocated() - base - kept) / 2**30,
           "offloaded_bytes": sum(t.numel() * t.element_size() for t in offloaded),
           "on_host_pinned": all(t.device.type == "cpu" and t.is_pinned() for t in offloaded),
           "n_offloaded": len(offloaded)}
    tx.settle()
    out["params"] = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    if multi:
        step.restore_state(snapshot)
        runner = parallel.MultiStep(step, len(tokens))
        m = runner(torch.stack(tokens))
        tx.settle()
        out["captures"] = runner.graph.captures
        out["multi_losses"] = m["loss"].tolist()
        out["multi_params"] = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    del step, st, model, tx, offloaded, snapshot
    torch.cuda.empty_cache()
    return out


def phase_offload(smi: str) -> dict:
    """Phase 20: host offload and named remat (module docstring)."""
    import math

    import torch

    from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp, stoke_ddp
    from pytorch_distributedtraining_tpu_torch.models import GPT2Config
    from pytorch_distributedtraining_tpu_torch.stoke import (DeepspeedConfig,
                                                             DeepspeedOffloadOptimizerConfig,
                                                             DeepspeedZeROConfig)

    t_phase = time.perf_counter()
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    out, faults = {"remat": {}, "offload": {}}, []
    try:
        rates = out["pinned_gbps"] = pinned_rates()
        print(f"[offload] pinned copies of {OFFLOAD_PROBE_MIB} MiB: host to card "
              f"{rates['h2d']:.2f} GB/s, card to host {rates['d2h']:.2f} GB/s | {smi}")
        # (a) SwinIR-S under each remat policy, f32 and bf16
        batches = [(x[:BATCH], y[:BATCH]) for x, y in _swinir_batches(REMAT_STEPS, seed=20)]
        for fp16 in (None, "bf16"):
            dtype = "bfloat16" if fp16 else "float32"
            runs = {}
            for policy in REMAT_POLICIES:
                runs[policy] = r = _remat_swinir(policy, fp16, batches)
                torch.cuda.empty_cache()
                name = f"(a) SwinIR-S {dtype} remat {policy}"
                bitwise, f = (True, []) if policy == "none" else _compare(
                    name, r, runs["none"], dtype)
                want = remat_kernels(policy)
                f += kernel_faults(name, r["kernels"], want)
                print(f"[offload] {name}: step {r['step_ms']:.2f} ms, peak {r['peak_gib']:.3f} "
                      f"GiB, K1 {r['kernels']['K1']:g} K2 {r['kernels']['K2']:g} a step in the "
                      f"device records (expected {want['K1']}/{want['K2']}, take {r['takes']}), "
                      f"{'the reference' if policy == 'none' else 'bitwise equal to none' if bitwise else 'not bitwise'} "
                      f"| {smi}")
                faults += f
                out["remat"][f"swinir_{dtype}_{policy}"] = {
                    k: r[k] for k in ("step_ms", "peak_gib", "kernels")} | {"bitwise": bitwise}
            for r in runs.values():
                r.pop("params"), r.pop("start")
            peaks = {p: runs[p]["peak_gib"] for p in REMAT_POLICIES}
            print(f"[offload] (a) SwinIR-S {dtype} peaks in order: "
                  + " > ".join(f"{p} {v:.3f}" for p, v in sorted(peaks.items(),
                                                                 key=lambda kv: -kv[1])))
        # (b) GPT-2 125M bf16, dropout 0.1, under names and offload
        g = torch.Generator(device="cuda").manual_seed(20)
        tokens = [torch.randint(0, GPT2Config().vocab_size, (LM_BATCH, LM_SEQ), device="cuda",
                                generator=g) for _ in range(OFFLOAD_STEPS)]
        lm = {}
        for policy in ("none", "names", "offload"):
            lm[policy] = r = _remat_lm(policy, tokens[:REMAT_STEPS])
            torch.cuda.empty_cache()
            name = f"(b) GPT-2 125M bf16 dropout 0.1 remat {policy}"
            bitwise, f = (True, []) if policy == "none" else _compare(name, r, lm["none"],
                                                                      "bfloat16")
            f += kernel_faults(name, r["kernels"], r["want"])
            print(f"[offload] {name}: step {r['step_ms']:.2f} ms, peak {r['peak_gib']:.3f} GiB, "
                  + " ".join(f"{k} {r['kernels'][k]:g}" for k in r["want"])
                  + f" a step (expected {r['want']}, take {r['takes']}), "
                  f"{'the reference' if policy == 'none' else 'bitwise equal to none' if bitwise else 'not bitwise'} "
                  f"| {smi}")
            faults += f
            out["remat"][f"gpt2_{policy}"] = {k: r[k] for k in ("step_ms", "peak_gib",
                                                                "kernels")} | {"bitwise": bitwise}
        del lm
        torch.cuda.empty_cache()
        # (c) optimizer-state, then parameter offload on GPT-2 125M
        for opt in ("adamw", "fused"):
            resident = _offload_arm(opt, None, tokens)
            for what in ("state", "params"):
                r = _offload_arm(opt, what, tokens, multi=what == "params")
                name = f"(c) GPT-2 125M bf16 {opt} ZeRO1(offload_{'opt_state' if what == 'state' else 'params'}=True)"
                bitwise = r["losses"] == resident["losses"] and all(
                    torch.equal(a, b) for a, b in zip(r["params"], resident["params"]))
                drop = (resident["held_gib"] - r["held_gib"]) * 2**30
                rel = abs(drop - r["offloaded_bytes"]) / r["offloaded_bytes"]
                moved = 2 * r["offloaded_bytes"]  # in before the update, back after it
                predicted = (r["offloaded_bytes"] / rates["h2d"]
                             + r["offloaded_bytes"] / rates["d2h"]) / 1e6
                row = {"step_ms": r["step_ms"], "resident_step_ms": resident["step_ms"],
                       "predicted_extra_ms": predicted, "peak_gib": r["peak_gib"],
                       "resident_peak_gib": resident["peak_gib"],
                       "offloaded_gib": r["offloaded_bytes"] / 2**30, "drop_gib": drop / 2**30,
                       "drop_rel_err": rel, "bitwise": bitwise, "pinned": r["on_host_pinned"]}
                print(f"[offload] {name}: {r['n_offloaded']} tensors, "
                      f"{r['offloaded_bytes'] / 2**30:.4f} GiB on the host "
                      f"({'pinned' if r['on_host_pinned'] else 'NOT pinned'}); between steps "
                      f"{drop / 2**30:.4f} GiB less on the card (rel. err {rel:.4f}); step "
                      f"{r['step_ms']:.2f} ms vs resident {resident['step_ms']:.2f} ms (the copy "
                      f"rates predict +{predicted:.2f} ms for {moved / 2**30:.3f} GiB moved); "
                      f"peak {r['peak_gib']:.3f} vs {resident['peak_gib']:.3f} GiB; "
                      f"{OFFLOAD_STEPS} steps {'bitwise equal' if bitwise else 'NOT bitwise'} "
                      f"to the resident run | {smi}")
                if not bitwise:
                    faults.append(f"{name}: not bitwise equal to the resident run")
                if not r["on_host_pinned"] or not r["n_offloaded"]:
                    faults.append(f"{name}: offloaded state not on the host and pinned")
                if rel > OFFLOAD_MEM_TOL:
                    faults.append(f"{name}: between-step drop {drop / 2**30:.4f} GiB, offloaded "
                                  f"{r['offloaded_bytes'] / 2**30:.4f} GiB")
                if "multi_losses" in r:
                    mbit = r["multi_losses"] == r["losses"] and all(
                        torch.equal(a, b) for a, b in zip(r["multi_params"], r["params"]))
                    row["multistep_bitwise"] = mbit
                    print(f"[offload] {name}: MultiStep(k={OFFLOAD_STEPS}) replay "
                          f"({r['captures']} capture) {'bitwise equal' if mbit else 'NOT bitwise'} "
                          f"to its eager steps")
                    if not mbit or r["captures"] != 1:
                        faults.append(f"{name}: MultiStep captures {r['captures']}, bitwise {mbit}")
                out["offload"][f"{opt}_{what}"] = row
                del r
            del resident
        torch.cuda.empty_cache()
        # (d) the driver's facade with DeepSpeed ZeRO-2 + optimizer offload
        ds = DeepspeedConfig(zero_optimization=DeepspeedZeROConfig(stage=2),
                             offload_optimizer=DeepspeedOffloadOptimizerConfig(device="cpu"))
        s = stoke_ddp.build_stoke(stoke_ddp.build_model(), batch_size=BATCH, verbose=False,
                                  configs=[ds])
        w0 = [p.detach().clone() for p in s.model_access.parameters()]
        gb = _swinir_batches(2, seed=21)
        losses = [_stoke_style(s, b).item() for b in gb]
        state = [t for v in s._opt._state().values() for t in v]
        pinned = s._opt.offloaded_state and all(t.is_pinned() for t in state)
        traced = traced_call(lambda: _stoke_style(s, gb[0]), {"K1": 48, "K2": 48})
        moved = max(float((p.detach() - w).abs().max())
                    for p, w in zip(s.model_access.parameters(), w0))
        name = "(d) the driver's facade, DeepspeedConfig(stage 2, offload_optimizer cpu)"
        print(f"[offload] {name}: {type(s.policy).__name__}(offload_opt_state="
              f"{s.policy.offload_opt_state}), {type(s._opt).__name__}, {len(state)} state "
              f"tensors {'pinned on the host' if pinned else 'NOT pinned'}, losses {losses}, "
              f"weights moved {moved:.3e}, K1 {traced['kernels']['K1']:g} K2 "
              f"{traced['kernels']['K2']:g} a step in the replay's device records (take "
              f"{traced['takes']}), graphs {[g_.captures for g_ in s._graphs.values()]} | {smi}")
        faults += kernel_faults(name, traced["kernels"], {"K1": 48, "K2": 48})
        if not pinned or not all(math.isfinite(v) for v in losses) or not moved > 0:
            faults.append(f"{name}: pinned {pinned}, losses {losses}, moved {moved}")
        out["facade"] = {"losses": losses, "pinned": pinned, "kernels": traced["kernels"]}
        del s, w0, state
        torch.cuda.empty_cache()
        # (e) the ESPCN driver with --remat names --device-prefetch 2
        model = fairscale_ddp.build_model()
        w0 = model.conv1.weight.detach().clone()
        t0 = time.perf_counter()
        loss = fairscale_ddp.main(["--synthetic", "--synthetic-n", "256", "--epochs", "1",
                                   "--workers", "0", "--remat", "names", "--device-prefetch",
                                   "2"], model=model)
        moved = (model.conv1.weight.detach().cpu() - w0.cpu()).abs().max().item()
        print(f"[offload] (e) drivers.fairscale_ddp --remat names --device-prefetch 2: one "
              f"epoch in {time.perf_counter() - t0:.1f} s, last loss {loss}, weights moved "
              f"{moved:.2e}, on {model.conv1.weight.device}")
        if loss is None or not math.isfinite(loss) or not moved > 0 or \
                model.conv1.weight.device.type != "cuda":
            faults.append(f"(e): loss {loss}, moved {moved}, on {model.conv1.weight.device}")
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])
        torch.utils.deterministic.fill_uninitialized_memory = saved[2]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        torch.cuda.empty_cache()
    print(f"[offload] phase {time.perf_counter() - t_phase:.1f} s")
    if faults:
        raise SystemExit("phase 20: " + "; ".join(faults))
    return out


def mfu_lines(smi: str, bench: dict, bench_cfg: dict, lm: dict, images: dict,
              health: dict) -> dict:
    """The MFU of each measured training path that ``observe.goodput``
    counts (SwinIR-S, GPT-2, ViT; the ResNets have no analytic count
    there): JAX's analytic FLOPs a step over the step ms measured above,
    against the table's peak for this card (989 TFLOP/s, dense bf16, for
    the f32 runs too)."""
    import torch

    from pytorch_distributedtraining_tpu_torch.models import GPT2Config, ViTConfig
    from pytorch_distributedtraining_tpu_torch.observe import goodput

    kind = torch.cuda.get_device_name(0)
    swinir = goodput.swinir_train_flops(2 * BATCH, LR_SIZE, LR_SIZE)  # 2 micro-batches a step
    gpt2 = goodput.gpt2_train_flops(GPT2Config(), LM_BATCH, seq=LM_SEQ)
    paths = [(f"SwinIR-S facade {k} (phase 6)", swinir, v["step_ms"]) for k, v in bench.items()]
    paths += [(f"SwinIR-S TrainStep + FusedAdamW {k} (phase 8)", swinir, v["step_ms"])
              for k, v in bench_cfg.items()]
    paths += [("GPT-2 125M (phase 7)", gpt2, lm["step_ms"]),
              ("GPT-2 125M dropout + untied + remat (phase 16a)", gpt2,
               health["gpt2"]["step_ms"])]
    vit = images.get("5_vitb16_bf16_fsdp")
    if vit is not None:
        paths.append(("ViT-B/16 bf16 ZeRO-3 (phase 13)",
                      goodput.vit_train_flops(ViTConfig.b16(), 64), vit["step_ms"]))
    out = {}
    for name, flops, step_ms in paths:
        out[name] = goodput.mfu(flops, step_ms / 1e3, 1, "gpu", kind)
        print(f"[mfu] {name}: {flops:.4g} FLOP a step, step {step_ms:.2f} ms, MFU "
              f"{out[name]:.4f} of {goodput.peak_flops('gpu', kind):.4g} FLOP/s | {smi}")
    return out


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
    flash_cases = phase_flash_kernels(smi)
    seen: set = set()
    with record_launches(seen):
        phase_driver()
        bench = phase_bench(smi)
        lm = phase_gpt2(smi)
        bench_cfg = phase_bench_config(smi)
        phase_espcn()
    phase_optimizer(smi)
    with record_launches(seen):
        phase_distributed(smi, lm)
        m_runs = phase_swinir_m(smi)
    images = phase_image_rungs(smi)
    with record_launches(seen):
        serving = phase_serving(smi)
        phase_resume(smi)
        health = phase_health(smi, lm)
        phase_observe(smi)
    phase_launch(smi)
    with record_launches(seen):
        phase_graphs(smi)
        phase_offload(smi)
    mfu_lines(smi, bench, bench_cfg, lm, images, health)
    checked = set().union(*(c["checked"] for c in cases + flash_cases), health["checked"])
    print(f"[shapes] phases 5-9, 11, 12, 14-17, 19 and 20 launched {len(seen)} kinds of (kernel, q "
          f"shape, dtype, mask windows or causal): {sorted(seen, key=str)}")
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
            "name": name, "route": "cuda", "source": SOURCES["window_attn"],
            "replaces": REPLACES[name], "launches": launched, "max_abs_err": abs_err,
            "ms": t[key], "plain_ms": t[f"plain_{key}"], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": t[f"lib_{key}"],
        })
    # K3-K5: phase 7's launches, phase 4's causal bf16 case (the path's);
    # one library call (SDPA's backward) stands for K4 and K5 together
    path_case = flash_cases[0]
    t = path_case["times"]
    for name, key, launched, outs, lib in (
        ("flash_attn_fwd", "fwd", lm["launches"][0], ("o", "lse"), "lib_fwd"),
        ("flash_attn_dq", "dq", lm["launches"][1], ("dq",), "lib_bwd"),
        ("flash_attn_dkv", "dkv", lm["launches"][2], ("dk", "dv"), "lib_bwd"),
    ):
        bound = path_case["bounds"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["flash_attn"],
            "replaces": REPLACES[name], "launches": launched,
            "max_abs_err": max(path_case["errors"][o][0] for o in outs), "ms": t[key],
            "plain_ms": t[f"plain_{key}"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": t[lib],
        })
    kernels += serving_kernels(cases, serving)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"swinir_m_kernels": swinir_m_kernels(cases, m_runs)}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
