"""The port's Stoke facade over gloo ranks.

At world 2 the facade runs the driver's flags (DDP + OSS + SDDP, ZeRO-2,
with ``FairscaleOSSConfig(broadcast_fp16=True)``) against the JAX facade
on a 2-device mesh, from the same toy SwinIR weights (JAX seed 0, carried
with ``swinir_state_dict_from_jax``), for three steps of two micro-batches
of 8 ``SyntheticSRDataset`` images, the lr handle changed between steps;
each rank takes rows ``r::2`` of a micro-batch. At two ranks both facades
narrow the sharded update to bf16 before it fans out, so both round the
same steps to bf16: the losses (averaged over ranks by
``detach_and_sync_loss``) agree to ~1e-6 relative (held at 1e-5) and the
parameters to a few 1e-7 (held at 1e-5), except the gradient-free key
part of each ``qkv.bias``, held at 5e-5 (``test_torch_dist_step.py``
says why). The two ranks end bitwise equal, rank 0 alone writes the
checkpoint, and a process with no group loads it strictly, with the
optimizer state in the layout of a one-rank run. In the same launch, DDP
with the per-leaf chain (``DistributedDataParallel``, ``no_sync`` on the
first micro-batch) follows the group-less facade on the global batches,
at the same tolerances.

At world 1 a group changes no number: under each layout (DDP +
``FusedAdamW``, OSS + ``FusedAdamW``, the driver's, FSDP) the facade in a
group of one rank, through every collective, follows the group-less
facade's trajectory, both at one CPU thread: losses held at 1e-6
relative (the card's phase-11 bound), parameters at 1e-6 absolute. They
come out equal but for an f32 ulp in a few convolution weights (another
process, other buffer addresses for the vectorised kernels).
"""

import jax
import numpy as np
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import checkpoint
from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from test_torch_dist_step import close_params, numpy_state
from test_torch_dist_workers import (FACADE_OPT, TOY, facade, facade_worker, full_params,
                                     run_ranks, toy_swinir)

BATCH = 8  # a global micro-batch
LRS = [1e-3, 5e-4, 1e-3]
DDP_PER_LEAF = dict(oss=False, sddp=False, fused_optimizer=False)
LAYOUTS = {"ddp+fused": dict(oss=False, sddp=False), "oss+fused": dict(oss=True, sddp=False),
           "oss+sddp": dict(oss=True, sddp=True), "fsdp": dict(fsdp=True)}


def _micro(n: int = 6) -> list:
    ds = SyntheticSRDataset(n=n * BATCH, lr_size=8)
    items = [ds[i] for i in range(len(ds))]
    return [tuple(np.stack([it[k] for it in items[j:j + BATCH]]) for k in (0, 1))
            for j in range(0, len(items), BATCH)]


def _jax_facade(world: int):
    mesh = make_mesh(MeshSpec.zero(world), devices=jax.devices()[:world])
    return jstoke.Stoke(
        model=JaxSwinIR(**TOY), optimizer=jstoke.StokeOptimizer("AdamW", dict(FACADE_OPT)),
        loss=jlosses.FeatLoss(), batch_size_per_device=BATCH // world, gpu=True,
        distributed="ddp", fairscale_oss=True, fairscale_sddp=True, grad_accum_steps=2,
        configs=[jstoke.AMPConfig(init_scale=2.0**14), jstoke.DDPConfig(local_rank=None),
                 jstoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=jstoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0), mesh=mesh,
        sample_input=np.zeros((BATCH, 8, 8, 3), np.float32))


def test_facade_at_world_2_matches_jax_facade_and_checkpoints_on_rank_0(tmp_path):
    micro = _micro()
    js = _jax_facade(2)
    assert js._update_wire_dtype() is not None  # the bf16 wire is on at two ranks
    p0 = jax.device_get(js.state.params)
    jl = []
    for i, (x, y) in enumerate(micro):
        js.optimizer.lr = LRS[i // 2]
        loss = js.loss(js.model(x), y)
        js.backward(loss)
        js.step()
        jl.append(loss)
    jl = [float(np.asarray(v)) for v in jl]

    ranks = run_ranks(facade_worker, 2, micro=micro, lrs=LRS, state=numpy_state(p0, TOY),
                      save_dir=str(tmp_path), layouts=[{}, DDP_PER_LEAF])
    r0, r1 = ranks[0][0], ranks[1][0]
    assert r0["opt"] == "AdamW" and r0["wire"] == "torch.bfloat16"
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(r1["losses"], r0["losses"], rtol=0)
    close_params(r0["params"], numpy_state(jax.device_get(js.state.params), TOY))
    for name, got in r1["params"].items():  # replicas bitwise equal
        np.testing.assert_array_equal(got, r0["params"][name], err_msg=name)
    moved = max(np.abs(r0["params"][n] - v).max() for n, v in numpy_state(p0, TOY).items()
                if n in r0["params"])
    assert moved > 1e-4

    assert (r0["written"], r1["written"]) == (1, 0) and r0["path"] == r1["path"]
    s = facade(toy_swinir(), batch=BATCH)  # one process, no group
    s.load_model_state(r0["path"], strict=True)
    for name, p in s.model_access.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r0["params"][name], err_msg=name)
    saved = checkpoint.load_file(r0["path"])["opt_state"]
    want = s._opt.state_dict()
    assert [tuple(m.shape) for m in saved["mu"]] == [tuple(m.shape) for m in want["mu"]]
    assert saved["count"] == 3

    # DDP with the per-leaf chain (the wrapper, no_sync on the first
    # micro-batch) at two ranks against the facade on the global batches
    ddp = ranks[0][1]
    assert ddp["opt"] == "AdamW" and ddp["wire"] == "None"
    s = facade(toy_swinir(numpy_state(p0, TOY)), batch=BATCH, **DDP_PER_LEAF)
    losses = []
    for i, (x, y) in enumerate(micro):
        s.optimizer.lr = LRS[i // 2]
        loss = s.loss(s.model(torch.from_numpy(x)), torch.from_numpy(y))
        s.backward(loss)
        s.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(ddp["losses"], losses, rtol=1e-5)
    close_params(ddp["params"], full_params(s.model_access))


def test_facade_in_a_group_of_one_follows_the_group_less_facade():
    micro = _micro(4)
    state = {n: v.numpy() for n, v in toy_swinir().state_dict().items()}
    grouped = run_ranks(facade_worker, 1, micro=micro, lrs=LRS, state=state,
                        layouts=list(LAYOUTS.values()))[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the rank's: the same reduction order in every kernel
    try:
        _group_less(micro, state, grouped)
    finally:
        torch.set_num_threads(threads)
    assert [g["opt"] for g in grouped] == ["FusedAdamW", "FusedAdamW", "AdamW", "AdamW"]


def _group_less(micro, state, grouped):
    for (name, flags), g in zip(LAYOUTS.items(), grouped):
        s = facade(toy_swinir(state), batch=BATCH, **flags)
        losses = []
        for i, (x, y) in enumerate(micro):
            s.optimizer.lr = LRS[i // 2]
            loss = s.loss(s.model(torch.from_numpy(x)), torch.from_numpy(y))
            s.backward(loss)
            s.step()
            losses.append(float(loss.detach()))
        assert g["opt"] == type(s._opt).__name__, name
        assert g["wire"] == "None"  # JAX's rule: no fan-out to narrow at one rank
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-6, err_msg=name)
        for pname, want in full_params(s.model_access).items():
            np.testing.assert_allclose(g["params"][pname], want, rtol=0, atol=1e-6,
                                       err_msg=f"{name} {pname}")

