"""The slice as a whole: the port's Stoke facade against the JAX facade.

Both facades are built the way ``drivers/stoke_ddp.py`` builds them (AdamW,
betas (0.9, 0.99), clip 0.1, ``grad_accum_steps=2``, ddp + OSS + SDDP),
the port's with ``device="cpu"``. They start from the same toy SwinIR
weights (carried over with ``swinir_state_dict_from_jax``) and take the
same ``SyntheticSRDataset`` batches through ``DistributedSampler`` for two
optimizer steps, with the lr handle changed between them.

Tolerances: f32 on both sides; per-micro-batch losses agree to ~1e-6
relative (held at 1e-5) and parameters after two AdamW steps at lr 1e-3 to
~1e-7 absolute, except the key part of ``qkv.bias``: its exact gradient is
zero (softmax is shift-invariant), so Adam steps it from each side's own
rounding noise, ~3e-6 apart. Parameters are held at 1e-5, 1% of a step.
Also here: the driver twin end to end on the CPU, and the facade's
refusals (no CUDA device without ``device="cpu"``, ``WORLD_SIZE > 1``).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributedtraining_tpu.data import SyntheticSRDataset as JaxSynthetic
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.data import DistributedSampler, SyntheticSRDataset
from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
from pytorch_distributedtraining_tpu_torch.interop import swinir_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import SwinIR

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2),
           embed_dim=12, num_heads=(2, 2), mlp_ratio=2.0)
BATCH = 8


def _facade(mod, model, loss, **extra):
    return mod.Stoke(
        model=model,
        optimizer=mod.StokeOptimizer(
            optimizer="AdamW",
            optimizer_kwargs={"lr": 1e-3, "betas": (0.9, 0.99), "eps": 1e-8,
                              "weight_decay": 1e-4},
        ),
        loss=loss,
        batch_size_per_device=BATCH,
        gpu=True,
        distributed=mod.DistributedOptions.ddp.value,
        fairscale_oss=True,
        fairscale_sddp=True,
        grad_accum_steps=2,
        configs=[mod.AMPConfig(init_scale=2.0**14), mod.DDPConfig(local_rank=None),
                 mod.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=mod.ClipGradNormConfig(max_norm=0.1, norm_type=2.0),
        **extra,
    )


def _run(s, loader, lrs):
    losses = []
    for i, (x, y) in enumerate(loader):
        s.optimizer.lr = lrs[i // 2]
        loss = s.loss(s.model(x), y)
        s.backward(loss)
        s.step()
        losses.append(loss)
    return [float(np.asarray(v.detach() if hasattr(v, "detach") else v)) for v in losses]


def test_two_step_trajectory_matches_jax_facade():
    # world size 1 on both sides: a one-device mesh, on which the JAX
    # facade's OSS broadcast_fp16 wire has no fan-out to narrow either
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    js = _facade(jstoke, JaxSwinIR(**TOY), jlosses.FeatLoss(), mesh=mesh,
                 sample_input=np.zeros((BATCH, 8, 8, 3), np.float32))
    params = jax.device_get(js.state.params)
    ts = _facade(tstoke, SwinIR(**TOY), tlosses.FeatLoss(), device="cpu")
    ts.load_model_state(swinir_state_dict_from_jax(params, img_size=TOY["img_size"]))

    jds = JaxSynthetic(n=4 * BATCH, lr_size=8)
    tds = SyntheticSRDataset(n=4 * BATCH, lr_size=8)
    jl = js.DataLoader(jds, batch_size=BATCH, sampler=JaxSampler(jds, 1, 0), device_prefetch=0)
    tl = ts.DataLoader(tds, batch_size=BATCH, sampler=DistributedSampler(tds, 1, 0))
    lrs = [1e-3, 5e-4]
    jlosses_ = _run(js, jl, lrs)
    tlosses_ = _run(ts, tl, lrs)

    assert len(tlosses_) == 4 and ts.step_count == js.step_count == 2
    np.testing.assert_allclose(tlosses_, jlosses_, rtol=1e-5)
    want = swinir_state_dict_from_jax(jax.device_get(js.state.params), img_size=TOY["img_size"])
    moved = 0.0
    for name, p in ts.model_access.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want[name].numpy()
                                        - swinir_state_dict_from_jax(params)[name].numpy()).max()))
    assert moved > 1e-4  # the two steps did move the weights


def test_driver_twin_runs_one_epoch_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(stoke_ddp, "SwinIR", lambda **kw: SwinIR(**{**kw, "depths": [2],
                                                                    "num_heads": [6]}))
    train_loss, val_loss = stoke_ddp.main([
        "--synthetic", "--synthetic-n", "20", "--batchSize", "4", "--nEpochs", "1",
        "--threads", "0", "--device", "cpu",
    ])
    assert np.isfinite(train_loss) and np.isfinite(val_loss)
    assert len(list((tmp_path / "checkpoint").glob("model_0_*.pt"))) == 1


def test_facade_refuses_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _facade(tstoke, SwinIR(**TOY), tlosses.FeatLoss())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stoke_ddp.main(["--synthetic", "--threads", "0"])


def test_facade_refuses_more_than_one_process(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="A.4"):
        _facade(tstoke, SwinIR(**TOY), tlosses.FeatLoss(), device="cpu")
