"""The facade's resume on one process, on the toy SwinIR, and the JAX
facade's own resume as the reference.

- ``Stoke.save`` at step 2, ``Stoke.load`` into a fresh facade, steps 3
  and 4: losses, parameters and moments equal an unbroken four-step run
  bitwise, for ``FusedAdamW`` (DDP flags), the per-leaf chain (the
  driver's OSS + SDDP flags) and fp16 ``amp`` (the scaler's scale and
  count come back), through each of the three formats (``.pt``, portable,
  sharded); the lr handle, the generator and the loaders' epochs come back.
- Against JAX: the JAX facade saves at step 2 of the same trajectory and
  a fresh JAX facade loads and takes steps 3 and 4; the port's resumed
  losses match JAX's within ``test_torch_stoke.py``'s tolerances (1e-5
  relative for losses, 1e-5 absolute for parameters) but for the
  gradient-free key third of each ``qkv.bias``, which Adam steps from each
  side's rounding noise and ``test_torch_dist_step.close_params`` holds at
  5e-5 (four steps here, two there).
- The Stoke driver with ``--portable-ckpt``, its second epoch lost,
  resumes from the newest committed epoch and ends with the unbroken
  run's losses.

Torch runs one thread here, as the gloo ranks do: the xdist workers share
the machine's cores.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from pytorch_distributedtraining_tpu_torch.interop import swinir_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from test_torch_dist_step import close_params
from test_torch_dist_workers import _moments, facade, full_params, toy_swinir

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2),
           embed_dim=12, num_heads=(2, 2), mlp_ratio=2.0)
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _micro(n: int = 8) -> list:
    ds = SyntheticSRDataset(n=n * BATCH, lr_size=8)
    items = [ds[i] for i in range(len(ds))]
    return [tuple(torch.from_numpy(np.stack([it[k] for it in items[j:j + BATCH]]))
                  for k in (0, 1)) for j in range(0, len(items), BATCH)]


def _steps(s, micro) -> list[float]:
    out = []
    for x, y in micro:
        loss = s.loss(s.model(x), y)
        s.backward(loss)
        s.step()
        out.append(float(loss.detach()))
    return out


FLAGS = {
    "fused": dict(oss=False, sddp=False),
    "per-leaf": dict(oss=True, sddp=True),
    "amp-fused": dict(oss=False, sddp=False, fp16="amp"),
    "amp-per-leaf": dict(oss=True, sddp=True, fp16="amp"),
}


def _save_load(kind, b, c, tmp_path):
    if kind == "pt":
        c.load(b.save(str(tmp_path), "ck")[0])
    elif kind == "portable":
        c.load_resharded(b.save_portable(str(tmp_path / "portable")))
    else:
        c.load_sharded(b.save_sharded(str(tmp_path / "sharded")))


@pytest.mark.parametrize("kind", ["pt", "portable", "sharded"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_facade_resume_equals_the_unbroken_run_bitwise(flags, kind, tmp_path):
    micro = _micro()
    a = facade(toy_swinir(), **FLAGS[flags])
    unbroken = _steps(a, micro)
    b = facade(toy_swinir(), **FLAGS[flags])
    first = _steps(b, micro[:4])
    b.optimizer.lr = 5e-4  # the lr handle comes back too
    c = facade(toy_swinir(), **FLAGS[flags])
    _save_load(kind, b, c, tmp_path)
    assert c.step_count == 2 and c.optimizer.lr == 5e-4
    c.optimizer.lr = a.optimizer.lr
    resumed = first + _steps(c, micro[4:])
    assert type(c._opt).__name__ == ("AdamW" if "per-leaf" in flags else "FusedAdamW")
    assert resumed == unbroken
    assert c.step_count == a.step_count == 4
    for (n, x), y in zip(full_params(a.model_access).items(),
                         full_params(c.model_access).values()):
        np.testing.assert_array_equal(x, y, err_msg=n)
    ma, mc = _moments(a._opt), _moments(c._opt)
    for k in ma:
        np.testing.assert_array_equal(ma[k], mc[k], err_msg=k)
    if a.loss_scaler is not None:
        assert c.loss_scaler.state_dict() == a.loss_scaler.state_dict()
    assert float(c._ema) == float(a._ema)


def test_facade_load_restores_the_generator_and_the_loaders_epochs(tmp_path):
    s = facade(toy_swinir(), oss=False, sddp=False)
    loader = s.DataLoader(SyntheticSRDataset(n=16, lr_size=8), batch_size=BATCH)
    for _ in range(3):
        list(loader)
    torch.manual_seed(7)
    path, _ = s.save(str(tmp_path), "ck", extras={"epoch": 2})
    want = torch.rand(4)
    torch.manual_seed(0)
    t = facade(toy_swinir(), oss=False, sddp=False)
    meta = t.load(path)
    assert meta["epoch"] == 2 and torch.equal(torch.rand(4), want)
    later = t.DataLoader(SyntheticSRDataset(n=16, lr_size=8), batch_size=BATCH)
    assert later.epoch == loader.epoch == 3


def _jax_facade(mesh):
    return jstoke.Stoke(
        model=JaxSwinIR(**TOY),
        optimizer=jstoke.StokeOptimizer("AdamW", {"lr": 1e-3, "betas": (0.9, 0.99), "eps": 1e-8,
                                                  "weight_decay": 1e-4}),
        loss=jlosses.FeatLoss(), batch_size_per_device=BATCH, gpu=True, distributed="ddp",
        fairscale_oss=True, fairscale_sddp=True, grad_accum_steps=2,
        configs=[jstoke.AMPConfig(init_scale=2.0**14), jstoke.DDPConfig(local_rank=None),
                 jstoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=jstoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0), mesh=mesh,
        sample_input=np.zeros((BATCH, 8, 8, 3), np.float32))


def test_resume_matches_the_jax_facades_own_resume(tmp_path):
    micro = _micro()
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    js = _jax_facade(mesh)
    p0 = jax.device_get(js.state.params)
    jl = []
    for x, y in micro[:4]:
        loss = js.loss(js.model(x.numpy()), y.numpy())
        js.backward(loss)
        js.step()
        jl.append(float(np.asarray(loss)))
    path, _ = js.save(str(tmp_path), "jax")
    js2 = _jax_facade(mesh)
    js2.load(path)
    assert js2.step_count == 2
    for x, y in micro[4:]:
        loss = js2.loss(js2.model(x.numpy()), y.numpy())
        js2.backward(loss)
        js2.step()
        jl.append(float(np.asarray(loss)))

    weights = swinir_state_dict_from_jax(p0, img_size=TOY["img_size"])
    ts = facade(SwinIR(**TOY), batch=BATCH)
    ts.load_model_state(weights)
    tl = _steps(ts, micro[:4])
    ts.save(str(tmp_path), "port")
    ts2 = facade(SwinIR(**TOY), batch=BATCH)
    ts2.load(str(tmp_path / "port.pt"))
    tl += _steps(ts2, micro[4:])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = swinir_state_dict_from_jax(jax.device_get(js2.state.params), img_size=TOY["img_size"])
    close_params(full_params(ts2.model_access), {k: v.numpy() for k, v in want.items()})


def test_stoke_driver_resumes_from_the_latest_committed_portable_epoch(tmp_path, monkeypatch):
    """``drivers.stoke_ddp --portable-ckpt``: a run that lost its second
    epoch (only ``epoch_0000`` committed, a torn ``epoch_0001.tmp`` beside
    it) resumes from epoch 0's checkpoint, trains epoch 1 alone, and ends
    with the unbroken run's train and validation losses, exactly."""
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(stoke_ddp, "SwinIR", lambda **kw: SwinIR(**{**kw, "depths": [2],
                                                                    "num_heads": [6]}))
    argv = ["--synthetic", "--synthetic-n", "20", "--batchSize", "4", "--nEpochs", "2",
            "--threads", "0", "--device", "cpu"]
    unbroken = stoke_ddp.main(argv + ["--portable-ckpt", str(tmp_path / "a")])
    assert sorted(os.listdir(tmp_path / "a")) == ["epoch_0000", "epoch_0001"]
    shutil.copytree(tmp_path / "a" / "epoch_0000", tmp_path / "b" / "epoch_0000")
    shutil.copytree(tmp_path / "a" / "epoch_0001", tmp_path / "b" / "epoch_0001.tmp")
    os.remove(tmp_path / "b" / "epoch_0001.tmp" / "_COMMIT")
    resumed = stoke_ddp.main(argv + ["--portable-ckpt", str(tmp_path / "b")])
    assert resumed == unbroken
    assert stoke_ddp.latest_portable(str(tmp_path / "b")).endswith("epoch_0001")
