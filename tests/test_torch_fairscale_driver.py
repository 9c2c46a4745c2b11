"""The ESPCN driver twin against the JAX driver's step.

Three steps of the port's ``TrainStep`` (``Net``, MSE, the per-leaf AdamW
the driver builds) against the JAX ``TrainStep`` under ``ZeRO2`` on a
one-device mesh, from the same weights (carried with
``espcn_state_dict_from_jax``) on the same ``SyntheticSRDataset`` batches.
f32 on both sides; the convolutions' gradients differ in sum order only,
so losses agree to 2.4e-6 relative (held at 1e-5) and parameters to
6e-8 (held at 1e-5, as the facade's trajectory test). Also: the twin's ``main`` end to end on the CPU and
its refusals (no card without ``--device cpu``; a world of more than one
rank with no rendezvous to join).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu.losses import mse_loss as jmse
from pytorch_distributedtraining_tpu.models import Net as JaxNet
from pytorch_distributedtraining_tpu.parallel import TrainStep as JaxTrainStep
from pytorch_distributedtraining_tpu.parallel import ZeRO2, create_train_state
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp
from pytorch_distributedtraining_tpu_torch.interop import espcn_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep

BATCH = 8


def _batches(n):
    ds = SyntheticSRDataset(n=n * BATCH, lr_size=32, scale=2)
    items = [ds[i] for i in range(len(ds))]
    return [tuple(np.stack([it[k] for it in items[j:j + BATCH]]) for k in (0, 1))
            for j in range(0, len(items), BATCH)]


def test_train_step_matches_jax_zero2_step():
    batches = _batches(3)
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    jnet = JaxNet(upscale_factor=2)
    jtx = joptim.adamw(lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4)
    state, shardings = create_train_state(model=jnet, sample_input=batches[0][0][:1], tx=jtx,
                                          mesh=mesh, policy=ZeRO2())

    def jloss(params, batch, rng, model_state):
        return jmse(jnet.apply({"params": params}, batch[0]), batch[1]), {}

    jstep = JaxTrainStep(jloss, jtx, mesh, ZeRO2(), state_shardings=shardings, donate=False)

    net = fairscale_ddp.build_model()
    net.load_state_dict(espcn_state_dict_from_jax(jax.device_get(state.params)))
    tx = fairscale_ddp.optim.adamw(net.named_parameters(), lr=1e-3, betas=(0.9, 0.99),
                                   eps=1e-8, weight_decay=1e-4)
    step = TrainStep(net, fairscale_ddp.loss_fn, tx)
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    for batch in batches:
        state, jm = jstep(state, batch)
        tm = step(tuple(map(torch.from_numpy, batch)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = espcn_state_dict_from_jax(jax.device_get(state.params))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
    assert max(float((p.detach() - p0[n]).abs().max()) for n, p in net.named_parameters()) > 1e-3


def test_driver_twin_runs_one_epoch_on_cpu(capsys):
    loss = fairscale_ddp.main(["--device", "cpu", "--synthetic", "--synthetic-n", "96",
                               "--epochs", "1", "--batch-size", "8", "--workers", "0"])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "--Shape-- (8, 32, 32, 3) (8, 64, 64, 3)" in out
    assert f"For Epoch 0, loss: {loss:.2f}" in out


def test_driver_twin_refuses_without_a_card_or_with_more_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fairscale_ddp.main(["--synthetic", "--workers", "0"])
    # more ranks train now (tests/test_torch_dist_launch.py), but only with a
    # rendezvous to join: a world of 2 without MASTER_ADDR/MASTER_PORT refuses
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT"):
        fairscale_ddp.main(["--synthetic", "--workers", "0", "--device", "cpu"])
