"""Port losses, metrics, optimizer, schedules, data and checkpoints vs the
JAX package, from the same numpy inputs.

Tolerances: f32 arithmetic in another order on each side; values agree to
~1e-6 relative, held at 1e-5. Numpy-only pieces (datasets, samplers,
schedules) must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import metrics as jmetrics
from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import precision as jprecision
from pytorch_distributedtraining_tpu.data import DataLoader as JaxDataLoader
from pytorch_distributedtraining_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributedtraining_tpu.data import SyntheticSRDataset as JaxSynthetic
from pytorch_distributedtraining_tpu.data import random_split as jax_random_split
from pytorch_distributedtraining_tpu_torch import checkpoint as tckpt
from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch import metrics as tmetrics
from pytorch_distributedtraining_tpu_torch import optim as toptim
from pytorch_distributedtraining_tpu_torch import precision as tprecision
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    SyntheticSRDataset,
    random_split,
)
from pytorch_distributedtraining_tpu_torch.observe import sink


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("size", [16, 15])
def test_feature_pyramid_pads_like_xla_same(size):
    """Stride-2 SAME: XLA pads (0, 1) on even sizes, where torch's
    ``padding=1`` would pad (1, 1) and shift the sampling grid."""
    x = _images((2, size, size + 2, 3), 0)
    jl = jlosses.FeatLoss()
    tl = tlosses.FeatLoss()
    want = jlosses._feature_pyramid(jnp.asarray(x), jl.filters)
    got = tlosses._feature_pyramid(torch.from_numpy(x), tl.filters("cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), atol=1e-5)
    assert tlosses.same_pad(16, 3, 2) == (0, 1)
    assert tlosses.same_pad(15, 3, 2) == (1, 1)


def test_losses_and_metrics_match_jax():
    out, tgt = _images((2, 16, 16, 3), 1), _images((2, 16, 16, 3), 2)
    jo, jt = jnp.asarray(out), jnp.asarray(tgt)
    to, tt = torch.from_numpy(out), torch.from_numpy(tgt)
    pairs = [
        (tlosses.mse_loss, jlosses.mse_loss),
        (tlosses.l1_loss, jlosses.l1_loss),
        (tlosses.FeatLoss(), jlosses.FeatLoss()),
        (tlosses.FeatLoss(depths=(8, 16), pixel_weight=0.5, seed=3),
         jlosses.FeatLoss(depths=(8, 16), pixel_weight=0.5, seed=3)),
        (tmetrics.mae, jmetrics.mae),
        (tmetrics.mse, jmetrics.mse),
        (tmetrics.psnr, jmetrics.psnr),
        (tmetrics.ssim, jmetrics.ssim),
    ]
    for tf, jf in pairs:
        np.testing.assert_allclose(float(tf(to, tt)), float(jf(jo, jt)), rtol=1e-5)
    assert float(tmetrics.psnr(to, to)) == pytest.approx(100.0)  # PSNR_MSE_EPS cap


def test_adamw_with_clip_matches_optax_chain():
    """The facade's update: the optax chain at lr=1, scaled by the handle's
    lr afterwards, against the port's AdamW stepping with that lr."""
    r = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[r.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    kw = dict(betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4, clip_grad_norm=0.1)

    tx = joptim.adamw(lr=1.0, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = toptim.adamw(tp, lr=1.0, **kw)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1)
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = [p + u * lr for p, u in zip(jp, upd)]
        opt.step([torch.tensor(a) for a in g], lr=lr)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert float(optax.global_norm(grads[0])) > 0.1  # the clip fired


def test_schedules_match_jax_step_for_step():
    th, jh = toptim.OptimizerHandle(1e-3), joptim.OptimizerHandle(1e-3)
    t1 = toptim.OneCycleLR(th, max_lr=0.01, pct_start=0.9, steps_per_epoch=7, epochs=3)
    j1 = joptim.OneCycleLR(jh, max_lr=0.01, pct_start=0.9, steps_per_epoch=7, epochs=3)
    kw = dict(mode="min", factor=0.2, patience=2, min_factor=0.05)
    t2, j2 = toptim.ReduceLROnPlateau(**kw), joptim.ReduceLROnPlateau(**kw)
    vals = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1]
    for i in range(25):
        assert t1.step() == j1.step()
        assert th.lr == jh.lr
        if i < len(vals):
            t1.lr_scale = t2.step(vals[i])
            j1.lr_scale = j2.step(vals[i])
            assert t1.lr_scale == j1.lr_scale
    ht, hj = toptim.OptimizerHandle(1e-3), joptim.OptimizerHandle(1e-3)
    pt = toptim.ReduceLROnPlateau(ht, factor=0.5, patience=0, min_lr=3e-4)
    pj = joptim.ReduceLROnPlateau(hj, factor=0.5, patience=0, min_lr=3e-4)
    for v in (1.0, 2.0, 3.0, 4.0):
        pt.step(v), pj.step(v)
        assert ht.lr == hj.lr
    assert pt.state_dict() == pj.state_dict()


def test_datasets_split_and_sampler_match_jax():
    tds, jds = SyntheticSRDataset(n=20, lr_size=8), JaxSynthetic(n=20, lr_size=8)
    for i in (0, 7, 19):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    tsplit = random_split(tds, [17, 3])
    jsplit = jax_random_split(jds, [17, 3])
    assert [s.indices for s in tsplit] == [s.indices for s in jsplit]
    for replicas, rank in ((1, 0), (3, 2)):
        ts = DistributedSampler(tsplit[0], num_replicas=replicas, rank=rank, seed=5)
        js = JaxSampler(jsplit[0], num_replicas=replicas, rank=rank, seed=5)
        for epoch in (0, 1):
            ts.set_epoch(epoch), js.set_epoch(epoch)
            assert list(ts) == list(js)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batch_order_matches_jax_loader(workers):
    """Two epochs through each loader's auto set_epoch: same batches in the
    same order; the port's come out as tensors on the loader's device."""
    ds = SyntheticSRDataset(n=22, lr_size=4)
    tl = DataLoader(ds, batch_size=4, sampler=DistributedSampler(ds, 1, 0), device="cpu",
                    num_workers=workers, drop_last=True, persistent_workers=True,
                    multiprocessing_context="spawn" if workers else None)
    jl = JaxDataLoader(JaxSynthetic(n=22, lr_size=4), batch_size=4,
                       sampler=JaxSampler(JaxSynthetic(n=22, lr_size=4), 1, 0),
                       drop_last=True)
    assert len(tl) == len(jl) == 5
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 5
        for (tx, ty), (jx, jy) in zip(got, want):
            assert tx.device.type == "cpu" and tx.dtype == torch.float32
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    tl.shutdown_workers()


def test_loader_refuses_the_gpu_default_without_a_device(monkeypatch):
    """The loader, like the facade, goes to the GPU unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataLoader(SyntheticSRDataset(n=4, lr_size=4), batch_size=2)


def test_checkpoint_strict_nested_load(tmp_path):
    model = torch.nn.Linear(3, 2)
    full, tag = tckpt.save_checkpoint(str(tmp_path), "m", {"params": model.state_dict()})
    assert tag == "m.pt" and full == str(tmp_path / "m.pt")
    src = tckpt.load_file(full)
    matched, keys = tckpt.load_params_dict(src, model.state_dict())
    assert set(matched) == {"weight", "bias"} and keys.missing_keys == []
    flat = dict(src["params"])  # un-nested also loads
    assert set(tckpt.load_params_dict(flat, model.state_dict())[0]) == {"weight", "bias"}
    with pytest.raises(ValueError, match="strict"):
        tckpt.load_params_dict({"weight": flat["weight"]}, model.state_dict())
    _, keys = tckpt.load_params_dict({"weight": flat["weight"]}, model.state_dict(), strict=False)
    assert keys.missing_keys == ["bias"]
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_params_dict({"weight": torch.zeros(2, 2), "bias": flat["bias"]},
                               model.state_dict())


def test_jsonl_sink_drops_nonfinite(tmp_path):
    s = sink.JSONLSink(str(tmp_path / "m.jsonl"))
    s.log({"a": torch.tensor(1.5), "b": float("nan")}, step=3)
    s.finish()
    import json

    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["a"] == 1.5 and rec["_step"] == 3 and "b" not in rec
    assert s.nonfinite_dropped == {"b": 1}


def test_loss_scaler_matches_jax_scaler():
    """Backoff on a non-finite step, growth after ``growth_interval`` clean
    ones, the count reset by either: the same scale sequence as the JAX
    scaler's branchless update."""
    kw = dict(init_scale=2.0**14, growth_factor=2.0, backoff_factor=0.5, growth_interval=3)
    ts, js = tprecision.DynamicLossScaler(**kw), jprecision.DynamicLossScaler(**kw)
    jstate = js.init()
    for finite in (True, True, True, False, True, True, False, False, True, True, True, True):
        ts.update(finite)
        jstate = js.update(jstate, jnp.bool_(finite))
        assert ts.scale == float(jstate.scale)
        assert ts.growth_count == int(jstate.growth_count)
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not ts.grads_finite(grads)
    assert bool(js.grads_finite([jnp.asarray(g.numpy()) for g in grads])) is False
    unscaled = ts.unscale([torch.full((2,), ts.scale)])
    torch.testing.assert_close(unscaled[0], torch.ones(2))


def test_precision_policy_names():
    assert tprecision.Policy.from_name(None).compute_dtype is None
    assert tprecision.Policy.from_name("bf16").compute_dtype == torch.bfloat16
    assert tprecision.Policy.from_name("amp").compute_dtype == torch.float16
    with pytest.raises(ValueError):
        tprecision.Policy.from_name("fp8")
    with tprecision.Policy.from_name("bf16").autocast(torch.device("cpu")):
        assert torch.nn.Linear(3, 2)(torch.randn(2, 3)).dtype == torch.bfloat16


@pytest.mark.parametrize("fp16", ["bf16", "amp"])
def test_facade_low_precision_steps_on_cpu(fp16):
    """The facade's reduced-precision arms on a toy SwinIR: the forward runs
    in the compute dtype (the plain window attention takes its q/k/v in that
    dtype), outputs and loss are f32, and an optimizer step moves the f32
    weights. Under ``amp`` a non-finite gradient skips the update and halves
    the loss scale; the next finite step applies."""
    from pytorch_distributedtraining_tpu_torch.models import SwinIR

    model = SwinIR(img_size=8, window_size=4, depths=(2,), embed_dim=12, num_heads=(2,),
                   generator=torch.Generator().manual_seed(0))
    poison = {"on": fp16 == "amp"}

    def loss_fn(out, tgt):
        loss = torch.mean(torch.abs(out - tgt))
        return loss * float("inf") if poison["on"] else loss

    s = tstoke.Stoke(
        model=model,
        optimizer=tstoke.StokeOptimizer(optimizer="AdamW", optimizer_kwargs={"lr": 1e-3}),
        loss=loss_fn, batch_size_per_device=2, fp16=fp16, grad_accum_steps=1,
        configs=[tstoke.AMPConfig(init_scale=2.0**14)],
        grad_clip=tstoke.ClipGradNormConfig(max_norm=0.1), device="cpu",
    )
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.random((2, 8, 8, 3), dtype=np.float32))
    y = torch.from_numpy(r.random((2, 16, 16, 3), dtype=np.float32))
    w0 = model.conv_first.weight.detach().clone()
    if fp16 == "amp":
        s.backward(s.loss(s.model(x), y))
        s.step()
        assert s.loss_scaler.scale == 2.0**13
        torch.testing.assert_close(model.conv_first.weight, w0, atol=0, rtol=0)
        poison["on"] = False
    out = s.model(x)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 3)
    loss = s.loss(out, y)
    assert torch.isfinite(loss)
    s.backward(loss)
    s.step()
    assert (model.conv_first.weight - w0).abs().max() > 0
    assert all(torch.isfinite(p).all() for p in model.parameters())
