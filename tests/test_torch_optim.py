"""The port's optimizers and schedules against the JAX package's ``optim.py``.

``FusedAdamW`` runs through each package's ``TrainStep`` on the ESPCN
``Net`` (MSE, batches from numpy seed 0, weights carried with
``espcn_state_dict_from_jax``) for five steps: the JAX step on a one-device
DDP mesh, the port's on the CPU. Both do the same f32 arithmetic on the
same flat layout (up to the order of the parameters in the buffer); they
differ in sum order (the convolutions' gradients, the flat norm) and in
``pow``'s last bit. Parameters agree to ~3e-7 after five steps (1.6e-6
with the value clip, where Adam's step on the smallest gradients amplifies
that noise), moments to ~1e-8, losses to ~2e-6 relative; all are held at
atol 1e-5, the JAX package's own fused-against-chain tolerance
(``tests/test_fused_optim.py``), and losses and norms at rtol 1e-5. The per-leaf ``sgd`` and
``adamw`` options are held against their optax chains at rtol 1e-5 (one
rounding apart a step), the schedules to two f32 ulps of 1 times ``max_lr``
(their cosines' rounding, amplified where ``1 + cos`` cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu.losses import mse_loss as jmse
from pytorch_distributedtraining_tpu.models import Net as JaxNet
from pytorch_distributedtraining_tpu.parallel import DDP
from pytorch_distributedtraining_tpu.parallel import TrainStep as JaxTrainStep
from pytorch_distributedtraining_tpu.parallel import create_train_state
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import optim as toptim
from pytorch_distributedtraining_tpu_torch.interop import espcn_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.losses import mse_loss
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config, Net
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep
from pytorch_distributedtraining_tpu_torch.precision import DynamicLossScaler


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.random((n, 16, 16, 3)).astype(np.float32)
    return hr.reshape(n, 8, 2, 8, 2, 3).mean(axis=(2, 4)), hr


def _jax_side(tx, accum):
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    model = JaxNet(upscale_factor=2)

    def loss_fn(params, batch, rng, model_state):
        return jmse(model.apply({"params": params}, batch[0]), batch[1]), {}

    state, shardings = create_train_state(
        init_fn=lambda rng: (model.init(rng, jnp.zeros((1, 8, 8, 3)))["params"], {}),
        tx=tx, mesh=mesh, policy=DDP())
    step = JaxTrainStep(loss_fn, tx, mesh, DDP(), grad_accum_steps=accum,
                        state_shardings=shardings, donate=False)
    return state, step


def _port_side(params, make_tx, accum):
    net = Net(upscale_factor=2)
    net.load_state_dict(espcn_state_dict_from_jax(jax.device_get(params)))

    def loss_fn(model, batch):
        return mse_loss(model(batch[0]), batch[1]), {}

    tx = make_tx(net.named_parameters())
    return net, tx, TrainStep(net, loss_fn, tx, grad_accum_steps=accum)


def _port_flat(tx, flat):
    """A port flat buffer as ``{name: tensor}`` in the port's layout."""
    lay = tx.state_dict()["layout"]
    return {n: flat[o:o + int(np.prod(s))].reshape(s)
            for n, o, s in zip(lay["names"], lay["offsets"], lay["shapes"])}


def _jax_flat(params, flat):
    """A JAX flat buffer (``ravel_pytree`` order) in the port's layout."""
    pflat, unravel = ravel_pytree(params)
    return espcn_state_dict_from_jax(jax.device_get(unravel(flat[: pflat.size])))


FUSED_CASES = {
    "clip": (dict(lr=3e-3, clip_grad_norm=0.1, weight_decay=0.01), 1, 1.0),
    "onecycle_accum2": (dict(lr=("onecycle", 3e-3, 50)), 2, 1.0),
    "ema": (dict(lr=3e-3, clip_grad_norm=0.1, ema_decay=0.9), 1, 1.0),
    "clip_value": (dict(lr=3e-3, clip_grad_value=1e-3), 1, 1.0),
    "lr_factor_0": (dict(lr=0.01), 1, 0.0),
}


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_adamw_matches_jax_fused(case):
    kw, accum, lr_factor = FUSED_CASES[case]

    def lr_of(mod):
        lr = kw["lr"]
        return mod.onecycle(max_lr=lr[1], total_steps=lr[2]) if isinstance(lr, tuple) else lr

    jtx = joptim.FusedAdamW(**{**kw, "lr": lr_of(joptim)})
    state, jstep = _jax_side(jtx, accum)
    p0 = jax.device_get(state.params)
    net, ttx, tstep = _port_side(p0, lambda ps: toptim.FusedAdamW(ps, **{**kw, "lr": lr_of(toptim)}),
                                 accum)
    for i in range(5):
        batch = _batch(8, seed=i)
        state, jm = jstep(state, batch, lr_factor=lr_factor)
        tm = tstep(tuple(map(torch.from_numpy, batch)), lr_factor=lr_factor)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)

    assert int(ttx.state.count) == int(state.opt_state.count) == 5
    want = espcn_state_dict_from_jax(jax.device_get(state.params))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
        if lr_factor == 0.0:
            np.testing.assert_array_equal(p.detach().numpy(),
                                          espcn_state_dict_from_jax(p0)[name].numpy())
    buffers = ["mu", "nu"] + (["ema"] if "ema_decay" in kw else [])
    for buf in buffers:
        got = _port_flat(ttx, getattr(ttx.state, buf))
        ref = _jax_flat(state.params, np.asarray(getattr(state.opt_state, buf)))
        for name in got:
            np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), atol=1e-5,
                                       err_msg=f"{buf} {name}")
    if "ema_decay" in kw:
        ema = dict(zip(ttx.names, toptim.ema_params(ttx, ttx.params)))
        jema = espcn_state_dict_from_jax(jax.device_get(joptim.ema_params(state.opt_state,
                                                                           state.params)))
        for name in ema:
            np.testing.assert_allclose(ema[name].numpy(), jema[name].numpy(), atol=1e-5)
        assert toptim.has_ema(ttx) and joptim.has_ema(state.opt_state)


def test_fused_scaler_gate_skips_a_non_finite_step():
    """GradScaler parity: an inf gradient leaves params, moments and count
    bitwise as they were and halves nothing here (the facade's scaler reads
    the returned flag); the next finite step applies."""
    net = Net(upscale_factor=2)
    tx = toptim.FusedAdamW(net.parameters(), lr=1e-2, clip_grad_norm=0.1)
    scaler = DynamicLossScaler(init_scale=2.0**14)
    x, y = map(torch.from_numpy, _batch(4))
    (mse_loss(net(x), y) * scaler.scale).backward()
    tx.apply_tree(scaler=scaler)
    tx.zero_grad()
    before = tx.flat_param.clone(), tx.state._replace(
        **{k: getattr(tx.state, k).clone() for k in ("count", "mu", "nu")})
    (mse_loss(net(x), y) * scaler.scale).backward()
    net.conv2.weight.grad[0, 0, 0, 0] = float("inf")
    _, finite = tx.apply_tree(scaler=scaler)
    assert finite.dtype == torch.bool and not bool(finite)
    assert torch.equal(tx.flat_param, before[0])
    for name in ("count", "mu", "nu"):
        assert torch.equal(getattr(tx.state, name), getattr(before[1], name)), name
    assert int(tx.state.count) == 1
    tx.zero_grad()
    (mse_loss(net(x), y) * scaler.scale).backward()
    _, finite = tx.apply_tree(scaler=scaler)
    assert bool(finite) and int(tx.state.count) == 2
    assert not torch.equal(tx.flat_param, before[0])


def test_fused_params_and_grads_stay_views_of_the_flat_buffers():
    """Every parameter's data and grad lie in the flat buffers after each
    step, autograd accumulates into the same grad storage across two
    micro-batches, and the tied GPT-2 head is one parameter in the buffer."""
    net = Net(upscale_factor=2)
    tx = toptim.FusedAdamW(net.named_parameters(), lr=1e-3)

    def inside(t, flat):
        start = flat.data_ptr()
        return start <= t.data_ptr() and t.data_ptr() + t.numel() * 4 <= start + flat.numel() * 4

    ptrs = [p.grad.data_ptr() for p in net.parameters()]
    seen = []

    def loss_fn(model, batch):
        seen.append([p.grad.data_ptr() for p in model.parameters()])
        return mse_loss(model(batch[0]), batch[1]), {}

    step = TrainStep(net, loss_fn, tx, grad_accum_steps=2)
    for i in range(3):
        step(tuple(map(torch.from_numpy, _batch(8, seed=i))))
        for p in net.parameters():
            assert inside(p, tx.flat_param) and inside(p.grad, tx.flat_grad)
    assert all(s == ptrs for s in seen) and len(seen) == 6
    lay = tx.state_dict()["layout"]
    assert lay["names"] == [n for n, _ in net.named_parameters()]
    assert lay["numel"] == sum(p.numel() for p in net.parameters())
    assert all(o % 64 == 0 for o in lay["offsets"])  # every parameter 256-byte aligned
    assert lay["padded"] % 1024 == 0 and lay["padded"] >= lay["offsets"][-1] + net.conv3.bias.numel()
    pads = torch.ones(lay["padded"], dtype=torch.bool)
    for o, p in zip(lay["offsets"], net.parameters()):
        pads[o:o + p.numel()] = False
    assert float(tx.flat_param[pads].abs().sum()) == 0.0  # the padding stays zero

    gpt = GPT2(GPT2Config.tiny(), generator=torch.Generator().manual_seed(0))
    gtx = toptim.FusedAdamW(gpt.named_parameters(), lr=1e-3)
    assert gtx.numel == sum(p.numel() for p in gpt.parameters())
    assert sum("wte" in n for n in gtx.names) == 1


def test_fused_refuses_what_a_flat_f32_buffer_cannot_hold():
    net = Net(upscale_factor=2).to(torch.bfloat16)
    with pytest.raises(ValueError, match="flat f32 buffer"):
        toptim.FusedAdamW(net.parameters())
    net = Net(upscale_factor=2)
    tx = toptim.FusedAdamW(net.parameters(), ema_decay=0.9)
    plain = toptim.FusedAdamW(Net(upscale_factor=2).parameters())
    with pytest.raises(ValueError, match="no ema buffer"):
        tx.apply(tx.flat_grad, plain.state, tx.flat_param)
    with pytest.raises(ValueError, match="ema_decay=None"):
        plain.apply(plain.flat_grad, tx.state, plain.flat_param)


def test_fused_update_wire_rounds_each_step():
    """``update_wire_dtype`` casts the step vector before the add: from zero
    parameters (no decay term) the new parameters are the f32 step rounded
    to bf16."""
    net = Net(upscale_factor=2)
    steps = {}
    for wire in (None, torch.bfloat16):
        tx = toptim.FusedAdamW(net.parameters(), lr=1e-3, update_wire_dtype=wire)
        g = torch.randn(tx.flat_grad.shape, generator=torch.Generator().manual_seed(0))
        steps[wire] = tx.apply(g, tx.state, torch.zeros_like(tx.flat_param))[0]
    assert torch.equal(steps[torch.bfloat16], steps[None].to(torch.bfloat16).float())
    assert not torch.equal(steps[torch.bfloat16], steps[None])


SGD_CASES = [dict(momentum=0.0), dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
             dict(momentum=0.9, weight_decay=1e-3, clip_grad_norm=0.5)]


@pytest.mark.parametrize("kw", SGD_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_sgd_matches_optax(kw):
    r = np.random.default_rng(7)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[r.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(4)]
    tx = joptim.sgd(lr=0.05, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = toptim.sgd(tp, lr=0.05, **kw)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(a) for a in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 1e-3])  # the clip fires / does not
def test_recorded_clip_matches_jax_clip_stats(scale):
    r = np.random.default_rng(8)
    shapes = [(5, 3), (7,)]
    params = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [(r.standard_normal(s) * scale).astype(np.float32) for s in shapes]
    tx = joptim.adamw(lr=1e-3, clip_grad_norm=0.1)
    jp = [jnp.asarray(p) for p in params]
    _, state = tx.update([jnp.asarray(g) for g in grads], tx.init(jp), jp)
    want = joptim.clip_stats(state)
    opt = toptim.adamw([torch.tensor(p, requires_grad=True) for p in params], lr=1e-3,
                       clip_grad_norm=0.1)
    assert toptim.clip_stats(opt) is None
    opt.step([torch.tensor(g) for g in grads])
    got = toptim.clip_stats(opt)
    np.testing.assert_allclose(float(got.gnorm), float(want.gnorm), rtol=1e-6)
    assert bool(got.clipped) == bool(want.clipped) == (scale == 1.0)

    # the fused optimizer records the same from its flat norm
    fused = toptim.FusedAdamW([torch.tensor(p, requires_grad=True) for p in params], lr=1e-3,
                              clip_grad_norm=0.1)
    for p, g in zip(fused.params, grads):
        p.grad.copy_(torch.from_numpy(g))
    gnorm, _ = fused.apply_tree()
    np.testing.assert_allclose(float(gnorm), float(want.gnorm), rtol=1e-6)
    assert bool(toptim.clip_stats(fused).clipped) == bool(want.clipped)


def test_adamw_value_clip_and_ema_match_jax_chain():
    """The per-leaf chain's value clip and params EMA on the same grads: at
    lr_factor 1 the chain's EMA element sees the true new params, so the
    port's EMA of its new params is the same quantity."""
    r = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(r.standard_normal(s) * 0.05).astype(np.float32) for s in shapes]
             for _ in range(4)]
    kw = dict(lr=3e-3, clip_grad_norm=0.1, clip_grad_value=0.02, ema_decay=0.8)
    tx = joptim.adamw(**kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = toptim.adamw([torch.tensor(p, requires_grad=True) for p in params], **kw)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(a) for a in g])
    for got, want in [(opt.params, jp), (toptim.ema_params(opt), joptim.ema_params(state))]:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert toptim.has_ema(opt) and not toptim.has_ema(toptim.adamw(Net().parameters()))
    assert float(np.abs(np.concatenate([a.ravel() for a in grads[0]])).max()) > 0.02  # it clipped


@pytest.mark.parametrize("name,kw", [
    ("cosine_with_warmup", dict(max_lr=1e-3, total_steps=40, warmup_steps=7, final_lr=1e-5)),
    ("cosine_with_warmup", dict(max_lr=2e-3, total_steps=30)),
    ("onecycle", dict(max_lr=3e-3, total_steps=40, pct_start=0.25)),
])
def test_schedules_match_jax_step_for_step(name, kw):
    tf, jf = getattr(toptim, name)(**kw), getattr(joptim, name)(**kw)
    for step in range(kw["total_steps"] + 5):
        want = float(jf(jnp.int32(step)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(arg)
            assert got.dtype == torch.float32 and got.dim() == 0
            # cos near -1 cancels in 1 + cos: an ulp of cos is 6e-8 of max_lr
            np.testing.assert_allclose(float(got), want, rtol=2e-7, atol=2.4e-7 * kw["max_lr"])


def test_scheduler_state_round_trips():
    th, jh = toptim.OptimizerHandle(1e-3), joptim.OptimizerHandle(1e-3)
    t1 = toptim.OneCycleLR(th, max_lr=0.01, total_steps=20)
    j1 = joptim.OneCycleLR(jh, max_lr=0.01, total_steps=20)
    for _ in range(6):
        t1.step(), j1.step()
    t1.lr_scale = j1.lr_scale = 0.5
    assert t1.state_dict() == j1.state_dict()
    h2 = toptim.OptimizerHandle(1e-3)
    t2 = toptim.OneCycleLR(h2, max_lr=0.01, total_steps=20)
    t2.load_state_dict(t1.state_dict())
    assert h2.lr == th.lr * 0.5 and t2.step() == t1.step()

    kw = dict(factor=0.5, patience=0, min_lr=1e-4)
    pt = toptim.ReduceLROnPlateau(toptim.OptimizerHandle(1e-3), **kw)
    pj = joptim.ReduceLROnPlateau(joptim.OptimizerHandle(1e-3), **kw)
    for v in (1.0, 2.0, 3.0):
        pt.step(v), pj.step(v)
    hr = toptim.OptimizerHandle(1e-3)
    restored = toptim.ReduceLROnPlateau(hr, **kw)
    restored.load_state_dict(pt.state_dict())
    assert restored.state_dict() == pt.state_dict() == pj.state_dict()
    assert restored.factor_value == pj.factor_value and hr.lr == pj.optimizer.lr
    assert restored.step(4.0) == pj.step(4.0)
