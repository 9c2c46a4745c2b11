"""Resume state on one process: the optimizers' and the loss scaler's
``load_state_dict``, and the rest of the facade surface this slice adds.

- Optimizers: two steps of seeded gradients, ``state_dict`` (or
  ``full_state_dict``), a fresh optimizer loads it, two more steps: the
  parameters, moments and count equal a four-step run bitwise. A
  ``FusedAdamW`` state loads into the per-leaf ``AdamW`` and the reverse,
  moment for moment; a state of another shape or kind is refused.
- The facade: ``zero_grad``, ``state``, ``barrier``, ``ema_params``,
  ``export_trace``, ``ClipGradConfig`` (one step equal to
  ``FusedAdamW(clip_grad_value=)``'s) and ``FP16Options``.

The facade's save and load are in ``tests/test_torch_stoke_resume.py``.
Torch runs one thread here, as the gloo ranks do: the xdist workers share
the machine's cores.
"""

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from pytorch_distributedtraining_tpu_torch.observe import trace
from pytorch_distributedtraining_tpu_torch.precision import DynamicLossScaler
from test_torch_dist_workers import facade, toy_swinir

BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed: int = 0) -> list[tuple[str, torch.Tensor]]:
    g = torch.Generator().manual_seed(seed)
    shapes = {"w": (8, 6), "b": (6,), "k": (3, 3, 2, 4)}
    return [(n, torch.randn(s, generator=g).requires_grad_()) for n, s in shapes.items()]


def _grads(step: int, params) -> list[torch.Tensor]:
    g = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=g) for _, p in params]


def _run(opt, params, steps):
    for i in steps:
        if isinstance(opt, optim.FusedAdamW):
            for (_, p), g in zip(params, _grads(i, params)):
                p.grad.copy_(g)
            opt.apply_tree(1.0)
        else:
            opt.step(_grads(i, params))


OPTIMIZERS = {
    "adamw": lambda ps: optim.adamw(ps, lr=1e-2, clip_grad_norm=1.0, ema_decay=0.9),
    "sgd": lambda ps: optim.sgd(ps, lr=1e-2, momentum=0.9, nesterov=True, clip_grad_value=0.5),
    "fused": lambda ps: optim.FusedAdamW(ps, lr=1e-2, clip_grad_norm=1.0, ema_decay=0.9),
}


@pytest.mark.parametrize("full", [False, True], ids=["state_dict", "full_state_dict"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_load_state_dict_resumes_bitwise(name, full):
    pa = _params()
    a = OPTIMIZERS[name](pa)
    _run(a, pa, range(4))
    pb = _params()
    b = OPTIMIZERS[name](pb)
    _run(b, pb, range(2))
    saved = b.full_state_dict() if full else b.state_dict()
    pc = [(n, p.detach().clone().requires_grad_()) for n, p in pb]
    c = OPTIMIZERS[name](pc)
    c.load_state_dict(saved)
    _run(c, pc, range(2, 4))
    for (n, x), (_, y) in zip(pa, pc):
        assert torch.equal(x, y), n
    sa, sc = a.full_state_dict(), c.full_state_dict()
    assert int(sa["count"]) == int(sc["count"]) == 4
    for key in ("mu", "nu", "ema", "trace"):
        if sa.get(key) is None:
            assert sc.get(key) is None
            continue
        for x, y in zip(torch.as_tensor(sa[key]) if name == "fused" else sa[key],
                        torch.as_tensor(sc[key]) if name == "fused" else sc[key]):
            assert torch.equal(x, y), key


def test_fused_and_per_leaf_states_load_into_each_other():
    pa = _params()
    fused = optim.FusedAdamW(pa, lr=1e-2, clip_grad_norm=1.0)
    _run(fused, pa, range(3))
    leaf = optim.adamw(_params(), lr=1e-2, clip_grad_norm=1.0)
    leaf.load_state_dict(fused.full_state_dict())
    want = fused.leaf_state_dict()
    assert leaf.count == 3
    for key in ("mu", "nu"):
        for n, t in zip(leaf.names, getattr(leaf, key)):
            assert torch.equal(t, want[key][n]), (key, n)
    back = optim.FusedAdamW(_params(), lr=1e-2, clip_grad_norm=1.0)
    back.load_state_dict(leaf.full_state_dict())
    assert int(back.state.count) == 3
    assert torch.equal(back.state.mu, fused.state.mu) and torch.equal(back.state.nu,
                                                                      fused.state.nu)


def test_optimizer_load_refuses_a_state_of_another_shape_or_kind():
    a = optim.adamw(_params(), lr=1e-2)
    sd = a.state_dict()
    sd["mu"] = [torch.zeros(2, 2)] + sd["mu"][1:]
    with pytest.raises(ValueError, match="neither the whole leaf"):
        optim.adamw(_params(), lr=1e-2).load_state_dict(sd)
    with pytest.raises(ValueError, match="ema"):
        optim.adamw(_params(), lr=1e-2, ema_decay=0.9).load_state_dict(a.state_dict())
    with pytest.raises(ValueError, match="ema_decay"):
        optim.FusedAdamW(_params(), ema_decay=0.9).load_state_dict(
            optim.FusedAdamW(_params()).state_dict())


def test_ema_params_are_whole_and_follow_the_parameters():
    for make in (OPTIMIZERS["adamw"], OPTIMIZERS["fused"]):
        ps = _params()
        opt = make(ps)
        _run(opt, ps, range(3))
        ema = optim.ema_params(opt)
        assert [tuple(e.shape) for e in ema] == [tuple(p.shape) for _, p in ps]
        assert all(not torch.equal(e, p) for e, (_, p) in zip(ema, ps))
    assert optim.ema_params(optim.adamw(_params())) is None


def test_loss_scaler_state_round_trips():
    a = DynamicLossScaler(init_scale=2.0**10, growth_interval=3)
    for finite in (True, True, False, True, True, True, True):
        a.update(finite)
    b = DynamicLossScaler()
    b.load_state_dict(a.state_dict())
    assert (b.scale, b.growth_count) == (a.scale, a.growth_count) == (2.0**10, 1)


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


# -- the rest of the facade surface --------------------------------------------------


def test_zero_grad_drops_an_open_accumulation_window():
    micro = _micro(4)
    a = facade(toy_swinir(), oss=False, sddp=False)
    x, y = micro[0]
    a.backward(a.loss(a.model(x), y))
    a.zero_grad()
    assert a._backward_count == 0 and not a._opt.flat_grad.any()
    b = facade(toy_swinir(), oss=False, sddp=False)
    assert _steps(a, micro[1:3]) == _steps(b, micro[1:3])


def test_state_barrier_ema_params_and_export_trace(tmp_path):
    s = tstoke.Stoke(model=toy_swinir(), loss=tlosses.FeatLoss(), device="cpu",
                     optimizer=tstoke.StokeOptimizer("AdamW", {"lr": 1e-3, "ema_decay": 0.9}))
    assert s.state.module is s.model_access and s.state.tx is s._opt
    assert s.state.policy.name == "DDP"
    s.barrier()  # no group: returns
    x, y = _micro(1)[0]
    s.backward(s.loss(s.model(x), y))
    s.step()
    ema = s.ema_params
    assert set(ema) == {n for n, _ in s.model_access.named_parameters()}
    assert all(not torch.equal(ema[n], p) for n, p in s.model_access.named_parameters())
    assert facade(toy_swinir()).ema_params is None
    trace.clear()
    assert s.export_trace(str(tmp_path / "t.json")) is None  # nothing recorded
    trace.enable(crash_handler=False)
    try:
        with trace.span("step", "step"):
            pass
        out = s.export_trace(str(tmp_path / "t.json"))
    finally:
        trace.disable()
        trace.clear()
    assert out == str(tmp_path / "t.json") and (tmp_path / "t.json").stat().st_size > 0


def test_clip_grad_config_clips_by_value():
    s = tstoke.Stoke(model=toy_swinir(), loss=tlosses.FeatLoss(), device="cpu",
                     optimizer=tstoke.StokeOptimizer("AdamW", {"lr": 1e-3}),
                     grad_clip=tstoke.ClipGradConfig(clip=1e-3))
    assert s._opt.clip_grad_value == 1e-3 and s._opt.clip_grad_norm is None
    x, y = _micro(1)[0]
    s.backward(s.loss(s.model(x), y))
    s.step()
    model = toy_swinir()
    ref = optim.FusedAdamW(model.named_parameters(), lr=1e-3, clip_grad_value=1e-3)
    tlosses.FeatLoss()(model(x), y).backward()
    ref.apply_tree(1.0)
    for (n, p), q in zip(s.model_access.named_parameters(), model.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(TypeError, match="ClipGradConfig"):
        tstoke.Stoke(model=toy_swinir(), loss=tlosses.FeatLoss(), device="cpu",
                     optimizer=tstoke.StokeOptimizer("AdamW", {"lr": 1e-3}), grad_clip=0.1)


@pytest.mark.parametrize("option", list(tstoke.FP16Options))
def test_fp16_options_enum_selects_the_precision(option):
    s = facade(toy_swinir(), fp16=option)
    assert s.fp16 == option.value
    if option is tstoke.FP16Options.bf16:
        assert s.precision.compute_dtype == torch.bfloat16 and s.loss_scaler is None
    else:
        assert s.precision.compute_dtype == torch.float16
        assert s.loss_scaler.scale == 2.0**14
