"""The deferred Stoke-style window against the JAX facade's.

Twins of the nine cases of ``tests/test_stoke_fused_eager.py``: ESPCN
``Net`` with the same weights in both packages (the JAX facade's seed-0
init carried over by ``espcn_state_dict_from_jax``), AdamW at lr 1e-3 and
weight decay 1e-4, MSE, batches of 8 from one numpy seed. The port's
facade runs on the CPU, where every program of the window runs
uncaptured through the code the card captures; JAX runs its compiled
programs on its 8-device CPU mesh. Tolerances are the JAX test's: losses
within 2e-5 relative, parameters within 1e-6 absolute (1e-5 where the
JAX test holds the fused program's parameters at 1e-5). The OSS case,
which JAX runs over its 8 devices, runs over two gloo ranks
(``tests/test_torch_dist_workers.py``).

Torch-only cases: a handle through ``torch.*`` calls and tensor methods;
an input written in place after ``.model()`` leaves the window as it
was; a ``DistributedDataParallel`` wrapper (``fused_optimizer=False``),
once refused, runs deferred with every program built to capture; ``fuse_eager_step=False`` equal to ``True``
bitwise; the driver's loop at accum 2 takes the split path, as JAX's.
Torch runs at one thread.
"""

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu.models import Net as JaxNet
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch import optim as toptim
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.interop import espcn_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import Net
from test_torch_dist_workers import facade, run_ranks, sr_batches, toy_swinir

torch.set_num_threads(1)

LOSS_RTOL = 2e-5


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.random((n, 16, 16, 3)).astype(np.float32)
    lr = hr.reshape(n, 8, 2, 8, 2, 3).mean(axis=(2, 4))
    return lr, hr


OPT = {"lr": 1e-3, "weight_decay": 1e-4}


def _jax(fuse, accum=1, opt=OPT, **extra):
    return jstoke.Stoke(
        model=JaxNet(upscale_factor=2),
        optimizer=jstoke.StokeOptimizer(optimizer="AdamW", optimizer_kwargs=dict(opt)),
        loss=jlosses.mse_loss, grad_accum_steps=accum, fuse_eager_step=fuse,
        sample_input=_batch()[0], **extra)


def _torch(fuse, jax_facade, accum=1, **extra):
    import jax

    net = Net(upscale_factor=2)
    net.load_state_dict(espcn_state_dict_from_jax(jax.device_get(jax_facade.state.params)))
    return tstoke.Stoke(
        model=net, optimizer=tstoke.StokeOptimizer("AdamW", dict(OPT)),
        loss=tlosses.mse_loss, grad_accum_steps=accum, fuse_eager_step=fuse, device="cpu",
        **extra)


def _pair(fuse, accum=1):
    js = _jax(fuse, accum)
    return js, _torch(fuse, js, accum)


def _params(s) -> dict:
    return {n: p.detach().numpy().copy() for n, p in s.model_access.named_parameters()}


def _jax_params(js) -> dict:
    import jax

    return {n: v.numpy() for n, v in
            espcn_state_dict_from_jax(jax.device_get(js.state.params)).items()}


def _close(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], atol=atol, err_msg=name)


def _run_loop(s, n_iters, batches):
    """The reference loop (``Stoke-DDP.py:70-86``); per-iteration losses."""
    out = []
    for i in range(n_iters):
        x, y = batches[i % len(batches)]
        loss = s.loss(s.model(x), y)
        s.backward(loss=loss)
        s.step()
        out.append(float(s.detach_and_sync_loss(loss=loss)))
    return out


def _kinds(s) -> set:
    return {kind for kind, _ in s._graphs}


@pytest.mark.parametrize("accum,iters,steps", [(1, 6, 6), (2, 8, 4)], ids=["accum1", "accum2"])
def test_fused_matches_split(accum, iters, steps):
    batches = [_batch(seed=s) for s in range(accum + 2)]
    runs = {}
    for fuse in (True, False):
        js, ts = _pair(fuse, accum)
        runs[fuse] = (_run_loop(js, iters, batches), js, _run_loop(ts, iters, batches), ts)
    (jl_f, js_f, tl_f, ts_f), (jl_s, js_s, tl_s, ts_s) = runs[True], runs[False]
    np.testing.assert_allclose(tl_f, tl_s, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl_f, jl_f, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl_s, jl_s, rtol=LOSS_RTOL)
    _close(_params(ts_f), _params(ts_s), atol=1e-6)
    _close(_params(ts_f), _jax_params(js_f), atol=1e-6)
    _close(_params(ts_s), _jax_params(js_s), atol=1e-6)
    assert ts_f.step_count == ts_s.step_count == int(js_f.state.step) == steps


def test_fused_program_runs_accum2_when_not_detaching_per_micro():
    """Without a read of a loss inside the window, each window of two runs
    as the one program (no split-path flush) and matches the split path
    and the JAX facade's fused program."""
    batches = [_batch(seed=s) for s in range(4)]
    runs = {}
    for fuse in (True, False):
        js, ts = _pair(fuse, accum=2)
        handles = []
        for i in range(4):
            for s in (js, ts):
                x, y = batches[i]
                loss = s.loss(s.model(x), y)
                s.backward(loss=loss)
                s.step()
                if s is ts:
                    handles.append(loss)
        runs[fuse] = (js, ts, handles)
    (js_f, ts_f, handles), (js_s, ts_s, _) = runs[True], runs[False]
    assert all(h._value is not None for h in handles)
    assert _kinds(ts_f) == {"window"} and _kinds(ts_s) == {"first", "acc", "apply"}
    _close(_params(ts_f), _params(ts_s), atol=1e-5)
    _close(_params(ts_f), _jax_params(js_f), atol=1e-5)


def test_backward_returns_concrete_loss_passthrough():
    """A caller that brought its own (non-deferred) loss gets it back."""
    for s in _pair(True):
        x, y = _batch()
        loss = s.loss(s.model(x), y)
        concrete = float(loss)
        ret = s.backward(loss=loss)
        assert ret is not None
        np.testing.assert_allclose(float(ret), concrete, rtol=1e-6)
        s.step()
    # a concrete loss of the caller's own, after a deferred .loss(): the
    # deferred one comes back, in both packages
    rets = []
    for s in _pair(True):
        x, y = _batch()
        s.loss(s.model(x), y)
        rets.append(s.backward(loss=torch.tensor(1.5)))
    assert [type(r).__name__ for r in rets] == ["_LazyLoss", "_LazyLoss"]
    np.testing.assert_allclose(float(rets[1]), float(rets[0]), rtol=LOSS_RTOL)


def test_early_loss_use_before_step():
    """``float(loss)`` between ``.backward()`` and ``.step()`` gives the
    pre-update loss, the same handle keeps it, the step still applies, and
    the value is the split path's and the JAX facade's."""
    x, y = _batch()
    values = {}
    for fuse in (True, False):
        for pkg, s in zip(("jax", "torch"), _pair(fuse)):
            loss = s.loss(s.model(x), y)
            s.backward(loss=loss)
            early = float(loss)
            p0 = (_params(s) if pkg == "torch" else _jax_params(s))["conv1.weight"]
            s.step()
            assert float(loss) == early
            p1 = (_params(s) if pkg == "torch" else _jax_params(s))["conv1.weight"]
            assert not np.array_equal(p0, p1), "step() must still update params"
            values[(fuse, pkg)] = early
    want = values[(False, "jax")]
    for key, got in values.items():
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=str(key))


def test_zero_grad_drops_window():
    x, y = _batch()
    losses = []
    for pkg, s in zip(("jax", "torch"), _pair(True)):
        loss = s.loss(s.model(x), y)
        s.backward(loss=loss)
        s.zero_grad()
        p0 = (_params(s) if pkg == "torch" else _jax_params(s))
        s.step()  # no pending backward: a no-op
        _close(_params(s) if pkg == "torch" else _jax_params(s), p0, atol=0.0)
        losses.append(float(loss))  # the handle still materializes
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL)


def test_oss_facade_auto_selects_fused_and_shards_moments():
    """``fairscale_oss=True`` (ZeRO-1) with AdamW takes ``FusedAdamW``
    with its flat moments sharded over the group (two gloo ranks; JAX: its
    8-device mesh), the loop trains, and the losses are the JAX facade's."""
    from pytorch_distributedtraining_tpu import optim as joptim

    x, y = _batch(16)
    js = _jax(True, opt={"lr": 3e-3}, fairscale_oss=True)
    assert isinstance(js._tx, joptim.FusedAdamW)
    import jax

    state = {k: v.numpy() for k, v in
             espcn_state_dict_from_jax(jax.device_get(js.state.params)).items()}
    jl = []
    for _ in range(12):
        loss = js.loss(js.model(x), y)
        js.backward(loss=loss)
        js.step()
        jl.append(float(js.detach_and_sync_loss(loss)))
    from test_torch_dist_workers import oss_fused_eager_worker

    got = run_ranks(oss_fused_eager_worker, 2, state=state, batch=(x, y), iters=12)
    for r in got:
        assert r["opt"] == "FusedAdamW" and r["mu_local"] * 2 == r["mu_padded"]
        assert r["losses"][-1] < r["losses"][0]
        np.testing.assert_allclose(r["losses"], jl, rtol=LOSS_RTOL)


def test_fused_opt_state_checkpoint_roundtrip(tmp_path):
    """The flat ``FusedAdamW`` state survives save/load and training
    resumes bitwise (the JAX test's check, here in each package)."""
    js, ts = _pair(True)
    x, y = _batch()
    for s in (js, ts):
        for _ in range(3):
            loss = s.loss(s.model(x), y)
            s.backward(loss=loss)
            s.step()
    path, _ = ts.save(path=str(tmp_path), name="fused_ckpt")
    t2 = _torch(True, _jax(True))
    t2.load(path)
    assert isinstance(t2._opt, toptim.FusedAdamW)
    np.testing.assert_array_equal(t2._opt.state.mu.numpy(), ts._opt.state.mu.numpy())
    assert int(t2._opt.state.count) == 3
    for s in (ts, t2, js):
        loss = s.loss(s.model(x), y)
        s.backward(loss=loss)
        s.step()
    _close(_params(t2), _params(ts), atol=0.0)
    _close(_params(ts), _jax_params(js), atol=1e-6)


def test_output_handle_resolves_from_fused_program():
    for s in _pair(True):
        x, y = _batch()
        out = s.model(x)
        loss = s.loss(out, y)
        s.backward(loss=loss)
        s.step()
        assert out._value is not None  # from the program's own forward
        assert out.shape[0] == x.shape[0]


# -- torch-only cases ---------------------------------------------------------


def test_handle_through_torch_calls_and_tensor_methods():
    _, ts = _pair(True)
    x, y = _batch()
    out = ts.model(x)
    loss = ts.loss(out, y)
    ts.backward(loss)
    ts.step()
    value = out._value
    assert torch.equal(torch.mean(out), value.mean())
    assert torch.equal(out.sum(dim=0), value.sum(dim=0))
    assert torch.equal(out + 1, value + 1) and torch.equal(2 * out, 2 * value)
    assert torch.equal(torch.nn.functional.mse_loss(out, torch.from_numpy(y)),
                       torch.nn.functional.mse_loss(value, torch.from_numpy(y)))
    assert torch.equal(torch.from_numpy(np.asarray(out)), value)
    assert float(loss) == float(loss.detach()) and bool(loss > 0) and len(out) == 8
    assert loss.detach().dim() == 0 and loss.item() == float(loss)
    # shape queries of a new handle of a seen signature run no forward
    out2 = ts.model(x)
    assert out2.shape == value.shape and out2.dtype == torch.float32 and out2.ndim == 4
    assert out2.size() == value.size() and out2.size(1) == value.size(1)
    assert out2._value is None
    # an early read runs the forward alone, and leaves the window as it was
    with torch.no_grad():
        want = ts.model_access(torch.from_numpy(x))
    assert torch.equal(out2.detach(), want)


def test_input_written_after_model_does_not_change_the_window():
    batches = [tuple(map(torch.from_numpy, _batch(seed=s))) for s in range(2)]
    runs = []
    for overwrite in (False, True):
        js, ts = _pair(True, accum=2)
        losses = []
        for x, y in batches:
            x, y = x.clone(), y.clone()
            loss = ts.loss(ts.model(x), y)
            ts.backward(loss)
            if overwrite:
                x.fill_(0.0)
                y.fill_(1.0)
            ts.step()
            losses.append(loss)
        runs.append(([float(v) for v in losses], _params(ts)))
    assert runs[0][0] == runs[1][0]
    _close(runs[1][1], runs[0][1], atol=0.0)


def test_refused_layout_runs_deferred_and_uncaptured():
    """A ``DistributedDataParallel`` wrapper (DDP flags with
    ``fused_optimizer=False``, over a gloo group of two), once refused, now
    captures: no refusal on the facade, the window deferred and every
    program built to capture (the bare module, the grads all-reduced by
    the update), and the result that of ``fuse_eager_step=False``."""
    from test_torch_dist_workers import refused_layout_worker

    got = run_ranks(refused_layout_worker, 2, batches=sr_batches(2))
    for r in got:
        assert r["refusal"] is None and r["ddp"]
        assert r["pending_after_backward"] == 1 and r["captured"]
        assert r["kinds"] == ["window"]
        assert r["losses"][True] == r["losses"][False]
        assert r["equal"]


@pytest.mark.parametrize("layout", [dict(oss=False, sddp=False), dict(oss=True, sddp=True)],
                         ids=["ddp-fused", "zero2-per-leaf"])
def test_unfused_equals_fused_bitwise(layout):
    """``fuse_eager_step=False`` (the split path's three programs) against
    the window's one program, on the driver's facade: the same operations
    in the same order, so the same bits."""
    runs = []
    for fuse in (True, False):
        s = facade(toy_swinir(), **layout, fuse_eager_step=fuse)
        losses = []
        for x, y in sr_batches(3):
            for i in range(2):
                loss = s.loss(s.model(x[4 * i:4 * i + 4]), y[4 * i:4 * i + 4])
                s.backward(loss)
                s.step()
                losses.append(loss)
        runs.append(([float(v) for v in losses], _params(s), float(s._ema), _kinds(s)))
    assert runs[0][3] == {"window"} and runs[1][3] == {"first", "acc", "apply"}
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]
    _close(runs[1][1], runs[0][1], atol=0.0)


def test_driver_loop_at_accum2_takes_the_split_path_as_jax_does():
    """The driver's loop reads each loss right after ``.step()``: at the
    first micro-batch of a window that read flushes it through the split
    path, in both packages (JAX's ``_step_fused`` never runs), with the
    same losses."""
    batches = [_batch(seed=s) for s in range(4)]
    js, ts = _pair(True, accum=2)
    fused_calls = []
    run_fused = js._step_fused
    js._step_fused = lambda: (fused_calls.append(1), run_fused())[1]
    jl, tl = _run_loop(js, 8, batches), _run_loop(ts, 8, batches)
    assert fused_calls == [] and _kinds(ts) == {"first", "acc", "apply"}
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(_params(ts), _jax_params(js), atol=1e-6)


def test_zero_grad_then_step_keeps_the_dropped_window_out():
    """A window dropped by ``zero_grad`` never reaches the update: the next
    window's step equals a fresh facade's first step."""
    x, y = _batch()
    x2, y2 = _batch(seed=1)
    js = _jax(True)
    a, b = _torch(True, js), _torch(True, js)
    a.backward(a.loss(a.model(x), y))
    a.zero_grad()
    for s in (a, b):
        s.backward(s.loss(s.model(x2), y2))
        s.step()
    _close(_params(a), _params(b), atol=0.0)
