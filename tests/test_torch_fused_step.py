"""``Stoke.fused_step`` and the loss scaler inside ``TrainStep``, against the
facade's Stoke-style path and the JAX package.

``fused_step(inputs, targets)`` runs one ``TrainStep`` over the facade's
model, loss, optimizer, policy, accumulation, clip and scaler (on the card
a captured CUDA graph; on the CPU the same runner calls the step). Facades
are built as ``drivers/stoke_ddp.py`` builds them (toy SwinIR,
``feat_loss``, AdamW betas (0.9, 0.99), clip 0.1, accum 2), on the DDP
layout (``FusedAdamW``) and the driver's OSS + SDDP layout (the per-leaf
chain). Torch runs at one thread.

Tolerances: in f32 the Stoke-style path (two micro-batches of 4, each loss
halved before its backward) and ``fused_step`` (the batch of 8 split in
two, the summed gradient halved) round alike, held at 1e-6 as JAX's
``test_fused_step_matches_eager_path`` holds its; under fp16 autocast
(``amp``) at 2e-5 (the loss scale meets the halving in another order).
Against the JAX facade's ``fused_step``: losses within 1e-5 relative,
parameters within 1e-5 absolute but the key third of each ``qkv.bias``
(5e-5; ``tests/test_torch_stoke.py`` says why). The in-step scaler against
JAX's ``DynamicLossScaler`` inside JAX's ``TrainStep``: the scale and the
growth count exactly, a skipped update bitwise, parameters as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu import precision as jprecision
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.observe import numerics as jnumerics
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import optim as toptim
from pytorch_distributedtraining_tpu_torch import parallel as tparallel
from pytorch_distributedtraining_tpu_torch import precision as tprecision
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.interop import swinir_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.observe import numerics as tnumerics
from test_torch_dist_workers import (TOY, facade, facade_modes_worker, full_params, mse_loss_fn,
                                     run_ranks, sr_batches, toy_swinir)

torch.set_num_threads(1)

KEY_BIAS_ATOL = 5e-5
LAYOUTS = {"ddp-fused": dict(oss=False, sddp=False), "zero2-per-leaf": dict(oss=True, sddp=True)}


def _params(s) -> dict:
    return {n: p.detach().clone() for n, p in s.model_access.named_parameters()}


def _stoke_style(s, x, y) -> None:
    for i in range(2):
        s.backward(s.loss(s.model(x[4 * i:4 * i + 4]), y[4 * i:4 * i + 4]))
        s.step()


def _close(got: dict, want: dict, atol: float, key_atol: float | None = None) -> None:
    for name, g in got.items():
        g, w = np.asarray(g, np.float32), np.asarray(want[name], np.float32)
        if key_atol is not None and name.endswith("qkv.bias"):
            c = g.shape[0] // 3
            np.testing.assert_allclose(g[c:2 * c], w[c:2 * c], atol=key_atol, err_msg=name)
            g, w = np.concatenate([g[:c], g[2 * c:]]), np.concatenate([w[:c], w[2 * c:]])
        np.testing.assert_allclose(g, w, atol=atol, err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_step_matches_the_stoke_style_path(layout):
    eager, fused = facade(toy_swinir(), **LAYOUTS[layout]), facade(toy_swinir(), **LAYOUTS[layout])
    assert isinstance(fused._opt, toptim.FusedAdamW) == (layout == "ddp-fused")
    for i, (x, y) in enumerate(sr_batches(3)):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        eager.optimizer.lr = fused.optimizer.lr = 1e-3 / (i + 1)
        _stoke_style(eager, x, y)
        metrics = fused.fused_step(x, y)
        assert set(metrics) == {"loss", "grad_norm"} and metrics["loss"].dim() == 0
    assert eager.step_count == fused.step_count == 3
    _close(_params(fused), _params(eager), atol=1e-6)
    np.testing.assert_allclose(float(fused._last_loss), float(metrics["loss"]))
    assert all(p.grad is None or not p.grad.any() for p in fused.model_access.parameters())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_and_stoke_style_steps_mix(layout):
    """Shared state: fused, Stoke-style, fused, each step on the state the
    other left, equals three Stoke-style steps."""
    eager, mixed = facade(toy_swinir(), **LAYOUTS[layout]), facade(toy_swinir(), **LAYOUTS[layout])
    for i, (x, y) in enumerate(sr_batches(3)):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        _stoke_style(eager, x, y)
        if i == 1:
            _stoke_style(mixed, x, y)
        else:
            mixed.fused_step(x, y)
    assert mixed.step_count == 3
    _close(_params(mixed), _params(eager), atol=1e-6)


def test_fused_step_amp_overflow_skips_like_the_stoke_style_path():
    """fp16 autocast with the scaler: a non-finite loss at step 1 skips the
    update and halves the scale on the device, as the Stoke-style path
    does, and the steps around it train alike."""
    poison = {"on": False}

    def loss(out, tgt):
        loss = torch.mean(torch.abs(out - tgt))
        return loss * float("inf") if poison["on"] else loss

    runs = []
    for fused in (False, True):
        s = tstoke.Stoke(
            model=toy_swinir(), optimizer=tstoke.StokeOptimizer("AdamW", {"lr": 1e-3}),
            loss=loss, batch_size_per_device=4, fp16="amp", grad_accum_steps=2,
            configs=[tstoke.AMPConfig(init_scale=2.0**14)],
            grad_clip=tstoke.ClipGradNormConfig(max_norm=0.1), device="cpu")
        scales, before = [], None
        for i, (x, y) in enumerate(sr_batches(3)):
            x, y = torch.from_numpy(x), torch.from_numpy(y)
            poison["on"] = i == 1
            before = _params(s)
            s.fused_step(x, y) if fused else _stoke_style(s, x, y)
            scales.append(float(s.loss_scaler.scale))
            if i == 1:
                for n, p in _params(s).items():
                    assert torch.equal(p, before[n]), n
        runs.append((scales, _params(s)))
    assert runs[0][0] == runs[1][0] == [2.0**14, 2.0**13, 2.0**13]
    _close(runs[1][1], runs[0][1], atol=2e-5)


def _jax_facade(layout):
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    flags = LAYOUTS[layout]
    return jstoke.Stoke(
        model=JaxSwinIR(**TOY),
        optimizer=jstoke.StokeOptimizer(optimizer="AdamW", optimizer_kwargs={
            "lr": 1e-3, "betas": (0.9, 0.99), "eps": 1e-8, "weight_decay": 1e-4}),
        loss=jlosses.FeatLoss(), batch_size_per_device=8, gpu=True, distributed="ddp",
        fairscale_oss=flags["oss"], fairscale_sddp=flags["sddp"], grad_accum_steps=2,
        configs=[jstoke.AMPConfig(init_scale=2.0**14), jstoke.DDPConfig(local_rank=None),
                 jstoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=jstoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0), mesh=mesh,
        sample_input=np.zeros((8, 8, 8, 3), np.float32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_step_matches_jax_fused_step(layout):
    js = _jax_facade(layout)
    p0 = jax.device_get(js.state.params)
    ts = facade(SwinIR(**TOY), **LAYOUTS[layout])
    ts.load_model_state(swinir_state_dict_from_jax(p0, img_size=TOY["img_size"]))
    for i, (x, y) in enumerate(sr_batches(3)):
        js.optimizer.lr = ts.optimizer.lr = 1e-3 / (i + 1)
        jm = js.fused_step(x, y)
        tm = ts.fused_step(x, y)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert ts.step_count == js.step_count == 3
    want = swinir_state_dict_from_jax(jax.device_get(js.state.params), img_size=TOY["img_size"])
    _close({n: p.numpy() for n, p in _params(ts).items()},
           {n: want[n].numpy() for n in _params(ts)}, atol=1e-5, key_atol=KEY_BIAS_ATOL)


SCALER = dict(init_scale=2.0**14, growth_factor=2.0, backoff_factor=0.5, growth_interval=2)


def _jax_scaled_run(opt: str, batches: list) -> tuple:
    mesh = make_mesh(MeshSpec.ddp(1), devices=jax.devices()[:1])
    model = JaxSwinIR(**TOY)
    kw = dict(lr=1e-3, clip_grad_norm=0.1)
    tx = joptim.FusedAdamW(**kw) if opt == "fused" else joptim.adamw(**kw)
    scaler = jprecision.DynamicLossScaler(**SCALER)
    state, sh = jparallel.create_train_state(
        model=model, sample_input=jnp.zeros((1, 8, 8, 3)), tx=tx, mesh=mesh,
        policy=jparallel.DDP(), scaler_state=scaler.init())

    def loss_fn(params, batch, rng, model_state):
        return jnp.mean((model.apply({"params": params}, batch[0]) - batch[1]) ** 2), {}

    step = jparallel.TrainStep(loss_fn, tx, mesh, jparallel.DDP(), grad_accum_steps=2,
                               loss_scaler=scaler, state_shardings=sh, donate=False,
                               numerics=jnumerics.NumericsProbe(inject="conv_first@1"))
    scales, counts, params = [], [], []
    for batch in batches:
        state, m = step(state, batch)
        scales.append(float(m["loss_scale"]))
        counts.append(int(state.scaler.growth_count))
        params.append(jax.device_get(state.params))
    return scales, counts, params


@pytest.mark.parametrize("opt", ["fused", "adamw"])
def test_in_step_loss_scaler_matches_jax_across_a_forced_overflow(opt):
    """A NaN poisoned into ``conv_first``'s gradient at step 1: the update
    is skipped and the scale halved on the device; two clean steps later it
    grows back (growth interval 2). Scale and growth count equal JAX's at
    every step; the skipped step leaves the parameters bitwise."""
    batches = sr_batches(5)
    p0 = jax.device_get(JaxSwinIR(**TOY).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8, 8, 3)))["params"])
    jscales, jcounts, jparams = _jax_scaled_run(opt, batches)
    model = toy_swinir({k: v.numpy() for k, v in
                        swinir_state_dict_from_jax(p0, img_size=TOY["img_size"]).items()})
    kw = dict(lr=1e-3, clip_grad_norm=0.1)
    tx = (toptim.FusedAdamW(model.named_parameters(), **kw) if opt == "fused"
          else toptim.adamw(model.named_parameters(), **kw))
    scaler = tprecision.DynamicLossScaler(**SCALER)
    step = tparallel.TrainStep(model, mse_loss_fn, tx, grad_accum_steps=2, loss_scaler=scaler,
                               numerics=tnumerics.NumericsProbe(inject="conv_first@1"))
    scales, counts, params = [], [], []
    for batch in batches:
        m = step(tuple(map(torch.from_numpy, batch)))
        scales.append(float(m["loss_scale"]))
        counts.append(int(scaler.growth_count))
        params.append(full_params(model))
    assert scales == jscales == [2.0**14, 2.0**13, 2.0**13, 2.0**14, 2.0**14]
    assert counts == jcounts == [1, 0, 1, 0, 1]
    assert (int(tx.state.count) if opt == "fused" else tx.count) == 4
    for name in params[0]:
        np.testing.assert_array_equal(params[1][name], params[0][name], err_msg=name)
    want = {k: v.numpy() for k, v in
            swinir_state_dict_from_jax(jparams[-1], img_size=TOY["img_size"]).items()}
    _close(params[-1], want, atol=1e-5, key_atol=KEY_BIAS_ATOL)


def test_fused_step_decodes_numerics_and_polls_the_capture(monkeypatch):
    """As :meth:`Stoke.step`: the probe's aux of each step decoded (the
    poisoned step 1 blamed by name), the ``halt`` trip after two
    non-finite steps raised out of ``fused_step``, and the armed capture
    polled once a step."""
    for var in ("GRAFT_NUMERICS", "GRAFT_NUMERICS_INJECT", "GRAFT_NUMERICS_ACTION"):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    monkeypatch.setenv("GRAFT_NUMERICS", "1")
    monkeypatch.setenv("GRAFT_NUMERICS_INJECT", "conv_first@1")
    s = facade(toy_swinir(), oss=False, sddp=False)
    polls = []
    s.capture = type("Capture", (), {"note_step": lambda self: polls.append(s.step_count)})()
    batches = [tuple(map(torch.from_numpy, b)) for b in sr_batches(3)]
    s.fused_step(*batches[0])
    assert s.numerics_summary["nonfinite"] is False and polls == [1]
    s.fused_step(*batches[1])
    assert s.numerics_summary["blame"] == {"leaf": "conv_first.weight", "layer": 0, "step": 2}
    with pytest.raises(tnumerics.NumericsDivergence, match="2 consecutive non-finite steps"):
        s.fused_step(*batches[2])
    assert polls == [1, 2]


def test_fused_step_refuses_zero3():
    """ZeRO-3 (``fairscale_fsdp``: FSDP2 in a gloo group of one) is no
    longer refused: its ``fused_step`` runs the program the card captures
    and follows the JAX facade's ``fused_step`` under ZeRO-3, at this
    file's tolerances."""
    flags = dict(fsdp=True)
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    js = jstoke.Stoke(
        model=JaxSwinIR(**TOY),
        optimizer=jstoke.StokeOptimizer(optimizer="AdamW", optimizer_kwargs={
            "lr": 1e-3, "betas": (0.9, 0.99), "eps": 1e-8, "weight_decay": 1e-4}),
        loss=jlosses.FeatLoss(), batch_size_per_device=8, gpu=True, distributed="ddp",
        fairscale_oss=True, fairscale_sddp=True, fairscale_fsdp=True, grad_accum_steps=2,
        configs=[jstoke.AMPConfig(init_scale=2.0**14), jstoke.DDPConfig(local_rank=None),
                 jstoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=jstoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0), mesh=mesh,
        sample_input=np.zeros((8, 8, 8, 3), np.float32))
    state = {k: v.numpy() for k, v in swinir_state_dict_from_jax(
        jax.device_get(js.state.params), img_size=TOY["img_size"]).items()}
    micro = [(x[4 * i:4 * i + 4], y[4 * i:4 * i + 4]) for x, y in sr_batches(3) for i in range(2)]
    lrs = [1e-3 / (i + 1) for i in range(3)]
    got = run_ranks(facade_modes_worker, 1, micro=micro, lrs=lrs, state=state,
                    layouts={"fsdp": flags}, modes=("fused",))[0]["fsdp/fused"]
    assert got["refusal"] is None and got["capture"]
    want = []
    for i, (x, y) in enumerate(sr_batches(3)):
        js.optimizer.lr = lrs[i]
        want.append(float(js.fused_step(x, y)["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    wparams = swinir_state_dict_from_jax(jax.device_get(js.state.params), img_size=TOY["img_size"])
    _close(got["params"], {n: wparams[n].numpy() for n in got["params"]}, atol=1e-5,
           key_atol=KEY_BIAS_ATOL)
