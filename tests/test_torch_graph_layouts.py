"""Every training and eval program of the port on the layouts a captured
graph used to refuse, against the JAX package's programs.

On the card these programs are captured CUDA graphs (``parallel.graph.
StepGraph``); on the CPU the same runner calls each program's function,
so these tests hold the code the card captures. Over two gloo ranks,
from the toy SwinIR's JAX seed-0 weights:

- ``MultiStep`` (K = 4, two windows, MSE, per-leaf AdamW, clip 0.1,
  ``grad_accum_steps=2``) over a ZeRO-3 state (FSDP2) and over a DDP
  state (a ``DistributedDataParallel`` model, whose program runs the bare
  module and all-reduces the grads itself) against JAX's ``MultiStep``
  under ``ZeRO3`` and ``DDP``: losses within 1e-5 relative, parameters
  within 2e-5 relative and 2e-6 absolute, as ``tests/test_torch_multi_
  step.py`` holds its own (the gradient-free key third of each
  ``qkv.bias`` at 5e-5, ``KEY_BIAS_ATOL``);
- the driver's facade (``feat_loss``, AdamW, clip 0.1, accum 2) under
  ``fairscale_fsdp`` and under plain DDP with the per-leaf chain
  (``fused_optimizer=False``), three optimizer steps through the window
  program, the split path and ``fused_step``, against the JAX facade's
  window, split path and ``fused_step`` at two devices: losses within
  1e-5 relative, parameters within 1e-5 absolute (the key bias third at
  5e-5), ``tests/test_torch_stoke.py``'s two-step bounds;
- in one process, the early-read and eval programs (a handle read alone,
  a loss read before ``.backward()``, eval-mode ``.model`` and
  ``eval_step`` over a full and a partial batch) against JAX's
  ``_jit_fwd``/``_jit_loss`` and its ``eval_step`` on the same weights,
  within 1e-6 (relative; outputs of the largest magnitude), each a
  program of its own per input signature.

Torch runs at one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from test_torch_dist_step import close_params, numpy_state
from test_torch_dist_workers import (FACADE_OPT, TOY, facade, facade_modes_worker, run_ranks,
                                     sr_batches, toy_swinir, windows)

torch.set_num_threads(1)

K = 4
WORLD = 2
BATCH = 8  # a global micro-batch
LRS = [1e-3, 5e-4, 1e-3]
KEY_BIAS_ATOL = 5e-5
OPT = dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4, clip_grad_norm=0.1)
LAYOUTS = {"fsdp": dict(fsdp=True), "ddp": dict(oss=False, sddp=False, fused_optimizer=False)}
MODES = ("window", "split", "fused")
MULTI = {"zero3": jparallel.ZeRO3, "ddp": jparallel.DDP}


def _micro(n: int = 6) -> list:
    ds = SyntheticSRDataset(n=n * BATCH, lr_size=8)
    items = [ds[i] for i in range(len(ds))]
    return [tuple(np.stack([it[k] for it in items[j:j + BATCH]]) for k in (0, 1))
            for j in range(0, len(items), BATCH)]


def _p0():
    return jax.device_get(JaxSwinIR(**TOY).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8, 8, 3)))["params"])


@pytest.fixture(scope="module")
def port_runs():
    """One launch of two gloo ranks: every facade layout and mode, and
    ``MultiStep`` under both policies."""
    state = numpy_state(_p0(), TOY)
    multi = dict(runs=[dict(policy=p) for p in MULTI], batches=sr_batches(2 * K), state=state,
                 k=K)
    ranks = run_ranks(facade_modes_worker, WORLD, micro=_micro(), lrs=LRS, state=state,
                      layouts=LAYOUTS, modes=MODES, multi=multi)
    return ranks


def _close_multi(got: dict, want: dict) -> None:
    for name, g in got.items():
        w = want[name]
        if name.endswith("qkv.bias"):
            c = g.shape[0] // 3
            np.testing.assert_allclose(g[c:2 * c], w[c:2 * c], atol=KEY_BIAS_ATOL, err_msg=name)
            g, w = np.concatenate([g[:c], g[2 * c:]]), np.concatenate([w[:c], w[2 * c:]])
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6, err_msg=name)


def _jax_multi(policy: str, batches: list) -> tuple:
    pol = MULTI[policy]()
    spec = MeshSpec.zero(WORLD) if policy == "zero3" else MeshSpec.ddp(WORLD)
    mesh = make_mesh(spec, devices=jax.devices()[:WORLD])
    model = JaxSwinIR(**TOY)
    tx = joptim.adamw(**OPT)
    state, shardings = jparallel.create_train_state(
        model=model, sample_input=jnp.zeros((1, 8, 8, 3)), tx=tx, mesh=mesh, policy=pol)

    def loss_fn(params, batch, rng, model_state):
        return jnp.mean((model.apply({"params": params}, batch[0]) - batch[1]) ** 2), {}

    step = jparallel.TrainStep(loss_fn, tx, mesh, pol, grad_accum_steps=2,
                               state_shardings=shardings, donate=False)
    multi = jparallel.MultiStep(step, k=K)
    losses = []
    for xs, ys in windows(batches, K):
        state, m = multi(state, (xs, ys))
        losses += np.asarray(m["loss"]).tolist()
    return losses, int(state.step), numpy_state(jax.device_get(state.params), TOY)


@pytest.mark.parametrize("policy", list(MULTI))
def test_multi_step_over_zero3_and_ddp_matches_jax_multi_step(policy, port_runs):
    """``MultiStep`` accepts both layouts (``refuse_capture`` no longer
    refuses them) and its windows follow JAX's."""
    want_losses, want_step, want_params = _jax_multi(policy, sr_batches(2 * K))
    i = list(MULTI).index(policy)
    for rank in port_runs:
        got = rank["multi"][i]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        assert got["step"] == want_step == 2 * K
        _close_multi(got["params"], want_params)
    start = numpy_state(_p0(), TOY)
    assert max(np.abs(p - start[n]).max() for n, p in port_runs[0]["multi"][i]["params"].items()
               ) > 1e-4


def _jax_facade(layout: str):
    flags = LAYOUTS[layout]
    fsdp = bool(flags.get("fsdp"))
    spec = MeshSpec.zero(WORLD) if fsdp else MeshSpec.ddp(WORLD)
    return jstoke.Stoke(
        model=JaxSwinIR(**TOY), optimizer=jstoke.StokeOptimizer("AdamW", dict(FACADE_OPT)),
        loss=jlosses.FeatLoss(), batch_size_per_device=BATCH // WORLD, gpu=True,
        distributed="ddp", fairscale_oss=flags.get("oss", True),
        fairscale_sddp=flags.get("sddp", True), fairscale_fsdp=fsdp, grad_accum_steps=2,
        fused_optimizer=flags.get("fused_optimizer"),
        configs=[jstoke.AMPConfig(init_scale=2.0**14), jstoke.DDPConfig(local_rank=None),
                 jstoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=jstoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0),
        mesh=make_mesh(spec, devices=jax.devices()[:WORLD]),
        sample_input=np.zeros((BATCH, 8, 8, 3), np.float32))


def _jax_run(layout: str, mode: str, micro: list) -> tuple:
    js = _jax_facade(layout)
    losses = []
    if mode == "fused":
        for j in range(0, len(micro), 2):
            js.optimizer.lr = LRS[j // 2]
            x, y = (np.concatenate([m[k] for m in micro[j:j + 2]]) for k in (0, 1))
            losses.append(float(js.fused_step(x, y)["loss"]))
    else:
        for i, (x, y) in enumerate(micro):
            js.optimizer.lr = LRS[i // 2]
            loss = js.loss(js.model(x), y)
            js.backward(loss)
            js.step()
            losses.append(float(np.asarray(loss)) if mode == "split" else loss)
        losses = [float(np.asarray(v)) for v in losses]
    return losses, numpy_state(jax.device_get(js.state.params), TOY)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_facade_programs_on_fsdp_and_ddp_match_the_jax_facade(layout, mode, port_runs):
    """The window program, the split path and ``fused_step`` under ZeRO-3
    and a ``DistributedDataParallel`` model: no refusal, every program
    built to capture, and JAX's trajectory at two ranks; the cold programs
    run between the window's steps (FSDP2 reshards after each) leave it
    as it is."""
    want_losses, want_params = _jax_run(layout, mode, _micro())
    r0, r1 = (rank[f"{layout}/{mode}"] for rank in port_runs)
    assert r0["refusal"] is None and r0["capture"]
    kinds = {"window": sorted(["window", "forward", "eval_forward", str(("eval", ()))]),
             "split": ["acc", "apply", "first"], "fused": []}[mode]
    assert r0["kinds"] == kinds
    np.testing.assert_allclose(r0["losses"], want_losses, rtol=1e-5)
    np.testing.assert_allclose(r1["losses"], r0["losses"], rtol=0)
    close_params(r0["params"], want_params)
    for name, got in r1["params"].items():  # the ranks agree bitwise
        np.testing.assert_array_equal(got, r0["params"][name], err_msg=name)


def _cold_pair():
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    js = jstoke.Stoke(
        model=JaxSwinIR(**TOY), optimizer=jstoke.StokeOptimizer("AdamW", dict(FACADE_OPT)),
        loss=jlosses.FeatLoss(), batch_size_per_device=BATCH, gpu=True, distributed="ddp",
        fairscale_oss=True, fairscale_sddp=True, grad_accum_steps=2,
        configs=[jstoke.AMPConfig(init_scale=2.0**14), jstoke.DDPConfig(local_rank=None),
                 jstoke.FairscaleOSSConfig(broadcast_fp16=True)],
        grad_clip=jstoke.ClipGradNormConfig(max_norm=0.1, norm_type=2.0), mesh=mesh,
        sample_input=np.zeros((BATCH, 8, 8, 3), np.float32))
    ts = facade(toy_swinir(numpy_state(jax.device_get(js.state.params), TOY)), batch=BATCH)
    return js, ts


def _close_output(got, want) -> None:
    """Within 1e-6 of the output's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_early_read_and_eval_programs_match_jit_fwd_and_jit_loss():
    """A handle read alone runs the forward program, a loss read before
    ``.backward()`` the loss program, eval-mode ``.model`` its own and
    ``eval_step`` one a signature (a partial last batch is one more):
    each against JAX's ``_jit_fwd``/``_jit_loss``/``eval_step`` on the same
    weights within 1e-6, and none moves a parameter."""
    js, ts = _cold_pair()
    x, y = _micro(1)[0]
    st = js.state
    rng = jax.random.fold_in(st.rng, st.step)
    want_out, _ = js._jit_fwd(st.params, st.model_state, x, rng, train=True)
    want_loss = float(js._jit_loss(want_out, y))
    before = {n: p.detach().clone() for n, p in ts.model_access.named_parameters()}

    out = ts.model(torch.from_numpy(x))
    _close_output(out.detach().numpy(), want_out)
    loss = ts.loss(ts.model(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    assert float(ts._last_loss) == float(loss)

    ts.model_access.eval()
    want_eval, _ = js._jit_fwd(st.params, st.model_state, x, rng, train=False)
    _close_output(ts.model(torch.from_numpy(x)).numpy(), want_eval)
    ts.model_access.train()
    jstep, tstep = js.eval_step(), ts.eval_step()
    for rows in (slice(None), slice(0, 5)):
        want = jstep(x[rows], y[rows])
        got = tstep(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    assert ts.model_access.training
    kinds = [k for k, _ in ts._graphs]
    assert sorted(map(str, kinds)) == sorted(map(str, ["forward", "loss", "eval_forward",
                                                       ("eval", ()), ("eval", ())]))
    assert all(g.capture for g in ts._graphs.values()) and ts.graph_refusal is None
    for n, p in ts.model_access.named_parameters():
        assert torch.equal(p, before[n]), n
