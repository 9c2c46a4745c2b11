"""``parallel.MultiStep``, ``tune_multi_step_k`` and ``data.stack_windows``
against the JAX package's, with the pieces a captured step reads from the
device: the optimizers' count and lr factor, the dropout key's step, the
probe's injection and its decode of a k-stacked aux.

On the CPU ``MultiStep`` runs its K steps through the same runner as on
the card, without a capture; the card's replay is held against the eager
step in ``tests/test_torch_multi_step_cuda.py`` and ``chip_smoke.py``
phase 19.

Tolerances: the toy SwinIR of ``tests/test_torch_dist_step.py`` (weights
from JAX seed 0) takes two windows of K = 4 steps of MSE (clip 0.1,
``grad_accum_steps=2``) in both packages, as JAX's ``tests/
test_multi_step.py`` does: losses ``[K]`` within 1e-5 relative and
parameters within 2e-5 relative and 2e-6 absolute (JAX's own bounds for
its ``MultiStep`` against its sequential step), but the key third of each
``qkv.bias``, which has no gradient and which Adam moves by each side's
rounding noise alone: 5e-5 absolute (``test_torch_dist_step.py``'s
``KEY_BIAS_ATOL``). The port's ``MultiStep`` against its own sequential
step is bitwise: the same code in the same order. Torch runs at one
thread (at eight under the suite's parallel workers the facade tests ran
far slower).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu.data import stack_windows as jax_stack_windows
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.observe import numerics as jnumerics
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import optim as toptim
from pytorch_distributedtraining_tpu_torch import parallel as tparallel
from pytorch_distributedtraining_tpu_torch.data import (DataLoader, SyntheticSRDataset,
                                                        stack_windows)
from pytorch_distributedtraining_tpu_torch.interop import swinir_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributedtraining_tpu_torch.observe import numerics as tnumerics
from pytorch_distributedtraining_tpu_torch.parallel.rng import DropoutKey
from test_torch_dist_workers import (TOY, full_params, graph_vs_eager_worker, mse_loss_fn,
                                     multi_step_worker, run_ranks, sr_batches, toy_swinir,
                                     windows)

torch.set_num_threads(1)

K = 4
KEY_BIAS_ATOL = 5e-5
OPT = dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4, clip_grad_norm=0.1)
JAX_POLICIES = {"none": jparallel.DDP, "ddp": jparallel.DDP, "zero2": jparallel.ZeRO2}


def _jax_step(policy: str, world: int, accum: int = 2, numerics=None, opt: str = "adamw"):
    pol = JAX_POLICIES[policy]()
    spec = MeshSpec.zero(world) if policy.startswith("zero") else MeshSpec.ddp(world)
    mesh = make_mesh(spec, devices=jax.devices()[:world])
    model = JaxSwinIR(**TOY)
    tx = joptim.FusedAdamW(**OPT) if opt == "fused" else joptim.adamw(**OPT)
    state, shardings = jparallel.create_train_state(
        model=model, sample_input=jnp.zeros((1, 8, 8, 3)), tx=tx, mesh=mesh, policy=pol)

    def loss_fn(params, batch, rng, model_state):
        return jnp.mean((model.apply({"params": params}, batch[0]) - batch[1]) ** 2), {}

    step = jparallel.TrainStep(loss_fn, tx, mesh, pol, grad_accum_steps=accum,
                               state_shardings=shardings, donate=False, numerics=numerics)
    return state, step


def _numpy_params(params) -> dict:
    return {k: v.numpy() for k, v in
            swinir_state_dict_from_jax(jax.device_get(params), img_size=TOY["img_size"]).items()}


def _close_params(got: dict, want: dict) -> None:
    for name, g in got.items():
        w = want[name]
        if name.endswith("qkv.bias"):
            c = g.shape[0] // 3
            np.testing.assert_allclose(g[c:2 * c], w[c:2 * c], atol=KEY_BIAS_ATOL, err_msg=name)
            g, w = np.concatenate([g[:c], g[2 * c:]]), np.concatenate([w[:c], w[2 * c:]])
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_start():
    state, _ = _jax_step("none", 1)
    return _numpy_params(state.params)


def _jax_multi(policy: str, opt: str, world: int, batches: list) -> tuple:
    state, step = _jax_step(policy, world, opt=opt)
    multi = jparallel.MultiStep(step, k=K)
    losses = []
    for xs, ys in windows(batches, K):
        state, m = multi(state, (xs, ys))
        assert m["loss"].shape == (K,)
        losses += np.asarray(m["loss"]).tolist()
    return losses, int(state.step), _numpy_params(state.params)


@pytest.mark.parametrize("policy,opt,world", [("none", "adamw", 1), ("ddp", "fused", 2),
                                               ("zero2", "adamw", 2)],
                         ids=["one-process", "ddp-world2", "zero2-world2"])
def test_multi_step_matches_jax_multi_step(policy, opt, world, jax_start):
    """DDP with ``FusedAdamW`` (one all-reduce of the flat gradient; a
    ``DistributedDataParallel`` wrapper, the per-leaf layout, cannot be
    captured), ZeRO-2 with the per-leaf chain."""
    batches = sr_batches(2 * K)
    want_losses, want_step, want_params = _jax_multi(policy, opt, world, batches)
    run = [dict(policy=policy, opt=opt)]
    if world == 1:
        got = [multi_step_worker(0, 1, runs=run, batches=batches, state=jax_start, k=K)]
    else:
        got = run_ranks(multi_step_worker, world, runs=run, batches=batches, state=jax_start,
                        k=K)
    for rank in got:
        np.testing.assert_allclose(rank[0]["losses"], want_losses, rtol=1e-5)
        assert rank[0]["step"] == want_step == 2 * K
        _close_params(rank[0]["params"], want_params)
    moved = max(np.abs(p - jax_start[n]).max() for n, p in got[0][0]["params"].items())
    assert moved > 1e-4


def _port_step(accum: int = 2, numerics=None, rng=None, model=None, loss_fn=mse_loss_fn):
    model = toy_swinir() if model is None else model
    tx = toptim.adamw(model.named_parameters(), **OPT)
    return model, tparallel.TrainStep(model, loss_fn, tx, grad_accum_steps=accum,
                                      numerics=numerics, rng=rng)


def _torch_window(w):
    return tuple(torch.from_numpy(a) for a in w)


@pytest.mark.parametrize("accum", [1, 2])
def test_window_equals_k_sequential_steps_bitwise(accum):
    """Accumulation inside each of the K steps, the stacked metrics, the
    host step count and the state: the K steps of a window are the
    sequential steps, bit for bit."""
    batches = sr_batches(K)
    model_a, seq = _port_step(accum)
    seq_losses = [float(seq(_torch_window(b))["loss"]) for b in batches]
    model_b, step = _port_step(accum)
    metrics = tparallel.MultiStep(step, K)(_torch_window(windows(batches, K)[0]))
    assert metrics["loss"].shape == metrics["grad_norm"].shape == (K,)
    assert metrics["loss"].tolist() == seq_losses
    assert step.rng.step == seq.rng.step == K and int(step.step_t) == K
    for (name, a), b in zip(model_a.named_parameters(), model_b.parameters()):
        assert torch.equal(a, b), name
    assert step.tx.count == seq.tx.count == K


def test_window_mismatch_raises():
    _, step = _port_step()
    multi = tparallel.MultiStep(step, K)
    xs, ys = windows(sr_batches(K), K)[0]
    with pytest.raises(ValueError, match="window"):
        multi((torch.from_numpy(xs[:K - 1]), torch.from_numpy(ys[:K - 1])))
    with pytest.raises(ValueError, match=">= 1"):
        tparallel.MultiStep(step, 0)


def test_stack_windows_over_host_batches_equals_jax():
    batches = sr_batches(2 * K + 1)  # the odd tail is dropped
    got = list(stack_windows(batches, K))
    want = list(jax_stack_windows(batches, K))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0].shape == (K, 8, 8, 8, 3)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match=">= 1"):
        stack_windows(batches, 0)


def test_feed_stacks_device_iter_windows_into_multi_step():
    """``MultiStep.feed``: the loader's device prefetch (a pass-through on
    the CPU) into ``stack_windows``, whose stacks train the window as the
    loader's batches train sequential steps."""
    ds = SyntheticSRDataset(n=2 * K * 4 + 4, lr_size=8)
    loader = DataLoader(ds, batch_size=4, device="cpu")
    _, step = _port_step()
    multi = tparallel.MultiStep(step, K)
    got = []
    for stacked in multi.feed(loader):
        assert stacked[0].shape == (K, 4, 8, 8, 3) and isinstance(stacked[0], torch.Tensor)
        got += multi(stacked)["loss"].tolist()
    assert len(got) == 2 * K and step.rng.step == 2 * K
    _, seq = _port_step()  # the loader's NHWC views stacked contiguous: the same layout
    want = [float(seq(tuple(t.contiguous() for t in b))["loss"])
            for b in DataLoader(ds, batch_size=4, device="cpu")]
    assert got == want[:2 * K]
    stacks = list(stack_windows(loader.device_iter(depth=2), 2))
    assert len(stacks) == K and stacks[0][1].shape == (2, 4, 16, 16, 3)


def _jax_tune(numerics=None):
    state, step = _jax_step("none", 1, accum=1, numerics=numerics)
    xs, ys = sr_batches(1)[0]
    return jparallel.tune_multi_step_k(step, state, (xs, ys), ks=(1, 2), steps_per_arm=4)


def test_tune_multi_step_k_returns_what_jax_returns(jax_start):
    best_k, rates, jstate = _jax_tune()
    model, step = _port_step(accum=1)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_start.items()}, strict=False)
    xs, ys = sr_batches(1)[0]
    got_k, got_rates, state = tparallel.tune_multi_step_k(
        step, (torch.from_numpy(xs), torch.from_numpy(ys)), ks=(1, 2), steps_per_arm=4)
    assert set(got_rates) == set(rates) == {1, 2}
    assert all(r > 0 and np.isfinite(r) for r in got_rates.values())
    assert got_k in (1, 2) and got_rates[got_k] == max(got_rates.values())
    assert state["step"] == int(jstate.step) == 4 + 1 + 4 + 2  # per arm: warm + timed calls
    _close_params(full_params(model), _numpy_params(jstate.params))
    assert torch.isfinite(step((torch.from_numpy(xs), torch.from_numpy(ys)))["loss"])


def test_tune_raises_with_the_pre_arm_state_after_an_injected_nan(jax_start):
    """A NaN poisoned into ``conv_first``'s gradient at step 6, inside the
    k=2 arm, makes the arm's last loss non-finite: both packages raise with
    the state from before that arm (step 5), and the port's snapshot
    restores a trainable state."""
    spec = "conv_first@6"
    with pytest.raises(RuntimeError, match="k=2") as jerr:
        _jax_tune(jnumerics.NumericsProbe(inject=spec))
    model, step = _port_step(accum=1, numerics=tnumerics.NumericsProbe(inject=spec))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_start.items()}, strict=False)
    xs, ys = map(torch.from_numpy, sr_batches(1)[0])
    with pytest.raises(RuntimeError, match="k=2") as err:
        tparallel.tune_multi_step_k(step, (xs, ys), ks=(1, 2), steps_per_arm=4)
    snapshot = err.value.state
    assert snapshot["step"] == int(jerr.value.state.step) == 5
    step.restore_state(snapshot)
    _close_params(full_params(model), _numpy_params(jerr.value.state.params))
    step.numerics.inject_spec = None
    assert torch.isfinite(step((xs, ys))["loss"])


def test_injection_fires_inside_a_window_on_the_device_step():
    """The probe's spec is compared with the device step counter, so the
    poisoned step is the same inside a window as in sequential steps."""
    batches = sr_batches(K)
    probe = tnumerics.NumericsProbe(inject="conv_first@2")
    _, step = _port_step(numerics=probe)
    aux = tparallel.MultiStep(step, K)(_torch_window(windows(batches, K)[0]))["numerics"]
    bad = ~aux["finite_mask"].all(dim=1)
    assert bad.tolist() == [False, False, True, True]  # poisoned at 2, NaN weights after
    assert aux["first_bad_leaf"].shape == (K,)
    summary = probe.observe(aux, step=K)
    assert summary["nonfinite"] and summary["blame"]["leaf"] == "conv_first.weight"


STACKED_AUX = [  # (finite_mask [K, n], first_bad_leaf [K], bad_layer [K, n], grad_norm [K])
    ([[1, 1, 1], [1, 1, 1]], [-1, -1], [[-1, -1, -1], [-1, -1, -1]], [0.5, 0.7]),
    ([[1, 1, 1], [1, 0, 1]], [-1, 1], [[-1, -1, -1], [-1, 3, -1]], [0.5, np.inf]),
    ([[1, 0, 1], [0, 0, 1]], [1, 0], [[-1, 2, -1], [0, 5, -1]], [np.nan, np.nan]),
]


@pytest.mark.parametrize("case", range(len(STACKED_AUX)), ids=["clean", "second", "both"])
def test_observe_decodes_a_k_stacked_aux_as_jax(case):
    finite, first, layer, gnorm = STACKED_AUX[case]
    aux = {"finite_mask": np.array(finite, bool), "first_bad_leaf": np.array(first, np.int32),
           "bad_layer": np.array(layer, np.int32), "grad_norm": np.array(gnorm, np.float32),
           "param_norm": np.array([2.0, 3.0], np.float32)}
    names = ["a/kernel", "b/kernel", "c/bias"]
    out = []
    for mod in (tnumerics, jnumerics):
        probe = mod.NumericsProbe(inject="")
        probe.leaf_paths = names
        s = probe.observe(aux, step=4, loss=np.array([0.3, 0.2], np.float32))
        out.append({k: s[k] for k in ("nonfinite", "blame", "loss", "param_norm")}
                   | {"grad_norm": np.float32(s["grad_norm"])})
    assert str(out[0]) == str(out[1])


def test_dropout_key_draws_one_mask_from_a_host_or_a_device_step():
    shape, keep = (6, 33, 10), 0.9
    for step in (0, 5, 2**31 - 1):
        host = DropoutKey(3, step, 1).mask(4, shape, keep, "cpu")
        dev = DropoutKey(3, torch.tensor(step), 1).mask(4, shape, keep, "cpu")
        assert torch.equal(host, dev) and host.shape == shape
    assert not torch.equal(DropoutKey(3, 5, 1).mask(4, shape, keep, "cpu"),
                           DropoutKey(3, 6, 1).mask(4, shape, keep, "cpu"))


def _lm_loss(model, tokens, key):
    logits = model(tokens, deterministic=False, generator=key)
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]).float(), tokens[:, 1:].reshape(-1)), {}


def test_a_window_draws_the_sequential_steps_dropout_masks():
    """GPT-2 with dropout 0.1 and remat: the K steps of a window key their
    masks by the device counter as K sequential steps key theirs by the
    host count, so the two runs are equal bitwise."""
    cfg = GPT2Config.tiny(dropout=0.1, remat=True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (K, 4, 16)))
    runs = []
    for windowed in (False, True):
        model = GPT2(cfg, generator=torch.Generator().manual_seed(0))
        tx = toptim.adamw(model.named_parameters(), lr=1e-3)
        step = tparallel.TrainStep(model, _lm_loss, tx, rng=11, grad_accum_steps=2)
        if windowed:
            losses = tparallel.MultiStep(step, K)(tokens)["loss"].tolist()
        else:
            losses = [float(step(t)["loss"]) for t in tokens]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


PER_LEAF = {
    "adamw-onecycle-factor": (lambda mod: mod.adamw, dict(lr=("onecycle", 3e-3, 20),
                                                         clip_grad_norm=0.1), 0.5),
    "sgd-nesterov": (lambda mod: mod.sgd, dict(lr=0.05, momentum=0.9, nesterov=True,
                                               weight_decay=1e-4), 1.0),
}


@pytest.mark.parametrize("case", PER_LEAF)
def test_per_leaf_trajectories_match_jax_with_device_scalars(case, jax_start):
    """The per-leaf chains now read their count, lr factor and schedule on
    the device (bias corrections in f32, as optax): four steps of each
    package's ``TrainStep`` at an lr factor, losses within 1e-5 relative and
    parameters within JAX's multi-step bounds."""
    factory, kw, factor = PER_LEAF[case]

    def lr_of(mod):
        lr = kw["lr"]
        return mod.onecycle(max_lr=lr[1], total_steps=lr[2]) if isinstance(lr, tuple) else lr

    mesh = make_mesh(MeshSpec.ddp(1), devices=jax.devices()[:1])
    jmodel = JaxSwinIR(**TOY)
    jtx = factory(joptim)(**{**kw, "lr": lr_of(joptim)})
    state, sh = jparallel.create_train_state(model=jmodel, sample_input=jnp.zeros((1, 8, 8, 3)),
                                             tx=jtx, mesh=mesh, policy=jparallel.DDP())

    def jloss(params, batch, rng, model_state):
        return jnp.mean((jmodel.apply({"params": params}, batch[0]) - batch[1]) ** 2), {}

    jstep = jparallel.TrainStep(jloss, jtx, mesh, jparallel.DDP(), state_shardings=sh,
                                donate=False)
    model = toy_swinir(jax_start)
    tx = factory(toptim)(model.named_parameters(), **{**kw, "lr": lr_of(toptim)})
    step = tparallel.TrainStep(model, mse_loss_fn, tx)
    for batch in sr_batches(4):
        state, jm = jstep(state, batch, lr_factor=factor)
        tm = step(tuple(map(torch.from_numpy, batch)), lr_factor=factor)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert tx.count == 4 and tx.count_t.device.type == "cpu"
    _close_params(full_params(model), _numpy_params(state.params))
    assert float(optax.global_norm(jax.tree.leaves(state.params))) > 0


def test_multi_step_refuses_zero3_ddp_wrappers_and_detect_anomaly():
    """``detect_anomaly`` (a host read every step) stays refused; ZeRO-3
    (FSDP2) and a ``DistributedDataParallel`` model are accepted: in a
    gloo group of one each window equals its K eager steps bitwise (the
    DDP program runs the bare module and all-reduces the grads itself)."""
    model = toy_swinir()
    tx = toptim.adamw(model.named_parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="detect_anomaly"):
        tparallel.MultiStep(tparallel.TrainStep(model, mse_loss_fn, tx, detect_anomaly=True), K)
    for policy in ("zero3", "ddp"):
        got = run_ranks(graph_vs_eager_worker, 1, policy=policy, opt="adamw",
                        batches=sr_batches(2 * K), k=K, device="cpu")[0]
        assert got["graphed"] == got["eager"] and got["equal"], policy
        assert len(got["graphed"]) == 2 * K
