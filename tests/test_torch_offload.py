"""Host offload and the DeepSpeed/Fairscale config surface against JAX.

- The configs: the same config list goes into the JAX facade and the
  port's (ESPCN ``Net``, AdamW): the same policy class and fields (the ZeRO
  stage, ``offload_opt_state``/``offload_params``), the same precision, the
  same warnings (``aio``, an offload device other than ``cpu``: matched on
  their first three words, which name the knob; the rest names each
  package's hardware), and for stages 0-2 a two-step trajectory within
  1e-5 (losses relative, parameters absolute, f32 with different sum
  orders, as ``tests/test_torch_stoke.py``'s trajectory).
- The CPU fallback: neither JAX's CPU backend nor the CPU here has host
  placement, so an offload policy keeps the state in place with JAX's
  warning (the same text) and trains to JAX's losses (1e-5 relative).
- The mechanics on the CPU: ``tx.offload`` puts the state and parameters
  in host tensors of their own (plain copies: there is no card to pin for)
  and every step streams them in and back, the code the card runs with
  pinned memory and side-stream copies. Per-leaf ``AdamW``/``SGD`` and
  ``FusedAdamW`` then train bitwise as the resident run, eagerly and under
  ``MultiStep``; a saved and loaded offloaded state resumes bitwise; the
  eval step streams the parameters in and drops the copies.
- The ESPCN driver against JAX's under ``--remat`` none/full/names with
  ``--device-prefetch 2``: the epoch's last loss within 1e-5 relative.
"""

import dataclasses
import functools
import logging
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.models import Net as JaxNet
from pytorch_distributedtraining_tpu.parallel import DDP as JDDP
from pytorch_distributedtraining_tpu.parallel import TrainStep as JaxTrainStep
from pytorch_distributedtraining_tpu.parallel import ZeRO1 as JZeRO1
from pytorch_distributedtraining_tpu.parallel import create_train_state as jax_train_state
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu.stoke import config as jconfig
from pytorch_distributedtraining_tpu_torch import checkpoint_sharded, optim
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.data import SyntheticSRDataset
from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp
from pytorch_distributedtraining_tpu_torch.interop import espcn_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.losses import mse_loss
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config, Net
from pytorch_distributedtraining_tpu_torch.models.gpt2 import cross_entropy_loss
from pytorch_distributedtraining_tpu_torch.parallel import (DDP, EvalStep, MultiStep, TrainStep,
                                                             ZeRO1, ZeRO2, ZeRO3,
                                                             create_train_state)
from pytorch_distributedtraining_tpu_torch.parallel import state as tstate

BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def no_remat_env(monkeypatch):
    monkeypatch.delenv("GRAFT_REMAT", raising=False)


# -- the configs ------------------------------------------------------------------


def _configs(mod, case: str) -> list:
    """One config list, built from ``mod`` (JAX's or the port's stoke)."""
    ds, zero = mod.DeepspeedConfig, mod.DeepspeedZeROConfig
    opt, par = mod.DeepspeedOffloadOptimizerConfig, mod.DeepspeedOffloadParamConfig
    return {
        "stage0": [ds(zero_optimization=zero(stage=0), offload_optimizer=opt(device="cpu"))],
        "stage1": [ds(zero_optimization=zero(stage=1), offload_optimizer=opt(device="cpu"))],
        "stage2": [ds(zero_optimization=zero(stage=2), offload_optimizer=opt(device="cpu"),
                      gradient_clipping=0.5)],
        "stage3-param-bf16": [ds(zero_optimization=zero(stage=3), offload_param=par(device="cpu"),
                                 bf16_enabled=True)],
        "stage2-param-fp16": [ds(zero_optimization=zero(stage=2),
                                 offload_param=par(device="cpu"), fp16_enabled=True)],
        "fsdp-cpu-offload": [mod.FairscaleFSDPConfig(cpu_offload=True)],
        "aio-and-nvme": [ds(aio=mod.DeepspeedAIOConfig(), offload_optimizer=opt(device="nvme"))],
        "param-nvme": [ds(offload_param=par(device="nvme"))],
        "none": [],
    }[case]


def _facades(case: str, distributed=None, one_device_mesh=False):
    """The JAX facade and the port's from the same configs: ``(js, ts,
    jax warnings, port warnings)``."""
    kw = dict(optimizer_kwargs={"lr": 1e-3, "betas": (0.9, 0.99), "eps": 1e-8,
                                "weight_decay": 1e-4})
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        extra = {"mesh": make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])} \
            if one_device_mesh else {}
        js = jstoke.Stoke(model=JaxNet(upscale_factor=2),
                          sample_input=jnp.zeros((BATCH, 8, 8, 3)),
                          optimizer=jstoke.StokeOptimizer(optimizer="AdamW", **kw),
                          loss=jlosses.mse_loss, batch_size_per_device=BATCH,
                          distributed=distributed, configs=_configs(jconfig, case), **extra)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        ts = tstoke.Stoke(model=Net(upscale_factor=2),
                          optimizer=tstoke.StokeOptimizer(optimizer="AdamW", **kw),
                          loss=mse_loss, batch_size_per_device=BATCH, device="cpu",
                          distributed=distributed, configs=_configs(tstoke, case))
    return js, ts, jw, tw


def _deepspeed_warnings(caught) -> list[str]:
    return sorted(" ".join(str(w.message).split()[:3]) for w in caught
                  if "Deepspeed" in str(w.message))


@pytest.mark.parametrize("case", ["stage0", "stage3-param-bf16", "stage2-param-fp16",
                                  "fsdp-cpu-offload", "aio-and-nvme", "param-nvme"])
def test_configs_build_the_policy_jax_builds(case):
    js, ts, jw, tw = _facades(case)
    assert type(ts.policy).__name__ == type(js.policy).__name__
    assert dataclasses.asdict(ts.policy) == dataclasses.asdict(js.policy)
    assert ts.fp16 == js.fp16
    assert _deepspeed_warnings(tw) == _deepspeed_warnings(jw)
    if case == "aio-and-nvme":
        assert _deepspeed_warnings(tw) == ["Deepspeed offload_optimizer device='nvme'",
                                           "DeepspeedAIOConfig is inert"]
    if case.startswith("stage") or case == "fsdp-cpu-offload":
        assert ts.policy.offload_opt_state or ts.policy.offload_params
        assert not ts._opt.offloaded  # the CPU: in place, as JAX's CPU fallback


@pytest.mark.parametrize("distributed", ["deepspeed", "horovod"])
def test_distributed_values_build_the_policy_jax_builds(distributed):
    js, ts, _, _ = _facades("none", distributed=distributed)
    assert type(ts.policy).__name__ == type(js.policy).__name__ == "DDP"
    assert dataclasses.asdict(ts.policy) == dataclasses.asdict(js.policy)


@pytest.mark.parametrize("case", ["stage0", "stage1", "stage2"])
def test_offload_configs_train_as_the_jax_facade(case):
    """Two Stoke-style steps of the offloaded configs (kept in place on the
    CPU) on both facades from the same weights: the gradient clip of
    ``gradient_clipping`` included (stage 2)."""
    js, ts, _, _ = _facades(case, one_device_mesh=True)
    assert type(ts.policy).__name__ == type(js.policy).__name__
    if case == "stage2":
        assert ts._opt.clip_grad_norm == 0.5
    ts.load_model_state(espcn_state_dict_from_jax(jax.device_get(js.state.params)))
    ds = SyntheticSRDataset(n=2 * BATCH, lr_size=8, scale=2)
    items = [ds[i] for i in range(len(ds))]
    batches = [tuple(np.stack([it[k] for it in items[j:j + BATCH]]) for k in (0, 1))
               for j in range(0, len(items), BATCH)]
    got, want = [], []
    for x, y in batches:
        for s, out in ((js, want), (ts, got)):
            loss = s.loss(s.model(x), y)
            s.backward(loss)
            s.step()
            out.append(float(np.asarray(loss.detach() if hasattr(loss, "detach") else loss)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    final = espcn_state_dict_from_jax(jax.device_get(js.state.params))
    for name, p in ts.model_access.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), atol=1e-5,
                                   err_msg=name)


# -- the CPU fallback ---------------------------------------------------------------


def _espcn_batches(n: int):
    ds = SyntheticSRDataset(n=n * BATCH, lr_size=8, scale=2)
    items = [ds[i] for i in range(len(ds))]
    return [tuple(np.stack([it[k] for it in items[j:j + BATCH]]) for k in (0, 1))
            for j in range(0, len(items), BATCH)]


@pytest.mark.parametrize("flag", ["offload_opt_state", "offload_params"])
def test_cpu_keeps_offloaded_state_in_place_with_jax_warning(flag, caplog):
    jpolicy = (JZeRO1 if flag == "offload_opt_state" else JDDP)(**{flag: True})
    policy = (ZeRO1 if flag == "offload_opt_state" else DDP)(**{flag: True})
    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    jnet = JaxNet(upscale_factor=2)
    jtx = joptim.adamw(lr=3e-3)
    with caplog.at_level(logging.WARNING):
        state, shardings = jax_train_state(model=jnet, sample_input=jnp.zeros((1, 8, 8, 3)),
                                           tx=jtx, mesh=mesh, policy=jpolicy)
    jmsg = [r.getMessage() for r in caplog.records if "host offload" in r.getMessage()]
    caplog.clear()
    net = Net(upscale_factor=2)
    net.load_state_dict(espcn_state_dict_from_jax(jax.device_get(state.params)))
    with caplog.at_level(logging.WARNING):
        st = create_train_state(net, functools.partial(optim.adamw, lr=3e-3), None, policy,
                                device="cpu")
    msg = [r.getMessage() for r in caplog.records if "host offload" in r.getMessage()]
    assert msg == jmsg and len(msg) == 1
    assert not st.tx.offloaded

    def jloss(params, batch, rng, model_state):
        return jlosses.mse_loss(jnet.apply({"params": params}, batch[0]), batch[1]), {}

    jstep = JaxTrainStep(jloss, jtx, mesh, jpolicy, state_shardings=shardings, donate=False)
    step = TrainStep(st.model, lambda m, b: (mse_loss(m(b[0]), b[1]), {}), st.tx)
    for batch in _espcn_batches(2):
        state, jm = jstep(state, batch)
        tm = step(tuple(map(torch.from_numpy, batch)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_zero3_refuses_offloaded_parameters_where_offload_is_real(monkeypatch):
    monkeypatch.setattr(tstate, "host_offload_supported", lambda device: True)
    with pytest.raises(ValueError, match="FSDP2 owns"):
        tstate.offload_placed(ZeRO3(offload_params=True), torch.device("cuda"))
    assert tstate.offload_placed(ZeRO3(offload_opt_state=True), torch.device("cuda")) == (
        True, False)
    assert tstate.offload_placed(ZeRO2(offload_params=True), torch.device("cuda")) == (
        False, True)


# -- the mechanics on the CPU ---------------------------------------------------------

OPTIMIZERS = {
    "adamw": functools.partial(optim.adamw, lr=1e-2, clip_grad_norm=1.0, ema_decay=0.9),
    "sgd": functools.partial(optim.sgd, lr=1e-2, momentum=0.9),
    "fused": functools.partial(optim.FusedAdamW, lr=1e-2, clip_grad_norm=1.0),
}
OFFLOADS = {"state": (True, False), "params": (False, True), "both": (True, True)}


def _lm_loss(m, batch):
    return cross_entropy_loss(m(batch[:, :-1]), batch[:, 1:]), {}


def _lm_state(opt: str, offload):
    model = GPT2(GPT2Config.tiny(), generator=torch.Generator().manual_seed(0))
    st = create_train_state(model, OPTIMIZERS[opt], None, ZeRO1(), device="cpu")
    if offload is not None:
        st.tx.offload(opt_state=offload[0], params=offload[1])
    return st


def _tokens(n: int) -> list:
    g = torch.Generator().manual_seed(1)
    return [torch.randint(0, 256, (2, 17), generator=g) for _ in range(n)]


def _snapshot(st) -> dict:
    st.tx.settle()
    return {n: p.detach().clone() for n, p in st.module.named_parameters()}


@pytest.mark.parametrize("offload", list(OFFLOADS))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_offloaded_steps_equal_the_resident_steps(opt, offload):
    toks = _tokens(3)
    want_st = _lm_state(opt, None)
    want_step = TrainStep(want_st.model, _lm_loss, want_st.tx)
    want = [float(want_step(t)["loss"]) for t in toks]
    st = _lm_state(opt, OFFLOADS[offload])
    step = TrainStep(st.model, _lm_loss, st.tx)
    assert st.tx.offloaded_state == OFFLOADS[offload][0]
    assert st.tx.offloaded_params == OFFLOADS[offload][1]
    got = [float(step(t)["loss"]) for t in toks]
    assert got == want
    a, b = _snapshot(st), _snapshot(want_st)
    assert all(torch.equal(a[n], b[n]) for n in b)
    if OFFLOADS[offload][1]:  # between steps the parameters are the host tensors
        homes = st.tx._host_params
        held = ([p.data_ptr() for p in st.tx.params] if opt != "fused"
                else [st.tx.flat_param.data_ptr()])
        assert held == [h.data_ptr() for h in homes]
    sd, want_sd = st.tx.state_dict(), want_st.tx.state_dict()
    for key in ("mu", "nu", "trace", "ema"):
        if isinstance(want_sd.get(key), list):
            assert all(torch.equal(x, y) for x, y in zip(sd[key], want_sd[key])), key
        elif isinstance(want_sd.get(key), torch.Tensor):
            assert torch.equal(sd[key], want_sd[key]), key


@pytest.mark.parametrize("opt", ["adamw", "fused"])
def test_multi_step_of_the_offloaded_step_equals_its_eager_twin(opt):
    toks = _tokens(4)
    st = _lm_state(opt, OFFLOADS["both"])
    metrics = MultiStep(TrainStep(st.model, _lm_loss, st.tx), 4)(torch.stack(toks))
    twin = _lm_state(opt, OFFLOADS["both"])
    step = TrainStep(twin.model, _lm_loss, twin.tx)
    assert metrics["loss"].tolist() == [float(step(t)["loss"]) for t in toks]
    a, b = _snapshot(st), _snapshot(twin)
    assert all(torch.equal(a[n], b[n]) for n in b)


@pytest.mark.parametrize("fmt", ["state_dict", "portable"])
@pytest.mark.parametrize("opt", ["adamw", "fused"])
def test_offloaded_state_saves_and_resumes_bitwise(opt, fmt, tmp_path):
    toks = _tokens(4)
    whole = _lm_state(opt, OFFLOADS["both"])
    step = TrainStep(whole.model, _lm_loss, whole.tx, rng=whole.rng)
    want = [float(step(t)["loss"]) for t in toks]
    first = _lm_state(opt, OFFLOADS["both"])
    step = TrainStep(first.model, _lm_loss, first.tx, rng=first.rng)
    head = [float(step(t)["loss"]) for t in toks[:2]]
    resumed = _lm_state(opt, OFFLOADS["both"])
    if fmt == "state_dict":
        resumed.load_state_dict(first.state_dict())
    else:
        checkpoint_sharded.save_portable(str(tmp_path / "ckpt"), first)
        checkpoint_sharded.restore_portable(str(tmp_path / "ckpt"), resumed)
    assert resumed.tx.offloaded_state and resumed.tx.offloaded_params
    step = TrainStep(resumed.model, _lm_loss, resumed.tx, rng=resumed.rng)
    tail = [float(step(t)["loss"]) for t in toks[2:]]
    assert head + tail == want
    a, b = _snapshot(resumed), _snapshot(whole)
    assert all(torch.equal(a[n], b[n]) for n in b)


def test_eval_step_streams_the_parameters_in_and_drops_them():
    st = _lm_state("fused", OFFLOADS["params"])
    ref = _lm_state("fused", None)
    tok = _tokens(1)[0]

    def metric(m, batch):
        return {"loss": _lm_loss(m, batch)[0]}

    got = EvalStep(st.model, metric, tx=st.tx)(tok)
    want = EvalStep(ref.model, metric)(tok)
    assert torch.equal(got["loss"], want["loss"])
    assert st.tx._device_params is None  # the copies were dropped after the forward
    assert st.tx.flat_param.data_ptr() == st.tx._host_params[0].data_ptr()


# -- the ESPCN driver --------------------------------------------------------------


def _jax_driver():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from drivers import fairscale_ddp as jdriver

    return jdriver


@pytest.mark.parametrize("remat", ["none", "full", "names"])
def test_espcn_driver_matches_the_jax_driver(remat):
    argv = ["--synthetic", "--synthetic-n", "24", "--epochs", "1", "--batch-size", "8",
            "--workers", "0", "--device-prefetch", "2", "--remat", remat]
    want = _jax_driver().main(argv)
    params = JaxNet(upscale_factor=2).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 32, 32, 3)))["params"]
    net = fairscale_ddp.build_model()
    net.load_state_dict(espcn_state_dict_from_jax(jax.device_get(params)))
    opt = fairscale_ddp.build_parser().parse_args(argv)
    assert (opt.remat, opt.device_prefetch) == (remat, 2)
    got = fairscale_ddp.main(argv + ["--device", "cpu"], model=net)
    np.testing.assert_allclose(got, want, rtol=1e-5)
