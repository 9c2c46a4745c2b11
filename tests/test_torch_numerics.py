"""``observe/numerics.py`` and ``TrainStep(numerics=, detect_anomaly=)`` of
the port against the JAX package's.

flax orders leaves by sorted key with ``[in, out]`` kernels and HWIO
convolutions, torch by registration with ``[out, in]`` and OIHW, so leaf
indices differ; leaves are compared by name through the ``interop`` key
maps, and ``bad_layer`` (the first offending row along the JAX leaf's
leading axis) must be JAX's number. Tolerances:

- the aux on the same gradients (JAX's, carried into the port's layout by
  the key maps), the same pre-update parameters and the same first AdamW
  update: gradient and parameter norms within 1e-6 relative, per-leaf
  update ratios within 1e-5 relative (the updates come from each
  package's own AdamW), the finite flags equal, the blamed leaf and its
  ``bad_layer`` equal, for a poisoned row of a dense kernel, an embedding
  and a convolution, and a poisoned LayerNorm scale;
- the watchdog: the same verdicts, field for field, on the same loss and
  grad-norm sequences (a clock of 0 on both sides);
- ``TrainStep`` on the ESPCN ``Net`` (JAX's on a one-device mesh): the same
  per-step summaries under ``GRAFT_NUMERICS_INJECT`` (grad norms within
  1e-5 relative: two models' sums), and ``detect_anomaly`` raising on the
  same leaf with the port's pre-step state untouched, bitwise.

The facade's env twins, the rollback drill through ``CheckpointManager``
and the probe's reduction over two gloo ranks under ZeRO-2 and ZeRO-3 are
here too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu.losses import mse_loss as jmse
from pytorch_distributedtraining_tpu.models import Net as JaxNet
from pytorch_distributedtraining_tpu.models import gpt2 as jg
from pytorch_distributedtraining_tpu.models import vit as jvit
from pytorch_distributedtraining_tpu.observe import numerics as jnum
from pytorch_distributedtraining_tpu.parallel import DDP
from pytorch_distributedtraining_tpu.parallel import TrainStep as JaxTrainStep
from pytorch_distributedtraining_tpu.parallel import create_train_state as jax_train_state
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import interop, optim
from pytorch_distributedtraining_tpu_torch.checkpoint_sharded import CheckpointManager
from pytorch_distributedtraining_tpu_torch.losses import mse_loss
from pytorch_distributedtraining_tpu_torch.models import Net
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.models import vit as tv
from pytorch_distributedtraining_tpu_torch.observe import numerics as tnum
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, create_train_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_gauges():
    jnum.reset()
    tnum.reset()
    yield
    jnum.reset()
    tnum.reset()


def _nest(path: str, leaf) -> dict:
    node = out = {}
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf
    return out


def port_name(mapper, path: str, leaf) -> str:
    """The port's parameter name of the JAX leaf at ``path``."""
    (name,) = mapper(_nest(path, np.asarray(leaf))).keys()
    return name


MODELS = {
    "gpt2": (lambda: jg.GPT2(jg.GPT2Config.tiny(tie_word_embeddings=False)),
             lambda: tg.GPT2(tg.GPT2Config.tiny(tie_word_embeddings=False)),
             lambda: np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32),
             interop.gpt2_state_dict_from_jax),
    "vit": (lambda: jvit.ViT(jvit.ViTConfig.tiny()), lambda: tv.ViT(tv.ViTConfig.tiny()),
            lambda: np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32),
            interop.vit_state_dict_from_jax),
}

# (model, JAX leaf path, row along the JAX leading axis or None for the whole leaf)
POISON = [
    (None, None, None),
    ("gpt2", "h_1/mlp_fc/kernel", 5),      # dense [in, out]: torch's column 5
    ("gpt2", "wte", 7),                    # an embedding keeps its rows
    ("gpt2", "lm_head/kernel", 30),        # the untied head [n_embd, vocab]
    ("gpt2", "ln_f/scale", None),          # 1-d: no layer axis
    ("vit", "patch_embed/kernel", 3),      # HWIO: kernel row 3 (torch OIHW axis 2)
    ("vit", "encoder_1/c_attn/kernel", 2),  # the packed in_proj_weight
]


@functools.lru_cache(maxsize=None)
def _jax_world(kind):
    jm, _, data, mapper = MODELS[kind]
    model = jm()
    x = data()
    params = jax.device_get(model.init(jax.random.PRNGKey(0), x[:1])["params"])
    params = jax.tree.map(lambda a: a + 0.05 * np.random.default_rng(1).normal(
        size=a.shape).astype(np.float32), params)

    def loss(p):
        return jnp.mean(model.apply({"params": p}, x) ** 2)

    grads = jax.device_get(jax.jit(jax.grad(loss))(params))
    return params, grads


@pytest.mark.parametrize("case", POISON, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_aux_and_observe_match_jax(case):
    kind, path, row = case
    kind = kind or "gpt2"
    params, grads = _jax_world(kind)
    grads = jax.tree.map(np.array, grads)  # a copy to poison
    _, tm, _, mapper = MODELS[kind]
    if path is not None:
        node = grads
        parts = path.split("/")
        for p in parts[:-1]:
            node = node[p]
        leaf = np.array(node[parts[-1]])
        if row is None:
            leaf[...] = np.nan
        else:
            leaf[row] = np.inf if kind == "vit" else np.nan
        node[parts[-1]] = leaf
    tx = joptim.adamw(lr=1e-3)
    jprobe = jnum.NumericsProbe(inject="")

    @jax.jit
    def jax_aux(g, p):
        updates, _ = tx.update(g, tx.init(p), p)
        return jprobe.aux(g, params=p, updates=updates)

    jaux = jax_aux(grads, params)
    jsum = jprobe.observe(jaux, step=1)

    model = tm()
    model.load_state_dict(mapper(params), strict=True)
    port_grads = mapper(grads)
    for n, p in model.named_parameters():
        p.grad = port_grads[n].clone()
    opt = optim.adamw(model.named_parameters(), lr=1e-3)
    opt.track_updates = True
    pnorm = tnum.leaf_norms(opt.params)
    opt.step(opt.grads())
    probe = tnum.NumericsProbe(inject="")
    aux = probe.aux(opt.grads(), param_norms=pnorm, update_norms=opt.update_norms,
                    **tnum.probe_layout(model, opt))
    got = probe.observe(aux, step=1)

    assert got["nonfinite"] == jsum["nonfinite"] == (path is not None)
    if path is not None:
        assert got["blame"]["leaf"] == port_name(mapper, path, leaf)
        assert got["blame"]["layer"] == jsum["blame"]["layer"] == (-1 if row is None or
                                                                   leaf.ndim < 2 else row)
    else:
        np.testing.assert_allclose(got["grad_norm"], jsum["grad_norm"], rtol=1e-6)
    np.testing.assert_allclose(got["param_norm"], jsum["param_norm"], rtol=1e-6)
    # the per-leaf picture by name
    jnames = [port_name(mapper, p, _leaf_at(params, p)) for p in jprobe.leaf_paths]
    jfinite = dict(zip(jnames, np.asarray(jaux["finite_mask"]).tolist()))
    tfinite = dict(zip(probe.leaf_paths, aux["finite_mask"].tolist()))
    assert tfinite == jfinite
    jlayer = dict(zip(jnames, np.asarray(jaux["bad_layer"]).tolist()))
    assert dict(zip(probe.leaf_paths, aux["bad_layer"].tolist())) == jlayer
    if path is None:
        jratio = dict(zip(jnames, np.asarray(jaux["update_ratio"]).tolist()))
        for n, r in zip(probe.leaf_paths, aux["update_ratio"].tolist()):
            np.testing.assert_allclose(r, jratio[n], rtol=1e-5, err_msg=n)


def _leaf_at(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def test_inject_spec_parsing_matches_jax():
    for spec in ("conv2.weight@3", "a@b@7", None, ""):
        assert tnum.parse_inject_spec(spec) == jnum.parse_inject_spec(spec)
    for bad in ("conv2.weight", "@3"):
        with pytest.raises(ValueError):
            jnum.parse_inject_spec(bad)
        with pytest.raises(ValueError):
            tnum.parse_inject_spec(bad)


def _sequences():
    rng = np.random.default_rng(0)
    base = list(1.0 + 0.01 * rng.normal(size=30))
    yield "loss spike", [dict(loss=v, grad_norm=0.5) for v in base[:20]] + [
        dict(loss=9.0, grad_norm=0.5)]
    yield "grad explosion", [dict(loss=1.0, grad_norm=v) for v in base[:12]] + [
        dict(loss=1.0, grad_norm=50.0)]
    yield "nonfinite streak", [dict(loss=1.0, grad_norm=1.0)] * 3 + [
        dict(nonfinite=True, blame={"leaf": "x", "layer": 2, "step": 4})] * 3
    yield "absorbed", [dict(loss=v, grad_norm=1.0) for v in base[:10]] + [
        dict(nonfinite=True), dict(loss=1.0, grad_norm=1.0), dict(loss=float("nan"))]
    yield "short history", [dict(loss=1.0, grad_norm=1.0), dict(loss=100.0, grad_norm=100.0)]


@pytest.mark.parametrize("action", ["halt", "rollback", "degrade"])
def test_watchdog_verdicts_match_jax(action):
    for name, seq in _sequences():
        jw = jnum.NumericsWatchdog(action, clock=lambda: 0.0)
        tw = tnum.NumericsWatchdog(action, clock=lambda: 0.0)
        for i, facts in enumerate(seq):
            want = jw.observe(step=i, **facts)
            assert tw.observe(step=i, **facts) == want, (name, i)
        assert tw.tripped == jw.tripped
    assert tnum.runtime_stats["verdicts"] == jnum.runtime_stats["verdicts"]
    with pytest.raises(ValueError):
        tnum.NumericsWatchdog("explode")


def test_apply_action_halt_degrade_and_rollback_without_a_checkpoint(monkeypatch):
    monkeypatch.setenv("GRAFT_WIRE", "int8")
    verdict = {"kind": "nonfinite", "step": 3, "detail": "x"}
    with pytest.raises(tnum.NumericsDivergence, match="nonfinite at step 3"):
        tnum.NumericsWatchdog("halt").apply_action(dict(verdict, action="halt"))
    assert tnum.NumericsWatchdog("degrade").apply_action(dict(verdict, action="degrade")) is None
    import os

    assert os.environ["GRAFT_WIRE"] == "fp32" and tnum.runtime_stats["degraded_wire"]
    with pytest.raises(tnum.NumericsDivergence):
        tnum.NumericsWatchdog("rollback").apply_action(dict(verdict, action="rollback"))


# -- TrainStep against JAX's TrainStep (ESPCN Net) -----------------------------


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    hr = rng.random((n, 16, 16, 3)).astype(np.float32)
    return hr.reshape(n, 8, 2, 8, 2, 3).mean(axis=(2, 4)), hr


def _jax_step(inject=None, detect_anomaly=False):
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    model = JaxNet(upscale_factor=2)

    def loss_fn(params, batch, rng, model_state):
        return jmse(model.apply({"params": params}, batch[0]), batch[1]), {}

    tx = joptim.adamw(lr=1e-3)
    state, shardings = jax_train_state(
        init_fn=lambda rng: (model.init(rng, jnp.zeros((1, 8, 8, 3)))["params"], {}),
        tx=tx, mesh=mesh, policy=DDP())
    probe = jnum.NumericsProbe(inject=inject or "")
    step = JaxTrainStep(loss_fn, tx, mesh, DDP(), state_shardings=shardings, donate=False,
                        numerics=probe, detect_anomaly=detect_anomaly)
    return state, step, probe


def _port_step(params, inject=None, detect_anomaly=False):
    net = Net(upscale_factor=2)
    net.load_state_dict(interop.espcn_state_dict_from_jax(jax.device_get(params)))
    st = create_train_state(net, functools.partial(optim.adamw, lr=1e-3), device="cpu")

    def loss_fn(model, batch):
        return mse_loss(model(batch[0]), batch[1]), {}

    probe = tnum.NumericsProbe(inject=inject or "")
    step = TrainStep(st.model, loss_fn, st.tx, rng=st.rng, numerics=probe,
                     detect_anomaly=detect_anomaly)
    return st, step, probe


def test_train_step_summaries_match_jax_under_injection():
    state, jstep, jprobe = _jax_step(inject="Conv_1/kernel@1")
    st, tstep, tprobe = _port_step(state.params, inject="conv2.weight@1")
    jw, tw = jnum.NumericsWatchdog("halt"), tnum.NumericsWatchdog("halt")
    for i in range(3):
        batch = _batch(i)
        state, jm = jstep(state, batch)
        tm = tstep(tuple(map(torch.from_numpy, batch)))
        want = jprobe.observe(jm["numerics"], step=int(state.step), loss=jm["loss"], watchdog=jw)
        got = tprobe.observe(tm["numerics"], step=tstep.rng.step, loss=tm["loss"], watchdog=tw)
        assert got["step"] == want["step"] == i + 1
        assert got["nonfinite"] == want["nonfinite"] == (i >= 1)
        if i == 0:
            for k in ("grad_norm", "loss", "param_norm", "update_ratio_max"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        elif i == 1:
            assert want["blame"]["leaf"] == "Conv_1/kernel"
            assert got["blame"] == dict(want["blame"], leaf="conv2.weight")
        assert (got["verdict"] is None) == (want["verdict"] is None) == (i < 2)
    assert got["verdict"]["kind"] == want["verdict"]["kind"] == "nonfinite"
    assert tnum.snapshot()["nonfinite_steps_total"] == jnum.snapshot()["nonfinite_steps_total"]


def test_detect_anomaly_matches_jax_and_keeps_the_state():
    state, jstep, _ = _jax_step(inject="Conv_2/bias@0", detect_anomaly=True)
    with pytest.raises(Exception, match=r"detect_anomaly: non-finite values in .*Conv_2.*bias"):
        jax.block_until_ready(jstep(state, _batch(0)))
    st, tstep, _ = _port_step(state.params, inject="conv3.bias@0", detect_anomaly=True)
    before = {n: p.detach().clone() for n, p in st.module.named_parameters()}
    moments = [m.clone() for m in st.tx.mu + st.tx.nu]
    with pytest.raises(FloatingPointError,
                       match=r"^detect_anomaly: non-finite values in conv3\.bias$"):
        tstep(tuple(map(torch.from_numpy, _batch(0))))
    for n, p in st.module.named_parameters():
        assert torch.equal(p, before[n]), n
    assert all(torch.equal(a, b) for a, b in zip(st.tx.mu + st.tx.nu, moments))
    assert st.tx.count == 0 and tstep.rng.step == 0
    # a clean step after it runs, and the loss itself is checked too
    tstep.numerics.inject_spec = None
    assert torch.isfinite(tstep(tuple(map(torch.from_numpy, _batch(1))))["loss"])

    def nan_loss(model, batch):
        return model(batch[0]).sum() * float("nan"), {}

    bad = TrainStep(st.model, nan_loss, st.tx, detect_anomaly=True)
    with pytest.raises(FloatingPointError, match="<loss>"):
        bad(tuple(map(torch.from_numpy, _batch(2))))


def test_detect_anomaly_restores_batch_norm_statistics():
    from pytorch_distributedtraining_tpu_torch.models import ResNet18

    model = ResNet18(num_classes=10, small_inputs=True, generator=torch.Generator().manual_seed(0))
    st = create_train_state(model, functools.partial(optim.adamw, lr=1e-3), device="cpu")

    def loss_fn(m, batch):
        return torch.nn.functional.cross_entropy(m(batch[0]), batch[1]), {}

    step = TrainStep(st.model, loss_fn, st.tx, detect_anomaly=True,
                     numerics=tnum.NumericsProbe(inject="fc.weight@0"))
    stats = {n: b.clone() for n, b in st.module.named_buffers()}
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with pytest.raises(FloatingPointError, match="fc.weight"):
        step((x, torch.tensor([1, 2, 3, 4])))
    for n, b in st.module.named_buffers():
        assert torch.equal(b, stats[n]), n


# -- the facade, the rollback drill, the ranks ---------------------------------


def _toy_facade(monkeypatch, **env):
    from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
    from pytorch_distributedtraining_tpu_torch.models import SwinIR

    for k in ("GRAFT_NUMERICS", "GRAFT_NUMERICS_ACTION", "GRAFT_NUMERICS_EVERY",
              "GRAFT_NUMERICS_INJECT", "GRAFT_TELEMETRY", "GRAFT_TRACE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model = SwinIR(upscale=2, img_size=8, window_size=4, depths=(2,), embed_dim=12,
                   num_heads=(2,), generator=torch.Generator().manual_seed(0))
    return stoke_ddp.build_stoke(model, device="cpu", batch_size=2, verbose=False)


def _facade_steps(s, n):
    g = torch.Generator().manual_seed(4)
    out = []
    for _ in range(n * s.grad_accum_steps):
        x, y = torch.rand(2, 8, 8, 3, generator=g), torch.rand(2, 16, 16, 3, generator=g)
        s.backward(s.loss(s.model(x), y))
        s.step()
        out.append(s.numerics_summary)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_facade_env_twins_build_the_probe_and_halt(monkeypatch, fused):
    name = "layers.0.residual_group.blocks.1.attn.proj.weight"
    s = _toy_facade(monkeypatch, GRAFT_NUMERICS="1", GRAFT_NUMERICS_INJECT=f"{name}@1")
    if fused:
        monkeypatch.setenv("GRAFT_NUMERICS", "on")
        from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp

        s = stoke_ddp.build_stoke(s.model_access, device="cpu", batch_size=2, verbose=False,
                                  oss=False, sddp=False)
        from pytorch_distributedtraining_tpu_torch.optim import FusedAdamW

        assert isinstance(s._opt, FusedAdamW)
    assert s.numerics_watchdog.action == "halt"
    first = _facade_steps(s, 1)[-1]
    assert not first["nonfinite"] and first["step"] == 1
    assert ("update_ratio_max" in first) == (not fused)
    poisoned = _facade_steps(s, 1)[-1]  # step 1 (0-based): the injected leaf, whole
    assert poisoned["blame"] == {"leaf": name, "layer": 0, "step": 2}
    with pytest.raises(tnum.NumericsDivergence, match="2 consecutive non-finite steps"):
        _facade_steps(s, 1)


def test_facade_cadence_action_and_off_switch(monkeypatch):
    s = _toy_facade(monkeypatch, GRAFT_NUMERICS="1", GRAFT_NUMERICS_EVERY="2",
                    GRAFT_NUMERICS_ACTION="rollback", GRAFT_TELEMETRY="0", GRAFT_TRACE="x")
    assert s.numerics_watchdog.action == "rollback" and not s.telemetry
    seen = [x is not None for x in _facade_steps(s, 4)[1::2]]
    assert seen == [False, True, True, True]  # decoded at the 2nd and 4th steps only
    assert tnum.runtime_stats["steps_observed"] == 2
    s = _toy_facade(monkeypatch, GRAFT_NUMERICS="0")
    assert s.numerics_probe is None
    with pytest.raises(ValueError, match="numerics action"):
        _toy_facade(monkeypatch, GRAFT_NUMERICS="1", GRAFT_NUMERICS_ACTION="panic")


def test_rollback_resumes_the_committed_step_bitwise(tmp_path):
    """The drill: poison step 2 (0-based), trip on the second non-finite
    step, restore the step-2 checkpoint through ``CheckpointManager``; the
    steps after it equal an unbroken run's, bitwise."""
    batches = [tuple(map(torch.from_numpy, _batch(i))) for i in range(5)]
    params = jax.device_get(_jax_step()[0].params)
    st, step, _ = _port_step(params)
    unbroken = [step(b)["loss"].item() for b in batches]
    want = {n: p.detach().clone() for n, p in st.module.named_parameters()}

    st, step, probe = _port_step(params, inject="conv1.weight@2")
    watchdog = tnum.NumericsWatchdog("rollback")
    mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2)
    losses, i, rolled = {}, 0, None
    while i < len(batches):
        m = step(batches[i])
        i += 1
        summary = probe.observe(m["numerics"], step=step.rng.step, loss=m["loss"],
                                watchdog=watchdog)
        if summary.get("verdict") is not None:
            rolled, _ = watchdog.apply_action(summary["verdict"], manager=mgr, template=st)
            i = rolled
            probe.inject_spec = None
            continue
        losses[i] = summary["loss"]
        if not summary["nonfinite"]:
            mgr.maybe_save(step.rng.step, st)
    mgr.close()
    assert rolled == 2 and step.rng.step == len(batches)
    assert [losses[j] for j in range(1, 6)] == unbroken
    for n, p in st.module.named_parameters():
        assert torch.equal(p, want[n]), n


def test_probe_summary_over_two_gloo_ranks_equals_one():
    """ZeRO-2 (per-leaf shards) and ZeRO-3 (FSDP2 chunks) at world 2: the
    probe's summary each step equals the one-process run's (norms within
    1e-5 relative, blame and flags exactly), a poisoned leaf included."""
    from test_torch_dist_workers import numerics_worker, run_ranks, sr_batches

    batches = sr_batches(3)
    runs = [dict(policy="none"), dict(policy="zero2"), dict(policy="zero3")]
    inject = "layers.1.residual_group.blocks.0.mlp.fc1.weight@1"
    alone = numerics_worker(0, 1, runs=runs[:1], batches=batches, inject=inject)[0]
    ranks = run_ranks(numerics_worker, 2, runs=runs[1:], batches=batches, inject=inject)
    for got in (ranks[0][0], ranks[0][1], ranks[1][0], ranks[1][1]):
        for a, b in zip(got, alone):
            assert a["nonfinite"] == b["nonfinite"] and a["blame"] == b["blame"]
            for k in ("grad_norm", "param_norm", "update_ratio_max", "loss"):
                if np.isfinite(b[k]):
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
                else:
                    assert not np.isfinite(a[k]), k
    assert alone[1]["blame"] == {"leaf": inject.split("@")[0], "layer": 0, "step": 2}
