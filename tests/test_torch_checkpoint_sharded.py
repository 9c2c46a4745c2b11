"""The portable format, the commit protocol and ``CheckpointManager``, on one
process, against the JAX package where both write or read the same thing.

- Port -> JAX: a portable dir the port writes (a train state with
  bfloat16 parameters and moments, and f32 ones) is committed by JAX's
  ``is_committed_dir``, and JAX's ``read_manifest``/``_assemble_host_tree``
  read the arrays the port reads, bf16 included (the port writes a bf16
  payload as its float32 values, which JAX's reader casts exactly; JAX's
  own raw ``|V2`` payload its reader cannot cast).
- JAX -> port: JAX's ``save_portable`` of its SwinIR facade's state, and
  of a scanned SwinIR's parameters, restores the port's SwinIR through
  ``interop.params_from_jax_portable`` and ``swinir_state_dict_from_jax``:
  forwards within 1e-5; a JAX bf16 leaf reads back bit for bit.
- The manager: torn (``.tmp``) and marker-less dirs are skipped, keep-last-k
  collects, an async save is a copy taken before the next step writes in
  place, a SIGTERM (and the ``train.preempt`` site) forces a save and the
  handler chains and is put back, a write killed inside the writer
  (``ckpt.write``) leaves a torn dir that the restore skips, and a
  transient ``checkpoint.write`` error is retried while another is not.
"""

import functools
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import checkpoint_sharded as jcs
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu_torch import checkpoint_sharded as tcs
from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.interop import (params_from_jax_portable,
                                                           swinir_state_dict_from_jax)
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.parallel import create_train_state
from pytorch_distributedtraining_tpu_torch.resilience.faults import FaultPlan, install_plan
from pytorch_distributedtraining_tpu_torch.resilience.outage import RetryPolicy

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2),
           embed_dim=12, num_heads=(2, 2), mlp_ratio=2.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as the gloo ranks run: the xdist workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(dtype=torch.float32, seed: int = 0, width: int = 8):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, width), torch.nn.Linear(width, 2)).to(dtype)
    return create_train_state(model, functools.partial(optim.adamw, lr=1e-2, ema_decay=0.9),
                              device="cpu")


def _step(state, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 4, generator=g).to(next(state.module.parameters()).dtype)
    state.module(x).float().square().mean().backward()
    state.tx.step(state.tx.grads())
    state.tx.zero_grad()


def _arrays(state) -> dict:
    return {leaf.path: leaf.pieces[0][1].float().clone() for leaf in tcs.state_leaves(state)}


def test_port_portable_dir_reads_in_jax_bf16_included(tmp_path):
    for dtype in (torch.float32, torch.bfloat16):
        st = _state(dtype)
        _step(st, 1)
        path = str(tmp_path / f"p_{str(dtype)[6:]}")
        tcs.save_portable(path, st, {"step": 1, "lr": 1e-2}, step=1)
        assert jcs.is_committed_dir(path) and tcs.is_committed_dir(path)
        man = jcs.read_manifest(path)
        assert (man["format"], man["version"], man["step"], man["world_size"]) == (
            "graft-portable-ckpt", 1, 1, 1)
        assert man["leaves"]["params/0.weight"]["dtype"] == str(dtype)[6:]
        _, jax_host = jcs._assemble_host_tree(path)
        _, port_host = tcs._assemble_host_tree(path)
        want = _arrays(st)
        assert set(jax_host) == set(port_host) == set(want) | {"meta/step", "meta/lr"}
        for k, t in want.items():
            got = tcs.host_tensor(port_host[k], man["leaves"][k]["dtype"])
            if k.startswith("params/") or "/mu/" in k:
                assert got.dtype == dtype, k
            np.testing.assert_array_equal(got.float().numpy(), t.numpy(), err_msg=k)
            np.testing.assert_array_equal(np.asarray(jax_host[k], np.float32), t.numpy(),
                                          err_msg=k)
            assert str(jax_host[k].dtype) == man["leaves"][k]["dtype"]


def test_jax_bf16_leaf_reads_back_bitwise(tmp_path):
    a = jnp.arange(7, dtype=jnp.bfloat16) * 1.37
    jcs.save_portable(str(tmp_path / "j"), {"a": a, "b": jnp.ones((2, 3))}, step=4)
    man, host = tcs._assemble_host_tree(str(tmp_path / "j"))
    got = tcs.host_tensor(host["['a']"], man["leaves"]["['a']"]["dtype"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(a, np.float32))
    np.testing.assert_array_equal(host["['b']"], np.ones((2, 3), np.float32))


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "scanned"])
def test_jax_portable_swinir_restores_the_port_model(tmp_path, scan):
    model = JaxSwinIR(**TOY, scan_layers=scan)
    x = np.random.default_rng(0).random((2, 8, 8, 3), dtype=np.float32)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))["params"]
    jcs.save_portable(str(tmp_path / "s"), {"params": params, "step": jnp.int32(5)}, step=5)
    want = np.asarray(model.apply({"params": params}, x))
    got = params_from_jax_portable(str(tmp_path / "s"))
    port = SwinIR(**TOY)
    port.load_state_dict(swinir_state_dict_from_jax(got, img_size=8), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_jax_facade_portable_restores_the_port_model(tmp_path):
    from pytorch_distributedtraining_tpu import losses as jlosses
    from pytorch_distributedtraining_tpu import stoke as jstoke
    from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec.zero(1), devices=jax.devices()[:1])
    js = jstoke.Stoke(model=JaxSwinIR(**TOY), optimizer=jstoke.StokeOptimizer("AdamW",
                                                                              {"lr": 1e-2}),
                      loss=jlosses.FeatLoss(), batch_size_per_device=2, mesh=mesh,
                      sample_input=np.zeros((2, 8, 8, 3), np.float32))
    rng = np.random.default_rng(1)
    x, y = rng.random((2, 8, 8, 3), np.float32), rng.random((2, 16, 16, 3), np.float32)
    js.backward(js.loss(js.model(x), y))
    js.step()
    path = js.save_portable(str(tmp_path / "facade"))
    params = jax.device_get(js.state.params)
    want = np.asarray(JaxSwinIR(**TOY).apply({"params": params}, x))
    port = SwinIR(**TOY)
    port.load_state_dict(swinir_state_dict_from_jax(params_from_jax_portable(path), img_size=8),
                         strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, atol=1e-5)


def test_restore_refuses_a_state_of_another_shape(tmp_path):
    st = _state()
    tcs.save_portable(str(tmp_path / "p"), st)
    tcs.runtime_stats["manifest_mismatches"].clear()
    with pytest.raises(ValueError, match="disagrees with checkpoint manifest"):
        tcs.restore_portable(str(tmp_path / "p"), _state(width=16))
    assert any("params/0.weight" in m for m in tcs.runtime_stats["manifest_mismatches"])
    tcs.runtime_stats["manifest_mismatches"].clear()


# -- the manager and the commit protocol -------------------------------------------


def _same_state(a, b) -> None:
    wa, wb = _arrays(a), _arrays(b)
    assert wa.keys() == wb.keys()
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k


def test_manager_skips_torn_and_markerless_dirs(tmp_path):
    st = _state()
    mgr = tcs.CheckpointManager(str(tmp_path), save_every=1, keep=5, handle_sigterm=False)
    for step in (1, 2, 3):
        _step(st, step)
        assert mgr.maybe_save(step, st, {"step": step}) is not None
    want = _arrays(st)
    shutil.copytree(tmp_path / "step_0000000003", tmp_path / "step_0000000004")
    os.remove(tmp_path / "step_0000000004" / "_COMMIT")  # a kill before the marker
    shutil.copytree(tmp_path / "step_0000000003", tmp_path / "step_0000000005.tmp")
    os.makedirs(tmp_path / "step_0000000006")  # empty
    assert mgr.all_steps() == [1, 2, 3] and mgr.latest_step() == 3
    fresh = _state(seed=1)
    step, meta = mgr.restore_latest(fresh)
    assert (step, meta["step"]) == (3, 3)
    got = _arrays(fresh)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mgr.close()


def test_manager_keeps_the_last_k(tmp_path):
    st = _state()
    mgr = tcs.CheckpointManager(str(tmp_path), save_every=2, keep=2, handle_sigterm=False)
    saved = [s for s in range(1, 9) if mgr.maybe_save(s, st) is not None]
    assert saved == [2, 4, 6, 8] and mgr.all_steps() == [6, 8]
    assert mgr.maybe_save(8, st) is None  # a resume re-enters its step: already durable
    mgr.close()


def test_async_save_is_a_copy_taken_before_the_next_step(tmp_path):
    st = _state()
    _step(st, 1)
    before = _state()
    before.module.load_state_dict(st.module.state_dict())
    before.tx.load_state_dict(st.tx.state_dict())
    mgr = tcs.CheckpointManager(str(tmp_path), save_every=1, async_save=True,
                                handle_sigterm=False)
    mgr.save(1, st)
    _step(st, 2)  # in place, maybe while the writer runs
    mgr.wait()
    assert not mgr.in_flight and mgr.all_steps() == [1]
    assert tcs.runtime_stats["last_snapshot_s"] is not None
    fresh = _state(seed=5)
    assert mgr.restore_latest(fresh)[0] == 1
    _same_state(fresh, before)
    mgr.close()


def test_sigterm_forces_a_save_and_the_handler_chains(tmp_path):
    calls = []
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: calls.append(signum))
    try:
        st = _state()
        mgr = tcs.CheckpointManager(str(tmp_path), save_every=100)
        forced = tcs.runtime_stats["forced_saves"]
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.preempted and calls == [signal.SIGTERM]
        assert mgr.maybe_save(3, st) is not None and mgr.all_steps() == [3]
        assert not mgr.preempted and tcs.runtime_stats["forced_saves"] == forced + 1
        # the train.preempt site delivers the same signal at a chosen step
        install_plan(FaultPlan.from_json([{"site": "train.preempt", "at": 2,
                                           "action": "sigterm"}]))
        assert mgr.maybe_save(4, st) is None
        assert mgr.maybe_save(5, st) is not None and mgr.all_steps() == [3, 5]
        handler = signal.getsignal(signal.SIGTERM)
        mgr.close()
        assert handler == mgr._on_sigterm and signal.getsignal(signal.SIGTERM) is not handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert len(calls) == 3  # the previous handler is back
    finally:
        install_plan(None)
        signal.signal(signal.SIGTERM, prev)


def test_a_write_killed_in_the_writer_leaves_a_torn_dir_that_restore_skips(tmp_path, capsys):
    st = _state()
    mgr = tcs.CheckpointManager(str(tmp_path), save_every=1, async_save=True,
                                handle_sigterm=False)
    mgr.save(1, st)
    mgr.wait()
    install_plan(FaultPlan.from_json([{"site": "ckpt.write", "action": "raise"}]))
    try:
        mgr.save(2, st)
        mgr.wait()
    finally:
        install_plan(None)
    assert "background write" in capsys.readouterr().err
    assert "InjectedFault" in tcs.runtime_stats["last_write_error"]
    assert (tmp_path / "step_0000000002.tmp").is_dir() and mgr.all_steps() == [1]
    assert mgr.restore_latest(_state(seed=2))[0] == 1
    tcs.runtime_stats["last_write_error"] = None
    mgr.close()


def test_sharded_write_retries_an_outage_only(tmp_path):
    st = _state()
    fast = RetryPolicy(attempts=3, base_delay_s=0.0)
    install_plan(FaultPlan.from_json([{"site": "checkpoint.write", "action": "oserror"}]))
    try:
        tcs.save_sharded(str(tmp_path / "ok"), st, {"step": 7}, retry=fast)  # EIO once
    finally:
        install_plan(None)
    fresh = _state(seed=3)
    assert tcs.restore_sharded(str(tmp_path / "ok"), fresh) == {"step": 7}
    _same_state(fresh, st)
    install_plan(FaultPlan.from_json([{"site": "checkpoint.write", "action": "raise"}]))
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            tcs.save_sharded(str(tmp_path / "bad"), st, retry=fast)
    finally:
        install_plan(None)
    mgr = tcs.CheckpointManager(str(tmp_path / "mgr"), handle_sigterm=False)
    tcs.save_sharded(mgr._step_dir(4), st)  # a DCP dir counts as a step too
    assert mgr.all_steps() == [4] and mgr.restore_latest(_state(seed=4))[0] == 4
    mgr.close()
