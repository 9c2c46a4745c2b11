"""The port's ``TrainStep`` under each policy, over gloo ranks, against the
JAX ``TrainStep`` on a mesh of as many virtual devices.

The toy SwinIR (weights from JAX seed 0, carried with
``swinir_state_dict_from_jax``) takes three steps of MSE on the same
global batches of 8, clip 0.1, ``grad_accum_steps=2``: the JAX step on
``make_mesh(MeshSpec.zero(W))`` (``MeshSpec.ddp(W)`` for DDP), the port's
on W spawned ranks, rank r drawing rows ``r::W`` as ``DistributedSampler``
does. The mean gradient does not depend on which rank held which rows, so
the two runs compute the same update in a different sum order: losses
and grad norms agree to ~1e-6 relative (held at 1e-5) and parameters to
3.6e-7 (held at 1e-5 absolute, as ``test_torch_stoke.py``'s trajectory),
except the key part of each ``qkv.bias``. Its exact gradient is zero
(softmax is shift-invariant), so Adam (eps 1e-8) steps it from each
side's rounding noise alone, 5e-6 to 1.0e-5 apart after three steps; it
is held at ``KEY_BIAS_ATOL`` = 5e-5, 5 % of one step at lr 1e-3. Every
rank ends with bitwise the same parameters.

ZeRO-2 also runs at world 4 on a toy whose upsampling kernel's largest
dimension (18 channels) 4 does not divide: ``leaf_spec`` then shards its
12 output channels, beside leaves sharded along their largest dimension
(the first or the second) and leaves kept whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch.interop import swinir_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.parallel import leaf_spec
from test_torch_dist_workers import (TOY, run_ranks, sr_batches, toy_swinir,
                                     train_step_worker, train_steps_worker)

KEY_BIAS_ATOL = 5e-5
OPT = dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4, clip_grad_norm=0.1)
JAX_POLICIES = {"ddp": jparallel.DDP, "zero1": jparallel.ZeRO1, "zero2": jparallel.ZeRO2,
                "zero3": jparallel.ZeRO3}
# embed 18 (4 does not divide it), MLP 72: leaves shard along dim 0, dim 1, a
# smaller dim than the largest, or not at all
TOY_W4 = dict(TOY, depths=(2,), embed_dim=18, num_heads=(2,), mlp_ratio=4.0)


def _jax_run(policy: str, opt: str, world: int, toy: dict, batches: list, accum: int = 2):
    pol = JAX_POLICIES[policy]()
    spec = MeshSpec.ddp(world) if policy == "ddp" else MeshSpec.zero(world)
    mesh = make_mesh(spec, devices=jax.devices()[:world])
    model = JaxSwinIR(**toy)
    tx = joptim.FusedAdamW(**OPT) if opt == "fused" else joptim.adamw(**OPT)
    state, shardings = jparallel.create_train_state(
        model=model, sample_input=jnp.zeros((1, 8, 8, 3)), tx=tx, mesh=mesh, policy=pol)

    def loss_fn(params, batch, rng, model_state):
        return jnp.mean((model.apply({"params": params}, batch[0]) - batch[1]) ** 2), {}

    step = jparallel.TrainStep(loss_fn, tx, mesh, pol, grad_accum_steps=accum,
                               state_shardings=shardings, donate=False)
    p0 = jax.device_get(state.params)
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return p0, losses, norms, jax.device_get(state.params)


def numpy_state(params, toy) -> dict:
    return {k: v.numpy() for k, v in
            swinir_state_dict_from_jax(params, img_size=toy["img_size"]).items()}


def close_params(got: dict, want: dict) -> None:
    """Every parameter of ``got`` within 1e-5 of ``want``'s, the key third of
    each ``qkv.bias`` (``[q | k | v]``, no gradient) within ``KEY_BIAS_ATOL``."""
    for name, g in got.items():
        w = want[name]
        if name.endswith("qkv.bias"):
            c = g.shape[0] // 3
            np.testing.assert_allclose(g[c:2 * c], w[c:2 * c], atol=KEY_BIAS_ATOL, err_msg=name)
            g, w = np.concatenate([g[:c], g[2 * c:]]), np.concatenate([w[:c], w[2 * c:]])
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def _initial(toy: dict):
    """The JAX toy's parameters as ``create_train_state`` makes them (seed 0)."""
    return jax.device_get(JaxSwinIR(**toy).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8, 8, 3)))["params"])


def _check(ranks: list, policy: str, opt: str, world: int, toy: dict) -> None:
    p0, jl, jn, jp = _jax_run(policy, opt, world, toy, sr_batches(3))
    start = numpy_state(p0, toy)
    np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["norms"], jn, rtol=1e-5)
    close_params(ranks[0]["params"], numpy_state(jp, toy))
    assert max(np.abs(got - start[n]).max() for n, got in ranks[0]["params"].items()) > 1e-3
    if opt == "fused":  # the grads the step reduced are still the flat buffer's views
        assert all(r["views_bound"] for r in ranks)
    for other in ranks[1:]:  # replicas stay bitwise equal
        for name, got in other["params"].items():
            np.testing.assert_array_equal(got, ranks[0]["params"][name], err_msg=name)


LAYOUTS = [("ddp", "adamw"), ("zero1", "adamw"), ("zero2", "adamw"), ("zero3", "adamw"),
           ("ddp", "fused"), ("zero1", "fused")]


@pytest.fixture(scope="module")
def world2_runs():
    """Every layout's run at world 2, from one launch of two ranks."""
    runs = run_ranks(train_steps_worker, 2, runs=[dict(policy=p, opt=o) for p, o in LAYOUTS],
                     batches=sr_batches(3), state=numpy_state(_initial(TOY), TOY), toy=TOY)
    return {layout: [r[i] for r in runs] for i, layout in enumerate(LAYOUTS)}


@pytest.mark.parametrize("policy,opt", LAYOUTS, ids=[f"{p}-{o}" for p, o in LAYOUTS])
def test_train_step_at_world_2_matches_jax(world2_runs, policy, opt):
    _check(world2_runs[policy, opt], policy, opt, 2, TOY)


def test_zero2_at_world_4_matches_jax_with_every_leaf_spec_branch():
    shapes = {n: tuple(p.shape) for n, p in toy_swinir(toy=TOY_W4).named_parameters()}
    dims = {n: leaf_spec(s, "fsdp", 4) for n, s in shapes.items()}
    largest = {n: max(range(len(s)), key=lambda i: s[i]) for n, s in shapes.items()}
    kinds = {("whole" if d is None else "largest" if d == largest[n] else "smaller", d)
             for n, d in dims.items()}
    assert {("whole", None), ("largest", 0), ("largest", 1), ("smaller", 0)} <= kinds
    assert dims["upsample.0.weight"] == 0 and shapes["upsample.0.weight"][1] == 18
    ranks = run_ranks(train_step_worker, 4, policy="zero2", opt="adamw", batches=sr_batches(3),
                      state=numpy_state(_initial(TOY_W4), TOY_W4), toy=TOY_W4)
    _check(ranks, "zero2", "adamw", 4, TOY_W4)
