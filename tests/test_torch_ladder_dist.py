"""The ladder's image models through the port's ``TrainStep`` at world 2,
over gloo ranks, against the JAX ``TrainStep`` on a 2-device mesh.

The tiny CIFAR ResNet (Basic blocks, 8 filters) under ``DDP`` (flat
``FusedAdamW``, config 2's optimizer, and the per-leaf chain behind the
``DistributedDataParallel`` wrapper at ``grad_accum_steps=2``) and
``ZeRO2`` (per leaf, config 3's), and ``ViTConfig.tiny()`` under
``ZeRO3`` (FSDP2 over the encoder blocks and the root, config 5's). Three
steps of softmax cross entropy (AdamW lr 1e-3, clip 1.0) on global
batches of 8 from a numpy seed; rank r takes rows ``r::2``, as
``DistributedSampler`` does. Weights start from the JAX init plus seeded
noise (the zero-initialised last BatchNorm and ViT head would leave
gradients at rounding noise, which Adam steps as if they were signal).

JAX computes BatchNorm statistics over the global batch (``jit`` sees it
whole, ``tests/test_sync_bn.py``); the port's BatchNorm all-reduces them
over the data group, forward and backward. So both runs compute the same
step in another sum order: losses agree to 1e-5 relative, running
statistics to 1e-5 absolute, and both ranks end with bitwise the same
parameters and statistics. Parameters are held at 1e-5 absolute (1 % of
a step), with two allowances for Adam, which scales every gradient entry
to about one step whatever its size: an entry whose gradient is ~1e-8
(1e-5 of the leaf's largest, some conv taps here) is stepped from a value
whose last digits are sum-order noise, so up to 0.1 % of a leaf's entries
may differ by up to 1e-4; and the key third of each ViT
``in_proj_bias`` has an exact gradient of zero (softmax is invariant to a
shift of every key by the same bias), so Adam steps it from each side's
rounding noise alone (1.8e-4 apart here): it is held to the 3e-3 that
three steps at lr 1e-3 can move any entry. A control run of one rank on
its own half shows the global statistics differ from a local batch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu.models import resnet as jresnet
from pytorch_distributedtraining_tpu.models import vit as jvit
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch.interop import (resnet_state_dict_from_jax,
                                                           vit_state_dict_from_jax)
from test_torch_dist_workers import TINY_RESNET, image_steps_worker, run_ranks

RUNS = [dict(kind="resnet", policy="ddp", opt="fused", accum=1),
        dict(kind="resnet", policy="ddp", opt="adamw", accum=2),
        dict(kind="resnet", policy="zero2", opt="adamw", accum=1),
        dict(kind="vit", policy="zero3", opt="adamw", accum=1)]
IDS = [f"{r['kind']}-{r['policy']}-{r['opt']}-accum{r['accum']}" for r in RUNS]
JAX_POLICIES = {"ddp": jparallel.DDP, "zero2": jparallel.ZeRO2, "zero3": jparallel.ZeRO3}


def _models():
    return {"resnet": jresnet.ResNet(block_cls=jresnet.BasicBlock, **TINY_RESNET),
            "vit": jvit.ViT(jvit.ViTConfig.tiny())}


def _variables(kind, model, seed: int = 0):
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
        np.float32), v["params"])
    return params, ({"batch_stats": jax.device_get(v["batch_stats"])} if kind == "resnet"
                    else {})


def _state_dict(kind, params, model_state):
    if kind == "resnet":
        return resnet_state_dict_from_jax(params, model_state["batch_stats"])
    return vit_state_dict_from_jax(params)


def _batches(steps: int = 3, n: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=(n,)).astype(np.int32)) for _ in range(steps)]


def _jax_run(run, model, params, model_state, batches):
    pol = JAX_POLICIES[run["policy"]](min_shard_size=1)
    spec = MeshSpec.ddp(2) if run["policy"] == "ddp" else MeshSpec.zero(2)
    mesh = make_mesh(spec, devices=jax.devices()[:2])
    tx = (joptim.FusedAdamW(lr=1e-3, clip_grad_norm=1.0) if run["opt"] == "fused"
          else joptim.adamw(lr=1e-3, clip_grad_norm=1.0))

    def loss_fn(p, batch, rng, ms):
        x, y = batch
        if ms:
            logits, mut = model.apply({"params": p, **ms}, x, train=True,
                                      mutable=["batch_stats"])
            aux = {"model_state": mut}
        else:
            logits, aux = model.apply({"params": p}, x), {}
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), aux

    state, sh = jparallel.create_train_state(init_fn=lambda r: (params, model_state), tx=tx,
                                             mesh=mesh, policy=pol)
    step = jparallel.TrainStep(loss_fn, tx, mesh, pol, grad_accum_steps=run["accum"],
                               state_shardings=sh, donate=False)
    losses = []
    with mesh:
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params), jax.device_get(state.model_state)


@pytest.fixture(scope="module")
def world2():
    models = _models()
    variables = {k: _variables(k, m) for k, m in models.items()}
    states = {k: {n: t.numpy() for n, t in _state_dict(k, *v).items()}
              for k, v in variables.items()}
    ranks = run_ranks(image_steps_worker, 2, runs=RUNS, batches=_batches(), states=states)
    return models, variables, {i: [r[i] for r in ranks] for i in range(len(RUNS))}


@pytest.mark.parametrize("i", range(len(RUNS)), ids=IDS)
def test_image_train_step_at_world_2_matches_jax(world2, i):
    models, variables, runs = world2
    run, ranks = RUNS[i], runs[i]
    kind = run["kind"]
    losses, params, model_state = _jax_run(run, models[kind], *variables[kind], _batches())
    assert ranks[0]["opt"] == ("FusedAdamW" if run["opt"] == "fused" else "AdamW")
    if run["policy"] == "ddp" and run["opt"] == "adamw":
        assert ranks[0]["wrapped"] == "DistributedDataParallel"
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    want = {n: t.numpy() for n, t in _state_dict(kind, params, model_state).items()}
    start = {n: t.numpy() for n, t in _state_dict(kind, *variables[kind]).items()}
    for name, got in ranks[0]["buffers"].items():
        if name.endswith("num_batches_tracked"):
            assert int(got) == 3, name  # one update a step
        else:
            np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-5, err_msg=name)
    for name, got in ranks[0]["params"].items():
        diff = np.abs(got - want[name])
        if name.endswith("in_proj_bias"):
            d = diff.shape[0] // 3
            assert diff[d:2 * d].max() <= 3e-3, name  # the key third: no gradient
            diff = np.concatenate([diff[:d], diff[2 * d:]])
        assert diff.max() <= 1e-4 and (diff > 1e-5).mean() <= 1e-3, (name, diff.max())
    assert max(np.abs(g - start[n]).max() for n, g in ranks[0]["params"].items()) > 1e-3
    for name, got in {**ranks[1]["params"], **ranks[1]["buffers"]}.items():
        np.testing.assert_array_equal(got, {**ranks[0]["params"], **ranks[0]["buffers"]}[name],
                                      err_msg=name)  # the ranks stay bitwise equal


def test_global_batch_statistics_differ_from_a_rank_s_own():
    """Control: one step of one rank on its own half of the batch moves the
    running statistics elsewhere than the global batch does, so the match
    above is the synchronisation's, not a coincidence."""
    models = _models()
    params, ms = _variables("resnet", models["resnet"])
    x, _ = _batches(1)[0]
    _, global_ = models["resnet"].apply({"params": params, **ms}, x, train=True,
                                        mutable=["batch_stats"])
    _, local = models["resnet"].apply({"params": params, **ms}, x[0::2], train=True,
                                      mutable=["batch_stats"])
    diffs = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - b).max()), global_,
                                         local))
    assert max(diffs) > 1e-3
