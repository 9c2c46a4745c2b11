"""The port's ResNet (``models/resnet.py``) against the JAX package's.

Tiny ResNets, ``stage_sizes=(1, 1)``, 8 filters, on 32x32 inputs, with
both stems (the CIFAR 3x3/1 stem, and the 7x7/2 stem with the 3x3/2 max
pool) and both blocks (Basic, Bottleneck), so every asymmetric ``SAME``
pad and the -inf max-pool pad run. Weights come from the JAX init (plus
seeded noise, so that the zero-initialised last BatchNorms carry signal)
through ``interop.resnet_state_dict_from_jax``; inputs from a numpy seed.

Tolerances (f32 on both sides): logits within 1e-5 of the largest logit,
parameter gradients within 1e-4 of the largest gradient entry (sums over
~4k elements of terms that cancel, in another order), running
statistics within 1e-6. The ``TrainStep`` runs (three AdamW steps at lr
1e-3) hold losses at 1e-5 relative and parameters at 1e-5 absolute
(1 % of a step), statistics at 1e-5.

Also here: flax's ``SAME`` pads and biased running variance against
torch's defaults (the traps the port must not fall into), the
accumulation rule (every micro-batch from the step's statistics, the
last one's update kept), remat updating the statistics once, the
torchvision state dict loading strictly into the port and, through JAX's
``RESNET*_KEY_MAP``, into the JAX model with the same logits, and a BN
model through both facades (statistics threaded micro to micro).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributedtraining_tpu import interop as jinterop
from pytorch_distributedtraining_tpu import optim as joptim
from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu import stoke as jstoke
from pytorch_distributedtraining_tpu.models import resnet as jresnet
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch import optim as toptim
from pytorch_distributedtraining_tpu_torch import parallel as tparallel
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.interop import resnet_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import resnet as tresnet
from test_interop_resnet import _synthesize

BLOCKS = {"basic": (jresnet.BasicBlock, tresnet.BasicBlock),
          "bottleneck": (jresnet.BottleneckBlock, tresnet.BottleneckBlock)}
CASES = [(stem, block) for stem in ("cifar", "imagenet") for block in BLOCKS]
IDS = [f"{stem}-{block}" for stem, block in CASES]
CLASSES = 10


def tiny(stem: str, block: str, **kw):
    """The JAX and the port's tiny ResNet of one case."""
    jb, tb = BLOCKS[block]
    common = dict(stage_sizes=(1, 1), num_classes=CLASSES, num_filters=8,
                  small_inputs=stem == "cifar")
    return jresnet.ResNet(block_cls=jb, **common, **kw), tresnet.ResNet(block_cls=tb, **common)


def jax_variables(jm, seed: int = 0):
    """JAX init, every parameter moved by seeded noise of 0.1."""
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
        np.float32), v["params"])
    return params, jax.device_get(v["batch_stats"])


def images(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, CLASSES, size=(n,)).astype(np.int32))


def close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("stem,block", CASES, ids=IDS)
def test_train_mode_logits_grads_and_stats_match_jax(stem, block):
    jm, tm = tiny(stem, block)
    params, stats = jax_variables(jm)
    x, _ = images(4)

    def f(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.mean(out ** 2), (out, mut["batch_stats"])

    (_, (want, new_stats)), grads = jax.value_and_grad(f, has_aux=True)(params)
    tm.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    got = tm(torch.from_numpy(x))  # a module in training mode: batch statistics
    got.square().mean().backward()

    close_rel(got.detach(), want, 1e-5)
    want_g = resnet_state_dict_from_jax(jax.device_get(grads), stats)
    scale = max(float(np.abs(g.numpy()).max()) for g in want_g.values() if g.is_floating_point())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    want_s = resnet_state_dict_from_jax(params, jax.device_get(new_stats))
    for name, b in tm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(b.numpy(), want_s[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            assert int(b) == 1, name  # num_batches_tracked: one update


@pytest.mark.parametrize("stem,block", CASES, ids=IDS)
def test_eval_mode_uses_the_running_statistics(stem, block):
    jm, tm = tiny(stem, block)
    params, _ = jax_variables(jm)
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda a: np.abs(rng.normal(size=a.shape)).astype(np.float32) + 0.5,
                         jax_variables(jm)[1])  # non-trivial running mean and variance
    x, _ = images(3, seed=4)
    want = jm.apply({"params": params, "batch_stats": stats}, x, train=False)
    tm.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    with torch.no_grad():
        by_flag = tm(torch.from_numpy(x), train=False)
        tm.eval()
        by_mode = tm(torch.from_numpy(x))
    close_rel(by_flag, want, 1e-5)
    assert torch.equal(by_flag, by_mode)
    assert all(torch.equal(b, before[n]) for n, b in tm.named_buffers())  # eval updates nothing


def test_same_padding_is_flax_asymmetric_pad():
    """flax pads ``total // 2`` before and the rest after: the 7x7/2 stem
    (2, 3) and every 3x3/2 window (0, 1) on even sizes; torch's even
    padding would shift each stride-2 window."""
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(7, 3, 2) == (1, 1)
    assert tresnet.same_pads(32, 3, 1) == (1, 1)
    assert tresnet.same_pads(32, 1, 2) == (0, 0)
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 4)).astype(np.float32)
    want = jax.device_get(jax.lax.reduce_window(  # flax's max_pool, padding "SAME"
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tresnet.max_pool_same(xt).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    even = F.max_pool2d(xt, 3, 2, 1).permute(0, 2, 3, 1)
    assert np.abs(even.numpy() - want).max() > 0.1  # the trap: torch's symmetric padding=1


def test_running_variance_is_flax_biased_variance():
    """After one update of a [4, 3, 3, 2] batch flax's running variance is
    0.9 + 0.1 x the biased variance; torch's BatchNorm2d stores the unbiased
    one (the trap)."""
    import flax.linen as nn

    x = np.random.default_rng(0).normal(size=(4, 3, 3, 2)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    want, mut = bn.apply(v, x, mutable=["batch_stats"])
    port = tresnet.BatchNorm(2)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, f"running_{name}").numpy(),
                                   np.asarray(mut["batch_stats"][name]), atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(2, momentum=0.1, eps=1e-5)
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(torch_bn.running_var.numpy() - np.asarray(mut["batch_stats"]["var"])).max() > 1e-3


def _ce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def _jax_train_step(jm, params, stats, batches, accum):
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    tx = joptim.adamw(lr=1e-3, clip_grad_norm=1.0)

    def init_fn(rng):
        return params, {"batch_stats": stats}

    def loss_fn(p, batch, rng, model_state):
        logits, mut = jm.apply({"params": p, **model_state}, batch[0], train=True,
                               mutable=["batch_stats"])
        return _ce(logits, batch[1]), {"model_state": mut}

    state, sh = jparallel.create_train_state(init_fn=init_fn, tx=tx, mesh=mesh,
                                             policy=jparallel.DDP())
    step = jparallel.TrainStep(loss_fn, tx, mesh, jparallel.DDP(), grad_accum_steps=accum,
                               state_shardings=sh, donate=False)
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params), jax.device_get(
        state.model_state["batch_stats"])


def _torch_loss(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y.long()), {}


@pytest.mark.parametrize("stem,block", [("cifar", "basic"), ("imagenet", "bottleneck")],
                         ids=["cifar-basic", "imagenet-bottleneck"])
def test_trainstep_accumulation_keeps_the_last_micro_batch_statistics(stem, block):
    """Three steps at ``grad_accum_steps=2``: JAX runs every micro-batch
    from the step's starting statistics and keeps the last one's update;
    the port's step gives the same losses, parameters and statistics,
    where torch's in-place BatchNorm left alone would update twice."""
    jm, tm = tiny(stem, block)
    params, stats = jax_variables(jm)
    batches = [images(8, seed=10 + i) for i in range(3)]
    losses, want_p, want_s = _jax_train_step(jm, params, stats, batches, accum=2)

    tm.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    step = tparallel.TrainStep(tm, _torch_loss,
                               toptim.adamw(tm.named_parameters(), lr=1e-3, clip_grad_norm=1.0),
                               grad_accum_steps=2)
    got = [float(step(tuple(torch.from_numpy(a) for a in b))["loss"]) for b in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    want = resnet_state_dict_from_jax(want_p, want_s)
    for name, t in tm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(t) == 3, name  # one update a step, not one a micro-batch
        else:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)

    # the trap is real: two forwards in a row end elsewhere than the
    # second micro-batch's update of the step's start
    x, _ = batches[0]
    seq, last = tiny(stem, block)[1], tiny(stem, block)[1]
    for m in (seq, last):
        m.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    seq(torch.from_numpy(x[:4]))
    seq(torch.from_numpy(x[4:]))
    last(torch.from_numpy(x[4:]))
    assert np.abs(seq.bn1.running_var.numpy() - last.bn1.running_var.numpy()).max() > 1e-3


def test_remat_recompute_updates_the_statistics_once():
    """Under ``remat='full'`` backward reruns the forward; the step keeps
    the forward's update, so the statistics equal the run without remat."""
    _, ref = tiny("cifar", "basic")
    _, ckpt = tiny("cifar", "basic")
    ckpt.load_state_dict(ref.state_dict())
    batch = tuple(torch.from_numpy(a) for a in images(4))
    for model, remat in ((ref, "none"), (ckpt, "full")):
        tparallel.TrainStep(model, _torch_loss, toptim.adamw(model.named_parameters(), lr=1e-3),
                            remat=remat)(batch)
    for (name, a), b in zip(ref.state_dict().items(), ckpt.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name,stage_sizes", [("18", (2, 2, 2, 2)), ("50", (3, 4, 6, 3))],
                         ids=["resnet18", "resnet50"])
def test_torchvision_state_dict_loads_into_both_packages(name, stage_sizes):
    """A state dict under torchvision's names and layouts (synthesized as
    the JAX interop test does, with ``num_batches_tracked``) loads strictly
    into the port; through JAX's ``RESNET{name}_KEY_MAP`` it loads into the
    JAX model, and both give the same eval logits. The port's own
    converter maps the loaded JAX trees back onto the same state dict."""
    jm = getattr(jresnet, f"ResNet{name}")(num_classes=CLASSES)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    template = {"params": v["params"], "batch_stats": v["batch_stats"]}
    sd = _synthesize(template, stage_sizes)
    tm = getattr(tresnet, f"ResNet{name}")(num_classes=CLASSES)
    tm.load_state_dict(sd, strict=True)
    loaded = jinterop.load_torch_into_template(
        jinterop._to_numpy_tree(sd), template, key_map=getattr(jresnet, f"RESNET{name}_KEY_MAP"),
        strict=True, param_key=None)
    x, _ = images(2, seed=5)
    want = jm.apply(loaded, x, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    close_rel(got, want, 1e-5)
    back = resnet_state_dict_from_jax(jax.device_get(loaded["params"]),
                                      jax.device_get(loaded["batch_stats"]))
    assert set(back) == set(sd)
    for k, t in sd.items():
        if t.is_floating_point():
            np.testing.assert_allclose(back[k].numpy(), t.numpy(), atol=1e-6, err_msg=k)


def _facade(mod, model, **extra):
    return mod.Stoke(
        model=model,
        optimizer=mod.StokeOptimizer(optimizer="AdamW",
                                     optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-4}),
        loss=extra.pop("loss"), batch_size_per_device=4, gpu=True,
        distributed=mod.DistributedOptions.ddp.value, grad_accum_steps=2,
        configs=[mod.DDPConfig(local_rank=None, convert_to_sync_batch_norm=True)],
        grad_clip=mod.ClipGradNormConfig(max_norm=1.0, norm_type=2.0), **extra)


def test_facade_threads_batch_norm_statistics_micro_to_micro():
    """Two optimizer steps at accum 2 through both facades (DDP layout,
    fused AdamW): the JAX facade threads ``model_state`` from one
    micro-batch to the next, as torch's in-place BatchNorm does. Losses,
    parameters and statistics agree; then the eval step (running
    statistics) gives the same loss."""
    jm, tm = tiny("imagenet", "basic")
    mesh = make_mesh(MeshSpec.ddp(1), devices=jax.devices()[:1])
    js = _facade(jstoke, jm, loss=_ce, mesh=mesh, sample_input=np.zeros((4, 32, 32, 3),
                                                                          np.float32))
    params, stats = jax_variables(jm)
    js.load_model_state({"params": params}, strict=True)
    ts = _facade(tstoke, tm, loss=lambda o, y: F.cross_entropy(o, y.long()), device="cpu")
    ts.load_model_state(resnet_state_dict_from_jax(params, stats))
    assert isinstance(ts._opt, toptim.FusedAdamW)

    micro = [images(4, seed=20 + i) for i in range(4)]
    got, want = [], []
    for s, out in ((js, want), (ts, got)):
        for x, y in micro:
            loss = s.loss(s.model(x), y)
            s.backward(loss)
            s.step()
            out.append(float(np.asarray(loss.detach() if hasattr(loss, "detach") else loss)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = resnet_state_dict_from_jax(jax.device_get(js.state.params),
                                     jax.device_get(js.state.model_state["batch_stats"]))
    for name, t in ts.model_access.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(t) == 4, name  # every micro-batch updated the statistics
        else:
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    x, y = images(4, seed=30)
    jeval = float(js.eval_step()(x, y)["loss"])
    teval = float(ts.eval_step()(x, y)["loss"])
    np.testing.assert_allclose(teval, jeval, rtol=1e-5)
    assert ts.model_access.training  # eval_step leaves the training mode as it was
