"""Named rematerialisation: the port's ``remat="names"`` and ``"offload"``
against JAX's ``names``.

The tagged set is JAX's ``CHECKPOINT_SAVED_NAMES`` (``attn_out``, the
softmax·V product before the output projection) in SwinIR, GPT-2 and ViT.
JAX's CPU backend cannot run ``offload`` (no pinned host memory space), so
the port's ``offload`` is held against JAX's ``names``: on the CPU it keeps
the same set, where on a card it keeps it in pinned host memory.

Tolerances are those of ``tests/test_torch_swinir_tails.py``: f32 on both
sides with different sum orders, outputs within 1e-5 and gradients within
1e-4 relative to the largest entry; GPT-2 within ``_grads_match``'s 1e-5
absolute (its tiny model's gradients are small). Against the port's own
run without remat, the recompute is the same arithmetic: 1e-6 relative,
bitwise for GPT-2 and ESPCN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.models import vit as jvit
from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.interop import vit_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config, Net, SwinIR
from pytorch_distributedtraining_tpu_torch.models.gpt2 import cross_entropy_loss
from pytorch_distributedtraining_tpu_torch.models import vit as tvit
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, remat as tremat
from test_torch_gpt2 import _grads_match, _jax_loss, _remainder_models, _tokens, _torch_loss
from test_torch_swinir_tails import (BODY, _assert_grads, _assert_out, _data, _jax_run, _pair,
                                     _torch_run)
from test_torch_vit import close_rel, images, jax_params

POLICIES = ["names", "offload"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _count_tags(fn) -> int:
    """How many tag ops ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is tremat.TAG_OP:
                seen.append(args[1])
            return func(*args, **(kwargs or {}))

    with Spy():
        fn()
    assert set(seen) <= set(tremat.CHECKPOINT_SAVED_NAMES)
    return len(seen)


@pytest.mark.parametrize("remat", POLICIES)
def test_swinir_matches_jax_names(remat):
    jmodel, params, tmodel = _pair(upscale=2, upsampler="pixelshuffle",
                                   jax_kw=dict(remat="names"), torch_kw=dict(remat=remat))
    assert tmodel.remat == remat
    x, y = _data(8, 2)
    jl, jout, jgrads = _jax_run(jmodel, params, x, y)
    tl, tout, tgrads = _torch_run(tmodel, x, y)
    _assert_out(tout, jout)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_grads(tgrads, jgrads)
    plain = SwinIR(**BODY, upsampler="pixelshuffle")
    plain.load_state_dict(tmodel.state_dict())
    _, pout, pgrads = _torch_run(plain, x, y)
    _assert_out(tout, pout, tol=1e-6)
    for name in pgrads:
        np.testing.assert_allclose(tgrads[name].numpy(), pgrads[name].numpy(), rtol=0,
                                   atol=1e-6 * max(1e-30, pgrads[name].abs().max().item()))


@pytest.mark.parametrize("remat", POLICIES)
def test_gpt2_matches_jax_names(remat):
    t = 32
    jmodel, params, loaded = _remainder_models(t, remat="names")
    tmodel = GPT2(GPT2Config.tiny(n_positions=t, remat=remat))
    plain = GPT2(GPT2Config.tiny(n_positions=t))
    for m in (tmodel, plain):
        m.load_state_dict(loaded.state_dict())
    tok = _tokens(jmodel.cfg, t)
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, jnp.asarray(tok))))(
        params)
    losses = [_torch_loss(m, torch.from_numpy(tok))[0] for m in (tmodel, plain)]
    for loss in losses:
        loss.backward()
    np.testing.assert_allclose(losses[0].item(), float(want_loss), rtol=1e-5)
    for (name, a), b in zip(plain.named_parameters(), tmodel.parameters()):
        assert torch.equal(a.grad, b.grad), name
    _grads_match(tmodel, want_grads)


@pytest.mark.parametrize("remat", POLICIES)
def test_vit_matches_jax_names(remat):
    jcfg = jvit.ViTConfig.tiny(remat="names")
    jm = jvit.ViT(jcfg)
    params = jax_params(jm, jcfg)
    x = images(jcfg)

    def f(p):
        out = jm.apply({"params": p}, x)
        return jnp.mean(out ** 2), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
    tm = tvit.ViT(tvit.ViTConfig.tiny(remat=remat))
    tm.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    got = tm(torch.from_numpy(x))
    got.square().mean().backward()
    close_rel(got.detach(), want, 1e-5)
    want_g = vit_state_dict_from_jax(jax.device_get(grads))
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("remat", POLICIES)
def test_the_saved_set_is_one_tag_an_attention(remat):
    """The forward of a names/offload model dispatches one ``attn_out`` tag
    a Swin layer or block, and none without remat (the tag is then its
    input itself); ``offload`` keeps that many tensors for the recompute."""
    x = torch.rand(2, 8, 8, 3)
    model = SwinIR(**BODY, upsampler="pixelshuffle", remat=remat)
    n_layers = sum(BODY["depths"])
    assert _count_tags(lambda: model(x)) == n_layers
    assert _count_tags(lambda: SwinIR(**BODY, upsampler="pixelshuffle")(x)) == 0
    tok = torch.randint(0, 256, (2, 16))
    gpt = GPT2(GPT2Config.tiny(remat=remat))
    assert _count_tags(lambda: gpt(tok)) == gpt.cfg.n_layer
    y = torch.rand(3)
    assert tremat.checkpoint_name(y, "attn_out") is y
    kept = []
    if remat == "offload":
        real = tremat._Keep

        class Recording(real):
            def __init__(self, saved):
                super().__init__(saved)
                kept.append(saved)

        tremat._Keep = Recording
        try:
            model(x).sum().backward()
        finally:
            tremat._Keep = real
        assert [len(s) for s in kept] == [1] * n_layers


@pytest.mark.parametrize("remat", POLICIES)
def test_a_model_without_tags_recomputes_as_full(remat):
    """ESPCN tags nothing: ``names`` and ``offload`` save nothing and give
    ``full``'s (and no remat's) gradients, bitwise, as JAX's ``names`` does
    on an untagged model."""
    g = torch.Generator().manual_seed(0)
    x, y = torch.rand(2, 8, 8, 3, generator=g), torch.rand(2, 16, 16, 3, generator=g)
    grads = {}
    for policy in ("none", "full", remat):
        torch.manual_seed(0)
        model = Net(upscale_factor=2)
        loss, _ = tremat.apply_remat(lambda m, b: (torch.mean((m(b[0]) - b[1]) ** 2), {}),
                                     policy)(model, (x, y))
        loss.backward()
        grads[policy] = [p.grad for p in model.parameters()]
    for policy in ("full", remat):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[policy])), policy


@pytest.mark.parametrize("remat", POLICIES)
def test_train_step_redraws_the_dropout_masks_in_the_recompute(remat):
    """GPT-2 with dropout 0.1 through ``TrainStep`` under names/offload
    remat (the step's and the model's): the recomputed blocks redraw the
    same masks, so two steps give the losses and weights of no remat,
    bitwise; the step counts the policy as recomputing."""

    def run(policy):
        model = GPT2(GPT2Config.tiny(dropout=0.1, remat=policy),
                     generator=torch.Generator().manual_seed(0))
        tx = optim.adamw(model.named_parameters(), lr=1e-2)

        def loss_fn(m, batch, key):
            logits = m(batch[:, :-1], deterministic=False, generator=key)
            return cross_entropy_loss(logits, batch[:, 1:]), {}

        step = TrainStep(model, loss_fn, tx, remat=policy, rng=5)
        g = torch.Generator().manual_seed(1)
        losses = [float(step(torch.randint(0, 256, (2, 17), generator=g))["loss"])
                  for _ in range(2)]
        return step, losses, [p.detach() for p in model.parameters()]

    step, losses, params = run(remat)
    assert step._recomputes
    _, want_losses, want_params = run("none")
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
