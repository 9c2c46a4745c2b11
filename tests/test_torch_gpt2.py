"""Port GPT-2 (training path) vs the JAX GPT-2, at ``GPT2Config.tiny`` widths.

Weights come from the JAX model's init and cross by
``interop.gpt2_state_dict_from_jax``; tokens from one numpy seed. The JAX
flash ``attn_fn`` runs the Pallas kernels in interpret mode; the port's runs
the plain versions of K3-K5 (CPU tensors). Parameters' gradients are
compared by name after the same carry-over (kernels transposed).

Tolerances (f32 unless stated): logits of magnitude ~0.7 agree to ~2e-7
and are held at 1e-4 through plain attention and at 2e-4 through flash
attention, as the JAX package's own flash-in-GPT-2 test holds them.
Losses agree to ~1e-7 (held at 1e-5), gradients to ~1e-7 against a
largest entry of ~0.2 (held at 1e-5). After two AdamW steps (lr 3e-4)
parameters are held at 1e-5: Adam divides each gradient by its own root
mean square, which amplifies the difference of near-zero entries, so the
bound is a few percent of one step. bf16 config: both sides round the same casts to bf16 but in
different sum orders; logits of magnitude ~0.7 agree to one bf16 step
there (2^-8 = 3.9e-3), held at 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributedtraining_tpu import optim as jax_optim
from pytorch_distributedtraining_tpu.models import gpt2 as jg
from pytorch_distributedtraining_tpu.ops.pallas_attn import make_flash_attn_fn as jax_flash
from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.interop import gpt2_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.ops.flash_attn import make_flash_attn_fn
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep

BATCH = 2


def _configs(t, dtype="f32"):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return jg.GPT2Config.tiny(n_positions=t, dtype=jdt), tg.GPT2Config.tiny(n_positions=t,
                                                                             dtype=tdt)


def _tokens(cfg, t, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, t)).astype(np.int32)


def _models(t, attn="default", dtype="f32"):
    """(jax model, jax params, port model with the same weights)."""
    jcfg, tcfg = _configs(t, dtype)
    jattn = jg.default_attention if attn == "default" else jax_flash(bq=64, bk=64,
                                                                      interpret=True)
    tattn = tg.default_attention if attn == "default" else make_flash_attn_fn(bq=64, bk=64)
    jmodel = jg.GPT2(jcfg, attn_fn=jattn)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tmodel = tg.GPT2(tcfg, attn_fn=tattn)
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params), strict=True)
    return jmodel, params["params"], tmodel


def _jax_loss(jmodel, tok):
    def loss(p):
        logits = jmodel.apply({"params": p}, tok)
        return jg.cross_entropy_loss(logits[:, :-1], tok[:, 1:])

    return loss


def _torch_loss(model, tokens):
    logits = model(tokens)
    return tg.cross_entropy_loss(logits[:, :-1], tokens[:, 1:]), {}


def test_state_dict_loads_strictly_with_hf_names():
    _, params, tmodel = _models(64)
    sd = gpt2_state_dict_from_jax({"params": params})
    result = tmodel.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(tmodel.state_dict())
    assert "transformer.h.1.attn.c_attn.weight" in sd and "transformer.wte.weight" in sd
    assert tuple(sd["transformer.h.0.mlp.c_fc.weight"].shape) == (128, 32)  # [out, in]


@pytest.mark.parametrize("attn,t,atol", [("default", 64, 1e-4), ("flash", 128, 2e-4)])
def test_logits_match(attn, t, atol):
    jmodel, params, tmodel = _models(t, attn)
    tok = _tokens(jmodel.cfg, t)
    want = jmodel.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == (BATCH, t, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("attn,ignore", [("default", False), ("flash", True)])
def test_loss_and_every_gradient_match(attn, ignore):
    t = 64
    jmodel, params, tmodel = _models(t, attn)
    tok = _tokens(jmodel.cfg, t)
    targets = tok[:, 1:].copy()
    if ignore:  # a run of padding tokens that the loss skips
        targets[:, -9:] = -100

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tok))
        return jg.cross_entropy_loss(logits[:, :-1], jnp.asarray(targets))

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    logits = tmodel(torch.from_numpy(tok))
    loss = tg.cross_entropy_loss(logits[:, :-1], torch.from_numpy(targets).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    want = gpt2_state_dict_from_jax(jax.device_get(want_grads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


def test_two_train_steps_match_the_optax_chain():
    """The slice as a whole: flash attention, cross entropy on shifted
    tokens, TrainStep and AdamW (lr 3e-4, clip 1.0) for two steps."""
    t = 64
    jmodel, params, tmodel = _models(t, "flash")
    tok = _tokens(jmodel.cfg, t)
    tx = jax_optim.adamw(lr=3e-4, clip_grad_norm=1.0)
    opt_state = tx.init(params)
    loss_fn = jax.value_and_grad(_jax_loss(jmodel, jnp.asarray(tok)))
    want_losses, want_norms = [], []
    for _ in range(2):
        loss, grads = loss_fn(params)
        want_losses.append(float(loss))
        want_norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    step = TrainStep(tmodel, _torch_loss,
                     optim.adamw(tmodel.parameters(), lr=3e-4, clip_grad_norm=1.0))
    batch = torch.from_numpy(tok)
    metrics = [step(batch) for _ in range(2)]
    np.testing.assert_allclose([m["loss"].item() for m in metrics], want_losses, atol=1e-5)
    np.testing.assert_allclose([m["grad_norm"].item() for m in metrics], want_norms, rtol=1e-4)
    want = gpt2_state_dict_from_jax(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_grad_accumulation_averages_micro_batches():
    """grad_accum_steps=2 on [4, T] gives the gradient of the mean of the
    two halves' losses, as the JAX step's scan does."""
    t = 32
    _, params, tmodel = _models(t)
    twin = tg.GPT2(tmodel.cfg)
    twin.load_state_dict(tmodel.state_dict())
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, t)).astype(np.int32))
    tx = optim.adamw(tmodel.parameters(), lr=3e-4, clip_grad_norm=1.0)
    m = TrainStep(tmodel, _torch_loss, tx, grad_accum_steps=2)(tok)
    halves = [_torch_loss(twin, tok[:2])[0], _torch_loss(twin, tok[2:])[0]]
    ((halves[0] + halves[1]) / 2).backward()
    norm = optim.AdamW.global_norm([p.grad for p in twin.parameters()])
    torch.testing.assert_close(m["loss"], (halves[0] + halves[1]).detach() / 2)
    torch.testing.assert_close(m["grad_norm"], norm, rtol=1e-5, atol=1e-7)


def test_bf16_config_keeps_a_bf16_residual_stream():
    t = 64
    jmodel, params, tmodel = _models(t, "flash", dtype="bf16")
    streams = []
    for block in tmodel.transformer.h:
        block.register_forward_hook(lambda mod, args, out: streams.append(out.dtype))
    tok = _tokens(jmodel.cfg, t)
    want = jmodel.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tok))
    assert streams == [torch.bfloat16] * tmodel.cfg.n_layer
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


@pytest.mark.parametrize("kw", [dict(decode=True, kv_wire="int8_block"),
                                dict(decode=True, paged=(4, 8), kv_wire="fp8_e4m3")])
def test_unported_serving_options_raise(kw):
    with pytest.raises(NotImplementedError, match="quantized-KV slice"):
        tg.GPT2(tg.GPT2Config.tiny(), **kw)


@pytest.mark.parametrize("cfg_kw", [dict(remat=True), dict(scan_layers=True), dict(fp8="e4m3"),
                                    dict(dropout=0.1), dict(tie_word_embeddings=False)])
def test_unported_config_options_raise(cfg_kw):
    with pytest.raises(NotImplementedError, match="not ported yet.*GPT-2 remainder slice"):
        tg.GPT2(tg.GPT2Config.tiny(**cfg_kw))
