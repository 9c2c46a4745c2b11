"""Port GPT-2 (training path) vs the JAX GPT-2, at ``GPT2Config.tiny`` widths.

Weights come from the JAX model's init and cross by
``interop.gpt2_state_dict_from_jax``; tokens from one numpy seed. The JAX
flash ``attn_fn`` runs the Pallas kernels in interpret mode; the port's runs
the plain versions of K3-K5 (CPU tensors). Parameters' gradients are
compared by name after the same carry-over (kernels transposed).

Also the options the GPT-2 training path takes beyond config 4: an untied
``lm_head``, per-block remat and dropout (with JAX's own masks), and HF's
head in ``gpt2_state_dict_from_hf``.

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
from pytorch_distributedtraining_tpu_torch.interop import (gpt2_state_dict_from_hf,
                                                          gpt2_state_dict_from_jax)
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


UNPORTED = {"scan_layers": "scan_layers .*scan-over-layers slice.*not ported yet",
            "fp8": "fp8 .*fp8 matmul slice.*not ported yet"}


@pytest.mark.parametrize("cfg_kw", [dict(scan_layers=True), dict(fp8="e4m3")])
def test_unported_config_options_raise(cfg_kw):
    ((key, value),) = cfg_kw.items()
    with pytest.raises(NotImplementedError, match=UNPORTED[key]):
        tg.GPT2(tg.GPT2Config.tiny(**cfg_kw))


# -- the untied head, remat and dropout --------------------------------------
#
# Same weights (JAX init through ``gpt2_state_dict_from_jax``), the file's
# tolerances: logits 1e-4, gradients 1e-5. Dropout is compared with JAX's own
# masks, captured in call order (embedding, then each block's c_proj and
# mlp_proj: the port's sites 0, 1 + 2i, 2 + 2i) and fed to the port through a
# mask source in place of its DropoutKey.


def capture_jax_masks(fn):
    """Run ``fn()`` with every active flax ``nn.Dropout`` drawing its mask as
    flax does (one ``make_rng``, ``bernoulli`` of keep), recorded in call
    order; returns ``(fn(), masks)``."""
    import flax.linen as nn

    masks = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else mod.deterministic)
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        rng = mod.make_rng(mod.rng_collection)
        masks.append(np.array(jax.random.bernoulli(rng, 1.0 - mod.rate, args[0].shape)))
        return next_fun(args[0], det, rng=rng)

    with nn.intercept_methods(interceptor):
        out = fn()
    return out, masks


class ReplayMasks:
    """A port mask source that hands out captured JAX masks by site."""

    def __init__(self, masks):
        self.masks = masks
        self.sites = []

    def mask(self, site, shape, keep, device):
        self.sites.append(site)
        m = torch.from_numpy(self.masks[site]).to(device)
        assert tuple(m.shape) == tuple(shape)
        return m


def _remainder_models(t, **cfg_kw):
    jcfg = jg.GPT2Config.tiny(n_positions=t, **cfg_kw)
    tcfg = tg.GPT2Config.tiny(n_positions=t, **cfg_kw)
    jmodel = jg.GPT2(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tmodel = tg.GPT2(tcfg)
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params), strict=True)
    return jmodel, params["params"], tmodel


def _grads_match(tmodel, want_grads, atol=1e-5):
    want = gpt2_state_dict_from_jax(jax.device_get(want_grads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=atol, err_msg=name)


def test_untied_head_logits_and_gradients_match():
    t = 32
    jmodel, params, tmodel = _remainder_models(t, tie_word_embeddings=False)
    assert "lm_head" in params and tuple(params["lm_head"]["kernel"].shape) == (32, 256)
    assert tuple(tmodel.lm_head.weight.shape) == (256, 32)  # [vocab, n_embd]
    tok = _tokens(jmodel.cfg, t)
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, jnp.asarray(tok))))(
        params)
    logits = tmodel(torch.from_numpy(tok))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jmodel.apply({"params": params}, jnp.asarray(tok))),
                               atol=1e-4)
    loss = _torch_loss(tmodel, torch.from_numpy(tok))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _grads_match(tmodel, want_grads)


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_matches_no_remat_and_jax(remat):
    """Per-block remat: the same gradients as no remat (bitwise on the CPU:
    the recompute runs the same ops) and as JAX's remat model (1e-5)."""
    t = 32
    jmodel, params, tmodel = _remainder_models(t, remat=remat)
    plain = tg.GPT2(tg.GPT2Config.tiny(n_positions=t))
    plain.load_state_dict(tmodel.state_dict())
    tok = _tokens(jmodel.cfg, t)
    _, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, jnp.asarray(tok))))(params)
    for m in (tmodel, plain):
        _torch_loss(m, torch.from_numpy(tok))[0].backward()
    for (name, a), b in zip(plain.named_parameters(), tmodel.parameters()):
        assert torch.equal(a.grad, b.grad), name
    _grads_match(tmodel, want_grads)


def test_dropout_is_off_unless_asked():
    """Rate 0.1 with ``deterministic=True`` (the default, as in JAX): the
    JAX model's deterministic logits, no generator needed."""
    t = 32
    jmodel, params, tmodel = _remainder_models(t, dropout=0.1)
    tok = _tokens(jmodel.cfg, t)
    want = jmodel.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="generator"):
        tmodel(torch.from_numpy(tok), deterministic=False)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(tie_word_embeddings=False, remat=True)])
def test_dropout_with_jax_masks_matches_logits_and_gradients(cfg_kw):
    t = 32
    jmodel, params, tmodel = _remainder_models(t, dropout=0.1, **cfg_kw)
    tok = _tokens(jmodel.cfg, t)
    key = jax.random.PRNGKey(7)

    def jloss(model):
        def loss(p):
            logits = model.apply({"params": p}, jnp.asarray(tok), deterministic=False,
                                 rngs={"dropout": key})
            return jg.cross_entropy_loss(logits[:, :-1], jnp.asarray(tok)[:, 1:]), logits
        return loss

    # the masks from the same config without remat (flax's remat traces the
    # block, so its masks are tracers), the reference numbers from the config
    # itself: flax derives a dropout rng from the module path, remat or not
    plain = jg.GPT2(jg.GPT2Config.tiny(n_positions=t, dropout=0.1,
                                       **dict(cfg_kw, remat=False)))
    _, masks = capture_jax_masks(lambda: plain.apply({"params": params}, jnp.asarray(tok),
                                                     deterministic=False,
                                                     rngs={"dropout": key}))
    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(jloss(jmodel),
                                                                      has_aux=True))(params)
    assert len(masks) == 1 + 2 * tmodel.cfg.n_layer
    assert 0.85 < np.mean([m.mean() for m in masks]) < 0.95
    source = ReplayMasks(masks)
    logits = tmodel(torch.from_numpy(tok), deterministic=False, generator=source)
    loss = tg.cross_entropy_loss(logits[:, :-1], torch.from_numpy(tok)[:, 1:])
    loss.backward()
    assert sorted(set(source.sites)) == list(range(len(masks)))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _grads_match(tmodel, want_grads)


@pytest.mark.parametrize("tied", [True, False])
def test_hf_head_kept_for_an_untied_config_only(tied):
    model = tg.GPT2(tg.GPT2Config.tiny(tie_word_embeddings=tied),
                    generator=torch.Generator().manual_seed(0))
    hf = {k: v.clone() for k, v in model.state_dict().items()}
    if tied:
        hf["lm_head.weight"] = hf["transformer.wte.weight"].clone()
    for k in [k for k in hf if k.endswith(("c_attn.weight", "c_proj.weight", "c_fc.weight"))]:
        hf[k] = hf[k].t().contiguous()  # HF Conv1D [in, out]
    hf["transformer.h.0.attn.bias"] = torch.ones(1, 1, 64, 64)
    sd = gpt2_state_dict_from_hf(hf, tie_word_embeddings=tied)
    assert ("lm_head.weight" in sd) == (not tied)
    twin = tg.GPT2(tg.GPT2Config.tiny(tie_word_embeddings=tied))
    twin.load_state_dict(sd, strict=True)
    tok = torch.from_numpy(_tokens(model.cfg, 16))
    with torch.no_grad():
        torch.testing.assert_close(twin(tok), model(tok), rtol=0, atol=0)


@pytest.mark.parametrize("tied", [True, False])
def test_jax_hf_export_loads_into_the_port(tied):
    """JAX's HF export (``interop.torch_gpt2_state_dict``: Conv1D ``[in,
    out]`` linears, an untied ``lm_head`` as ``nn.Linear`` ``[vocab,
    n_embd]``, a tied one as a copy of ``wte``) read by
    ``gpt2_state_dict_from_hf`` gives the JAX model's logits (the file's
    1e-4)."""
    from pytorch_distributedtraining_tpu import interop as jinterop

    t = 32
    jmodel, params, _ = _remainder_models(t, tie_word_embeddings=tied)
    hf = jinterop.torch_gpt2_state_dict(params)
    assert "lm_head.weight" in hf
    model = tg.GPT2(tg.GPT2Config.tiny(n_positions=t, tie_word_embeddings=tied))
    model.load_state_dict(gpt2_state_dict_from_hf(hf, tie_word_embeddings=tied), strict=True)
    tok = _tokens(jmodel.cfg, t)
    with torch.no_grad():
        got = model(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.apply({"params": params}, jnp.asarray(tok))),
                               atol=1e-4)
