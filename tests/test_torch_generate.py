"""The port's KV-cache decode and ``generate`` against the JAX package's.

GPT-2 ``tiny`` (n_embd 32, 4 heads, 64 positions, f32); the weights come
from the JAX model's init through ``interop.gpt2_state_dict_from_jax`` and
the tokens from numpy seeds. Tolerances: decode logits of magnitude ~0.5
agree with JAX's and with the port's own full forward to ~2e-7, held at
1e-5; greedy tokens are held equal. In bf16 both sides round the same casts
in different sum orders; logits agree to one bf16 step (2^-8 relative),
held at 1e-2. Sampling cannot match JAX's PRNG: the filters are held
instead, the port's ``filter_logits`` against the logits JAX's
``sample_logits`` hands to ``jax.random.categorical`` (the same ``-inf``
mask, kept values within 1e-6), and the tokens the port draws against the
set those filters keep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.models import gpt2 as jg
from pytorch_distributedtraining_tpu.models import generate as jgen
from pytorch_distributedtraining_tpu_torch.interop import gpt2_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import generate as tgen
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg

JCFG = jg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=64)
TCFG = tg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=64)
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return jg.GPT2(JCFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _port(params, cfg=TCFG, **kw):
    model = tg.GPT2(cfg, **kw)
    model.load_state_dict(gpt2_state_dict_from_jax(params), strict=True)
    return model


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, shape).astype(np.int32)


def _jax_paged_table(b, max_pages):
    return np.asarray(1 + np.arange(b)[:, None] * max_pages + np.arange(max_pages), np.int32)


def test_incremental_matches_full(params):
    """Token-by-token cached logits equal the port's full forward and JAX's."""
    tok = _tokens(0, (2, 12))
    want = np.asarray(jg.GPT2(JCFG).apply({"params": params}, jnp.asarray(tok)))
    full = _port(params)
    dec = _port(params, decode=True)
    cache = tgen.init_cache(dec, 2, 12)
    with torch.no_grad():
        ref = full(torch.from_numpy(tok)).numpy()
        inc = torch.cat([dec(torch.from_numpy(tok[:, i:i + 1]), cache) for i in range(12)],
                        dim=1).numpy()
    assert cache.position == 12
    np.testing.assert_allclose(inc, ref, atol=TOL)
    np.testing.assert_allclose(inc, want, atol=TOL)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_prefill_matches_full(params, layout):
    tok = _tokens(1, (1, 16))
    full = _port(params)
    dec = _port(params, decode=True)
    with torch.no_grad():
        ref = full(torch.from_numpy(tok)).numpy()
        if layout == "contiguous":
            cache = tgen.init_cache(dec, 1, 16)
            kw = [{}, {}]
        else:  # page 3 does not divide the chunks: mid-page writes
            cache = tgen.init_paged_cache(dec, 1 + 6, 3)
            table = torch.from_numpy(_jax_paged_table(1, 6))
            kw = [dict(page_table=table, lengths=torch.tensor([s])) for s in (0, 10)]
        got = torch.cat([dec(torch.from_numpy(tok[:, :10]), cache, **kw[0]),
                         dec(torch.from_numpy(tok[:, 10:]), cache, **kw[1])], dim=1).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)


def _jax_decode_logits(params, tok, layout, page=4):
    """JAX decode: a 7-token prefill, then one token a step."""
    b, t = tok.shape
    chunks = [tok[:, :7]] + [tok[:, i:i + 1] for i in range(7, t)]
    out = []
    if layout == "contiguous":
        model = jg.GPT2(JCFG, decode=True)
        cache = jgen.init_cache(model, b, t)
        for c in chunks:
            logits, mut = model.apply({"params": params, "cache": cache}, jnp.asarray(c),
                                      mutable=["cache"])
            cache = mut["cache"]
            out.append(np.asarray(logits))
        return np.concatenate(out, axis=1)
    max_pages = -(-t // page)
    model = jg.GPT2(JCFG, decode=True, paged=(1 + b * max_pages, page))
    pages = jgen.init_paged_cache(model, b, max_pages)
    table = jnp.asarray(_jax_paged_table(b, max_pages))
    start = 0
    for c in chunks:
        logits, mut = model.apply({"params": params, "pages": pages}, jnp.asarray(c),
                                  page_table=table, lengths=jnp.full((b,), start, jnp.int32),
                                  mutable=["pages"])
        pages = mut["pages"]
        start += c.shape[1]
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def _port_decode_logits(params, tok, layout, page=4, cfg=TCFG):
    b, t = tok.shape
    chunks = [tok[:, :7]] + [tok[:, i:i + 1] for i in range(7, t)]
    model = _port(params, cfg, decode=True)
    out = []
    with torch.no_grad():
        if layout == "contiguous":
            cache = tgen.init_cache(model, b, t)
            for c in chunks:
                out.append(model(torch.from_numpy(c), cache))
        else:
            max_pages = -(-t // page)
            cache = tgen.init_paged_cache(model, 1 + b * max_pages, page)
            table = torch.from_numpy(_jax_paged_table(b, max_pages))
            start = 0
            for c in chunks:
                out.append(model(torch.from_numpy(c), cache, page_table=table,
                                 lengths=torch.full((b,), start)))
                start += c.shape[1]
    return torch.cat(out, dim=1).float().numpy()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_logits_match_jax(params, layout):
    tok = _tokens(2, (2, 13))
    want = _jax_decode_logits(params, tok, layout)
    got = _port_decode_logits(params, tok, layout)
    assert got.shape == want.shape == (2, 13, TCFG.vocab_size)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_decode_logits_match_jax_bf16(params):
    """bf16 compute: cache, residual stream and scores in bf16 on both sides."""
    tok = _tokens(3, (2, 10))
    jcfg = jg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=64, dtype=jnp.bfloat16)
    tcfg = tg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=64, dtype=torch.bfloat16)
    model = jg.GPT2(jcfg, decode=True)
    cache = jgen.init_cache(model, 2, 10)
    want = []
    for c in (tok[:, :7], tok[:, 7:8], tok[:, 8:9], tok[:, 9:10]):
        logits, mut = model.apply({"params": params, "cache": cache}, jnp.asarray(c),
                                  mutable=["cache"])
        cache = mut["cache"]
        want.append(np.asarray(logits))
    got = _port_decode_logits(params, tok, "contiguous", cfg=tcfg)
    assert jax.tree_util.tree_leaves(cache)[0].dtype == jnp.bfloat16
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), atol=1e-2)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_greedy_generate_matches_jax(params, layout):
    prompt = _tokens(4, (2, 9))
    want = jgen.generate(jg.GPT2(JCFG, decode=True), params, jnp.asarray(prompt), 10,
                         temperature=0.0, kv_layout=layout, page_size=4)
    got = tgen.generate(_port(params, decode=True), prompt, 10, temperature=0.0,
                        kv_layout=layout, page_size=4)
    assert got.shape == (2, 19) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_generate_matches_contiguous_sampled(params):
    """One generator seed, both layouts: the same draws (page 3 does not
    divide the prompt, so writes start mid-page)."""
    model = _port(params, decode=True)
    prompt = _tokens(5, (3, 5))
    kw = dict(temperature=1.0, top_p=0.9)
    ref = tgen.generate(model, prompt, 8, generator=torch.Generator().manual_seed(11), **kw)
    paged = tgen.generate(model, prompt, 8, generator=torch.Generator().manual_seed(11),
                          kv_layout="paged", page_size=3, **kw)
    torch.testing.assert_close(paged, ref, rtol=0, atol=0)
    assert not torch.equal(ref[:, 5:], tgen.generate(model, prompt, 8, temperature=0.0)[:, 5:])


def _jax_filtered(monkeypatch, logits, **kw):
    """The logits JAX's ``sample_logits`` hands to the categorical draw."""
    seen = {}

    def capture(rng, filtered, axis=-1):
        seen["logits"] = np.asarray(filtered)
        return jnp.argmax(filtered, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), **kw)
    monkeypatch.undo()
    return seen["logits"]


FILTERS = [
    dict(top_k=2), dict(top_p=0.7), dict(top_k=3, top_p=0.75), dict(top_p=0.0),
    dict(top_p=1e-6), dict(top_p=1.0), dict(top_k=4), dict(top_k=999),
    dict(top_k=2, temperature=0.5),
]


@pytest.mark.parametrize("kw", FILTERS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_sample_filters_match_jax(monkeypatch, kw):
    """Hand-built logits (probs ~ [0.032, 0.087, 0.236, 0.643]) and a
    random [3, 50] batch: the same tokens dropped, the same values kept."""
    kw = dict(temperature=1.0, **kw) if "temperature" not in kw else kw
    rows = [np.log(np.asarray([[0.032, 0.087, 0.236, 0.643]], np.float32)),
            np.random.default_rng(6).normal(size=(3, 50)).astype(np.float32)]
    for logits in rows:
        want = _jax_filtered(monkeypatch, logits, **kw)
        got = tgen.filter_logits(torch.from_numpy(logits), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=1e-6)


@pytest.mark.parametrize("kw,kept", [(dict(top_k=2), {2, 3}), (dict(top_p=0.7), {2, 3}),
                                     (dict(top_k=3, top_p=0.75), {2, 3}),
                                     (dict(top_p=0.0), {3}), (dict(top_p=1e-6), {3}),
                                     (dict(top_k=999), {0, 1, 2, 3})])
def test_sampled_tokens_stay_in_the_kept_set(kw, kept):
    """400 draws per case reach every kept token and no dropped one."""
    logits = torch.log(torch.tensor([[0.032, 0.087, 0.236, 0.643]])).repeat(400, 1)
    g = torch.Generator().manual_seed(0)
    seen = set(tgen.sample_logits(logits, g, temperature=1.0, **kw).tolist())
    assert seen == kept


def test_greedy_is_argmax_and_draws_nothing():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 0.5]])
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert tgen.sample_logits(logits, g, temperature=0.0).tolist() == [1, 0]
    assert torch.equal(g.get_state(), state)


def test_length_cap_raises(params):
    model = _port(params, decode=True)
    with pytest.raises(ValueError, match="n_positions"):
        tgen.generate(model, np.zeros((1, 60), np.int32), 10, temperature=0.0)
    cache = tgen.init_cache(model, 1, 4)
    with pytest.raises(ValueError, match="past its length"):
        model(torch.zeros(1, 5, dtype=torch.long), cache)


def test_layout_and_mode_checks(params):
    model = _port(params, decode=True)
    with pytest.raises(ValueError, match="kv_layout"):
        tgen.generate(model, np.zeros((1, 4), np.int32), 2, kv_layout="ring")
    with pytest.raises(NotImplementedError, match="quantized-KV slice"):
        tgen.generate(model, np.zeros((1, 4), np.int32), 2, kv_layout="paged",
                      kv_wire="int8_block")
    with pytest.raises(ValueError, match="decode=True"):
        tgen.generate(_port(params), np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError, match="KV cache on every call"):
        model(torch.zeros(1, 4, dtype=torch.long))
    paged = _port(params, decode=True, paged=(5, 4))
    with pytest.raises(ValueError, match="page_table"):
        paged(torch.zeros(1, 4, dtype=torch.long), tgen.init_paged_cache(paged))
    with pytest.raises(ValueError, match="PagedKVCache"):
        paged(torch.zeros(1, 4, dtype=torch.long), tgen.init_cache(paged, 1, 8))
    for fn, args in ((tgen.quantize_kv, (None, None, 8)), (tgen.dequantize_kv, (None, None, None)),
                     (tgen.kv_scale_block, (None, 4, 8))):
        with pytest.raises(NotImplementedError, match="quantized-KV slice"):
            fn(*args)
