"""Autoregressive generation: KV caches, paged attention, sampling.

Counterpart of ``pytorch_distributedtraining_tpu/models/generate.py``.
Chunked prompt prefill into GPT-2's KV caches (``GPT2(decode=True)``),
then one forward per new token; sampling is greedy, temperature, top-k or
top-p (nucleus).

The caches are explicit tensors that the caller allocates and the forward
updates in place, not state hidden in the module:

- **contiguous** (:class:`KVCache`, :func:`init_cache`): one
  ``[B, max_len, H, Dh]`` buffer per layer for K and for V, and one global
  write position; the whole batch advances in lockstep.
- **paged** (:class:`PagedKVCache`, :func:`init_paged_cache`): the
  serving layout (``serve/``). K/V live in a shared pool of fixed-size
  pages, ``[num_pages, page_size, H, Dh]`` per layer; each batch *slot*
  has a page table (physical page ids) and a length, so slots at
  different positions decode together and a finished slot's pages go back
  to the pool. Physical page 0 is the **null page**: unassigned page-table
  entries point at it, so writes from idle slots and bucket padding land
  in trash instead of another request's KV.

Write-before-read invariant (what makes padding and idle slots safe): every
call writes its chunk's K/V *before* it attends, and queries attend only
positions ``<= their own``. Padded tail positions of a bucketed prefill
chunk scatter garbage past the live length, but any later query at
position ``p`` first overwrites position ``p`` with its real K/V in the
same call, so garbage past the live length is overwritten before it is
read.

The cached and paged attention are plain PyTorch (the JAX package runs them
as stock XLA einsum and softmax): scores in the compute dtype scaled by
``1/sqrt(Dh)`` in q's dtype, positions ``kpos > qpos`` set to
``finfo.min``, softmax in f32, the product with V in the compute dtype.

Sampling draws from an explicit ``torch.Generator``, so a run repeats from
its seed; the draws cannot match JAX's PRNG, but the filters (top-k, top-p)
are the JAX function's (:func:`filter_logits`).

Quantized KV pages (``kv_wire``, :func:`quantize_kv`, :func:`dequantize_kv`,
:func:`kv_scale_block`) wait for the quantized-KV slice and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

QUANTIZED_KV = ("quantized KV pages ({}) are not ported yet (the quantized-KV slice): they "
                "need parallel/compressed.py's WireFormat")


@dataclass
class KVCache:
    """Contiguous KV cache: per layer ``k[i]``/``v[i]`` ``[B, max_len, H,
    Dh]`` in the model's compute dtype, and the global write position (the
    JAX model's single top-level counter)."""

    k: list
    v: list
    position: int = 0


@dataclass
class PagedKVCache:
    """Paged KV pool: per layer ``k[i]``/``v[i]`` ``[num_pages, page_size,
    H, Dh]``; page 0 is the null page."""

    k: list
    v: list


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: int | None = None, top_p: float | None = None) -> torch.Tensor:
    """``[B, V]`` logits divided by ``temperature``, with the tokens the
    top-k and top-p filters drop set to ``-inf`` (the JAX
    ``sample_logits`` filters, top-k first).

    ``top_k`` keeps the k highest logits and is clamped to the vocab, so
    ``top_k >= V`` filters nothing. ``top_p`` keeps the smallest prefix of
    the sorted distribution whose mass reaches p, and always the argmax:
    ``top_p <= 0`` degenerates to greedy.
    """
    logits = logits / temperature
    v = logits.shape[-1]
    if top_k is not None:
        top_k = min(int(top_k), v)
    want_k = top_k is not None and 0 < top_k < v
    want_p = top_p is not None and top_p < 1.0
    if not (want_k or want_p):
        return logits
    # one descending sort serves both filters
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    rank = torch.arange(v, device=logits.device)[None, :]
    neg_inf = torch.tensor(-math.inf, dtype=logits.dtype, device=logits.device)
    if want_k:
        kth = sorted_desc[:, top_k - 1][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
        sorted_desc = torch.where(rank < top_k, sorted_desc, neg_inf)
    if want_p:
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the mass before them is < p; the argmax always
        keep = (cum - probs < top_p) | (rank == 0)
        cutoff = torch.where(keep, sorted_desc, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None, *,
                  temperature: float = 1.0, top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """``[B, V]`` logits -> ``[B]`` token ids (int64); temperature 0 is
    greedy. Otherwise one categorical draw per row from the filtered
    distribution (:func:`filter_logits`), from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits.float(), temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _kv_shape(model) -> tuple[int, int, torch.dtype, torch.device]:
    cfg = model.cfg
    device = model.transformer.wte.weight.device
    return cfg.n_head, cfg.n_embd // cfg.n_head, cfg.dtype, device


def init_cache(model, batch_size: int, max_len: int) -> KVCache:
    """Zero contiguous cache for ``batch_size`` x ``max_len`` on the
    model's device, in its compute dtype."""
    h, dh, dtype, device = _kv_shape(model)
    shape = (batch_size, max_len, h, dh)
    n = model.cfg.n_layer
    return KVCache([torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
                   [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)])


def init_paged_cache(model, num_pages: int | None = None,
                     page_size: int | None = None) -> PagedKVCache:
    """Zero page pool, ``num_pages`` x ``page_size`` (default: the
    model's ``paged=(num_pages, page_size)``), per layer."""
    if num_pages is None or page_size is None:
        if model.paged is None:
            raise ValueError("init_paged_cache needs (num_pages, page_size) or a model "
                             "built with paged=")
        num_pages, page_size = model.paged
    h, dh, dtype, device = _kv_shape(model)
    shape = (num_pages, page_size, h, dh)
    n = model.cfg.n_layer
    return PagedKVCache([torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
                        [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)])


def kv_scale_block(fmt, n_head: int, head_dim: int) -> int:
    raise NotImplementedError(QUANTIZED_KV.format("kv_scale_block"))


def quantize_kv(x, fmt, block: int):
    raise NotImplementedError(QUANTIZED_KV.format("quantize_kv"))


def dequantize_kv(payload, scales, dtype):
    raise NotImplementedError(QUANTIZED_KV.format("dequantize_kv"))


def _scale(q: torch.Tensor) -> torch.Tensor:
    return torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)


def _masked_attention(q, keys, values, qpos, kpos, softmax_dtype=torch.float32):
    """Causal attention of ``q`` ``[B, T, H, Dh]`` against ``keys``/``values``
    ``[B, L, H, Dh]``: keys at ``kpos > qpos`` are masked. ``qpos``
    ``[B, T]`` or ``[T]``, ``kpos`` ``[L]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, keys) / _scale(q)
    if qpos.dim() == 1:
        qpos = qpos[None]
    masked = kpos[None, None, :] > qpos[:, :, None]  # [B, T, L]
    logits = logits.masked_fill(masked[:, None], torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(softmax_dtype), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, values)


def cached_attention(q, k, v, k_cache, v_cache, position: int):
    """One step against a contiguous layer cache: write ``k``/``v``
    ``[B, T, H, Dh]`` at ``position`` (in place), then attend ``q`` against
    the whole buffer with the causal mask at global positions."""
    t, max_len = q.shape[1], k_cache.shape[1]
    if position + t > max_len:
        raise ValueError(f"cache write at {position}..{position + t - 1} past its length "
                         f"{max_len}")
    k_cache[:, position:position + t] = k
    v_cache[:, position:position + t] = v
    qpos = position + torch.arange(t, device=q.device)
    kpos = torch.arange(max_len, device=q.device)
    return _masked_attention(q, k_cache, v_cache, qpos, kpos)


def _positions(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return lengths.long()[:, None] + torch.arange(t, device=lengths.device)[None, :]


def write_paged_kv(k_pages, v_pages, k, v, page_table, lengths):
    """Scatter a chunk's K/V into the page pool at each slot's position,
    in place.

    ``k_pages``/``v_pages``: ``[num_pages, page_size, H, Dh]``; ``k``/``v``:
    ``[B, T, H, Dh]`` for positions ``lengths[b] .. lengths[b]+T-1`` of
    slot ``b``; ``page_table``: ``[B, max_pages]`` physical page ids;
    ``lengths``: ``[B]``. A position's page index is clipped to the table,
    and positions past a slot's allocated pages resolve to the null page
    (rows are 0-padded), so bucket padding never reaches another slot's KV.
    Several rows may land on the null page in one call; which of them it
    keeps is unspecified, as in JAX. Returns ``(k_pages, v_pages)``.
    """
    page = k_pages.shape[1]
    pos = _positions(lengths, k.shape[1])
    slot_page = torch.clamp(pos // page, 0, page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, slot_page)  # [B, T]
    off = pos % page
    k_pages[phys, off] = k.to(k_pages.dtype)
    v_pages[phys, off] = v.to(v_pages.dtype)
    return k_pages, v_pages


def paged_attention(q, k_pages, v_pages, page_table, lengths, softmax_dtype=torch.float32):
    """Causal attention of ``q`` ``[B, T, H, Dh]`` (at positions
    ``lengths[b] .. lengths[b]+T-1``) against each slot's gathered pages,
    a ``[B, max_pages*page, H, Dh]`` view: keys past the query's position
    are masked; those inside are written (the write-before-read invariant)."""
    b, t, h, dh = q.shape
    page = k_pages.shape[1]
    max_len = page_table.shape[1] * page
    table = page_table.long()
    gk = k_pages[table].reshape(b, max_len, h, dh)
    gv = v_pages[table].reshape(b, max_len, h, dh)
    kpos = torch.arange(max_len, device=q.device)
    return _masked_attention(q, gk, gv, _positions(lengths, t), kpos, softmax_dtype)


def _check_layout(kv_layout: str, kv_wire) -> None:
    if kv_layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    if kv_wire is not None:
        raise NotImplementedError(QUANTIZED_KV.format(f"kv_wire={kv_wire!r}"))


@torch.inference_mode()
def generate(model, prompt, max_new_tokens: int, *, generator: torch.Generator | None = None,
             temperature: float = 1.0, top_k: int | None = None, top_p: float | None = None,
             kv_layout: str = "contiguous", page_size: int = 8, kv_wire=None) -> torch.Tensor:
    """``[B, T_prompt + max_new_tokens]`` tokens (prompt included), on the
    model's device.

    ``model`` is a ``GPT2(decode=True)``; its ``n_positions`` bounds the
    total length. One prefill of the whole prompt samples the first new
    token, then one forward per token. ``kv_layout="paged"`` runs the same
    loop against a paged pool, each row owning a contiguous run of pages
    after the null page: the like-for-like proof that the serving engine's
    cache is token-identical to the contiguous one. ``generator`` (default:
    one seeded with 0 on the model's device) drives the sampling; greedy
    (``temperature=0``) draws nothing.
    """
    if not model.decode:
        raise ValueError("generate() needs a model built with decode=True")
    _check_layout(kv_layout, kv_wire)
    device = model.transformer.wte.weight.device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, t_prompt = prompt.shape
    total = t_prompt + max_new_tokens
    if total > model.cfg.n_positions:
        raise ValueError(f"prompt+new = {total} exceeds n_positions {model.cfg.n_positions}")
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    if kv_layout == "paged":
        max_pages = math.ceil(total / page_size)
        cache = init_paged_cache(model, 1 + b * max_pages, page_size)
        # page 0 is the null page; row i owns pages 1 + i*max_pages ...
        table = (1 + torch.arange(b, device=device)[:, None] * max_pages
                 + torch.arange(max_pages, device=device)[None, :])
        lengths = torch.zeros(b, dtype=torch.long, device=device)

        def step(tokens):
            nonlocal lengths
            logits = model(tokens, cache, page_table=table, lengths=lengths)
            lengths = lengths + tokens.shape[1]
            return logits
    else:
        if model.paged is not None:
            raise ValueError("a model built with paged= takes kv_layout='paged'")
        cache = init_cache(model, b, total)

        def step(tokens):
            return model(tokens, cache)

    out = [prompt]
    tok = sample_logits(step(prompt)[:, -1], generator, **kw)
    for _ in range(max_new_tokens - 1):
        out.append(tok[:, None])
        tok = sample_logits(step(tok[:, None])[:, -1], generator, **kw)
    out.append(tok[:, None])
    return torch.cat(out, dim=1)
