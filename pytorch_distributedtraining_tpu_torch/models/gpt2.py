"""GPT-2 causal LM: the training path (ladder config 4, "GPT-2 125M") and
KV-cache decode, contiguous or paged, for ``models.generate`` and ``serve``.

Counterpart of ``pytorch_distributedtraining_tpu/models/gpt2.py``:
decoder-only, pre-LN (LayerNorm eps 1e-5), learned positions, fused QKV
projection, tanh GELU, an LM head tied to ``wte`` (or, with
``tie_word_embeddings=False``, a bias-free ``lm_head`` of ``[vocab,
n_embd]``) and a pluggable ``attn_fn``
(``ops.flash_attn.make_flash_attn_fn`` routes it through the CUDA flash
kernels). Module names are HF ``GPT2LMHeadModel``'s
(``transformer.h.{i}.attn.c_attn``, ``transformer.wte``, ...), the names
the JAX package's ``GPT2_EXPORT_KEY_MAP`` targets; linear weights are
``nn.Linear``'s ``[out, in]``.

Precision follows flax's cast points, not autocast: parameters are f32;
with ``cfg.dtype`` bf16 the embedding sum is cast to bf16, so the residual
stream is bf16 throughout; dense layers compute in bf16; LayerNorm takes
its statistics in f32 and returns bf16; the logits are ``x @ wteᵀ`` in
bf16, cast to f32.

Dropout (``cfg.dropout``) runs only when ``forward(..., deterministic=False,
generator=...)`` asks, JAX's default: after the embedding sum, after the
attention's ``c_proj`` and after the MLP's ``c_proj`` (JAX's ``mlp_proj``),
each with its own site in :func:`~..parallel.rng.dropout`'s key, none on
the attention probabilities (the JAX model has none there, so ``attn_fn``
and the flash kernels stay as they are). ``cfg.remat`` checkpoints each
block under a ``parallel.remat`` policy (``True``/``'full'``, ``'dots'``,
``'names'`` or ``'offload'``, as JAX's ``remat_block``); the attention's
output before ``c_proj`` carries JAX's ``attn_out`` tag, the set
``'names'`` saves and ``'offload'`` keeps on the host. A recomputed block
redraws the same masks, which are fixed by the key and the site.

``decode=True`` takes a KV cache on every call (``models.generate``): a
:class:`~.generate.KVCache` (contiguous, one global write position, the
JAX model's ``"cache"`` collection) or a :class:`~.generate.PagedKVCache`
with ``page_table`` ``[B, max_pages]`` and ``lengths`` ``[B]`` (per-slot
positions, the JAX ``"pages"`` collection; ``paged=(num_pages,
page_size)`` sizes ``init_paged_cache``'s pool and makes the paged layout
the only one the model takes). The forward writes the chunk's K/V into
the cache in place and attends it with plain PyTorch, as the JAX Block
does with ``_cached_attention``/``_paged_attention``; ``attn_fn`` (and the
flash kernels) serve the cache-less forward only.

Not ported yet, and raising ``NotImplementedError``: quantized KV pages
(``kv_wire``; the quantized-KV slice), ``fp8`` dense layers (the fp8
matmul slice) and ``scan_layers`` (the scan-over-layers slice).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.remat import apply_remat, checkpoint_name, resolve_remat
from ..parallel.rng import as_key, dropout
from .generate import (QUANTIZED_KV, KVCache, PagedKVCache, cached_attention,
                       paged_attention, write_paged_kv)

AttnFn = Callable[..., torch.Tensor]  # (q, k, v, *, causal) -> out
# the stddev of a unit normal truncated to [-2, 2]: flax's truncated_normal
# variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    tie_word_embeddings: bool = True
    remat: bool | str = False
    scan_layers: bool = False
    fp8: str | None = None

    @staticmethod
    def gpt2_125m() -> "GPT2Config":
        return GPT2Config()  # the 125M point is the default config

    @staticmethod
    def gpt2_medium() -> "GPT2Config":  # 350M
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16)

    @staticmethod
    def gpt2_large() -> "GPT2Config":  # 774M
        return GPT2Config(n_embd=1280, n_layer=36, n_head=20)

    @staticmethod
    def gpt2_xl() -> "GPT2Config":  # 1.5B
        return GPT2Config(n_embd=1600, n_layer=48, n_head=25)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        base = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2,
                    n_head=2, dtype=torch.float32)
        base.update(kw)
        return GPT2Config(**base)


def default_attention(q, k, v, *, causal: bool = True):
    """Plain softmax attention, the XLA default's counterpart: scores in the
    input dtype, softmax in f32. q/k/v: ``[B, T, H, Dh]`` -> ``[B, T, H, Dh]``."""
    dh = q.shape[-1]
    # the scale filled on the device (a captured graph refuses a copy from
    # pageable host memory), rounded to the input dtype as XLA's
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.full(
        (), math.sqrt(dh), dtype=q.dtype, device=q.device)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics, output in ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, cfg.mlp_ratio * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.mlp_ratio * cfg.n_embd, cfg.n_embd)


class Block(nn.Module):
    """Pre-LN transformer block: LN → attn → +res, LN → MLP → +res."""

    def __init__(self, cfg: GPT2Config, attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.attn = Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.mlp = MLP(cfg)

    def forward(self, x, cache=None, layer: int = 0, page_table=None, lengths=None,
                key=None, deterministic: bool = True):
        """``cache`` (with this block's ``layer`` index) switches to KV-cache
        decode: contiguous at ``cache.position``, or paged at each slot's
        ``lengths`` through ``page_table``. ``key`` draws the dropout masks
        of this block's two sites, ``1 + 2 * layer`` and ``2 + 2 * layer``."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, t, d = x.shape
        h = cfg.n_head
        y = _layer_norm(self.ln_1, x, dt)
        qkv = _dense(self.attn.c_attn, y, dt)
        # views of the fused projection, [B, T, H, Dh]: the flash kernels
        # read them through strides, without copies
        q, k, v = (a.unflatten(-1, (h, d // h)) for a in qkv.split(d, dim=-1))
        if cache is None:
            y = self.attn_fn(q, k, v, causal=True)
        elif isinstance(cache, PagedKVCache):
            kp, vp = write_paged_kv(cache.k[layer], cache.v[layer], k, v, page_table, lengths)
            y = paged_attention(q, kp, vp, page_table, lengths)
        else:
            y = cached_attention(q, k, v, cache.k[layer], cache.v[layer], cache.position)
        # the named-remat tag ("names"/"offload"): save softmax·V
        y = checkpoint_name(y, "attn_out").reshape(b, t, d)
        y = dropout(_dense(self.attn.c_proj, y, dt), cfg.dropout, key, 1 + 2 * layer,
                    deterministic)
        x = x + y

        y = _layer_norm(self.ln_2, x, dt)
        y = F.gelu(_dense(self.mlp.c_fc, y, dt), approximate="tanh")
        y = dropout(_dense(self.mlp.c_proj, y, dt), cfg.dropout, key, 2 + 2 * layer,
                    deterministic)
        return x + y


class GPT2(nn.Module):
    """GPT-2 LM. ``forward(tokens [B, T]) -> logits [B, T, vocab]`` (f32).

    ``generator`` seeds the initialisation, the JAX model's scheme: dense
    kernels and ``wte`` normal(0.02), ``wpe`` normal(0.01), zero biases,
    LayerNorms at one and zero.

    ``decode=True``: ``forward(tokens, cache, page_table=, lengths=)`` with
    a cache from ``generate.init_cache`` or ``generate.init_paged_cache``
    (module docstring); ``paged=(num_pages, page_size)`` needs ``decode``.

    ``forward(tokens, deterministic=False, generator=key)`` turns dropout
    on (``cfg.dropout > 0``); ``key`` is a ``parallel.rng.DropoutKey``
    (module docstring). An untied ``lm_head`` is
    initialised as flax's ``Dense`` default, LeCun normal (truncated).
    """

    def __init__(self, cfg: GPT2Config = GPT2Config(), attn_fn: AttnFn = default_attention,
                 *, decode: bool = False, paged: tuple | None = None, kv_wire=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kv_wire is not None:
            raise NotImplementedError(QUANTIZED_KV.format(f"GPT2 kv_wire={kv_wire!r}"))
        if paged is not None and not decode:
            raise ValueError("paged KV layout requires decode=True")
        waits = {"scan_layers": (cfg.scan_layers, "the scan-over-layers slice"),
                 "fp8": (cfg.fp8 is not None, "the fp8 matmul slice")}
        asked = [f"{name} (waits for {slice_})" for name, (on, slice_) in waits.items() if on]
        if asked:
            raise NotImplementedError(f"GPT2 {', '.join(asked)}: not ported yet")
        self.remat = resolve_remat(cfg.remat)
        self.cfg = cfg
        self.decode = decode
        self.paged = None if paged is None else (int(paged[0]), int(paged[1]))
        self.transformer = nn.ModuleDict(dict(
            wte=nn.Embedding(cfg.vocab_size, cfg.n_embd),
            wpe=nn.Embedding(cfg.n_positions, cfg.n_embd),
            h=nn.ModuleList(Block(cfg, attn_fn) for _ in range(cfg.n_layer)),
            ln_f=nn.LayerNorm(cfg.n_embd, eps=1e-5),
        ))
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.transformer.wte.weight, std=0.02, generator=generator)
        nn.init.normal_(self.transformer.wpe.weight, std=0.01, generator=generator)
        if not self.cfg.tie_word_embeddings:
            # flax Dense's default kernel init: lecun_normal, a normal truncated
            # to two of its standard deviations, scaled back to variance 1/fan_in
            std = (1.0 / self.cfg.n_embd) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(self.lm_head.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

    def fsdp_blocks(self) -> list[nn.Module]:
        """The units ZeRO-3 shards one by one (FSDP2, before the root): the
        transformer blocks. ``wte`` (and an untied ``lm_head``) stay in the
        root's unit."""
        return list(self.transformer.h)

    def forward(self, tokens, cache=None, *, page_table=None, lengths=None,
                deterministic: bool = True, generator=None):
        cfg, tr = self.cfg, self.transformer
        dt, t = cfg.dtype, tokens.shape[1]
        key = as_key(generator)
        pe = self._positions(tokens, cache, page_table, lengths)
        x = tr.wte.weight[tokens.long()].to(dt) + pe.to(dt)
        x = dropout(x, cfg.dropout, key, 0, deterministic)
        remat = self.remat != "none" and cache is None
        for i, block in enumerate(tr.h):
            # the module call (hooks fire), checkpointed per block under remat
            call = apply_remat(block.__call__, self.remat) if remat else block
            x = call(x, cache, i, page_table, lengths, key, deterministic)
        if isinstance(cache, KVCache):
            cache.position += t
        x = _layer_norm(tr.ln_f, x, dt)
        if cfg.tie_word_embeddings:
            return (x @ tr.wte.weight.to(dt).t()).float()
        return _dense(self.lm_head, x, dt).float()

    def _positions(self, tokens, cache, page_table, lengths):
        """The position embeddings of this call, checking its cache."""
        wpe, t = self.transformer.wpe.weight, tokens.shape[1]
        if cache is None:
            if self.decode:
                raise ValueError("a decode=True model takes a KV cache on every call "
                                 "(generate.init_cache / init_paged_cache)")
            return wpe[:t]
        if not self.decode:
            raise ValueError("a KV cache needs a model built with decode=True")
        if isinstance(cache, PagedKVCache):
            if page_table is None or lengths is None:
                raise ValueError("paged decode needs page_table [B, max_pages] and lengths [B] "
                                 "on every call")
            # per-slot positions; the clip keeps padded garbage rows in range
            pos = lengths.long()[:, None] + torch.arange(t, device=tokens.device)[None, :]
            return wpe[pos.clamp(0, self.cfg.n_positions - 1)]
        if self.paged is not None:
            raise ValueError("a model built with paged= takes a PagedKVCache")
        start = cache.position
        if start + t > self.cfg.n_positions:
            raise ValueError(f"positions {start}..{start + t - 1} exceed n_positions "
                             f"{self.cfg.n_positions}")
        return wpe[start:start + t]


def cross_entropy_loss(logits, targets, ignore_index: int = -100):
    """Token-level CE with ignore mask; logits ``[B, T, V]``, targets ``[B, T]``."""
    mask = (targets != ignore_index).float()
    safe = torch.where(targets == ignore_index, 0, targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
