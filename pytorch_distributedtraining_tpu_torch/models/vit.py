"""ViT-B/16: the ladder's image rung 5 ("bf16 + FSDP ViT-B/16 ImageNet").

Counterpart of ``pytorch_distributedtraining_tpu/models/vit.py``: a
16x16/16 ``VALID`` convolution cuts the image into patches, a CLS token
goes in front, learned position embeddings are added, pre-LN encoder
blocks follow, and the CLS token's final LayerNorm feeds the head.
Images go in NHWC; logits come out f32.

Module names are torchvision's ``vit_b_16`` (``conv_proj``,
``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_{i}.{ln_1, self_attention, ln_2, mlp.0,
mlp.3}``, ``encoder.ln``, ``heads.head``), so its state dict loads
strictly. The attention projection is ``nn.MultiheadAttention``'s packed
``in_proj_weight`` ``[3d, d]`` (rows ``[q; k; v]``) and ``out_proj``; the
module is a container only, the block computes the attention itself with
the pluggable ``attn_fn`` (``causal=False``), as the JAX block does.

The numerics are flax's: LayerNorm epsilon 1e-6 (flax's default, not
GPT-2's 1e-5) with f32 statistics, tanh GELU, dense layers and the
residual stream in ``cfg.dtype``, f32 logits. Initialisation (from
``generator``): the patch convolution ``lecun_normal``, the CLS token
zero, ``pos_embedding`` normal(0.02), encoder dense kernels
xavier-uniform, the head's kernel zero, every bias zero.

``cfg.remat`` checkpoints each encoder block under a ``parallel.remat``
policy, the attention's output before ``out_proj`` tagged ``attn_out`` as
in JAX (the set ``'names'`` saves and ``'offload'`` keeps on the host). Dropout (``cfg.dropout``) runs
only when ``forward(images, deterministic=False, generator=key)`` asks,
as in JAX: after the embedding (site 0), after each block's ``out_proj``
(JAX's ``c_proj``, site ``1 + 2 i``) and after its ``mlp.3`` (JAX's
``mlp_proj``, site ``2 + 2 i``), by GPT-2's helper
(:func:`~..parallel.rng.dropout`), so a recomputed block redraws its masks.
The torchvision ``nn.Dropout`` placeholders in ``mlp`` stay at rate 0, for
the names. Not ported yet, and raising ``NotImplementedError``:
``scan_layers`` (the scan-over-layers slice) and ``fp8`` (the fp8 matmul
slice).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.remat import apply_remat, checkpoint_name, resolve_remat
from ..parallel.rng import as_key, dropout
from .gpt2 import _TRUNC_STD, AttnFn, _dense, _layer_norm, default_attention


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool | str = False
    scan_layers: bool = False
    fp8: str | None = None

    @staticmethod
    def b16() -> "ViTConfig":
        return ViTConfig()  # ViT-B/16 is the default config

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(image_size=32, patch_size=8, num_classes=10, hidden_dim=32, num_layers=2,
                    num_heads=2, mlp_dim=64, dtype=torch.float32)
        base.update(kw)
        return ViTConfig(**base)


class EncoderBlock(nn.Module):
    """Pre-LN block: LN -> attention -> +res, LN -> MLP (tanh GELU) -> +res."""

    def __init__(self, cfg: ViTConfig, attn_fn: AttnFn = default_attention):
        super().__init__()
        d = cfg.hidden_dim
        self.cfg, self.attn_fn = cfg, attn_fn
        self.ln_1 = nn.LayerNorm(d, eps=1e-6)
        self.self_attention = nn.MultiheadAttention(d, cfg.num_heads, batch_first=True)
        self.ln_2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = nn.Sequential(nn.Linear(d, cfg.mlp_dim), nn.GELU("tanh"), nn.Dropout(0.0),
                                 nn.Linear(cfg.mlp_dim, d), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, layer: int = 0, key=None,
                deterministic: bool = True) -> torch.Tensor:
        """``key`` draws the masks of the block's sites ``1 + 2 * layer`` and
        ``2 + 2 * layer``."""
        cfg = self.cfg
        dt, h = cfg.dtype, cfg.num_heads
        b, t, d = x.shape
        sa = self.self_attention
        y = _layer_norm(self.ln_1, x, dt)
        qkv = F.linear(y, sa.in_proj_weight.to(dt), sa.in_proj_bias.to(dt))
        q, k, v = (a.unflatten(-1, (h, d // h)) for a in qkv.split(d, dim=-1))
        # the named-remat tag ("names"/"offload"): save softmax·V
        y = checkpoint_name(self.attn_fn(q, k, v, causal=False), "attn_out").reshape(b, t, d)
        x = x + dropout(_dense(sa.out_proj, y, dt), cfg.dropout, key, 1 + 2 * layer,
                        deterministic)

        y = _layer_norm(self.ln_2, x, dt)
        y = F.gelu(_dense(self.mlp[0], y, dt), approximate="tanh")
        return x + dropout(_dense(self.mlp[3], y, dt), cfg.dropout, key, 2 + 2 * layer,
                           deterministic)


class Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig, attn_fn: AttnFn):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.pos_embedding = nn.Parameter(torch.zeros(1, n, cfg.hidden_dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(cfg, attn_fn)) for i in range(cfg.num_layers)))
        self.ln = nn.LayerNorm(cfg.hidden_dim, eps=1e-6)


class ViT(nn.Module):
    """ViT classifier. ``forward(images [B, H, W, C]) -> logits [B,
    num_classes]`` (f32); ``deterministic=False, generator=key`` turns
    dropout on (module docstring)."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), attn_fn: AttnFn = default_attention, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        waits = {"scan_layers": (cfg.scan_layers, "the scan-over-layers slice"),
                 "fp8": (cfg.fp8 is not None, "the fp8 matmul slice")}
        asked = [f"{name} (waits for {slice_})" for name, (on, slice_) in waits.items() if on]
        if asked:
            raise NotImplementedError(f"ViT {', '.join(asked)}: not ported yet")
        self.remat = resolve_remat(cfg.remat)
        self.cfg = cfg
        d, p = cfg.hidden_dim, cfg.patch_size
        self.conv_proj = nn.Conv2d(3, d, p, p)
        self.class_token = nn.Parameter(torch.zeros(1, 1, d))
        self.encoder = Encoder(cfg, attn_fn)
        self.heads = nn.Sequential(OrderedDict(head=nn.Linear(d, cfg.num_classes)))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        w = self.conv_proj.weight
        std = (1.0 / w[0].numel()) ** 0.5 / _TRUNC_STD
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(self.conv_proj.bias)
        nn.init.zeros_(self.class_token)
        nn.init.normal_(self.encoder.pos_embedding, std=0.02, generator=generator)
        for block in self.encoder.layers:
            sa = block.self_attention
            # xavier-uniform of flax's [d, 3d] kernel: the bound of fan d + 3d
            nn.init.xavier_uniform_(sa.in_proj_weight, generator=generator)
            nn.init.zeros_(sa.in_proj_bias)
            for lin in (sa.out_proj, block.mlp[0], block.mlp[3]):
                nn.init.xavier_uniform_(lin.weight, generator=generator)
                nn.init.zeros_(lin.bias)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.zeros_(self.heads.head.weight)
        nn.init.zeros_(self.heads.head.bias)

    def fsdp_blocks(self) -> list[nn.Module]:
        """The units ZeRO-3 shards one by one (FSDP2, before the root): the
        encoder blocks."""
        return list(self.encoder.layers)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:  # [B, H, W, C]
        cfg = self.cfg
        dt, p = cfg.dtype, cfg.patch_size
        key = as_key(generator)
        x = images.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.conv_proj.weight.to(dt), self.conv_proj.bias.to(dt), p)
        x = x.flatten(2).transpose(1, 2)  # [B, gh * gw, d], patches row-major
        b = x.shape[0]
        x = torch.cat([self.class_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = x + self.encoder.pos_embedding.to(dt)
        x = dropout(x, cfg.dropout, key, 0, deterministic)
        for i, block in enumerate(self.encoder.layers):
            # the module call: hooks fire
            x = apply_remat(block.__call__, self.remat)(x, i, key, deterministic)
        x = _layer_norm(self.encoder.ln, x, dt)[:, 0]  # CLS pool
        return _dense(self.heads.head, x, dt).float()


ViTB16 = functools.partial(ViT, cfg=ViTConfig.b16())
