"""SwinIR: shifted-window attention super-resolution transformer.

Counterpart of ``pytorch_distributedtraining_tpu/models/swinir.py`` with its
three tails:

- ``'pixelshuffledirect'``, SwinIR-S (the reference's configuration)::

      SwinIR(upscale=2, in_chans=3, img_size=64, window_size=8, img_range=1.,
             depths=[6,6,6,6], embed_dim=60, num_heads=[6,6,6,6], mlp_ratio=2,
             upsampler='pixelshuffledirect', resi_connection='1conv')

- ``'pixelshuffle'``, classical SwinIR-M (``conv_before_upsample.0`` and a
  LeakyReLU at 0.01, ``upsample.{2s}`` convs to 4·64 channels each followed
  by a x2 shuffle, or one conv to 9·64 and a x3 shuffle, then
  ``conv_last``)::

      SwinIR(upscale=2, in_chans=3, img_size=48, window_size=8, img_range=1.,
             depths=[6]*6, embed_dim=180, num_heads=[6]*6, mlp_ratio=2,
             upsampler='pixelshuffle', resi_connection='1conv')

- ``'nearest+conv'``, real-world SR at x2 and x4 (``conv_before_upsample.0``
  with LeakyReLU 0.01, then ``conv_up1`` [and ``conv_up2``] after nearest
  x2 repeats and ``conv_hr``, each with LeakyReLU 0.2, then ``conv_last``;
  the slopes differ on purpose, as in official SwinIR).

The public layout is NHWC ``[B, H, W, C]`` as in the JAX model; only the
``nn.Conv2d``\\ s see NCHW (a channels-last view, no copy). Module names
follow the official torch-SwinIR tree (``layers.N.residual_group.blocks.M``,
``patch_embed.norm``, ``conv_after_body``, ``upsample.0``,
``conv_before_upsample.0``, ``conv_last``), and the
``relative_position_index`` / ``attn_mask`` buffers are registered, so an
official file of any of the three families strict-loads.

Numerics follow the JAX model, not official SwinIR, where the two differ:
LayerNorm epsilon 1e-6 (flax's default), tanh-approximated GELU
(``flax.linen.gelu``), and the JAX ``pixel_shuffle`` channel order in every
tail. Attention always goes through ``ops.window_attn``: the CUDA kernels
(K1 forward, K2 backward) for CUDA tensors, the plain version for CPU
tensors. ``attn_impl`` (``'xla' | 'pallas' | 'paired' | 'blockdiag'``)
and ``attn_pack`` name how the JAX model lays the attention out on a TPU;
all of them have the same parameters and the same math, and here every
choice runs K1/K2 at one window a tile. Packing two windows into one
tile (``'paired'``, ``'pallas'`` at ``attn_pack=2``) fills a TPU matrix
unit's 128 rows at 64 tokens a window; on Hopper the packed kernel was
slower than pack 1 at every SwinIR-M shape measured (``PERF.md`` §6), so
the constructor takes the choices and the kernels do not pack.

The kernels accumulate the softmax in f32, so ``softmax_dtype`` other than
f32 raises, as the JAX ``'pallas'`` path does. ``norm_dtype`` rounds each
LayerNorm's output to that type and casts it back to the input's type,
where the JAX model casts (``patch_norm``, ``norm1``, ``norm2``, ``norm``).
``remat`` checkpoints each Swin layer under a ``parallel.remat`` policy
(``none``, ``full``, ``dots``, ``names``, ``offload``), the unit the JAX
model's ``remat_block`` wraps; the attention's softmax·V product, before
``proj``, carries JAX's ``attn_out`` tag, the set ``names`` saves and
``offload`` keeps on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops import window_attn
from ..parallel.remat import apply_remat, checkpoint_name, resolve_remat
from .sr_espcn import conv_nhwc, pixel_shuffle

LN_EPS = 1e-6  # flax.linen.LayerNorm's default, which the JAX model keeps


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    c = wins.shape[-1]
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] lookup into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, n, n]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws*ws, ws*ws] additive mask for SW-MSA."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    wins = (
        img.reshape(1, h // ws, ws, w // ws, ws, 1)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(-1, ws * ws)
    )
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


ATTN_IMPLS = ("xla", "pallas", "paired", "blockdiag")
UPSAMPLERS = ("pixelshuffledirect", "pixelshuffle", "nearest+conv")
NUM_FEAT = 64  # the classical and real-SR tails' width, as in official SwinIR


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size)),
        )
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        bn, n, c = x.shape  # [B*nW, ws^2, C]
        h = self.num_heads
        qkv = self.qkv(x).reshape(bn, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))  # [bn, h, n, d]
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        bias = bias.reshape(n, n, h).permute(2, 0, 1).float().contiguous()
        out = window_attn.window_attention(q, k, v, bias, mask)
        # the named-remat tag ("names"/"offload"): save softmax·V
        return self.proj(checkpoint_name(out.transpose(1, 2).reshape(bn, n, c), "attn_out"))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, norm_dtype: torch.dtype | None) -> torch.Tensor:
    """``ln(x)`` rounded to ``norm_dtype`` (where one is set and it is not
    the output's type) and cast back to ``x``'s type: the JAX model's
    ``LayerNorm(dtype=norm_dtype)`` computes in f32 and returns
    ``norm_dtype``, which its callers cast to the model's type."""
    y = ln(x)
    if norm_dtype is None or y.dtype == norm_dtype:
        return y
    return y.to(norm_dtype).to(x.dtype)


class SwinLayer(nn.Module):
    """One STL: (shifted-)window attention + MLP, pre-norm residuals."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float, img_size: int, norm_dtype: torch.dtype | None = None):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm_dtype = norm_dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.img_size = img_size
        if shift > 0:  # the trained-size mask, as official checkpoints carry it
            self.register_buffer(
                "attn_mask",
                torch.from_numpy(_shift_attn_mask(img_size, img_size, window_size, shift)),
            )
        self._masks: dict = {}

    def _mask(self, h: int, w: int, device) -> torch.Tensor:
        if h == w == self.img_size:
            return self.attn_mask
        key = (h, w, device)
        if key not in self._masks:
            m = _shift_attn_mask(h, w, self.window_size, self.shift)
            self._masks[key] = torch.from_numpy(m).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, hgt, wid, c = x.shape
        ws = self.window_size
        y = layer_norm(self.norm1, x, self.norm_dtype)
        mask = None
        if self.shift > 0:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = self._mask(hgt, wid, x.device)
        wins = self.attn(window_partition(y, ws), mask)
        y = window_reverse(wins, ws, hgt, wid)
        if self.shift > 0:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(layer_norm(self.norm2, x, self.norm_dtype))


class ResidualGroup(nn.Module):
    def __init__(self, blocks: Sequence[SwinLayer], remat: str = "none"):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.remat = remat

    def forward(self, x):
        for blk in self.blocks:
            x = apply_remat(blk.__call__, self.remat)(x)  # the module call: hooks fire
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer Block: depth STLs + conv + residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, img_size: int, remat: str = "none",
                 norm_dtype: torch.dtype | None = None):
        super().__init__()
        self.residual_group = ResidualGroup([
            SwinLayer(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio, img_size, norm_dtype)
            for i in range(depth)
        ], remat)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)  # resi_connection='1conv'

    def forward(self, x):
        return x + conv_nhwc(self.conv, self.residual_group(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, norm_dtype: torch.dtype | None = None):
        return layer_norm(self.norm, x, norm_dtype)


class PixelShuffle(nn.Module):
    """NHWC depth-to-space in the JAX channel order (``pixel_shuffle``)."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)


class Upsample(nn.Sequential):
    """The classical tail's staged upsampler, indexed as official SwinIR's
    ``Upsample`` (convs at even indices, shuffles between): log2(r) convs
    to 4·nf channels each followed by a x2 shuffle, or at r = 3 one conv
    to 9·nf and a x3 shuffle."""

    def __init__(self, r: int, nf: int):
        if r & (r - 1) == 0:
            stages = [(4 * nf, 2)] * (r.bit_length() - 1)
        elif r == 3:
            stages = [(9 * nf, 3)]
        else:
            raise NotImplementedError(
                f"pixelshuffle upsampler supports scales 2^n and 3, got {r}")
        mods = []
        for width, s in stages:
            mods += [nn.Conv2d(nf, width, 3, padding=1), PixelShuffle(s)]
        super().__init__(*mods)

    def forward(self, x):  # NHWC
        for m in self:
            x = conv_nhwc(m, x) if isinstance(m, nn.Conv2d) else m(x)
        return x


def _nearest2(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour x2 (each pixel repeated 2x2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class SwinIR(nn.Module):
    """SwinIR with the JAX model's constructor surface (NHWC in and out).

    ``generator`` seeds the initialisation (official SwinIR's scheme:
    truncated normal 0.02 for linears and the bias tables, unit LayerNorms,
    PyTorch's default for convs), so a run is reproducible from a seed.
    """

    def __init__(self, upscale: int = 2, in_chans: int = 3, img_size: int = 64,
                 window_size: int = 8, img_range: float = 1.0,
                 depths: Sequence[int] = (6, 6, 6, 6), embed_dim: int = 60,
                 num_heads: Sequence[int] = (6, 6, 6, 6), mlp_ratio: float = 2.0,
                 upsampler: str = "pixelshuffledirect", resi_connection: str = "1conv",
                 attn_impl: str = "xla", attn_pack: int = 1,
                 norm_dtype: torch.dtype | None = None,
                 softmax_dtype: torch.dtype = torch.float32,
                 remat: bool | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if upsampler not in UPSAMPLERS:
            raise NotImplementedError(
                "upsampler must be 'pixelshuffledirect' (SwinIR-S), "
                "'pixelshuffle' (classical SwinIR-M) or 'nearest+conv' (real-SR)")
        if resi_connection != "1conv":
            raise NotImplementedError(
                f"resi_connection={resi_connection!r}: the JAX SwinIR builds the "
                "1-conv residual only")
        if upsampler == "nearest+conv" and upscale not in (2, 4):
            raise NotImplementedError(f"nearest+conv supports scales 2 and 4, got {upscale}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(
                "attn_impl must be one of 'xla'/'pallas'/'paired'/"
                f"'blockdiag', got {attn_impl!r}")
        if softmax_dtype != torch.float32:
            raise ValueError(
                "the window-attention kernels compute softmax in f32; "
                f"softmax_dtype={softmax_dtype} is not honored")
        self.remat = resolve_remat(remat)
        self.upscale = upscale
        self.in_chans = in_chans
        self.img_size = img_size
        self.window_size = window_size
        self.img_range = img_range
        self.depths = tuple(depths)
        self.embed_dim = embed_dim
        self.mlp_ratio = mlp_ratio
        self.upsampler = upsampler
        self.norm_dtype = norm_dtype
        self.register_buffer(
            "mean", torch.tensor([0.4488, 0.4371, 0.4040]) * img_range, persistent=False
        )
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, depth, heads, window_size, mlp_ratio, img_size, self.remat,
                 norm_dtype)
            for depth, heads in zip(depths, num_heads)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        if upsampler == "pixelshuffledirect":
            self.upsample = nn.ModuleList([
                nn.Conv2d(embed_dim, in_chans * upscale * upscale, 3, padding=1)
            ])
        else:
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, NUM_FEAT, 3, padding=1), nn.LeakyReLU(0.01))
            if upsampler == "pixelshuffle":
                self.upsample = Upsample(upscale, NUM_FEAT)
            else:
                self.conv_up1 = nn.Conv2d(NUM_FEAT, NUM_FEAT, 3, padding=1)
                if upscale == 4:
                    self.conv_up2 = nn.Conv2d(NUM_FEAT, NUM_FEAT, 3, padding=1)
                self.conv_hr = nn.Conv2d(NUM_FEAT, NUM_FEAT, 3, padding=1)
            self.conv_last = nn.Conv2d(NUM_FEAT, in_chans, 3, padding=1)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=5**0.5, generator=generator)
                bound = 1 / (m.weight[0].numel() ** 0.5)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                      generator=generator)

    def fsdp_blocks(self) -> list[nn.Module]:
        """The units ZeRO-3 shards one by one (FSDP2, before the root): the
        residual Swin blocks."""
        return list(self.layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C] in [0, img_range]
        b, h, w, c = x.shape
        ws = self.window_size
        pad_h, pad_w = (-h) % ws, (-w) % ws
        mean = self.mean.to(x.dtype)
        x = (x - mean) / self.img_range
        if pad_h or pad_w:  # reflect-pad to window multiples
            x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
            x = x.permute(0, 2, 3, 1)
        feat = conv_nhwc(self.conv_first, x)
        y = self.patch_embed(feat, self.norm_dtype)
        for layer in self.layers:
            y = layer(y)
        y = conv_nhwc(self.conv_after_body, layer_norm(self.norm, y, self.norm_dtype))
        feat = feat + y
        out = self._tail(feat)
        out = out.float() * self.img_range + mean.float()
        if pad_h or pad_w:
            r = self.upscale
            out = out[:, : h * r, : w * r, :]
        return out

    def _tail(self, feat: torch.Tensor) -> torch.Tensor:
        """The upsampler: NHWC features -> NHWC image at ``upscale``."""
        if self.upsampler == "pixelshuffledirect":
            return pixel_shuffle(conv_nhwc(self.upsample[0], feat), self.upscale)
        act = self.conv_before_upsample[1]
        y = act(conv_nhwc(self.conv_before_upsample[0], feat))
        if self.upsampler == "pixelshuffle":
            return conv_nhwc(self.conv_last, self.upsample(y))
        y = F.leaky_relu(conv_nhwc(self.conv_up1, _nearest2(y)), 0.2)
        if self.upscale == 4:
            y = F.leaky_relu(conv_nhwc(self.conv_up2, _nearest2(y)), 0.2)
        y = F.leaky_relu(conv_nhwc(self.conv_hr, y), 0.2)
        return conv_nhwc(self.conv_last, y)
