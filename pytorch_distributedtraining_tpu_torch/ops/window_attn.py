"""Window attention for Swin-style models: CUDA kernels plus plain versions.

Counterpart of ``pytorch_distributedtraining_tpu/ops/pallas_window_attn.py``.
The TPU kernels ``_fwd_kernel`` (K1) and ``_bwd_kernel`` (K2) become the
hand-written CUDA kernels in ``csrc/window_attn.cu`` (see its header for the
design and the bound on an H100); this module holds their wrappers, the
``torch.autograd.Function`` that ties them together, the packed variant and
the plain PyTorch versions.

Dispatch rule: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version. Nothing falls back from one to the other. The
launch counts ``fwd_launches`` and ``bwd_launches`` rise by one where a
wrapper launches its kernel and nowhere else, so a run can show that the
main path went through the kernels.

Layouts follow the JAX package: q/k/v/o ``[B*nW, heads, n, d]``, bias
``[heads, n, n]`` f32, mask ``[nW, n, n]`` f32 (window ``w`` takes
``mask[w % nW]``) or ``None``.
"""

from __future__ import annotations

import math

import torch

from .. import csrc

MAX_N = 128  # pack=2 of SwinIR's 64-token windows
MAX_D = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

fwd_launches = 0
bwd_launches = 0


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


# -- plain versions ----------------------------------------------------------


def _scores(q, k, bias, mask):
    """f32 scores ``q·kᵀ·d^-½ + bias[h] + mask[w mod nW]``, ``[bn, h, n, n]``."""
    bn, h, n, d = q.shape
    s = (q.float() * d**-0.5) @ k.float().transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        idx = torch.arange(bn, device=q.device) % nw
        s = s + mask.float()[idx][:, None]
    return s


def _f32(device):
    """The plain versions compute in f32 even inside a caller's autocast."""
    return torch.autocast(device_type=device.type, enabled=False)


def plain_forward(q, k, v, bias, mask):
    """What K1 computes, in f32; the output takes q's dtype."""
    with _f32(q.device):
        return _plain_forward(q, k, v, bias, mask)


def _plain_forward(q, k, v, bias, mask):
    p = torch.softmax(_scores(q, k, bias, mask), dim=-1)
    return (p @ v.float()).to(q.dtype)


def plain_backward(q, k, v, bias, mask, do):
    """What K2 computes, in f32: ``(dq, dk, dv, dbias)``; dbias is f32."""
    with _f32(q.device):
        return _plain_backward(q, k, v, bias, mask, do)


def _plain_backward(q, k, v, bias, mask, do):
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, bias, mask), dim=-1)
    do32 = do.float()
    dv = p.transpose(-1, -2) @ do32
    dp = do32 @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k.float()) * scale
    dk = ds.transpose(-1, -2) @ (q.float() * scale)
    dbias = ds.sum(0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# -- kernel wrappers -----------------------------------------------------------


def _check(q, k, v, bias, mask):
    """Raise on anything the kernels do not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B*nW, heads, n, d], got shape {tuple(q.shape)}")
    bn, h, n, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v must be float32, bfloat16 or float16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if not 1 <= n <= MAX_N or not 1 <= d <= MAX_D:
        raise ValueError(f"window attention takes n <= {MAX_N}, d <= {MAX_D}; got {n}, {d}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be [heads, n, n] = {(h, n, n)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)):
        raise ValueError(f"mask must be [nW, {n}, {n}], got {tuple(mask.shape)}")
    for name, t in (("bias", bias), ("mask", mask)):
        if t is not None and (t.dtype != torch.float32 or t.device != q.device):
            raise TypeError(f"{name} must be float32 on {q.device}")


def _check_cuda(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("window attention kernels take contiguous tensors")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def kernel_forward(q, k, v, bias, mask):
    """Launch K1 on CUDA tensors; returns o ``[B*nW, heads, n, d]``."""
    global fwd_launches
    _check(q, k, v, bias, mask)
    _check_cuda(q, k, v, bias, mask)
    lib = csrc.load()
    bn, h, n, d = q.shape
    o = torch.empty_like(q)
    nw = 1 if mask is None else mask.shape[0]
    code = lib.window_attn_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _ptr(mask), o.data_ptr(), bn, h, n, d, nw,
        d**-0.5, _stream(q.device),
    )
    csrc.check(lib, code, "window_attn_forward")
    fwd_launches += 1
    return o


def backward_group(bn: int, heads: int, device) -> int:
    """Windows per K2 block: about four blocks per SM, fewer partials."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, math.ceil(bn * heads / (4 * sms)))


def kernel_backward(q, k, v, bias, mask, do):
    """Launch K2 (and its dbias reduction) on CUDA tensors."""
    global bwd_launches
    _check(q, k, v, bias, mask)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    _check_cuda(q, k, v, bias, mask, do)
    lib = csrc.load()
    bn, h, n, d = q.shape
    group = backward_group(bn, h, q.device)
    groups = math.ceil(bn / group)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.empty((groups, h, n, n), dtype=torch.float32, device=q.device)
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    nw = 1 if mask is None else mask.shape[0]
    code = lib.window_attn_backward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _ptr(mask), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
        bn, h, n, d, nw, group, d**-0.5, _stream(q.device),
    )
    csrc.check(lib, code, "window_attn_backward")
    bwd_launches += 1
    return dq, dk, dv, dbias


def _forward(q, k, v, bias, mask):
    if q.is_cuda:
        return kernel_forward(q, k, v, bias, mask)
    if q.device.type != "cpu":
        raise RuntimeError(f"window attention runs on CUDA or CPU, not {q.device}")
    _check(q, k, v, bias, mask)
    return plain_forward(q, k, v, bias, mask)


def _backward(q, k, v, bias, mask, do):
    if q.is_cuda:
        return kernel_backward(q, k, v, bias, mask, do)
    if q.device.type != "cpu":
        raise RuntimeError(f"window attention runs on CUDA or CPU, not {q.device}")
    return plain_backward(q, k, v, bias, mask, do)


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        ctx.save_for_backward(q, k, v, bias, mask)
        return _forward(q, k, v, bias, mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = _backward(q, k, v, bias, mask, do.contiguous())
        return dq, dk, dv, dbias.to(bias.dtype), None  # the mask takes no gradient


def window_attention(q, k, v, bias, mask=None):
    """Fused ``softmax(q·kᵀ/√d + bias [+ mask])·v`` over independent windows.

    Gradients flow to q, k, v and bias; the mask is a constant.
    """
    return _WindowAttention.apply(q, k, v, bias, mask)


def pack_windows(q, k, v, bias, mask, pack: int):
    """``pack`` consecutive windows as one window of ``pack*n`` tokens:
    ``(q, k, v, bias, mask)`` at the packed shapes, contiguous. The bias is
    block-diagonal with -1e9 off the diagonal blocks; the mask (if any) is
    block-diagonal with zeros there."""
    bn, h, n, d = q.shape
    p = pack
    if bn % p:
        raise ValueError(f"window count {bn} not divisible by pack {p}")
    if mask is not None and mask.shape[0] % p:
        raise ValueError(f"mask window count {mask.shape[0]} not divisible by pack {p}")
    pn = p * n

    def packed(t):
        return t.reshape(bn // p, p, h, n, d).transpose(1, 2).reshape(bn // p, h, pn, d)

    blk = torch.arange(pn, device=q.device) // n
    same = blk[:, None] == blk[None, :]
    bias_p = torch.where(same[None], bias.repeat(1, p, p), torch.full((), -1e9, device=q.device))
    mask_p = None
    if mask is not None:
        nw = mask.shape[0]
        m = mask.reshape(nw // p, p, n, n)
        eye = torch.eye(p, dtype=m.dtype, device=m.device)
        mask_p = torch.einsum("ab,wanm->wanbm", eye, m).reshape(nw // p, pn, pn).contiguous()
    return (packed(q).contiguous(), packed(k).contiguous(), packed(v).contiguous(),
            bias_p.contiguous(), mask_p)


def window_attention_packed(q, k, v, bias, mask=None, pack: int = 2):
    """Window attention with ``pack`` consecutive windows per attention tile.

    A pure reshape to ``pack*n``-token windows plus a block-diagonal bias at
    -1e9 off the diagonal blocks (:func:`pack_windows`), around the same
    kernel: the softmax over the packed axis reproduces the per-window
    softmax. With a mask, its window count must divide by ``pack`` so pairs
    stay within one image.
    """
    if pack <= 1:
        return window_attention(q, k, v, bias, mask)
    bn, h, n, d = q.shape
    out = window_attention(*pack_windows(q, k, v, bias, mask, pack))
    return out.reshape(bn // pack, h, pack, n, d).transpose(1, 2).reshape(bn, h, n, d)
