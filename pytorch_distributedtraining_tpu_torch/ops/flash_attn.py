"""Causal flash attention for GPT-2: CUDA kernels plus plain versions.

Counterpart of ``pytorch_distributedtraining_tpu/ops/pallas_attn.py``. The
TPU kernels ``_fwd_kernel`` (K3), ``_dq_kernel`` (K4) and ``_dkv_kernel``
(K5) become the hand-written CUDA kernels in ``csrc/flash_attn.cu`` (see
its header for the design and the bound on an H100); this module holds
their wrappers, the ``torch.autograd.Function`` that ties them together,
the GPT-2 ``attn_fn`` and the plain PyTorch versions.

Dispatch rule: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version. Nothing falls back from one to the other. The
launch counts ``fwd_launches``, ``dq_launches`` and ``dkv_launches`` rise
by one where a wrapper launches its kernel and nowhere else.

All three kernels run on the tensor cores in every type
(:func:`uses_tensor_cores`): bf16 and f16 on ``mma.sync.m16n8k16``, f32 as
3xTF32 on ``mma.sync.m16n8k8`` (plain TF32 would miss the f32 tolerance).
They stage rows (q/k/v, and dO for K4 and K5) by 16-byte ``cp.async``
copies, so the wrappers hand them only rows that start on 16 bytes
(:func:`rows_aligned`) and copy anything else to a fresh contiguous
tensor first.

Layouts follow the JAX package: q/k/v/o ``[B, T, H, Dh]``; the per-row
logsumexp ``lse`` and ``delta = rowsum(dO*O)`` are ``[B, H, T]`` f32 (the
JAX package's 8-lane broadcast of them is a TPU layout workaround and is
not carried over).
"""

from __future__ import annotations

import torch

from .. import csrc

HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROW_ALIGN = 16  # bytes: one cp.async copy

fwd_launches = 0
dq_launches = 0
dkv_launches = 0


def reset_launch_counts() -> None:
    global fwd_launches, dq_launches, dkv_launches
    fwd_launches = 0
    dq_launches = 0
    dkv_launches = 0


def _check_blocks(t, bq, bk):
    if t % bq or t % bk:
        raise ValueError(f"seq len {t} must divide block sizes ({bq},{bk})")


# -- plain versions ----------------------------------------------------------


def _f32(device):
    """The plain versions compute in f32 even inside a caller's autocast."""
    return torch.autocast(device_type=device.type, enabled=False)


def _heads_first(*ts):
    """``[B, T, H, Dh]`` -> f32 ``[B, H, T, Dh]``."""
    return [t.float().transpose(1, 2) for t in ts]


def _scores(q, k, causal):
    """Unscaled f32 ``q·kᵀ`` ``[B, H, T, T]`` and the causal keep-mask."""
    s = q @ k.transpose(-1, -2)
    t = s.shape[-1]
    keep = torch.ones(t, t, dtype=torch.bool, device=s.device)
    return s, keep.tril() if causal else keep


def _probs(q, k, lse, causal, scale):
    """``p = exp(scale·q·kᵀ − lse)`` with masked entries exactly 0."""
    s, keep = _scores(q, k, causal)
    return torch.where(keep, torch.exp(scale * s - lse[..., None]), 0.0)


def plain_forward(q, k, v, causal: bool = True):
    """What K3 computes, in f32: ``(out, lse)``; out takes q's dtype, lse
    is ``[B, H, T]`` f32."""
    with _f32(q.device):
        scale = q.shape[-1] ** -0.5
        qf, kf, vf = _heads_first(q, k, v)
        s, keep = _scores(qf * scale, kf, causal)
        s = s.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        out = torch.exp(s - lse[..., None]) @ vf
        return out.transpose(1, 2).to(q.dtype), lse


def plain_dq(q, k, v, do, lse, delta, causal: bool = True):
    """What K4 computes, in f32: ``dq = scale·(p ⊙ (dO·vᵀ − delta))·k``."""
    with _f32(q.device):
        scale = q.shape[-1] ** -0.5
        qf, kf, vf, dof = _heads_first(q, k, v, do)
        p = _probs(qf, kf, lse, causal, scale)
        ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
        return ((ds @ kf) * scale).transpose(1, 2).to(q.dtype)


def plain_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """What K5 computes, in f32: ``(dk, dv) = (scale·dsᵀ·q, pᵀ·dO)``."""
    with _f32(q.device):
        scale = q.shape[-1] ** -0.5
        qf, kf, vf, dof = _heads_first(q, k, v, do)
        p = _probs(qf, kf, lse, causal, scale)
        ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
        dk = (ds.transpose(-1, -2) @ qf) * scale
        dv = p.transpose(-1, -2) @ dof
        return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def delta_rows(out, do):
    """``delta = rowsum(dO ⊙ O)`` in f32, ``[B, H, T]`` (a plain torch pass,
    as the JAX package leaves it to XLA)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# -- kernel wrappers -----------------------------------------------------------


def _check(q, k, v):
    """Raise on anything the kernels do not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, Dh], got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v must be float32, bfloat16 or float16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head dim {HEAD_DIMS}, got {q.shape[-1]}")


KERNELS = ("fwd", "dq", "dkv")  # K3, K4, K5


def uses_tensor_cores(dtype, kernel: str) -> bool:
    """Whether K3 (``"fwd"``), K4 (``"dq"``) or K5 (``"dkv"``) runs on the
    tensor cores for ``dtype``: every kernel does in every type the library
    takes, bf16 and f16 on ``mma.sync.m16n8k16`` and f32 as 3xTF32 on
    ``m16n8k8``."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel is one of {KERNELS}, got {kernel!r}")
    return dtype in _DTYPE_CODES


def rows_aligned(t) -> bool:
    """Whether every row ``t[b, i, h, :]`` of a ``[B, T, H, Dh]`` tensor
    starts on :data:`ROW_ALIGN` bytes: its address and its batch, time and
    head strides in bytes are multiples of it."""
    e = t.element_size()
    return t.data_ptr() % ROW_ALIGN == 0 and all(s * e % ROW_ALIGN == 0 for s in t.stride()[:3])


def _aligned_copy(t):
    """``t`` contiguous with aligned rows; a copy only where it is not."""
    t = t.contiguous()
    return t if rows_aligned(t) else t.clone()


def _qkv_strides(q, k, v):
    """q/k/v as the kernels read them: one set of (batch, time, head)
    strides, last dimension contiguous, every row on 16 bytes. Views of one
    fused projection already are (GPT-2's sit 1536 and 3072 bytes in,
    4608-byte time stride); anything else is copied to fresh contiguous
    tensors."""
    keep = q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
    keep = keep and all(rows_aligned(t) for t in (q, k, v))
    if not keep:
        q, k, v = (_aligned_copy(t) for t in (q, k, v))
    return (q, k, v), q.stride()[:3]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def kernel_forward(q, k, v, causal: bool = True):
    """Launch K3 on CUDA tensors; returns ``(out [B, T, H, Dh], lse [B, H, T])``."""
    global fwd_launches
    _check(q, k, v)
    (q, k, v), (sb, st, sh) = _qkv_strides(q, k, v)
    lib = csrc.load("flash_attn")
    b, t, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    code = lib.flash_attn_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, h, d, sb, st, sh, int(causal), d**-0.5, _stream(q.device),
    )
    csrc.check(lib, code, "flash_attn_forward")
    fwd_launches += 1
    return out, lse


def _check_grad_inputs(q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    b, t, h, _ = q.shape
    for name, s in (("lse", lse), ("delta", delta)):
        if tuple(s.shape) != (b, h, t) or s.dtype != torch.float32 or s.device != q.device:
            raise ValueError(f"{name} must be [B, H, T] = {(b, h, t)} float32 on {q.device}")
    return _aligned_copy(do), lse.contiguous(), delta.contiguous()


def kernel_dq(q, k, v, do, lse, delta, causal: bool = True):
    """Launch K4 on CUDA tensors; returns dq ``[B, T, H, Dh]``."""
    global dq_launches
    _check(q, k, v)
    do, lse, delta = _check_grad_inputs(q, do, lse, delta)
    (q, k, v), (sb, st, sh) = _qkv_strides(q, k, v)
    lib = csrc.load("flash_attn")
    b, t, h, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    code = lib.flash_attn_dq(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, h, d, sb, st, sh,
        int(causal), d**-0.5, _stream(q.device),
    )
    csrc.check(lib, code, "flash_attn_dq")
    dq_launches += 1
    return dq


def kernel_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """Launch K5 on CUDA tensors; returns ``(dk, dv)``, each ``[B, T, H, Dh]``."""
    global dkv_launches
    _check(q, k, v)
    do, lse, delta = _check_grad_inputs(q, do, lse, delta)
    (q, k, v), (sb, st, sh) = _qkv_strides(q, k, v)
    lib = csrc.load("flash_attn")
    b, t, h, d = q.shape
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    code = lib.flash_attn_dkv(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
        sb, st, sh, int(causal), d**-0.5, _stream(q.device),
    )
    csrc.check(lib, code, "flash_attn_dkv")
    dkv_launches += 1
    return dk, dv


def _on(q, kernel, plain, *args):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if q.is_cuda:
        return kernel(q, *args)
    if q.device.type != "cpu":
        raise RuntimeError(f"flash attention runs on CUDA or CPU, not {q.device}")
    return plain(q, *args)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        _check(q, k, v)
        out, lse = _on(q, kernel_forward, plain_forward, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = delta_rows(out, do)
        args = (k, v, do, lse, delta, ctx.causal)
        dq = _on(q, kernel_dq, plain_dq, *args)
        dk, dv = _on(q, kernel_dkv, plain_dkv, *args)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, bq: int = 128, bk: int = 128):
    """Flash attention. q/k/v: ``[B, T, H, Dh]`` -> ``[B, T, H, Dh]``.

    ``bq`` and ``bk`` keep the JAX package's block rule: after clipping to
    T, both must divide T. The CUDA kernels tile by their own 64 rows.
    """
    t = q.shape[1]
    bq, bk = min(bq, t), min(bk, t)
    _check_blocks(t, bq, bk)
    return _FlashAttention.apply(q, k, v, causal)


def make_flash_attn_fn(*, bq: int = 128, bk: int = 128):
    """Drop-in ``attn_fn`` for ``models.gpt2``: the kernels on a card, their
    plain versions on the CPU, and nothing else."""

    def attn_fn(q, k, v, *, causal: bool = True):
        return flash_attention(q, k, v, causal, bq, bk)

    return attn_fn
