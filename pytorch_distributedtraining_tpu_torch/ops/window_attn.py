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

import dataclasses
import math

import torch

from .. import csrc

MAX_N = 128  # pack=2 of SwinIR's 64-token windows
MAX_D = 32
ALIGN = 16  # bytes: the kernels' widest cp.async piece
FWD_BLOCKS_PER_SM = 4  # K1 (no partials): more, shorter blocks; fastest of 1-64 measured
BWD_BLOCKS_PER_SM = 2  # K2's target; SwinIR-S's bench shape takes one block per (head, class)
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
    q, k, v = (_aligned(t) for t in (q, k, v))
    lib = csrc.load("window_attn")
    bn, h, n, d = q.shape
    o = torch.empty_like(q)
    nw = 1 if mask is None else mask.shape[0]
    plan = forward_plan(bn, h, nw, _sm_count(q.device))
    code = lib.window_attn_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _ptr(mask), o.data_ptr(), bn, h, n, d, nw, plan.chunk,
        d**-0.5, _stream(q.device),
    )
    csrc.check(lib, code, "window_attn_forward")
    fwd_launches += 1
    return o


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """How K1 and K2 split the windows over blocks. A block takes head
    ``h`` and ``chunk`` windows of one mask class ``r`` (the windows ``w``
    with ``w % nw == r``, of which it takes the ``c``-th run), so it loads
    ``bias[h] + mask[r]`` once. A K2 block writes one dbias partial, and
    the partials are summed in their order. ``nw`` is the mask's window
    count (1 without a mask)."""

    bn: int
    nw: int
    chunk: int

    @property
    def classes(self) -> int:
        return min(self.nw, self.bn)

    @property
    def chunks(self) -> int:
        """Blocks per (head, class): class 0 has the most windows."""
        return math.ceil(math.ceil(self.bn / self.nw) / self.chunk)

    @property
    def blocks(self) -> int:
        """Blocks per head, one per (class, chunk); K2 writes a dbias
        partial for each."""
        return self.classes * self.chunks

    def windows(self, slot: int) -> list[int]:
        """The windows of block ``slot`` (= class * chunks + chunk) of a
        head, in the order the block takes them, as the kernels compute
        them."""
        r, c = divmod(slot, self.chunks)
        return [w for w in range(r + self.nw * c * self.chunk,
                                 r + self.nw * (c + 1) * self.chunk, self.nw) if w < self.bn]


def _plan(bn: int, heads: int, nw: int, sms: int, per_sm: int) -> WindowPlan:
    """About ``per_sm`` blocks per SM, or one block per (head, class) where
    that is already more."""
    classes = min(nw, bn)
    per_class = math.ceil(bn / nw)
    chunks = min(per_class, max(1, math.ceil(per_sm * sms / (heads * classes))))
    return WindowPlan(bn, nw, math.ceil(per_class / chunks))


def forward_plan(bn: int, heads: int, nw: int, sms: int) -> WindowPlan:
    """K1's split for ``bn`` windows, ``heads`` heads and ``nw`` mask windows
    (1 without a mask) on a card of ``sms`` SMs: about
    :data:`FWD_BLOCKS_PER_SM` blocks per SM, or one block per (head, class)
    where that is already more."""
    return _plan(bn, heads, nw, sms, FWD_BLOCKS_PER_SM)


def backward_plan(bn: int, heads: int, nw: int, sms: int) -> WindowPlan:
    """K2's split, as :func:`forward_plan` with :data:`BWD_BLOCKS_PER_SM`.
    Fewer, longer blocks write fewer dbias partials, and measured faster on
    the H100 than four blocks per SM."""
    return _plan(bn, heads, nw, sms, BWD_BLOCKS_PER_SM)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def uses_tensor_cores(dtype, kernel: str = "bwd") -> bool:
    """Whether a window-attention kernel runs tensor-core (HMMA)
    instructions for ``dtype``: K1 (``"fwd"``) and K2 (``"bwd"``) do in
    every type, bf16/f16 on ``mma.sync.m16n8k16`` and f32 as 3xTF32 on
    ``m16n8k8``."""
    if kernel not in ("fwd", "bwd"):
        raise ValueError(f"kernel is 'fwd' or 'bwd', got {kernel!r}")
    return dtype in _DTYPE_CODES


def _aligned(t):
    """``t`` (contiguous) on :data:`ALIGN` bytes; a copy only where it is not:
    K1 and K2 copy their tiles in pieces of up to 16 bytes, and the library
    refuses a tile pointer that is not aligned to its piece."""
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def kernel_backward(q, k, v, bias, mask, do):
    """Launch K2 (and its dbias reduction) on CUDA tensors."""
    global bwd_launches
    _check(q, k, v, bias, mask)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    _check_cuda(q, k, v, bias, mask, do)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lib = csrc.load("window_attn")
    bn, h, n, d = q.shape
    nw = 1 if mask is None else mask.shape[0]
    plan = backward_plan(bn, h, nw, _sm_count(q.device))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.empty((plan.blocks, h, n, n), dtype=torch.float32, device=q.device)
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    code = lib.window_attn_backward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _ptr(mask), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
        bn, h, n, d, nw, plan.chunk, d**-0.5, _stream(q.device),
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
    if mask is not None:  # copied block by block: no product that autocast would narrow
        nw = mask.shape[0]
        m = mask.reshape(nw // p, p, n, n)
        mask_p = mask.new_zeros(nw // p, pn, pn)
        for a in range(p):
            mask_p[:, a * n:(a + 1) * n, a * n:(a + 1) * n] = m[:, a]
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
