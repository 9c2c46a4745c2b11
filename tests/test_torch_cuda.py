"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip without
one (a CUDA kernel has no interpret mode). On a GPU machine, where JAX
need not be installed (the suite's ``conftest.py`` imports it)::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: in f32 the kernel and the plain version differ only in sum
order (~1e-6 relative; the 3xTF32 products of K1-K5 keep about f32's
digits); in
bf16 and f16 both round the same f32 result, so outputs may differ by one
step of the type (2^-8 relative in bf16, 2^-11 in f16, held at 1e-2 and
2e-3), and the tensor-core bodies of K1-K5 also round P (and dS) to the
input's type before their second products (the same step again, on terms
that mostly cancel). lse and dbias are f32 in every case. The tiny
GPT-2 holds gradients at 1e-4 relative to their largest entry: f32 sums
in another order through two blocks. ``FusedAdamW`` on the card is held
at 1e-6 of the largest parameter against its own CPU run and the per-leaf
``AdamW`` (an ulp or two of f32 a step apart).
"""

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch import csrc
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config, SwinIR
from pytorch_distributedtraining_tpu_torch.models.swinir import _shift_attn_mask
from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa
from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel):
    scale = max(1.0, want.abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= rel * scale


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n,d", [(64, 10), (16, 6), (49, 32), (128, 32), (49, 10), (49, 7),
                                 (100, 17)])
def test_kernels_match_plain(cuda, dtype, rel, with_mask, n, d):
    """K1 and K2 at window sizes 8 (n = 64), 4 and 7 (49 keys, padded to
    64 in K2) and 128 (pack 2), head dims padded to 16 or 32 in K2: d = 10
    has rows of 20 or 40 bytes (4- or 8-byte copies), d = 7 and 17 rows of
    an odd number of 2-byte elements (read element by element)."""
    g = torch.Generator().manual_seed(0)
    bn, h, nw = 24, 3, 4
    q, k, v, do = (torch.randn(bn, h, n, d, generator=g).to(cuda, dtype) for _ in range(4))
    bias = torch.randn(h, n, n, generator=g).to(cuda)
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(nw, n, n, generator=g) > 0.8, -100.0, 0.0).to(cuda)
    _close(twa.kernel_forward(q, k, v, bias, mask), twa.plain_forward(q, k, v, bias, mask), rel)
    got = twa.kernel_backward(q, k, v, bias, mask, do)
    want = twa.plain_backward(q, k, v, bias, mask, do)
    for a, b in zip(got, want):
        _close(a, b, rel)


SWINIR_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2), (torch.float16, 2e-3)]


def _swinir_case(cuda, dtype, bn, lr, seed=5):
    """q/k/v/dO at SwinIR-S's shape [bn, 6, 64, 10] with the shift mask of
    an LR x LR image in windows of 8 ((LR/8)^2 mask windows)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(bn, 6, 64, 10, generator=g).to(cuda, dtype) for _ in range(4))
    bias = (torch.randn(6, 64, 64, generator=g) * 0.5).to(cuda)
    mask = torch.from_numpy(_shift_attn_mask(lr, lr, 8, 4)).to(cuda)
    return q, k, v, bias, mask, do


@pytest.mark.parametrize("dtype,rel", SWINIR_DTYPES)
@pytest.mark.parametrize("bn,lr", [(1152, 64), (160, 32)])
def test_kernels_match_plain_at_swinir_shapes(cuda, dtype, rel, bn, lr):
    """The bench shape (batch 18 at LR 64: 64 mask windows) and the
    driver's validation batch (10 images at LR 32: 16 mask windows)."""
    q, k, v, bias, mask, do = _swinir_case(cuda, dtype, bn, lr)
    _close(twa.kernel_forward(q, k, v, bias, mask), twa.plain_forward(q, k, v, bias, mask), rel)
    for a, b in zip(twa.kernel_backward(q, k, v, bias, mask, do),
                    twa.plain_backward(q, k, v, bias, mask, do)):
        _close(a, b, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_backward_is_deterministic(cuda, dtype):
    """K2 twice on the same inputs gives the same bits: the dbias partials
    are summed in a fixed order, with no atomics."""
    args = _swinir_case(cuda, dtype, 1152, 64)
    first = twa.kernel_backward(*args)
    second = twa.kernel_backward(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_backward_copies_a_misaligned_tile_and_the_library_refuses_it(cuda, dtype):
    """Window 7 at d = 10: a tile row is 20 (bf16/f16) or 40 (f32) bytes, so
    K2 copies 4- or 8-byte pieces. A contiguous dO that starts one element
    into its buffer sits on no such piece: the wrapper copies it, so K2
    gives what it gives on an aligned copy; called directly, the library
    refuses it rather than read it wrong."""
    g = torch.Generator().manual_seed(6)
    bn, h, n, d = 24, 3, 49, 10
    q, k, v, dense = (torch.randn(bn, h, n, d, generator=g).to(cuda, dtype) for _ in range(4))
    bias = torch.randn(h, n, n, generator=g).to(cuda)
    flat = torch.empty(dense.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = dense.flatten()
    do = flat[1:].view(bn, h, n, d)
    assert do.is_contiguous() and do.data_ptr() % twa.ALIGN != 0
    for a, b in zip(twa.kernel_backward(q, k, v, bias, None, do),
                    twa.kernel_backward(q, k, v, bias, None, dense)):
        assert torch.equal(a, b)

    lib = csrc.load("window_attn")
    plan = twa.backward_plan(bn, h, 1, torch.cuda.get_device_properties(cuda).multi_processor_count)
    dq, dk, dv = (torch.zeros_like(dense) for _ in range(3))
    part = torch.zeros(plan.blocks, h, n, n, device=cuda)
    dbias = torch.zeros(h, n, n, device=cuda)
    code = lib.window_attn_backward(
        twa._DTYPE_CODES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None,
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), part.data_ptr(),
        dbias.data_ptr(), bn, h, n, d, 1, plan.chunk, d**-0.5,
        torch.cuda.current_stream(cuda).cuda_stream,
    )
    torch.cuda.synchronize()
    assert code != 0 and "misaligned" in lib.error_string(code).decode()
    assert not dq.any() and not dbias.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_forward_copies_a_misaligned_tile_and_the_library_refuses_it(cuda, dtype):
    """K1 at window 7, d = 10 (4- or 8-byte copies of 20- or 40-byte rows):
    a contiguous v that starts one element into its buffer is copied by
    the wrapper, so K1 gives what it gives on an aligned copy; called
    directly, the library refuses it rather than read it wrong."""
    g = torch.Generator().manual_seed(7)
    bn, h, n, d = 24, 3, 49, 10
    q, k, dense = (torch.randn(bn, h, n, d, generator=g).to(cuda, dtype) for _ in range(3))
    bias = torch.randn(h, n, n, generator=g).to(cuda)
    flat = torch.empty(dense.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = dense.flatten()
    v = flat[1:].view(bn, h, n, d)
    assert v.is_contiguous() and v.data_ptr() % twa.ALIGN != 0
    assert torch.equal(twa.kernel_forward(q, k, v, bias, None),
                       twa.kernel_forward(q, k, dense, bias, None))

    lib = csrc.load("window_attn")
    plan = twa.forward_plan(bn, h, 1, torch.cuda.get_device_properties(cuda).multi_processor_count)
    o = torch.zeros_like(dense)
    code = lib.window_attn_forward(
        twa._DTYPE_CODES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None,
        o.data_ptr(), bn, h, n, d, 1, plan.chunk, d**-0.5,
        torch.cuda.current_stream(cuda).cuda_stream,
    )
    torch.cuda.synchronize()
    assert code != 0 and "misaligned" in lib.error_string(code).decode()
    assert not o.any()


def test_packed_windows_match_unpacked(cuda):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(16, 2, 64, 10, generator=g).to(cuda) for _ in range(3))
    bias = torch.randn(2, 64, 64, generator=g).to(cuda)
    mask = torch.where(torch.rand(4, 64, 64, generator=g) > 0.8, -100.0, 0.0).to(cuda)
    _close(twa.window_attention_packed(q, k, v, bias, mask, pack=2),
           twa.window_attention(q, k, v, bias, mask), 1e-5)


def test_toy_swinir_on_the_card_matches_the_cpu(cuda):
    model = SwinIR(img_size=8, window_size=4, depths=(2, 2), embed_dim=12, num_heads=(2, 2),
                   generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random((2, 8, 8, 3), dtype=np.float32))
    want = model(x)
    before = twa.fwd_launches
    got = model.to(cuda)(x.to(cuda))
    assert twa.fwd_launches - before == 4
    _close(got.cpu(), want, 1e-5)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(128, 64), (100, 32), (64, 16), (512, 64), (512, 16),
                                 (200, 64), (200, 32)])
def test_flash_kernels_match_plain(cuda, dtype, rel, causal, t, d):
    """K3, K4 and K5 on q/k/v that are strided views of one fused [B, T,
    3*H*D] projection, as GPT-2 hands them over. T = 512 runs eight 64-row
    tiles with the causal diagonal; T = 100 and 200 end on a ragged tile.
    K3, K4 and K5 run on the tensor cores in every type (f32 as 3xTF32)."""
    g = torch.Generator().manual_seed(0)
    b, h = 2, 3
    qkv = torch.randn(b, t, 3 * h * d, generator=g).to(cuda, dtype)
    q, k, v = (a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1))
    do = torch.randn(b, t, h, d, generator=g).to(cuda, dtype)
    out, lse = tfa.kernel_forward(q, k, v, causal)
    want_out, want_lse = tfa.plain_forward(q, k, v, causal)
    _close(out, want_out, rel)
    _close(lse, want_lse, 1e-5)
    delta = tfa.delta_rows(want_out, do)
    _close(tfa.kernel_dq(q, k, v, do, want_lse, delta, causal),
           tfa.plain_dq(q, k, v, do, want_lse, delta, causal), rel)
    for a, w in zip(tfa.kernel_dkv(q, k, v, do, want_lse, delta, causal),
                    tfa.plain_dkv(q, k, v, do, want_lse, delta, causal)):
        _close(a, w, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_on_unaligned_views_match_contiguous(cuda, dtype, causal):
    """q/k/v as views of a buffer whose rows are one element wider and
    start one element in: no row sits on 16 bytes, so the wrappers copy
    them for every body (all on the tensor cores, f32 K4 included). The
    results equal those on contiguous copies."""
    g = torch.Generator().manual_seed(2)
    b, t, h, d = 2, 200, 3, 64
    flat = torch.randn(b * t * (3 * h * d + 1) + 1, generator=g).to(cuda, dtype)
    qkv = flat[1:].view(b, t, 3 * h * d + 1)[..., : 3 * h * d]
    views = [a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1)]
    assert not any(tfa.rows_aligned(x) for x in views)
    dense = [x.contiguous() for x in views]
    do = torch.randn(b, t, h, d, generator=g).to(cuda, dtype)
    out, lse = tfa.kernel_forward(*views, causal)
    want_out, want_lse = tfa.kernel_forward(*dense, causal)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = tfa.delta_rows(want_out, do)
    args = (do, want_lse, delta, causal)
    assert torch.equal(tfa.kernel_dq(*views, *args), tfa.kernel_dq(*dense, *args))
    for a, w in zip(tfa.kernel_dkv(*views, *args), tfa.kernel_dkv(*dense, *args)):
        assert torch.equal(a, w)


def _fused_qkv(cuda, dtype, b, t, h, d, g):
    """q/k/v as views of one fused [B, T, 3*H*D] projection, and dO."""
    qkv = torch.randn(b, t, 3 * h * d, generator=g).to(cuda, dtype)
    q, k, v = (a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1))
    return q, k, v, torch.randn(b, t, h, d, generator=g).to(cuda, dtype)


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 1e-2), (torch.float16, 2e-3)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 65, 200])
def test_flash_dq_tensor_cores_on_ragged_lengths(cuda, dtype, rel, causal, d, t):
    """K4's tensor-core body where T ends inside a key tile: T = 1 (one key;
    63 of the block's rows lie past T), 65 (one key into the second tile,
    which is also the causal diagonal of the second query tile) and 200
    (eight keys into the fourth). Keys past T and, on the diagonal, keys
    after a row must add nothing to its dq."""
    q, k, v, do = _fused_qkv(cuda, dtype, 2, t, 3, d, torch.Generator().manual_seed(3))
    out, lse = tfa.plain_forward(q, k, v, causal)
    args = (do, lse, tfa.delta_rows(out, do), causal)
    before = tfa.dq_launches
    got = tfa.kernel_dq(q, k, v, *args)
    assert tfa.dq_launches == before + 1
    _close(got, tfa.plain_dq(q, k, v, *args), rel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_dq_copies_a_misaligned_grad_and_the_library_refuses_it(cuda, dtype):
    """A contiguous dO that starts one element into its buffer: the wrapper
    copies it, so K4 gives what it gives on an aligned copy; called
    directly, the library refuses it rather than read it wrong."""
    b, t, h, d = 2, 200, 3, 64
    g = torch.Generator().manual_seed(4)
    q, k, v, dense = _fused_qkv(cuda, dtype, b, t, h, d, g)
    flat = torch.empty(dense.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = dense.flatten()
    do = flat[1:].view(b, t, h, d)
    assert do.is_contiguous() and not tfa.rows_aligned(do) and tfa.rows_aligned(q)
    out, lse = tfa.plain_forward(q, k, v, True)
    delta = tfa.delta_rows(out, dense)
    assert torch.equal(tfa.kernel_dq(q, k, v, do, lse, delta),
                       tfa.kernel_dq(q, k, v, dense, lse, delta))

    lib = csrc.load("flash_attn")
    dq = torch.zeros_like(dense)
    code = lib.flash_attn_dq(
        tfa._DTYPE_CODES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, h, d, *q.stride()[:3], 1,
        d**-0.5, torch.cuda.current_stream(cuda).cuda_stream,
    )
    torch.cuda.synchronize()
    assert code != 0 and "misaligned" in lib.error_string(code).decode()
    assert not dq.any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 65, 100, 200])
def test_flash_fwd_f32_tensor_cores_on_ragged_lengths(cuda, causal, d, t):
    """f32 K3 (3xTF32) where T ends inside a key tile: T = 1 (63 of the
    block's rows past T), 65 (one key into the second tile, the causal
    diagonal of the second query tile), 100 and 200. Keys past T and, on
    the diagonal, keys after a row must add nothing; o and lse hold f32's
    tolerance. Two launches give the same bits."""
    q, k, v, _ = _fused_qkv(cuda, torch.float32, 2, t, 3, d, torch.Generator().manual_seed(5))
    before = tfa.fwd_launches
    out, lse = tfa.kernel_forward(q, k, v, causal)
    assert tfa.fwd_launches == before + 1
    want_out, want_lse = tfa.plain_forward(q, k, v, causal)
    _close(out, want_out, 1e-5)
    _close(lse, want_lse, 1e-5)
    again = tfa.kernel_forward(q, k, v, causal)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


def test_flash_fwd_f32_copies_a_misaligned_view_and_the_library_refuses_it(cuda):
    """f32 q/k/v as views of a buffer whose rows start one float off 16
    bytes: the wrapper copies them for K3's tensor-core body, which then
    gives what it gives on contiguous copies; called directly on the
    views, the library refuses them rather than read them wrong."""
    b, t, h, d = 2, 200, 3, 64
    g = torch.Generator().manual_seed(6)
    flat = torch.randn(b * t * (3 * h * d + 1) + 1, generator=g).to(cuda)
    qkv = flat[1:].view(b, t, 3 * h * d + 1)[..., : 3 * h * d]
    q, k, v = (a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1))
    assert not any(tfa.rows_aligned(x) for x in (q, k, v))
    dense = [x.contiguous() for x in (q, k, v)]
    out, lse = tfa.kernel_forward(q, k, v, True)
    want_out, want_lse = tfa.kernel_forward(*dense, True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)

    lib = csrc.load("flash_attn")
    o = torch.zeros_like(dense[0])
    stats = torch.zeros(b, h, t, device=cuda)
    code = lib.flash_attn_forward(
        tfa._DTYPE_CODES[torch.float32], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        stats.data_ptr(), b, t, h, d, *q.stride()[:3], 1, d**-0.5,
        torch.cuda.current_stream(cuda).cuda_stream,
    )
    torch.cuda.synchronize()
    assert code != 0 and "misaligned" in lib.error_string(code).decode()
    assert not o.any() and not stats.any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 65, 100, 200])
def test_flash_dkv_f32_tensor_cores_on_ragged_lengths(cuda, causal, d, t):
    """f32 K5 (3xTF32) where T ends inside a query tile: T = 1 (63 of the
    block's keys and every query row but one past T), 65 (one query into
    the second tile, the causal diagonal of the second key tile), 100 and
    200. Queries past T and, on the diagonal, queries before a key must add
    nothing; dk and dv hold f32's tolerance. Two launches give the same
    bits."""
    q, k, v, do = _fused_qkv(cuda, torch.float32, 2, t, 3, d, torch.Generator().manual_seed(7))
    out, lse = tfa.plain_forward(q, k, v, causal)
    args = (do, lse, tfa.delta_rows(out, do), causal)
    before = tfa.dkv_launches
    dk, dv = tfa.kernel_dkv(q, k, v, *args)
    assert tfa.dkv_launches == before + 1
    want_dk, want_dv = tfa.plain_dkv(q, k, v, *args)
    _close(dk, want_dk, 1e-5)
    _close(dv, want_dv, 1e-5)
    again = tfa.kernel_dkv(q, k, v, *args)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


def test_flash_dkv_f32_copies_a_misaligned_view_and_the_library_refuses_it(cuda):
    """f32 q/k/v as views of a buffer whose rows start one float off 16
    bytes: the wrapper copies them for K5's tensor-core body, which then
    gives what it gives on contiguous copies; called directly on the
    views, the library refuses them rather than read them wrong."""
    b, t, h, d = 2, 200, 3, 64
    g = torch.Generator().manual_seed(8)
    flat = torch.randn(b * t * (3 * h * d + 1) + 1, generator=g).to(cuda)
    qkv = flat[1:].view(b, t, 3 * h * d + 1)[..., : 3 * h * d]
    q, k, v = (a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1))
    assert not any(tfa.rows_aligned(x) for x in (q, k, v))
    dense = [x.contiguous() for x in (q, k, v)]
    do = torch.randn(b, t, h, d, generator=g).to(cuda)
    out, lse = tfa.plain_forward(*dense, True)
    args = (do, lse, tfa.delta_rows(out, do), True)
    for got, want in zip(tfa.kernel_dkv(q, k, v, *args), tfa.kernel_dkv(*dense, *args)):
        assert torch.equal(got, want)

    lib = csrc.load("flash_attn")
    dk, dv = torch.zeros_like(do), torch.zeros_like(do)
    code = lib.flash_attn_dkv(
        tfa._DTYPE_CODES[torch.float32], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), args[2].data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
        *q.stride()[:3], 1, d**-0.5, torch.cuda.current_stream(cuda).cuda_stream,
    )
    torch.cuda.synchronize()
    assert code != 0 and "misaligned" in lib.error_string(code).decode()
    assert not dk.any() and not dv.any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 65, 100, 200])
def test_flash_dq_f32_tensor_cores_on_ragged_lengths(cuda, causal, d, t):
    """f32 K4 (3xTF32) where T ends inside a key tile: T = 1 (one key; 63
    of the block's rows past T), 65 (one key into the second tile, the
    causal diagonal of the second query tile), 100 and 200. Keys past T
    and, on the diagonal, keys after a row must add nothing to its dq,
    which holds f32's tolerance. Two launches give the same bits."""
    q, k, v, do = _fused_qkv(cuda, torch.float32, 2, t, 3, d, torch.Generator().manual_seed(9))
    out, lse = tfa.plain_forward(q, k, v, causal)
    args = (do, lse, tfa.delta_rows(out, do), causal)
    before = tfa.dq_launches
    dq = tfa.kernel_dq(q, k, v, *args)
    assert tfa.dq_launches == before + 1
    _close(dq, tfa.plain_dq(q, k, v, *args), 1e-5)
    assert torch.equal(tfa.kernel_dq(q, k, v, *args), dq)


def test_flash_dq_f32_copies_a_misaligned_view_and_the_library_refuses_it(cuda):
    """f32 q/k/v as views of a buffer whose rows start one float off 16
    bytes: the wrapper copies them for K4's tensor-core body, which then
    gives what it gives on contiguous copies; called directly on the
    views, the library refuses them rather than read them wrong."""
    b, t, h, d = 2, 200, 3, 64
    g = torch.Generator().manual_seed(10)
    flat = torch.randn(b * t * (3 * h * d + 1) + 1, generator=g).to(cuda)
    qkv = flat[1:].view(b, t, 3 * h * d + 1)[..., : 3 * h * d]
    q, k, v = (a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1))
    assert not any(tfa.rows_aligned(x) for x in (q, k, v))
    dense = [x.contiguous() for x in (q, k, v)]
    do = torch.randn(b, t, h, d, generator=g).to(cuda)
    out, lse = tfa.plain_forward(*dense, True)
    args = (do, lse, tfa.delta_rows(out, do), True)
    assert torch.equal(tfa.kernel_dq(q, k, v, *args), tfa.kernel_dq(*dense, *args))

    lib = csrc.load("flash_attn")
    dq = torch.zeros_like(do)
    code = lib.flash_attn_dq(
        tfa._DTYPE_CODES[torch.float32], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), args[2].data_ptr(), dq.data_ptr(), b, t, h, d, *q.stride()[:3], 1,
        d**-0.5, torch.cuda.current_stream(cuda).cuda_stream,
    )
    torch.cuda.synchronize()
    assert code != 0 and "misaligned" in lib.error_string(code).decode()
    assert not dq.any()


def test_tiny_gpt2_on_the_card_matches_the_cpu(cuda):
    cfg = GPT2Config.tiny(n_embd=128, n_head=2, n_positions=128)
    model = GPT2(cfg, attn_fn=tfa.make_flash_attn_fn(),
                 generator=torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 128)))
    want = model(tok)
    want.square().mean().backward()
    want_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    before = tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches
    got = model.to(cuda)(tok.to(cuda))
    got.square().mean().backward()
    after = tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    _close(got.cpu(), want, 1e-5)
    for n, p in model.named_parameters():
        _close(p.grad.cpu(), want_grads[n], 1e-4)


def _card_against_cpu(model, x, out_rel, grad_rel, cuda):
    """Forward and parameter gradients of ``model`` (training mode) on the
    card against the same model on the CPU; the ResNets' running
    statistics too."""
    start = [b.clone() for b in model.buffers()]
    want = model(x)
    want.square().mean().backward()
    want_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    cpu_buffers = {n: b.clone() for n, b in model.named_buffers()}
    model.zero_grad()
    for b, v in zip(model.buffers(), start):  # the card's forward from the same statistics
        b.copy_(v)
    got = model.to(cuda)(x.to(cuda))
    got.square().mean().backward()
    _close(got.cpu(), want, out_rel)
    scale = max(g.abs().max().item() for g in want_grads.values())
    for n, p in model.named_parameters():
        assert (p.grad.cpu() - want_grads[n]).abs().max().item() <= grad_rel * scale, n
    for n, b in model.named_buffers():
        if b.is_floating_point():
            assert (b.cpu() - cpu_buffers[n]).abs().max().item() <= 1e-5, n


@pytest.mark.parametrize("small_inputs", [True, False], ids=["cifar-stem", "imagenet-stem"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_tiny_resnet_on_the_card_matches_the_cpu(cuda, small_inputs, block):
    """cuDNN's convolutions on the channels_last view against the CPU's
    NCHW, with the asymmetric pads and the port's BatchNorm; f32 without
    TF32: outputs within 1e-5, gradients within 1e-4 of the largest."""
    from pytorch_distributedtraining_tpu_torch.models import resnet

    block_cls = resnet.BasicBlock if block == "basic" else resnet.BottleneckBlock
    model = resnet.ResNet((1, 1), block_cls, num_classes=10, num_filters=8,
                          small_inputs=small_inputs, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # the zero-initialised last BatchNorms would carry no signal
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                m.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32))
    _card_against_cpu(model, x, 1e-5, 1e-4, cuda)


@pytest.mark.parametrize("dtype,out_rel,grad_rel", [(torch.float32, 1e-5, 1e-4),
                                                    (torch.bfloat16, 1e-3, 1e-3)])
def test_tiny_vit_on_the_card_matches_the_cpu(cuda, dtype, out_rel, grad_rel):
    """The tiny ViT in f32 and bf16, cuBLAS against the CPU's GEMMs. On
    this seeded input bf16 agrees exactly in the output and to 1.8e-5 in
    the gradients (H100, torch 2.11): the limits catch a path that lost
    precision, such as bf16 accumulation or a cast of the gradients."""
    from pytorch_distributedtraining_tpu_torch.models import ViT, ViTConfig

    model = ViT(ViTConfig.tiny(dtype=dtype), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # the init zeroes the head
        model.heads.head.weight.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(np.float32))
    _card_against_cpu(model, x, out_rel, grad_rel, cuda)


# a ragged parameter list: 2601 elements, not a multiple of the 1024 padding
RAGGED = [(37, 11), (5,), (3, 7, 9), (2000,)]


@pytest.mark.parametrize("kw", [dict(clip_grad_norm=0.5), dict(clip_grad_norm=0.5, ema_decay=0.9),
                                dict(weight_decay=0.0, clip_grad_value=0.05)],
                         ids=["clip", "ema", "value-clip"])
def test_fused_adamw_on_the_card_matches_its_cpu_run_and_adamw(cuda, kw):
    """Five steps of seeded grads: FusedAdamW on the card against the same
    code on the CPU and against the per-leaf AdamW on the card, within 1e-6
    relative to the largest parameter (an ulp or two of f32 a step: the
    per-leaf chain's bias correction is in doubles, the fused one's in f32)."""
    from pytorch_distributedtraining_tpu_torch import optim

    g0 = torch.Generator().manual_seed(3)
    init = [torch.randn(s, generator=g0) for s in RAGGED]

    def params(device):
        return [t.to(device).clone().requires_grad_(True) for t in init]

    kw = dict(lr=1e-3, **kw)
    fused, on_cpu = optim.FusedAdamW(params(cuda), **kw), optim.FusedAdamW(params("cpu"), **kw)
    leaf = optim.AdamW(params(cuda), **kw)
    n, sizes = fused.numel, [t.numel() for t in init]
    assert n == 2601 and fused.offsets == [0, 448, 512, 704] and fused.flat_param.numel() == 3072
    for step in range(5):
        g = torch.randn(n, generator=torch.Generator().manual_seed(step)) * 0.01 * (step + 1)
        for p, a in zip(leaf.params, g.split(sizes)):
            p.grad = a.view_as(p).to(cuda)
        for opt in (on_cpu, fused):  # into the views of the flat grad buffer
            for p, a in zip(opt.params, g.split(sizes)):
                p.grad.copy_(a.view_as(p))
        on_cpu.apply_tree()
        fused.apply_tree()
        leaf.step(leaf.grads())
    _close(fused.flat_param.cpu(), on_cpu.flat_param, 1e-6)
    for buf in ("mu", "nu") + (("ema",) if "ema_decay" in kw else ()):
        _close(getattr(fused.state, buf).cpu(), getattr(on_cpu.state, buf), 1e-6)
    assert int(fused.state.count) == 5
    for a, b in zip(fused.params, leaf.params):
        _close(a.detach(), b.detach(), 1e-6)
    if "ema_decay" in kw:
        for a, b in zip(optim.ema_params(fused), optim.ema_params(leaf)):
            _close(a, b, 1e-6)
    pads = torch.ones(fused.flat_param.numel(), dtype=torch.bool)
    for o, t in zip(fused.offsets, init):
        pads[o:o + t.numel()] = False
    assert fused.flat_param.cpu()[pads].abs().max().item() == 0.0


def test_fused_adamw_gate_skips_without_a_host_read(cuda):
    from pytorch_distributedtraining_tpu_torch import optim
    from pytorch_distributedtraining_tpu_torch.precision import DynamicLossScaler

    fused = optim.FusedAdamW([torch.randn(s, device=cuda).requires_grad_(True) for s in RAGGED],
                             lr=1e-3, clip_grad_norm=0.5)
    fused.flat_grad.normal_()
    fused.apply_tree()
    fused.flat_grad[17] = float("inf")
    before = {"params": fused.flat_param.clone(), "mu": fused.state.mu.clone(),
              "nu": fused.state.nu.clone(), "count": fused.state.count.clone()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, finite = fused.apply_tree(scaler=DynamicLossScaler())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not bool(finite)
    assert torch.equal(fused.flat_param, before["params"])
    for name in ("mu", "nu", "count"):
        assert torch.equal(getattr(fused.state, name), before[name]), name
