"""Port flash attention (plain versions) vs the JAX Pallas kernels.

The JAX side runs ``ops/pallas_attn.py`` in interpret mode, as
``tests/test_pallas_attn.py`` does; the port's CPU tensors take the plain
versions of K3/K4/K5 through the same ``torch.autograd.Function`` that
launches the kernels on a card. Same inputs from one numpy seed, same
cotangent, B 2, T 128, H 2, Dh 16; one case at B 1, T 512 with 128-row
blocks (four tiles a side, causal skipping). The wrapper's host-side
decisions (the tensor-core bodies by dtype, the row alignment they need)
are plain functions, tested here without a card.

Tolerances: both sides compute in f32 with different sum orders (and the
conftest's ``jax_disable_most_optimizations``); outputs and lse agree to
~1e-6 and gradients to ~1e-5, held at 1e-5 and 1e-4. In bf16 both round
an f32 result to bf16 (one step is 2^-8 relative), held at 3e-2 as the
JAX package's own bf16 test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.ops import pallas_attn as pa
from pytorch_distributedtraining_tpu_torch import csrc
from pytorch_distributedtraining_tpu_torch.models.gpt2 import default_attention
from pytorch_distributedtraining_tpu_torch.ops import flash_attn as tfa

B, T, H, DH = 2, 128, 2, 16
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
BLOCKS = [(32, 32), (64, 32), (128, 128)]


def _inputs(seed=0, t=T, dh=DH):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, t, H, dh)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", BLOCKS)
def test_forward_and_lse_match_pallas(causal, bq, bk):
    q, k, v, _ = _inputs()
    want_out, want_lse = pa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                           bq=bq, bk=bk, interpret=True)
    out = tfa.flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal, bq, bk)
    _, lse = tfa.plain_forward(*(torch.tensor(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=FWD_ATOL)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=FWD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(32, 64), (64, 32), (128, 128)])
def test_gradients_match_pallas(causal, bq, bk):
    """dq, dk, dv through the autograd Function against ``jax.grad`` of the
    Pallas custom_vjp, with a random cotangent so every row counts."""
    q, k, v, g = _inputs(seed=1)

    def f(q, k, v):
        return jnp.sum(pa.flash_attention(q, k, v, causal, bq, bk, True) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tfa.flash_attention(*leaves, causal, bq, bk).backward(torch.tensor(g))
    for leaf, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=name)


def test_four_tiles_with_causal_skipping_match_pallas():
    """T = 512 with bq = bk = 128: the Pallas kernels skip the tiles past
    the diagonal and mask the diagonal ones, as the CUDA kernels do with
    their own 64-row tiles; forward, lse and all three gradients."""
    r = np.random.default_rng(4)
    q, k, v, g = (r.standard_normal((1, 512, H, DH)).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out, want_lse = pa._flash_forward(jq, jk, jv, causal=True, bq=128, bk=128,
                                           interpret=True)
    want = jax.grad(lambda *a: jnp.sum(pa.flash_attention(*a, True, 128, 128, True) * g),
                    argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, True, 128, 128)
    out.backward(torch.tensor(g))
    _, lse = tfa.plain_forward(*(torch.tensor(a) for a in (q, k, v)), True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=FWD_ATOL)
    for leaf, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=name)


def test_bf16_inputs_keep_their_dtype():
    q, k, v, _ = _inputs(seed=2)
    want = pa.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                              True, 64, 64, True)
    out = tfa.flash_attention(*(torch.tensor(a).bfloat16() for a in (q, k, v)), True, 64, 64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_indivisible_seq_raises():
    q, k, v, _ = (torch.tensor(a) for a in _inputs(t=100))
    with pytest.raises(ValueError, match="must divide"):
        tfa.flash_attention(q, k, v, True, 64, 64)


def test_other_head_dims_raise():
    q, k, v, _ = (torch.tensor(a) for a in _inputs(dh=24))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v)


def test_cpu_tensors_never_touch_csrc(monkeypatch):
    def refuse(name):
        raise AssertionError(f"csrc.load({name!r}) on a CPU tensor")

    monkeypatch.setattr(csrc, "load", refuse)
    tfa.reset_launch_counts()
    leaves = [torch.tensor(a, requires_grad=True) for a in _inputs()[:3]]
    tfa.flash_attention(*leaves).sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_is_the_gradient_of_plain_forward(causal):
    """K4's and K5's plain versions against autograd through K3's, so the
    explicit backward the kernels are held against on the card is itself
    right; and the flash ``attn_fn`` against plain softmax attention."""
    q, k, v, g = (torch.tensor(a) for a in _inputs(seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = tfa.plain_forward(*leaves, causal)
    out.backward(g)
    delta = tfa.delta_rows(out.detach(), g)
    dq = tfa.plain_dq(q, k, v, g, lse.detach(), delta, causal)
    dk, dv = tfa.plain_dkv(q, k, v, g, lse.detach(), delta, causal)
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=1e-5)
    attn = tfa.make_flash_attn_fn(bq=64, bk=32)
    torch.testing.assert_close(attn(q, k, v, causal=causal),
                               default_attention(q, k, v, causal=causal), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel", tfa.KERNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_body_is_chosen_by_dtype(dtype, kernel):
    """Tensor cores for every body: bf16/f16 on m16n8k16, f32 as 3xTF32."""
    assert tfa.uses_tensor_cores(dtype, kernel) is True


def test_uses_tensor_cores_names_a_kernel():
    assert not tfa.uses_tensor_cores(torch.float64, "fwd")
    with pytest.raises(ValueError, match="kernel"):
        tfa.uses_tensor_cores(torch.float32, "bwd")


def _fused_views(dtype, width_pad=0, offset=0, b=2, t=8, h=3, d=64):
    """q/k/v as GPT-2 hands them over: views of one [B, T, 3*H*D] buffer,
    optionally with extra columns per row and a start offset (elements)."""
    flat = torch.arange(b * t * (3 * h * d + width_pad) + offset).to(dtype)
    qkv = flat[offset:].view(b, t, 3 * h * d + width_pad)[..., : 3 * h * d]
    return [a.unflatten(-1, (h, d)) for a in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize("width_pad,offset,aligned", [(0, 0, True), (8, 8, True),
                                                      (1, 0, False), (0, 1, False)])
def test_rows_aligned_reads_address_and_strides(width_pad, offset, aligned):
    """GPT-2's fused views start 1536 and 3072 bytes in with a 4608-byte
    time stride, all multiples of 16; an odd row width or start is not."""
    q, k, v = _fused_views(torch.bfloat16, width_pad, offset)
    assert [tfa.rows_aligned(t) for t in (q, k, v)] == [aligned] * 3


def test_qkv_strides_keeps_aligned_views_and_copies_the_rest():
    """One rule for K3, K4 and K5 in every type: aligned views of the fused
    projection go through as they are, anything else is copied."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _fused_views(dtype)
        (q2, k2, v2), strides = tfa._qkv_strides(q, k, v)
        assert [t.data_ptr() for t in (q2, k2, v2)] == [t.data_ptr() for t in (q, k, v)]
        assert strides == q.stride()[:3]

        q, k, v = _fused_views(dtype, width_pad=1)
        (q2, k2, v2), strides = tfa._qkv_strides(q, k, v)
        for got, want in zip((q2, k2, v2), (q, k, v)):
            assert got.is_contiguous() and tfa.rows_aligned(got) and torch.equal(got, want)
        assert strides == q2.stride()[:3]

    # f32 K4 stages rows by cp.async too: an unaligned f32 view is copied
    q, k, v = _fused_views(torch.float32, width_pad=1, offset=1)
    (q2, _, _), strides = tfa._qkv_strides(q, k, v)
    assert q2.data_ptr() != q.data_ptr() and tfa.rows_aligned(q2) and torch.equal(q2, q)
    assert strides == q2.stride()[:3]


@pytest.mark.parametrize("width_pad,offset,copied", [(0, 0, False), (4, 4, False),
                                                     (1, 0, True), (0, 1, True)])
def test_qkv_strides_copies_unaligned_f32_views_for_k3_only(width_pad, offset, copied):
    """Every f32 body (K3, K4 and K5, all on the tensor cores now) stages
    its rows by 16-byte ``cp.async`` like the bf16 bodies: the one stride
    rule of the three wrappers copies a view off 16 bytes and keeps an
    aligned one. (The name is from when f32 K4 read views as they were.)"""
    assert all(tfa.uses_tensor_cores(torch.float32, kernel) for kernel in tfa.KERNELS)
    q, k, v = _fused_views(torch.float32, width_pad, offset)
    (q2, k2, v2), strides = tfa._qkv_strides(q, k, v)
    assert (q2.data_ptr() != q.data_ptr()) is copied
    assert all(tfa.rows_aligned(t) and torch.equal(t, w) for t, w in zip((q2, k2, v2), (q, k, v)))
    assert strides == q2.stride()[:3]


def test_unaligned_contiguous_grad_is_copied():
    """A contiguous dO that starts off 16 bytes (a view into a larger
    buffer) gets a fresh copy; an aligned one goes through untouched."""
    b, t, h, d = 1, 4, 2, 16
    flat = torch.randn(b * t * h * d + 1).bfloat16()
    do = flat[1:].view(b, t, h, d)
    q = torch.zeros(b, t, h, d, dtype=torch.bfloat16)
    stats = torch.zeros(b, h, t)
    got, _, _ = tfa._check_grad_inputs(q, do, stats, stats)
    assert tfa.rows_aligned(got) and got.data_ptr() != do.data_ptr() and torch.equal(got, do)
    aligned = do.clone()
    assert tfa._check_grad_inputs(q, aligned, stats, stats)[0].data_ptr() == aligned.data_ptr()
