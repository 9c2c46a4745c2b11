"""Port window attention (plain version) vs the JAX Pallas kernel.

The JAX side runs ``ops/pallas_window_attn.py`` in interpret mode, as
``tests/test_pallas_window_attn.py`` does; the port's CPU tensors take the
plain version of K1/K2. Same inputs from one numpy seed, same cotangent.

Tolerances: both sides compute in f32 with different sum orders (and the
conftest's ``jax_disable_most_optimizations``), so outputs agree to ~1e-6
and gradients to ~1e-5; the bounds below leave a 10x margin. dbias sums
ds over all windows, so it is held relative to its own magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.ops import pallas_window_attn as pwa
from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _inputs(bn=8, h=3, n=16, d=6, nw=4, with_mask=True, seed=0):
    r = np.random.default_rng(seed)
    q, k, v, g = (r.standard_normal((bn, h, n, d)).astype(np.float32) for _ in range(4))
    bias = r.standard_normal((h, n, n)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.where(r.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask, g


def _jax(q, k, v, bias, mask, g, pack):
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v, bias):
        out = pwa.window_attention_packed(q, k, v, bias, m, pack, 4, True)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias))
    )
    return [np.asarray(out)] + [np.asarray(a) for a in grads]


def _torch(q, k, v, bias, mask, g, pack):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    m = None if mask is None else torch.tensor(mask)
    out = twa.window_attention_packed(*ts, m, pack=pack)
    out.backward(torch.tensor(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_matches_pallas_kernel(with_mask, pack):
    args = _inputs(with_mask=with_mask)
    want = _jax(*args, pack)
    got = _torch(*args, pack)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL, err_msg="o")
    for a, b, name in zip(got[1:4], want[1:4], ["dq", "dk", "dv"]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=name)
    scale = max(1.0, float(np.abs(want[4]).max()))
    np.testing.assert_allclose(got[4], want[4], atol=GRAD_ATOL * scale, err_msg="dbias")


def test_plain_backward_is_the_gradient_of_plain_forward():
    """K2's plain version against autograd through K1's plain version, so
    the explicit backward the kernel is checked against on the card is
    itself right."""
    q, k, v, bias, mask, g = (None if a is None else torch.tensor(a) for a in _inputs())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    twa.plain_forward(*leaves, mask).backward(g)
    dq, dk, dv, dbias = twa.plain_backward(q, k, v, bias, mask, g)
    for got, leaf in zip((dq, dk, dv, dbias), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, bias, mask, _ = (None if a is None else torch.tensor(a) for a in _inputs())
    before = (twa.fwd_launches, twa.bwd_launches)
    out = twa.window_attention(q, k, v, bias, mask)
    torch.testing.assert_close(out, twa.plain_forward(q, k, v, bias, mask))
    assert (twa.fwd_launches, twa.bwd_launches) == before


def test_bf16_plain_version_rounds_only_the_output():
    q, k, v, bias, mask, _ = (None if a is None else torch.tensor(a) for a in _inputs())
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    out = twa.window_attention(qb, kb, vb, bias, mask)
    assert out.dtype == torch.bfloat16
    ref = twa.plain_forward(qb.float(), kb.float(), vb.float(), bias, mask)
    torch.testing.assert_close(out.float(), ref.bfloat16().float(), atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["n", "d", "bias", "mask", "dtype", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v, bias, mask, _ = (None if a is None else torch.tensor(a) for a in _inputs())
    if bad == "n":
        q = k = v = torch.zeros(2, 1, twa.MAX_N + 1, 4)
        bias, mask = torch.zeros(1, twa.MAX_N + 1, twa.MAX_N + 1), None
    elif bad == "d":
        q = k = v = torch.zeros(2, 1, 4, twa.MAX_D + 1)
        bias, mask = torch.zeros(1, 4, 4), None
    elif bad == "bias":
        bias = bias[:, :-1]
    elif bad == "mask":
        mask = mask.double()
    elif bad == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        twa.window_attention(q, k, v, bias, mask)
