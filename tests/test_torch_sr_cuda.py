"""The super-resolution path's card parts: K1/K2 at SwinIR-M's shapes, the
device prefetcher's side stream, and a SwinIR-M toy trained on the card
against the CPU.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip without
one. On a GPU machine, where JAX need not be installed::

    python -m pytest tests/test_torch_sr_cuda.py -q -m cuda --noconftest

Tolerances: K1/K2 against their plain versions as in
``tests/test_torch_cuda.py`` (f32 1e-5, bf16 1e-2 of the largest entry).
The toy's losses on the card and on the CPU within 1e-4 relative: f32 on
both (TF32 off), sums in other orders through cuDNN, the kernels and two
AdamW steps.
"""

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch.data import DevicePrefetcher
from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
from pytorch_distributedtraining_tpu_torch.losses import VGGFeatLoss
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.models.swinir import _shift_attn_mask
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


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("pack", [1, 2])
def test_window_kernels_at_swinir_m_shapes(cuda, dtype, rel, with_mask, pack):
    """SwinIR-M x2 at batch 16, LR 48: q/k/v [576, 6, 64, 30] (rows of 120
    or 60 bytes: 8- or 4-byte copies), [288, 6, 128, 30] at pack 2."""
    g = torch.Generator().manual_seed(pack + 2 * with_mask)
    q, k, v, do = (torch.randn(576, 6, 64, 30, generator=g).to(dtype).to(cuda) for _ in range(4))
    bias = (torch.randn(6, 64, 64, generator=g) * 0.5).to(cuda)
    mask = torch.from_numpy(_shift_attn_mask(48, 48, 8, 4)).to(cuda) if with_mask else None
    want = [twa.plain_forward(q, k, v, bias, mask), *twa.plain_backward(q, k, v, bias, mask, do)]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    before = twa.fwd_launches, twa.bwd_launches
    out = twa.window_attention_packed(*leaves, mask, pack=pack)
    out.backward(do)
    assert (twa.fwd_launches - before[0], twa.bwd_launches - before[1]) == (1, 1)
    for got, w in zip([out.detach()] + [t.grad for t in leaves], want):
        _close(got, w, rel)


@pytest.mark.parametrize("pack", [1, 2])
def test_packed_attention_under_bf16_autocast_keeps_its_mask_f32(cuda, pack):
    """Called inside a bf16 autocast region, as the facade's forward runs,
    packing the shift mask must not narrow it (the kernels take an f32
    mask)."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(576, 6, 64, 30, generator=g).to(cuda) for _ in range(3))
    bias = (torch.randn(6, 64, 64, generator=g) * 0.5).to(cuda)
    mask = torch.from_numpy(_shift_attn_mask(48, 48, 8, 4)).to(cuda)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        packed = twa.pack_windows(q, k, v, bias, mask, pack)
        out = twa.window_attention_packed(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, mask,
                                          pack=pack)
    assert packed[3].dtype == packed[4].dtype == torch.float32
    _close(out, twa.plain_forward(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, mask), 1e-2)


def _host_batches(n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(4, 48, 48, 3, generator=g).pin_memory(),
             torch.rand(4, 96, 96, 3, generator=g).pin_memory()) for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_batches_equal_the_hosts(cuda, depth):
    host = _host_batches()
    pf = DevicePrefetcher(iter(host), cuda, depth=depth)
    got = list(pf)
    assert pf.staged == pf.yielded == len(host)
    for (a, b), (x, y) in zip(got, host):
        assert a.is_cuda and b.is_cuda
        assert torch.equal(a.cpu(), x) and torch.equal(b.cpu(), y)


def test_record_stream_keeps_a_batch_alive_while_it_is_used(cuda):
    """A batch taken from the prefetcher and dropped by the host while the
    consumer's stream still has work on it queued (behind a spin) must not
    be overwritten by the side stream's later copies into recycled memory."""
    host = _host_batches(n=8, seed=1)
    want = host[0][0].double().sum().item()
    pf = DevicePrefetcher(iter(host), cuda, depth=2)
    x, _ = next(pf)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the consumer's stream
    total = x.double().sum()
    del x
    for _ in pf:  # later copies allocate on the side stream meanwhile
        pass
    assert abs(total.item() - want) <= 1e-9 * abs(want)


def test_swinir_m_toy_two_steps_on_card_match_cpu(cuda):
    """The classical tail at head dim 30 (K1/K2's DP = 32 bodies) through
    the driver's facade, VGGFeatLoss and two AdamW steps, on the card and on
    the CPU from the same weights and batches."""
    kw = dict(upscale=2, img_size=16, window_size=8, depths=(2,), embed_dim=60,
              num_heads=(2,), upsampler="pixelshuffle")
    g = np.random.default_rng(0)
    batches = [(g.random((2, 16, 16, 3)).astype(np.float32),
                g.random((2, 32, 32, 3)).astype(np.float32)) for _ in range(2)]
    losses = {}
    for device in ("cpu", "cuda"):
        model = SwinIR(**kw, generator=torch.Generator().manual_seed(0))
        vgg = VGGFeatLoss(device=device)
        s = stoke_ddp.build_stoke(model, batch_size=2, device=device, verbose=False, loss=vgg)
        s.grad_accum_steps = 1
        before = twa.fwd_launches, twa.bwd_launches
        run = []
        for x, y in batches:
            loss = s.loss(s.model(x), torch.from_numpy(y).to(device))
            s.backward(loss)
            s.step()
            run.append(loss.item())
        losses[device] = run
        launched = twa.fwd_launches - before[0], twa.bwd_launches - before[1]
        assert launched == ((4, 4) if device == "cuda" else (0, 0))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["cpu"][1] != losses["cpu"][0]
