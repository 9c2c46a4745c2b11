"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip without
one (a CUDA kernel has no interpret mode). On a GPU machine, where JAX
need not be installed (the suite's ``conftest.py`` imports it)::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: in f32 the kernel and the plain version differ only in sum
order (~1e-6 relative); in bf16 and f16 both round the same f32 result, so
outputs may differ by one step of the type (2^-8 relative in bf16, 2^-11
in f16, held at 1e-2 and 2e-3).
"""

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch.models import SwinIR
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
@pytest.mark.parametrize("n,d", [(64, 10), (16, 6), (49, 32), (128, 32)])
def test_kernels_match_plain(cuda, dtype, rel, with_mask, n, d):
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
