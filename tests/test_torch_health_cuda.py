"""The training-health parts on the card: the probe's reductions, dropout
under remat, and the measured memory analysis.

Marked ``cuda``: they need an NVIDIA GPU and skip without one. On a GPU
machine, where JAX need not be installed::

    python -m pytest tests/test_torch_health_cuda.py -q -m cuda --noconftest

The CPU tests hold these parts against JAX; here the card must give the
same answers as the CPU: ``torch._foreach_norm``'s largest magnitude
propagates NaN and inf and stays finite on large finite values (where an
f32 L2 norm overflows), a dropout key draws the same masks twice and a
recomputed GPT-2 block redraws them (gradients with and without remat
bitwise equal), and ``TrainStep.memory_analysis`` returns a peak above
what was resident while leaving the state as it was.
"""

import functools

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributedtraining_tpu_torch.observe import numerics
from pytorch_distributedtraining_tpu_torch.ops.flash_attn import make_flash_attn_fn
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, create_train_state
from pytorch_distributedtraining_tpu_torch.parallel.rng import DropoutKey, dropout

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_largest_magnitude_flags_on_the_card(cuda):
    big = torch.full((1 << 20,), 3e30, device=cuda)
    nan = torch.randn(1000, device=cuda)
    nan[17] = float("nan")
    inf = torch.randn(64, 64, device=cuda)
    inf[3, 5] = -float("inf")
    empty = torch.empty(0, 4, device=cuda)
    flags = torch.isfinite(numerics.leaf_norms([big, nan, inf, empty], float("inf"))).tolist()
    assert flags == [True, False, False, True]
    assert not torch.isfinite(numerics.leaf_norms([big])[0])  # the L2 norm overflows


def test_dropout_masks_and_remat_replay_on_the_card(cuda):
    x = torch.ones(256, 512, device=cuda)
    a = dropout(x, 0.1, DropoutKey(3, 4, 5), 6, deterministic=False)
    assert torch.equal(a, dropout(x, 0.1, DropoutKey(3, 4, 5), 6, deterministic=False))
    assert abs((a != 0).float().mean().item() - 0.9) < 0.01
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64))).to(cuda)
    grads = []
    for remat in (False, True):
        cfg = GPT2Config.tiny(dropout=0.1, remat=remat, n_positions=64,
                              tie_word_embeddings=False, dtype=torch.bfloat16)
        model = GPT2(cfg, attn_fn=make_flash_attn_fn(),
                     generator=torch.Generator().manual_seed(0)).to(cuda)
        model(tok, deterministic=False, generator=DropoutKey(1)).float().square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(g, h) for g, h in zip(*grads))


def test_memory_analysis_on_the_card(cuda):
    model = GPT2(GPT2Config.tiny(n_positions=64, dtype=torch.bfloat16),
                 attn_fn=make_flash_attn_fn(), generator=torch.Generator().manual_seed(0))
    st = create_train_state(model, functools.partial(optim.adamw, lr=1e-3), device="cuda")

    def loss_fn(m, tok):
        return m(tok).float().square().mean(), {}

    step = TrainStep(st.model, loss_fn, st.tx, rng=st.rng)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 64))).to(cuda)
    step(tok)
    before = {n: (p.detach().clone(), p.grad.clone()) for n, p in st.module.named_parameters()}
    stats = step.memory_analysis(tok)
    assert stats.argument_bytes > 0 and stats.peak_bytes > stats.argument_bytes
    bigger = step.memory_analysis(torch.cat([tok] * 4))
    assert bigger.peak_bytes > stats.peak_bytes
    for n, p in st.module.named_parameters():
        assert torch.equal(p, before[n][0]) and torch.equal(p.grad, before[n][1]), n
    assert st.rng.step == 1
