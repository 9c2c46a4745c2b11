"""The distributed runtime on the card: a process group of one rank over
NCCL, under each policy, against the same step without a group.

Marked ``cuda``: NCCL and the kernels need an NVIDIA GPU, and these skip
without one. NCCL refuses two ranks of one communicator on one GPU, so a
single card holds world 1 only; worlds of 2 and 4 are held on the CPU
over gloo (``tests/test_torch_dist_step.py``). At one rank each shard is
the whole leaf and every collective still runs through NCCL. Run on a GPU
machine, where JAX need not be installed::

    python -m pytest tests/test_torch_dist_cuda.py -q -m cuda --noconftest

The toy SwinIR's step is the same arithmetic with and without the group
(cuDNN deterministic on both sides): losses held at 1e-6 relative and
parameters at 1e-6 absolute, the card's phase-11 bound.
"""

import numpy as np
import pytest
import torch

from test_torch_dist_workers import (named_numpy, run_ranks, sr_batches, toy_swinir,
                                     train_step_worker)

pytestmark = pytest.mark.cuda

LAYOUTS = [("ddp", "adamw"), ("zero1", "adamw"), ("zero2", "adamw"), ("zero3", "adamw"),
           ("ddp", "fused"), ("zero1", "fused")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; NCCL and the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


@pytest.mark.parametrize("policy,opt", LAYOUTS, ids=[f"{p}-{o}" for p, o in LAYOUTS])
def test_nccl_world_1_step_matches_the_step_without_a_group(cuda, policy, opt):
    batches, state = sr_batches(3), named_numpy(toy_swinir())
    want = train_step_worker(0, 1, policy="none", opt=opt, batches=batches, state=state,
                             device="cuda")
    got = run_ranks(train_step_worker, 1, group_device="cuda", device="cuda", policy=policy,
                    opt=opt, batches=batches, state=state)[0]
    assert got["backend"] == "nccl" and want["backend"] is None
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    moved = 0.0
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, want["params"][name], rtol=0, atol=1e-6, err_msg=name)
        moved = max(moved, float(np.abs(p - state[name]).max()))
    assert moved > 1e-3
    if opt == "fused":
        assert got["views_bound"]
