"""K1's and K2's plans on the CPU: how ``ops.window_attn.forward_plan`` and
``backward_plan`` split the windows over blocks, what ``kernel_forward``
and ``kernel_backward`` hand the library for them, and which bodies use
the tensor cores. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import math
import types

import pytest
import torch

from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa

# (bn, heads, mask windows): SwinIR-S's bench batch (18 images at LR 64,
# 64 mask windows) with and without the mask, the driver's training (18
# at LR 32) and validation (10 at LR 32) batches, pack 2 of the bench
# batch, a window count that no chunk divides, more mask windows than
# windows, and a few small ones
SHAPES = [(1152, 6, 64), (1152, 6, 1), (288, 6, 16), (160, 6, 16), (576, 6, 32),
          (1000, 6, 64), (5, 2, 16), (7, 1, 3), (24, 3, 4), (24, 3, 1), (1, 1, 1)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("bn,heads,nw", SHAPES)
def test_plan_covers_every_window_once_in_one_class_per_block(bn, heads, nw, sms):
    _assert_covers(twa.backward_plan(bn, heads, nw, sms), bn, nw)


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("bn,heads,nw", SHAPES)
def test_forward_plan_covers_every_window_once_in_one_class_per_block(bn, heads, nw, sms):
    _assert_covers(twa.forward_plan(bn, heads, nw, sms), bn, nw)


def _assert_covers(plan, bn, nw):
    """Every window in exactly one block, each block within one mask class
    and no longer than the chunk."""
    assert plan.classes == min(nw, bn) and plan.chunk >= 1
    seen = []
    for slot in range(plan.blocks):
        windows = plan.windows(slot)
        assert len(windows) <= plan.chunk
        assert len({w % nw for w in windows}) <= 1  # one mask class a block
        if windows:
            assert windows[0] % nw == slot // plan.chunks
        seen += windows
    assert sorted(seen) == list(range(bn))


@pytest.mark.parametrize("bn,heads,nw", SHAPES)
def test_plan_fills_the_card_with_few_partials(bn, heads, nw):
    """About two blocks a SM, or one block per (head, class) where that is
    already more: SwinIR-S's bench batch takes one block per (head, class),
    18 windows each, and writes 64 partials a head."""
    plan = twa.backward_plan(bn, heads, nw, 132)
    per_class = math.ceil(bn / nw)
    assert plan.chunks == math.ceil(per_class / plan.chunk) <= per_class
    if plan.chunk > 1:
        assert heads * plan.blocks < 2 * 132 * 2
    if (bn, heads, nw) == (1152, 6, 64):
        assert (plan.chunk, plan.blocks) == (18, 64)


@pytest.mark.parametrize("bn,heads,nw", SHAPES)
def test_forward_plan_takes_more_shorter_blocks(bn, heads, nw):
    """K1 writes no partials: about FWD_BLOCKS_PER_SM blocks a SM, or one
    block per (head, class) where that is already more, and never fewer
    blocks than K2."""
    fwd, bwd = twa.forward_plan(bn, heads, nw, 132), twa.backward_plan(bn, heads, nw, 132)
    per_class = math.ceil(bn / nw)
    assert fwd.chunks == math.ceil(per_class / fwd.chunk) <= per_class
    assert fwd.chunk <= bwd.chunk and fwd.blocks >= bwd.blocks
    if fwd.chunk > 1:
        assert heads * fwd.blocks < 2 * 132 * twa.FWD_BLOCKS_PER_SM


class _FakeLib:
    """Stands in for the built library: records the backward's arguments."""

    def __init__(self):
        self.calls = []

    def window_attn_backward(self, *args):
        self.calls.append(args)
        return 0

    def window_attn_forward(self, *args):
        self.calls.append(args)
        return 0


def _fake_card(monkeypatch):
    """A fake library and a card of 132 SMs; returns the library."""
    lib = _FakeLib()
    monkeypatch.setattr(twa.csrc, "load", lambda name: lib)
    monkeypatch.setattr(twa, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    return lib


@pytest.mark.parametrize("bn,heads,nw", [(1152, 6, 64), (160, 6, 16), (1000, 6, 1)])
def test_kernel_backward_allocates_the_plans_partials(monkeypatch, bn, heads, nw):
    """What ``kernel_backward`` passes the library: the plan's chunk, and a
    dbias partial buffer of the plan's partial count (CPU tensors here, a
    fake library, 132 SMs)."""
    lib = _fake_card(monkeypatch)
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    n, d = 4, 2  # small tensors: the fake library reads nothing
    q = torch.zeros(bn, heads, n, d)
    bias = torch.zeros(heads, n, n)
    mask = torch.zeros(nw, n, n) if nw > 1 else None
    before = twa.bwd_launches
    twa.kernel_backward(q, q, q, bias, mask, q)
    assert twa.bwd_launches == before + 1
    plan = twa.backward_plan(bn, heads, nw, 132)
    (args,) = lib.calls
    assert args[12:18] == (bn, heads, n, d, nw, plan.chunk)
    assert (plan.blocks, heads, n, n) in allocated


@pytest.mark.parametrize("bn,heads,nw", [(1152, 6, 64), (160, 6, 16), (1000, 6, 1)])
def test_kernel_forward_passes_the_plans_chunk(monkeypatch, bn, heads, nw):
    """What ``kernel_forward`` passes the library: the shape, the mask's
    window count and the forward plan's chunk (CPU tensors here, a fake
    library, 132 SMs)."""
    lib = _fake_card(monkeypatch)
    n, d = 4, 2
    q = torch.zeros(bn, heads, n, d)
    bias = torch.zeros(heads, n, n)
    mask = torch.zeros(nw, n, n) if nw > 1 else None
    before = twa.fwd_launches
    o = twa.kernel_forward(q, q, q, bias, mask)
    assert twa.fwd_launches == before + 1 and o.shape == q.shape
    (args,) = lib.calls
    assert args[7:13] == (bn, heads, n, d, nw, twa.forward_plan(bn, heads, nw, 132).chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_uses_tensor_cores_k1_and_k2_in_every_type(dtype):
    assert twa.uses_tensor_cores(dtype)
    assert twa.uses_tensor_cores(dtype, "bwd")
    assert twa.uses_tensor_cores(dtype, "fwd")
    assert not twa.uses_tensor_cores(torch.float64)
    assert not twa.uses_tensor_cores(torch.float64, "fwd")
    with pytest.raises(ValueError):
        twa.uses_tensor_cores(dtype, "dq")
