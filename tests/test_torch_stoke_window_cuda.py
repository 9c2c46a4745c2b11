"""Card-only checks of the Stoke facade's deferred window as captured CUDA
graphs: the window program (JAX's ``eager_step``) and the split path's
three (JAX's ``_jit_acc_first``, ``_jit_acc`` and ``_jit_apply``).

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (the toy SwinIR
launches K1/K2) and skip without one. No JAX here (the card's machine has
none); run them there with::

    python -m pytest tests/test_torch_stoke_window_cuda.py -q -m cuda --noconftest

Each graph must equal the same programs run uncaptured
(``Stoke.uncaptured``) from the same state bitwise (f32, TF32 off,
cuDNN's deterministic algorithms), each program is captured once for its
input signature, the per-leaf (ZeRO-2) and flat (``FusedAdamW``) layouts,
ZeRO-3 (FSDP2) and a ``DistributedDataParallel`` model (both in an NCCL
group of one) all hold, and a capture that cannot work raises rather than
run eagerly. The cold programs (an early read, eval-mode ``.model``,
``eval_step`` with a partial batch) capture once a signature and replay
after, bitwise their uncaptured twin, and leave the next training step as
it would be without them.
"""

import contextlib

import pytest
import torch

from pytorch_distributedtraining_tpu_torch import losses, stoke
from pytorch_distributedtraining_tpu_torch.models import SwinIR

pytestmark = pytest.mark.cuda

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2), embed_dim=12,
           num_heads=(2, 2), mlp_ratio=2.0)
LAYOUTS = {"ddp-fused": dict(fairscale_oss=False, fairscale_sddp=False),
           "zero2-per-leaf": dict(fairscale_oss=True, fairscale_sddp=True),
           # these two need a process group: an NCCL group of one
           # (tests/test_torch_dist_workers.py's ``facade`` flags)
           "ddp": dict(oss=False, sddp=False, fused_optimizer=False),
           "fsdp": dict(fsdp=True)}
GROUPED = ("ddp", "fsdp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs and the kernels run only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _batches(n: int, b: int = 4) -> list:
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for _ in range(n):
        hr = torch.rand(b, 16, 16, 3, device="cuda", generator=g)
        out.append((hr.reshape(b, 8, 2, 8, 2, 3).mean(dim=(2, 4)), hr))
    return out


def _facade(layout: str, loss=None, **extra):
    return stoke.Stoke(
        model=SwinIR(**TOY, generator=torch.Generator().manual_seed(0)),
        optimizer=stoke.StokeOptimizer("AdamW", {"lr": 1e-3, "betas": (0.9, 0.99)}),
        loss=loss or losses.FeatLoss(), batch_size_per_device=4, grad_accum_steps=2,
        grad_clip=stoke.ClipGradNormConfig(max_norm=0.1), device="cuda",
        **LAYOUTS[layout], **extra)


def _loop(s, batches, read_each: bool) -> list:
    """The Stoke-style loop, each loss read after its ``.step()`` (the
    driver's, the split path) or after the run (the window)."""
    out = []
    for i, (x, y) in enumerate(batches):
        s.optimizer.lr = 1e-3 if i < 2 else 5e-4  # the lr factor reaches the replay
        loss = s.loss(s.model(x), y)
        s.backward(loss)
        s.step()
        out.append(loss.item() if read_each else loss)
    return [v if isinstance(v, float) else v.item() for v in out]


def _graphs(s) -> dict:
    return {kind: (g.captures, g.replays) for (kind, _), g in s._graphs.items()}


@pytest.mark.parametrize("read_each", [False, True], ids=["window", "split"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_graphs_equal_the_uncaptured_programs(cuda, layout, read_each):
    if layout in GROUPED:
        from test_torch_dist_workers import run_ranks, stoke_window_worker

        got = run_ranks(stoke_window_worker, 1, group_device="cuda", read_each=read_each,
                        flags=LAYOUTS[layout])[0]
        assert got["graphed"] == got["uncaptured"] and got["equal"]
        assert got["refusal"] is None
        kinds = ("first", "acc", "apply") if read_each else ("window",)
        assert got["captures"] == dict.fromkeys(kinds, 1)
        assert got["replays"] == dict.fromkeys(kinds, 3)
        return
    batches = _batches(6)
    graphed, twin = _facade(layout), _facade(layout)
    got = _loop(graphed, batches, read_each)
    with twin.uncaptured():
        want = _loop(twin, batches, read_each)
    assert got == want
    for a, b in zip(graphed.model_access.parameters(), twin.model_access.parameters()):
        assert torch.equal(a, b)
    assert float(graphed._ema) == float(twin._ema)
    if read_each:  # one capture each, a replay each micro-batch or step
        assert _graphs(graphed) == {"first": (1, 3), "acc": (1, 3), "apply": (1, 3)}
    else:
        assert _graphs(graphed) == {"window": (1, 3)}
    assert graphed.graph_refusal is None
    assert all(g.captures == 0 for g in twin._graphs.values())


def test_mixed_window_and_split_share_the_grad_buffers(cuda):
    """Per-leaf: a window, a split window (a loss read early), a window,
    graphed, equal to the same run uncaptured."""
    batches = _batches(6)
    runs = []
    for graphed in (True, False):
        s = _facade("zero2-per-leaf")
        with s.uncaptured() if not graphed else contextlib.nullcontext():
            for i, (x, y) in enumerate(batches):
                loss = s.loss(s.model(x), y)
                s.backward(loss)
                if i in (2, 3):
                    loss.item()
                s.step()
        runs.append([p.detach().clone() for p in s.model_access.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_a_failed_capture_raises(cuda):
    """A loss that reads the device inside the capture cannot be graphed:
    the step raises, nothing runs eagerly in its place, and the card still
    draws random numbers."""
    feat = losses.FeatLoss()

    def reading(out, tgt):
        loss = feat(out, tgt)
        if torch.cuda.is_current_stream_capturing():
            loss.item()
        return loss

    s = _facade("ddp-fused", loss=reading)
    x, y = _batches(1)[0]
    before = [p.detach().clone() for p in s.model_access.parameters()]
    s.backward(s.loss(s.model(x), y))
    s.backward(s.loss(s.model(x), y))
    with pytest.raises(RuntimeError):
        s.step()
    torch.cuda.synchronize()
    torch.rand(4, device="cuda")
    assert all(torch.equal(a, b) for a, b in zip(before, s.model_access.parameters()))


@pytest.mark.parametrize("read_each", [False, True], ids=["window", "split"])
def test_zero2_over_an_nccl_group_equals_the_uncaptured_programs(cuda, read_each):
    """The driver's layout (ZeRO-2, per-leaf AdamW, the reduce-scatter and
    all-gather inside the graphs) over an NCCL group of one, which
    ``runtime.dist.initialize`` brings up with NCCL's async error handling
    off."""
    from test_torch_dist_workers import run_ranks, stoke_window_worker

    got = run_ranks(stoke_window_worker, 1, group_device="cuda", read_each=read_each)[0]
    assert got["graphed"] == got["uncaptured"] and got["equal"]
    assert got["async_error_handling"] == "0"
    assert got["captures"] == ({"first": 1, "acc": 1, "apply": 1} if read_each
                               else {"window": 1})


@pytest.mark.parametrize("layout", ["zero2-per-leaf", "ddp", "fsdp"])
def test_cold_programs_capture_once_a_signature(cuda, layout):
    """Eval-mode ``.model``, a handle read alone, a loss read before
    ``.backward()`` and ``eval_step`` (a batch of 4 and a partial one of
    3), in an NCCL group of one: each a graph captured once a signature
    and replayed after, bitwise their uncaptured twin; a training step
    after them equals one without them (FSDP2 reshards after each forward
    program)."""
    from test_torch_dist_workers import cold_programs_worker, run_ranks

    flags = {"zero2-per-leaf": {}, "ddp": LAYOUTS["ddp"], "fsdp": LAYOUTS["fsdp"]}[layout]
    got = run_ranks(cold_programs_worker, 1, group_device="cuda", flags=flags)[0]
    assert got["equal"] and got["step_equal"] and got["refusal"] is None
    evals = str(("eval", ()))
    assert got["counts"] == sorted([("eval_forward", 4, 1, 2), ("forward", 4, 1, 4),
                                    ("loss", 4, 1, 2), (evals, 4, 1, 2), (evals, 3, 1, 2)])
