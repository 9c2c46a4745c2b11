"""Card-only checks of the CUDA-graph step: ``parallel.MultiStep`` and
``Stoke.fused_step`` captured and replayed on the GPU.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (the toy SwinIR
launches K1/K2) and skip without one. No JAX here (the card's machine has
none); run them there with::

    python -m pytest tests/test_torch_multi_step_cuda.py -q -m cuda --noconftest

A replay must equal the eager step bitwise (f32, TF32 off, cuDNN's
deterministic algorithms: the same kernels in the same order), a changed
lr factor must reach the replay, and a capture that cannot work must raise
rather than run eagerly.
"""

import pytest
import torch

from pytorch_distributedtraining_tpu_torch import optim, parallel, stoke
from pytorch_distributedtraining_tpu_torch.models import SwinIR

pytestmark = pytest.mark.cuda

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2), embed_dim=12,
           num_heads=(2, 2), mlp_ratio=2.0)
K = 3


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


def _mse(model, batch):
    return torch.mean((model(batch[0]) - batch[1]) ** 2), {}


def _step(opt: str, accum: int, loss_fn=_mse):
    model = SwinIR(**TOY, generator=torch.Generator().manual_seed(0)).cuda()
    kw = dict(lr=1e-3, clip_grad_norm=0.1)
    tx = (optim.FusedAdamW(model.named_parameters(), **kw) if opt == "fused"
          else optim.adamw(model.named_parameters(), **kw))
    return model, parallel.TrainStep(model, loss_fn, tx, grad_accum_steps=accum)


def _window(batches):
    return tuple(torch.stack(xs) for xs in zip(*batches))


@pytest.mark.parametrize("opt", ["fused", "adamw"])
@pytest.mark.parametrize("accum", [1, 2])
def test_replay_equals_the_eager_step(cuda, opt, accum):
    batches = _batches(2 * K)
    model_e, eager = _step(opt, accum)
    want = [eager(b, lr_factor=0.5 if i >= K else 1.0)["loss"].item()
            for i, b in enumerate(batches)]
    model_g, step = _step(opt, accum)
    multi = parallel.MultiStep(step, K)
    got = multi(_window(batches[:K]))["loss"].tolist()
    got += multi(_window(batches[K:]), lr_factor=0.5)["loss"].tolist()
    assert got == want
    assert multi.graph.captures == 1 and multi.graph.replays == 2 and step.rng.step == 2 * K
    for a, b in zip(model_e.parameters(), model_g.parameters()):
        assert torch.equal(a, b)


def test_metrics_are_copied_out_of_the_graph(cuda):
    _, step = _step("fused", 1)
    multi = parallel.MultiStep(step, K)
    batches = _batches(2 * K)
    first = multi(_window(batches[:K]))
    kept = first["loss"].clone()
    multi(_window(batches[K:]))
    assert torch.equal(first["loss"], kept)


def test_fused_step_replays_equal_the_eager_train_step(cuda):
    def facade():
        return stoke.Stoke(model=SwinIR(**TOY, generator=torch.Generator().manual_seed(0)),
                           optimizer=stoke.StokeOptimizer("AdamW", {"lr": 1e-3}),
                           loss=lambda o, t: torch.mean(torch.abs(o - t)),
                           batch_size_per_device=4, grad_accum_steps=2, device="cuda")

    graphed, eager = facade(), facade()
    step = eager._fused_step_runner()[0]
    for b in _batches(3, b=8):
        graphed.fused_step(*b)
        step(b, eager.optimizer.lr)
    assert graphed._fused_graph.captures == 1 and graphed._fused_graph.replays == 3
    for a, b in zip(graphed.model_access.parameters(), eager.model_access.parameters()):
        assert torch.equal(a, b)


def test_a_failed_capture_raises(cuda):
    """A loss that reads a value back to the host cannot be captured: the
    call raises, nothing runs it eagerly in its place, and the process's
    random draws on the card still work afterwards."""
    def host_read(model, batch):
        loss = torch.mean((model(batch[0]) - batch[1]) ** 2)
        if loss.item() < 0:  # a host sync: refused while the stream captures
            raise AssertionError
        return loss, {}

    _, step = _step("fused", 1, loss_fn=host_read)
    multi = parallel.MultiStep(step, K)
    with pytest.raises(RuntimeError):
        multi(_window(_batches(K)))
    assert multi.graph.replays == 0 and step.rng.step == 0
    torch.cuda.synchronize()
    assert torch.randn(8, device="cuda").isfinite().all()


def test_a_graph_the_collector_frees_does_not_break_a_capture(cuda):
    """An unreachable graph (here in a reference cycle) that the garbage
    collector freed inside another capture would destroy its executable
    there and lose that capture: the runner collects first and holds the
    collector off while it captures, however often it would run."""
    import gc

    _, first = _step("fused", 1)
    old = parallel.MultiStep(first, K)
    old(_window(_batches(K)))
    old.cycle = old  # garbage only a collection frees
    del old, first
    seen = []

    def loss(model, batch):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return _mse(model, batch)

    _, step = _step("fused", 1, loss_fn=loss)
    multi = parallel.MultiStep(step, K)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)  # a collection at nearly every allocation
    try:
        got = multi(_window(_batches(K)))["loss"]
    finally:
        gc.set_threshold(*thresholds)
    assert got.isfinite().all() and multi.graph.captures == 1
    assert seen == [False] * K and gc.isenabled()


@pytest.mark.parametrize("policy,opt", [("ddp", "fused"), ("zero2", "adamw"), ("zero1", "fused"),
                                        ("zero3", "adamw"), ("ddp", "adamw")],
                         ids=["ddp-fused", "zero2-adamw", "zero1-fused", "zero3-adamw",
                              "ddp-wrapper-adamw"])
def test_replay_under_an_nccl_group_equals_the_eager_step(cuda, monkeypatch, policy, opt):
    """A whole-network capture through NCCL at world 1: DDP's flat
    all-reduce, ZeRO-2's reduce-scatter and all-gather (its per-leaf shard
    views hold no autograd history), ZeRO-1's flat all-gather, ZeRO-3's
    FSDP2 hooks, copies and streams, and a ``DistributedDataParallel``
    model, whose program runs the bare module and all-reduces the grads
    once (against the eager step through the wrapper's reducer); NCCL's
    async error handling off, as PyTorch documents for a capture of
    collectives."""
    from test_torch_dist_workers import graph_vs_eager_worker, run_ranks, sr_batches

    monkeypatch.setenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    got = run_ranks(graph_vs_eager_worker, 1, group_device="cuda", policy=policy, opt=opt,
                    batches=sr_batches(2 * K), k=K)[0]
    assert got["graphed"] == got["eager"] and got["equal"]
    assert got["captures"] == 1 and got["replays"] == 2


def test_eval_step_captures_once_a_signature(cuda):
    """``parallel.EvalStep`` as a graph owner: one capture a batch
    signature (a partial last batch is one more), a replay every later
    call, each value bitwise the eval function run eagerly."""
    model = SwinIR(**TOY, generator=torch.Generator().manual_seed(0)).cuda()
    step = parallel.EvalStep(model, lambda m, b: {"mse": _mse(m, b)[0]})
    batches = _batches(2)
    partial = tuple(t[:3] for t in batches[1])
    got = [step(b)["mse"] for b in (batches[0], batches[1], partial, partial)]
    with torch.no_grad():
        want = [_mse(model, b)[0] for b in (batches[0], batches[1], partial, partial)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    counts = sorted((sig[0][0][0], g.captures, g.replays) for sig, g in step.graphs.items())
    assert counts == [(3, 1, 2), (4, 1, 2)]
