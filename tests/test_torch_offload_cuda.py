"""Card-only checks of host offload: ``Policy(offload_opt_state=,
offload_params=)`` through ``parallel.create_train_state`` on the GPU.

Marked ``cuda``: they need an NVIDIA GPU (the toy GPT-2 runs the flash
kernels, built by ``nvcc``) and skip without one. No JAX here; run them on
the card's machine with::

    python -m pytest tests/test_torch_offload_cuda.py -q -m cuda --noconftest

The offloaded tensors must be pinned host tensors; an offloaded step must
equal the resident step bitwise (f32, TF32 off: the same kernels in the
same order, the copies only add to them); a saved and loaded offloaded
state resumes bitwise and stays pinned; a ``MultiStep`` replay of the
offloaded step equals its eager twin bitwise.
"""

import functools

import pytest
import torch

from pytorch_distributedtraining_tpu_torch import checkpoint_sharded, optim, parallel
from pytorch_distributedtraining_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributedtraining_tpu_torch.models.gpt2 import cross_entropy_loss
from pytorch_distributedtraining_tpu_torch.ops import flash_attn

pytestmark = pytest.mark.cuda

FACTORIES = {"adamw": functools.partial(optim.adamw, lr=1e-2, clip_grad_norm=1.0),
             "fused": functools.partial(optim.FusedAdamW, lr=1e-2, clip_grad_norm=1.0)}
OFFLOADS = {"state": dict(offload_opt_state=True), "params": dict(offload_params=True),
            "both": dict(offload_opt_state=True, offload_params=True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned host memory and the flash kernels")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _loss(m, batch):
    return cross_entropy_loss(m(batch[:, :-1]), batch[:, 1:]), {}


def _state(opt: str, offload: str | None):
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), attn_fn=flash_attn.make_flash_attn_fn(),
                 generator=torch.Generator().manual_seed(0))
    policy = parallel.ZeRO1(**OFFLOADS.get(offload, {}))
    return parallel.create_train_state(model, FACTORIES[opt], None, policy, device="cuda")


def _tokens(n: int) -> list:
    g = torch.Generator(device="cuda").manual_seed(1)
    return [torch.randint(0, 256, (2, 65), device="cuda", generator=g) for _ in range(n)]


def _params(st) -> list:
    st.tx.settle()
    return [p.detach().to("cpu", copy=True) for p in st.module.parameters()]


def _offloaded(tx, offload: str) -> list:
    out = list(tx._host_params or []) if OFFLOADS[offload].get("offload_params") else []
    if OFFLOADS[offload].get("offload_opt_state"):
        out += [t for v in tx._state().values() for t in v]
    return out


@pytest.mark.parametrize("offload", list(OFFLOADS))
@pytest.mark.parametrize("opt", list(FACTORIES))
def test_offloaded_tensors_are_pinned_and_steps_equal_resident(cuda, opt, offload):
    toks = _tokens(3)
    st = _state(opt, offload)
    tensors = _offloaded(st.tx, offload)
    assert tensors and all(t.device.type == "cpu" and t.is_pinned() for t in tensors)
    step = parallel.TrainStep(st.model, _loss, st.tx)
    got = [float(step(t)["loss"]) for t in toks]
    ref = _state(opt, None)
    ref_step = parallel.TrainStep(ref.model, _loss, ref.tx)
    want = [float(ref_step(t)["loss"]) for t in toks]
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(_params(st), _params(ref)))
    if "offload_params" in OFFLOADS[offload]:
        held = ([p.data_ptr() for p in st.tx.params] if opt == "adamw"
                else [st.tx.flat_param.data_ptr()])
        assert held == [h.data_ptr() for h in st.tx._host_params]


@pytest.mark.parametrize("opt", list(FACTORIES))
def test_offloaded_state_saves_and_loads_pinned_and_bitwise(cuda, opt, tmp_path):
    toks = _tokens(4)
    whole = _state(opt, "both")
    step = parallel.TrainStep(whole.model, _loss, whole.tx, rng=whole.rng)
    want = [float(step(t)["loss"]) for t in toks]
    first = _state(opt, "both")
    step = parallel.TrainStep(first.model, _loss, first.tx, rng=first.rng)
    head = [float(step(t)["loss"]) for t in toks[:2]]
    checkpoint_sharded.save_portable(str(tmp_path / "ckpt"), first)
    resumed = _state(opt, "both")
    checkpoint_sharded.restore_portable(str(tmp_path / "ckpt"), resumed)
    assert all(t.is_pinned() for t in _offloaded(resumed.tx, "both"))
    step = parallel.TrainStep(resumed.model, _loss, resumed.tx, rng=resumed.rng)
    tail = [float(step(t)["loss"]) for t in toks[2:]]
    assert head + tail == want
    assert all(torch.equal(a, b) for a, b in zip(_params(resumed), _params(whole)))


@pytest.mark.parametrize("opt", list(FACTORIES))
def test_graphed_offloaded_steps_equal_their_eager_twin(cuda, opt):
    toks = _tokens(3)
    st = _state(opt, "both")
    step = parallel.TrainStep(st.model, _loss, st.tx)
    snapshot = step.state_snapshot()
    eager = [float(step(t)["loss"]) for t in toks]
    eager_params = _params(st)
    step.restore_state(snapshot)
    multi = parallel.MultiStep(step, len(toks))
    got = multi(torch.stack(toks))["loss"].tolist()
    assert multi.graph.captures == 1
    assert got == eager
    assert all(torch.equal(a, b) for a, b in zip(_params(st), eager_params))
    assert all(t.is_pinned() for t in _offloaded(st.tx, "both"))
