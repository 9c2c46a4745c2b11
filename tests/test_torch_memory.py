"""``observe/memory.py`` of the port against the JAX package's, and
``TrainStep.memory_analysis`` on the CPU.

``tune_batch_size`` is the same search in both packages: for the same
``peak_bytes_fn`` it probes the same batches in the same order and picks
the same batch (compared exactly), refuses a first batch over the budget
and returns ``start`` when the probe answers None. Without a device both
packages' budget falls back to the host's memory, and the strict form
refuses with ``NoMemoryBudget``. The port's ``memory_analysis`` runs one
step's compute on the card; on the CPU it returns None (so the search
returns its ``start``, JAX's answer when no analysis is available) and
leaves the parameters, gradients, optimizer state, BatchNorm statistics
and the step stream as they were, bitwise.
"""

import functools

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.observe import memory as jmem
from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.models import ResNet18
from pytorch_distributedtraining_tpu_torch.observe import memory as tmem
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, create_train_state

torch.set_num_threads(1)

PEAKS = {
    "linear": lambda b: 1000 + 37 * b,
    "quadratic": lambda b: 5 * b * b + 11,
    "stepwise": lambda b: 4000 if b > 70 else 10 * b,
    "none past 40": lambda b: None if b > 40 else 50 * b,
}


@pytest.mark.parametrize("name", list(PEAKS))
@pytest.mark.parametrize("start,budget,max_batch", [(1, 3000, 4096), (3, 2000, 100),
                                                     (8, 100000, 64)])
def test_tune_batch_size_makes_jax_choices(name, start, budget, max_batch):
    fn = PEAKS[name]
    seen = {"port": [], "jax": []}

    def probe(side):
        def peak(b):
            seen[side].append(b)
            return fn(b)
        return peak

    kw = dict(budget_bytes=budget, start=start, max_batch=max_batch, safety=0.9)
    try:
        want = jmem.tune_batch_size(probe("jax"), **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="already exceeds"):
            tmem.tune_batch_size(probe("port"), **kw)
        assert "already exceeds" in str(e)
        return
    assert tmem.tune_batch_size(probe("port"), **kw) == want
    assert seen["port"] == seen["jax"]


def test_tune_batch_size_cache_and_strict_budget():
    cache = {4: 10, 8: 10**9}
    calls = []

    def peak(b):
        calls.append(b)
        return 100 * b

    got = tmem.tune_batch_size(peak, budget_bytes=10**4, start=4, cache=cache)
    assert got == jmem.tune_batch_size(lambda b: 100 * b if b not in (8,) else 10**9,
                                       budget_bytes=10**4, start=4)
    assert 4 not in calls and 8 not in calls  # answered from the cache
    if not torch.cuda.is_available():
        with pytest.raises(tmem.NoMemoryBudget):
            tmem.tune_batch_size(peak)
        with pytest.raises(jmem.NoMemoryBudget):
            jmem.tune_batch_size(peak)


def test_memory_stats_fields_and_peak_match_jax():
    kw = dict(argument_bytes=100, output_bytes=20, temp_bytes=300, alias_bytes=15,
              generated_code_bytes=7)
    assert tmem.MemoryStats(**kw).as_dict() == jmem.MemoryStats(**kw).as_dict()
    assert tmem.MemoryStats(**dict(kw, alias_bytes=10**6)).peak_bytes == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host fallback is the no-card path")
def test_host_fallback_budget_matches_jax_on_the_cpu():
    assert tmem.host_memory_budget() == jmem.host_memory_budget()
    assert tmem.device_hbm_budget() == jmem.device_hbm_budget() == tmem.host_memory_budget()
    assert tmem.device_hbm_budget(fallback=None) is None
    assert tmem.device_hbm_budget(fallback=123) == 123
    stats = tmem.record_hbm_stats(projected_peak_bytes=42)
    assert stats["budget_source"] == "host-fallback" and stats["projected_peak_bytes"] == 42
    assert stats["hbm_high_water_bytes"] is None


def _loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y), {}


@pytest.mark.parametrize("opt", ["adamw", "fused"])
def test_memory_analysis_is_none_on_the_cpu_and_leaves_the_state(opt):
    """A ResNet-18 (BatchNorm statistics) after one step, per-leaf and
    flat: the analysis returns None, the search its start, and nothing of
    the state moves."""
    model = ResNet18(num_classes=10, small_inputs=True, generator=torch.Generator().manual_seed(0))
    tx = (functools.partial(optim.FusedAdamW, lr=1e-3) if opt == "fused"
          else functools.partial(optim.adamw, lr=1e-3))
    st = create_train_state(model, tx, device="cpu", seed=3)
    step = TrainStep(st.model, _loss, st.tx, rng=st.rng)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 10, 4)))
    step(batch)

    def snap():
        out = {f"p/{n}": p.detach().clone() for n, p in st.module.named_parameters()}
        out.update({f"g/{n}": p.grad.clone() for n, p in st.module.named_parameters()
                    if p.grad is not None})
        out.update({f"b/{n}": b.clone() for n, b in st.module.named_buffers()})
        sd = st.tx.state_dict()
        for k in ("mu", "nu"):
            v = sd.get(k)
            if isinstance(v, torch.Tensor):
                out[f"o/{k}"] = v.clone()
        if opt == "fused":
            out["o/mu"], out["o/nu"] = st.tx.state.mu.clone(), st.tx.state.nu.clone()
        else:
            out.update({f"o/mu{i}": t.clone() for i, t in enumerate(st.tx.mu)})
        return out

    before, rng_before = snap(), st.rng.state_dict()
    assert step.memory_analysis(batch) is None
    assert tmem.tune_batch_size(lambda b: None if step.memory_analysis(batch) is None else 0,
                                budget_bytes=10**9, start=6) == 6
    after = snap()
    assert set(after) == set(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert st.rng.state_dict() == rng_before == {"seed": 3, "step": 1}
