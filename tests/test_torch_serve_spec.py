"""Speculative decode in the port's engine, held against the JAX package's.

The accept rule is JAX's (hand-built traces, and the same counts as JAX's
``accept_drafts`` on seeded random ones). Speculative serving banks exactly
the sequential greedy tokens, so it is held token-identical to the port's
vanilla engine and to the JAX engine on the same trace (GPT-2 ``tiny``,
weights from the JAX init through ``interop``). The program set grows by
exactly one signature, steady state adds none, and the scheduler's
draft-depth headroom keeps the shed path leak-free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributedtraining_tpu.models import gpt2 as jg
from pytorch_distributedtraining_tpu.serve import engine as jengine
from pytorch_distributedtraining_tpu.serve import scheduler as jsched
from pytorch_distributedtraining_tpu.serve.kv_cache import PagePool as JaxPagePool
from pytorch_distributedtraining_tpu_torch.interop import gpt2_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.resilience.faults import FaultPlan, install_plan
from pytorch_distributedtraining_tpu_torch.serve import build_engine, serve_knobs_from_env
from pytorch_distributedtraining_tpu_torch.serve import engine as tengine
from pytorch_distributedtraining_tpu_torch.serve import scheduler as tsched
from pytorch_distributedtraining_tpu_torch.serve.kv_cache import PagePool

JCFG = jg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=96)
TCFG = tg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=96)
BASE = dict(n_slots=3, page_size=8, max_len=48, prefill_chunk=16, prefill_buckets=(8, 16),
            temperature=0.0)


@pytest.fixture(scope="module")
def params():
    return jg.GPT2(JCFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict(params):
    return gpt2_state_dict_from_jax(params)


def _reqs(module, n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [module.Request(i, rng.randint(0, TCFG.vocab_size, size=int(rng.randint(3, 14)))
                           .astype(np.int32), int(rng.randint(4, 10))) for i in range(n)]


def _tokens(records):
    return {r["rid"]: list(r["tokens"]) for r in records}


def _engine(state_dict, **kw):
    return tengine.ServeEngine(TCFG, state_dict, **{**BASE, "device": "cpu", **kw})


@pytest.fixture(scope="module")
def vanilla(state_dict):
    eng = _engine(state_dict)
    return _tokens(eng.run(_reqs(tsched), realtime=False))


@pytest.mark.parametrize("drafts,greedy,budget,want", [
    ([5, 6, 7], [5, 6, 7, 9], 10, 4),   # every draft verified
    ([5, 6, 7], [4, 6, 7, 9], 10, 1),   # first draft wrong: greedy[0] banks alone
    ([5, 6, 7], [5, 6, 8, 2], 10, 3),   # partial prefix, then the corrected token
    ([5, 6, 7], [5, 6, 7, 9], 2, 2),    # the budget caps acceptance
    ([5, 6, 7], [5, 6, 7, 9], 1, 1),
    ([5], [5, 6], 0, 1),                # the floor is one token
])
def test_accept_drafts_cases(drafts, greedy, budget, want):
    assert tengine.accept_drafts(drafts, greedy, budget) == want
    assert jengine.accept_drafts(drafts, greedy, budget) == want


def test_accept_drafts_matches_jax_on_random_traces():
    rng = np.random.default_rng(0)
    for _ in range(300):
        k = int(rng.integers(2, 6))
        drafts = rng.integers(0, 3, k - 1).tolist()
        greedy = rng.integers(0, 3, k).tolist()
        budget = int(rng.integers(0, 8))
        assert tengine.accept_drafts(drafts, greedy, budget) == jengine.accept_drafts(
            drafts, greedy, budget)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_serving_matches_vanilla_and_jax(params, state_dict, vanilla, spec_k):
    """Same trace, same tokens: the port's speculative engine, its vanilla
    engine and the JAX engine."""
    eng = _engine(state_dict, spec_k=spec_k)
    got = _tokens(eng.run(_reqs(tsched), realtime=False))
    assert got == vanilla
    if spec_k == 4:
        want = _tokens(jengine.ServeEngine(JCFG, params, **BASE).run(_reqs(jsched),
                                                                     realtime=False))
        assert got == want
    m = eng.metrics()
    spec = m["spec"]
    assert spec["ticks"] > 0 and spec["proposed"] > 0 and spec["verify_s"] > 0
    # fewer ticks than tokens: speculation banked more than one a slot-tick
    assert spec["ticks"] < m["decode_tokens"]
    assert 0.0 <= spec["accept_rate"] <= 1.0


def test_accounting_reassembles_from_counters(state_dict):
    eng = _engine(state_dict, spec_k=4)
    recs = eng.run(_reqs(tsched), realtime=False)
    m = eng.metrics()
    spec = m["spec"]
    ticks = {}
    for rec in eng.ledger.completed:
        for ph, a, _, attrs in rec["intervals"]:
            if ph == "decode":
                ticks.setdefault(a, []).append(attrs)
    assert len(ticks) == spec["ticks"]
    assert sum(a["accepted"] for t in ticks.values() for a in t) == spec["accepted"]
    assert sum(a["proposed"] for t in ticks.values() for a in t) == spec["proposed"]
    assert sum(a["tokens"] for t in ticks.values() for a in t) == m["decode_tokens"]
    assert m["decode_tokens"] == sum(r["new_tokens"] - 1 for r in recs)
    assert spec["accept_rate"] == pytest.approx(spec["accepted"] / spec["proposed"])


def test_exactly_one_extra_program_zero_steady_recompiles(state_dict):
    eng = _engine(state_dict, spec_k=4)
    eng.run(_reqs(tsched), realtime=False)
    m = eng.metrics()
    # a prefill per bucket, the vanilla decode and ONE verify program
    assert m["compiled_programs"] == len(BASE["prefill_buckets"]) + 2
    assert ("spec_verify", (3, 4), (3, 6), (3,)) in eng.programs
    assert m["steady_recompiles"] == 0


def test_spec_k_one_is_vanilla_and_spec_needs_greedy(state_dict):
    assert _engine(state_dict, spec_k=1).spec_k == 0
    with pytest.raises(ValueError, match="greedy"):
        _engine(state_dict, spec_k=4, temperature=0.7)


@pytest.mark.parametrize("spec_k,want", [(4, 11), (0, 8)])
def test_reservation_includes_draft_overshoot(spec_k, want):
    """prompt 3 + max_new 5 (+ spec_k - 1): both schedulers reserve the same."""
    for pool_cls, sched in ((PagePool, tsched), (JaxPagePool, jsched)):
        pool = pool_cls(num_pages=32, page_size=8)
        s = sched.AdmissionScheduler(n_slots=2, pool=pool, max_pages_per_slot=6,
                                     prefill_chunk=8, prefill_buckets=(8,), spec_k=spec_k)
        req = sched.Request(0, [1, 2, 3], 5)
        assert s.reserve_tokens(req) == want
        s.submit(req)
        s.admit(now=0.0)
        assert pool.in_use == pool.pages_for(want)


def test_spec_shed_path_returns_headroom_pages(state_dict):
    install_plan(FaultPlan.from_json([{"site": "serve.admit", "action": "raise", "at": 1,
                                       "times": 2}]))
    try:
        eng = _engine(state_dict, spec_k=4)
        free0 = eng.pool.available
        recs = eng.run(_reqs(tsched, 5, seed=2), realtime=False)
    finally:
        install_plan(None)
    assert len(recs) == 3 and len(eng.sched.dropped) == 2
    assert eng.pool.in_use == 0 and eng.pool.available == free0
    eng.pool.check_invariants()
    assert eng.sched.free_slots == list(range(eng.sched.n_slots))
    for r in recs:
        assert len(r["tokens"]) == r["new_tokens"]


def test_spec_knob_round_trips_into_engine(state_dict, monkeypatch):
    assert serve_knobs_from_env({"GRAFT_SERVE_SPEC_K": "4"})["spec_k"] == 4
    assert serve_knobs_from_env({})["spec_k"] == 0
    monkeypatch.setenv("GRAFT_SERVE_SPEC_K", "3")
    gpt = tg.GPT2(TCFG)
    gpt.load_state_dict(state_dict)
    eng = build_engine(gpt, **{**BASE, "device": "cpu"})
    assert eng.spec_k == 3
    assert build_engine(gpt, **{**BASE, "device": "cpu", "spec_k": 0}).spec_k == 0
