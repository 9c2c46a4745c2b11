"""The port's serving path against the JAX package's: pages, scheduler,
paged primitives, the continuous-batching engine, SwinIR tiles, the
factory and ``Stoke.serve``.

The host-side pieces (``PagePool``, ``bucket_for``, ``chunk_plan``,
``AdmissionScheduler``, ``tile_grid``, the env knobs) run JAX's own cases
from ``tests/test_serve.py`` on the JAX objects and the port's side by
side, and must give the same answers. The device-side ones start from the
same numpy inputs and weights (``interop``): ``write_paged_kv`` writes the
same pages as JAX's (all but the null page, whose duplicate writes keep an
unspecified one) and ``paged_attention`` agrees to ~1e-7, held at 1e-5; the
engine's greedy tokens equal the JAX engine's on the same trace and the
port's own ``generate``; the tiny SwinIR tile server's stitched images
agree with JAX's ``SwinIRTileServer`` (whose SwinIR runs the Pallas window
attention in interpret mode) to ~1e-6, held at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributedtraining_tpu import serve as jserve
from pytorch_distributedtraining_tpu.models import generate as jgen
from pytorch_distributedtraining_tpu.models import gpt2 as jg
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.serve import engine as jengine
from pytorch_distributedtraining_tpu.serve import kv_cache as jkv
from pytorch_distributedtraining_tpu.serve import scheduler as jsched
from pytorch_distributedtraining_tpu.serve import tiles as jtiles
from pytorch_distributedtraining_tpu_torch import serve as tserve
from pytorch_distributedtraining_tpu_torch.interop import (gpt2_state_dict_from_jax,
                                                           swinir_state_dict_from_jax)
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.models import generate as tgen
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.observe import trace
from pytorch_distributedtraining_tpu_torch.resilience.faults import FaultPlan, install_plan
from pytorch_distributedtraining_tpu_torch.serve import engine as tengine
from pytorch_distributedtraining_tpu_torch.serve import kv_cache as tkv
from pytorch_distributedtraining_tpu_torch.serve import scheduler as tsched
from pytorch_distributedtraining_tpu_torch.serve import tiles as ttiles

JCFG = jg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=96)
TCFG = tg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=96)
BASE = dict(n_slots=3, page_size=8, max_len=48, prefill_chunk=16, prefill_buckets=(8, 16),
            temperature=0.0)
PROMPT_LENS, MAX_NEW = (5, 11, 3, 20, 7), (6, 4, 8, 5, 7)
IMPLS = {"jax": (jkv, jsched, jtiles), "port": (tkv, tsched, ttiles)}
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return jg.GPT2(JCFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict(params):
    return gpt2_state_dict_from_jax(params)


def _prompt(rng, n):
    return rng.integers(0, TCFG.vocab_size, size=n).astype(np.int32)


def _mixed_prompts():
    rng = np.random.default_rng(0)
    return [_prompt(rng, n) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_served(params):
    """The JAX engine over the mixed trace, once for the module."""
    eng = jengine.ServeEngine(JCFG, params, **BASE)
    recs = eng.run([jsched.Request(i, p, m) for i, (p, m) in
                    enumerate(zip(_mixed_prompts(), MAX_NEW))], realtime=False)
    return {r["rid"]: r["tokens"] for r in recs}


def _engine(state_dict, **kw):
    return tengine.ServeEngine(TCFG, state_dict, **{**BASE, "device": "cpu", **kw})


# -- pages, buckets, scheduler: JAX's cases on both implementations -----------


@pytest.mark.parametrize("impl", IMPLS)
def test_page_pool_cases(impl):
    kv = IMPLS[impl][0]
    pool = kv.PagePool(num_pages=6, page_size=4)
    assert pool.capacity == 5 and pool.alloc(3, owner="a") == [1, 2, 3]
    pool.check_invariants()
    pool = kv.PagePool(num_pages=8, page_size=4)
    a, b = pool.alloc(2, "a"), pool.alloc(2, "b")
    assert (a, b) == ([1, 2], [3, 4])
    assert pool.free("a") == [1, 2] and pool.alloc(2, "c") == [1, 2]  # LIFO, same order
    pool.check_invariants()
    pool = kv.PagePool(num_pages=4, page_size=2)
    assert pool.alloc(5, "a") is None and pool.available == 3  # all-or-nothing
    pool = kv.PagePool(num_pages=4, page_size=8)
    assert [pool.pages_for(n) for n in (0, 1, 8, 9)] == [1, 1, 1, 2]
    for bad in (dict(num_pages=1, page_size=4), dict(num_pages=4, page_size=0)):
        with pytest.raises(ValueError):
            kv.PagePool(**bad)


def test_page_pools_agree_under_churn():
    """The same seeded alloc/free sequence on both pools: the same ids."""
    rng = np.random.default_rng(0)
    pools = [jkv.PagePool(33, 4), tkv.PagePool(33, 4)]
    for step in range(200):
        if rng.random() < 0.6:
            n, owner = int(rng.integers(1, 6)), int(rng.integers(0, 8))
            got = [p.alloc(n, owner) for p in pools]
        else:
            owner = int(rng.integers(0, 8))
            got = [p.free(owner) for p in pools]
        assert got[0] == got[1], step
    for p in pools:
        p.check_invariants()


@pytest.mark.parametrize("fault", ["null_owned", "null_free", "leak", "double"])
def test_page_pool_invariants_raise_without_asserts(fault):
    """``check_invariants`` raises ``RuntimeError`` for each broken
    invariant, so the check holds under ``python -O`` too."""
    pool = tkv.PagePool(num_pages=6, page_size=4)
    pool.alloc(2, "a")
    if fault == "null_owned":
        pool._owned["a"].append(0)
        pool._free.pop()
    elif fault == "null_free":
        pool._free[0] = 0
    elif fault == "leak":
        pool._free.pop()
    else:
        pool._owned["b"] = [pool._owned["a"][0]]
        pool._free.pop()
    with pytest.raises(RuntimeError):
        pool.check_invariants()


@pytest.mark.parametrize("impl", IMPLS)
def test_buckets_and_chunk_plan(impl):
    s = IMPLS[impl][1]
    assert [s.bucket_for(n, (8, 16, 32)) for n in (3, 8, 9)] == [8, 8, 16]
    with pytest.raises(ValueError):
        s.bucket_for(33, (8, 16, 32))
    assert s.chunk_plan(21, 8, (4, 8)) == [(0, 8, 8), (8, 8, 8), (16, 5, 8)]
    assert s.chunk_plan(11, 8, (4, 8)) == [(0, 8, 8), (8, 3, 4)]


def _sched(impl, n_slots=2, pages=9, page=4, **kw):
    kv, s, _ = IMPLS[impl]
    pool = kv.PagePool(pages, page)
    return s.AdmissionScheduler(n_slots=n_slots, pool=pool, max_pages_per_slot=4,
                                prefill_chunk=8, prefill_buckets=(4, 8), **kw), pool


@pytest.mark.parametrize("impl", IMPLS)
def test_scheduler_fifo_reuse_and_blocking(impl):
    s = IMPLS[impl][1]
    sched, _ = _sched(impl)
    rng = np.random.default_rng(0)
    for rid, (plen, mnew) in enumerate([(3, 2), (7, 2), (11, 2)]):
        sched.submit(s.Request(rid, _prompt(rng, plen), mnew))
    admitted = sched.admit()
    assert [st.rid for st in admitted] == [0, 1] and [st.slot for st in admitted] == [0, 1]
    assert [sched.prefill_chunk_for(st) for st in admitted] == [(0, 3, 4), (0, 7, 8)]

    sched, pool = _sched(impl, n_slots=1)
    rng = np.random.default_rng(1)
    sched.submit(s.Request(0, _prompt(rng, 4), 4))
    sched.submit(s.Request(1, _prompt(rng, 4), 4))
    (st0,) = sched.admit()
    assert st0.pages == [1, 2]
    st0.state = s.DECODE
    assert sched.retire(st0) == [1, 2]
    (st1,) = sched.admit()
    assert st1.pages == [1, 2] and st1.slot == st0.slot  # the exact pages cycle
    pool.check_invariants()

    sched, pool = _sched(impl, n_slots=2, pages=5)
    rng = np.random.default_rng(2)
    sched.submit(s.Request(0, _prompt(rng, 8), 8))
    sched.submit(s.Request(1, _prompt(rng, 2), 2))
    first = sched.admit()
    assert [st.rid for st in first] == [0] and sched.admit() == []  # head-of-line blocks
    occ = sched.occupancy()
    assert occ["queued"] == 1 and occ["pages_free"] == 0
    first[0].state = s.DECODE
    sched.retire(first[0])
    assert [st.rid for st in sched.admit()] == [1]


@pytest.mark.parametrize("impl", IMPLS)
def test_scheduler_static_occupancy_and_limits(impl):
    s = IMPLS[impl][1]
    sched, _ = _sched(impl, n_slots=2, admission="static")
    rng = np.random.default_rng(4)
    for rid in range(3):
        sched.submit(s.Request(rid, _prompt(rng, 3), 2))
    assert [st.rid for st in sched.admit()] == [0, 1] and sched.admit() == []
    for st in list(sched.active.values()):
        st.state = s.DECODE
        sched.retire(st)
    assert [st.rid for st in sched.admit()] == [2]

    sched, _ = _sched(impl, n_slots=2, pages=9)
    rng = np.random.default_rng(3)
    sched.submit(s.Request(0, _prompt(rng, 4), 4))
    sched.submit(s.Request(1, _prompt(rng, 6), 2))
    sched.admit()
    occ = sched.occupancy()
    assert occ["pages_in_use"] + occ["pages_free"] == occ["pages_capacity"]
    assert occ["slots_active"] + occ["slots_free"] == occ["slots_total"]
    assert occ["prefilling"] == 2 and occ["decoding"] == 0
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        sched.submit(s.Request(9, np.zeros(30, np.int32), 30))


def test_schedulers_agree_on_a_seeded_trace():
    """Both schedulers over one seeded submit/admit/retire sequence: the
    same admissions, slots and pages at every step."""
    rng = np.random.default_rng(5)
    reqs = [(int(rng.integers(1, 12)), int(rng.integers(1, 6))) for _ in range(20)]
    trail = {}
    for impl in IMPLS:
        s = IMPLS[impl][1]
        sched, _ = _sched(impl, n_slots=3, pages=13)
        steps = []
        for rid, (plen, mnew) in enumerate(reqs):
            sched.submit(s.Request(rid, np.arange(plen) % 7, mnew))
        while sched.queue or sched.active:
            steps.append([(st.rid, st.slot, list(st.pages)) for st in sched.admit()])
            oldest = min(sched.active.values(), key=lambda st: st.rid)
            oldest.state = s.DECODE
            sched.retire(oldest)
            steps.append(sched.pool.available)
        trail[impl] = steps
    assert trail["jax"] == trail["port"]


# -- the paged primitives -------------------------------------------------------


def test_paged_primitives_match_jax():
    """Scatter into a pool with live and null rows, then attend: the live
    pages JAX writes, and its attention output."""
    rng = np.random.default_rng(0)
    b, t, h, dh, page, max_pages = 3, 6, 2, 4, 4, 3
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    pages0 = rng.standard_normal((8, page, h, dh)).astype(np.float32)
    # slot 0 owns pages 1-3; slot 1 owns 4 and 5 (its row null-padded);
    # slot 2 is idle: null row, length 0
    table = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    lengths = np.asarray([2, 3, 0], np.int32)
    jk, jv = jgen.write_paged_kv(jnp.asarray(pages0), jnp.asarray(pages0), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(table), jnp.asarray(lengths))
    jout = jgen.paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    tk, tv = (torch.from_numpy(pages0.copy()) for _ in range(2))
    args = (torch.from_numpy(table), torch.from_numpy(lengths))
    tgen.write_paged_kv(tk, tv, torch.from_numpy(k), torch.from_numpy(v), *args)
    tout = tgen.paged_attention(torch.from_numpy(q), tk, tv, *args)
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    # slot 2 reads only position 0 of the null page, which both sides
    # may have filled from different duplicate writes
    np.testing.assert_allclose(tout.numpy()[:2], np.asarray(jout)[:2], atol=TOL)


def test_padding_and_idle_rows_never_reach_a_live_page():
    """A bucket-padded prefill chunk past its slot's pages and an idle
    slot's decode row write only the null page: every other page keeps its
    bytes but the chunk's own real positions."""
    h, dh, page = 2, 4, 4
    pool = torch.randn(6, page, h, dh, generator=torch.Generator().manual_seed(0))
    before = pool.clone()
    table = torch.tensor([[1, 0, 0], [0, 0, 0]])  # slot 0 owns page 1; slot 1 idle
    lengths = torch.tensor([2, 0])
    k = torch.full((2, 8, h, dh), 7.0)  # positions 2..9: 2 real, 6 padding
    tgen.write_paged_kv(pool, pool.clone(), k, k, table, lengths)
    assert torch.equal(pool[2:], before[2:])  # pages of other slots untouched
    assert torch.equal(pool[1, :2], before[1, :2]) and (pool[1, 2:] == 7.0).all()
    assert (pool[0] == 7.0).any()  # the trash went to the null page


# -- the engine -------------------------------------------------------------------


def test_engine_tokens_match_jax_engine_and_generate(state_dict, jax_served):
    """The mixed trace (every bucket, multi-chunk prefill): the port engine's
    greedy tokens equal the JAX engine's and the port's own generate."""
    eng = _engine(state_dict)
    prompts = _mixed_prompts()
    recs = eng.run([tsched.Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, MAX_NEW))],
                   realtime=False)
    got = {r["rid"]: r["tokens"] for r in recs}
    assert got == jax_served
    model = tg.GPT2(TCFG, decode=True)
    model.load_state_dict(state_dict)
    for rid, toks in got.items():
        ref = tgen.generate(model, prompts[rid][None], MAX_NEW[rid], temperature=0.0)
        assert toks == ref[0, len(prompts[rid]):].tolist(), rid


def test_zero_steady_recompiles_and_closed_program_set(state_dict):
    eng = _engine(state_dict)
    rng = np.random.default_rng(1)
    eng.run([tsched.Request(i, _prompt(rng, int(n)), 4)
             for i, n in enumerate(rng.integers(2, 30, 8))], realtime=False)
    m = eng.metrics()
    assert m["steady_recompiles"] == 0
    assert m["compiled_programs"] == len(BASE["prefill_buckets"]) + 1
    assert {p[0] for p in eng.programs} == {"prefill_8", "prefill_16", "decode"}
    assert 0.0 < m["mean_slot_occupancy"] <= 1.0
    assert m["decode_tokens"] > 0 and m["kv"]["kv_bytes_per_slot"] == 2 * 2 * 6 * 8 * 32 * 4
    # a shape outside the closed set counts as a recompile under load
    eng._forward("decode", np.zeros((1, 1), np.int32), np.zeros((1, 6), np.int32),
                 np.zeros((1,), np.int32))
    assert eng.steady_recompiles() == 1


def test_pages_cycle_across_requests(state_dict):
    eng = _engine(state_dict, n_slots=2, num_pages=2 * 6 + 1)
    rng = np.random.default_rng(2)
    recs = eng.run([tsched.Request(i, _prompt(rng, 8), 4) for i in range(5)], realtime=False)
    assert len(recs) == 5 and eng.pool.in_use == 0
    eng.pool.check_invariants()


def test_admit_fault_sheds_request_not_engine(state_dict):
    install_plan(FaultPlan.from_json([{"site": "serve.admit", "action": "raise", "at": 2}]))
    try:
        eng = _engine(state_dict)
        rng = np.random.default_rng(3)
        recs = eng.run([tsched.Request(i, _prompt(rng, 4), 3) for i in range(4)],
                       realtime=False)
    finally:
        install_plan(None)
    assert len(recs) == 3 and eng.metrics()["dropped_at_admit"] == 1
    assert [r.rid for r in eng.sched.dropped] == [1]


def test_client_fault_cancels_and_slow_reader_accounted(state_dict):
    install_plan(FaultPlan.from_json([
        {"site": "serve.client", "action": "raise", "at": 1},
        {"site": "serve.client", "action": "sleep", "arg": 0.01, "at": 2},
    ]))
    try:
        eng = _engine(state_dict)
        rng = np.random.default_rng(4)
        recs = eng.run([tsched.Request(i, _prompt(rng, 4), 3) for i in range(3)],
                       realtime=False)
    finally:
        install_plan(None)
    m = eng.metrics()
    assert m["cancelled_at_delivery"] == 1 and len(recs) == 2
    assert m["slow_reader_stall_s"] >= 0.01 and eng.pool.in_use == 0


def test_static_admission_gang_schedules(state_dict):
    eng = _engine(state_dict, admission="static", n_slots=2)
    rng = np.random.default_rng(5)
    recs = eng.run([tsched.Request(i, _prompt(rng, 4), 3 + i) for i in range(4)],
                   realtime=False)
    assert len(recs) == 4 and {r["rid"] for r in recs[:2]} == {0, 1}


def test_engine_snapshots_its_weights_and_refuses_waiting_options(state_dict):
    sd = {k: v.clone() for k, v in state_dict.items()}
    eng = _engine(sd)
    for v in sd.values():
        v.zero_()
    assert eng.model.transformer.wte.weight.abs().sum() > 0
    for method, args in (("export_decode_state", ()), ("adopt", ({},)), ("migrate_out", ())):
        with pytest.raises(NotImplementedError, match="serving-fleet slice"):
            getattr(eng, method)(*args)
    with pytest.raises(NotImplementedError, match="quantized-KV slice"):
        _engine(state_dict, kv_wire="int8_block")
    with pytest.raises(NotImplementedError, match="quantized-KV slice"):
        tkv.kv_bytes_per_slot("int8_block", n_layer=1, n_head=1, head_dim=1, page_size=1,
                              max_pages_per_slot=1)


def test_sampled_engine_is_seeded(state_dict):
    """temperature > 0: one seed, one trace, the same tokens."""
    def run(seed):
        eng = _engine(state_dict, temperature=1.0, top_k=20, seed=seed)
        rng = np.random.default_rng(6)
        return [r["tokens"] for r in eng.run([tsched.Request(i, _prompt(rng, 6), 6)
                                              for i in range(3)], realtime=False)]

    assert run(3) == run(3) != run(4)


def test_bucket_spans_compile_then_step(state_dict):
    trace.enable(crash_handler=False)
    trace.clear()
    try:
        class Owner:
            pass

        o = Owner()
        for bucket in (8, 8, 8, 16):
            with trace.bucket_dispatch_span(o, "serve.prefill", bucket):
                pass
        recs = [r for r in trace.records() if "serve.prefill" in r["name"]]
        assert [r["cat"] for r in recs] == ["compile", "step", "step", "compile"]
        assert [r["attrs"]["bucket"] for r in recs] == [8, 8, 8, 16]
        trace.clear()
        eng = tengine.ServeEngine(TCFG, state_dict, n_slots=2, page_size=8, max_len=32,
                                  prefill_chunk=8, prefill_buckets=(8,), device="cpu")
        eng.run([tsched.Request(0, np.arange(4), 3)], realtime=False)
        names = {r["name"] for r in trace.records()}
        assert {"serve.prefill.compile+dispatch", "serve.decode.compile+dispatch",
                "serve.decode.dispatch"} <= names
    finally:
        trace.clear()
        trace.disable()


# -- tiles ------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,tile,ov", [(100, 70, 48, 8), (48, 48, 48, 8), (97, 51, 32, 4),
                                         (256, 256, 48, 8), (128, 200, 48, 8)])
def test_tile_grid_matches_jax_and_covers(h, w, tile, ov):
    grid = ttiles.tile_grid(h, w, tile, ov)
    assert grid == jtiles.tile_grid(h, w, tile, ov)
    cov = np.zeros((h, w), bool)
    for y, x in grid:
        assert y + tile <= h and x + tile <= w
        cov[y: y + tile, x: x + tile] = True
    assert cov.all()
    for bad in ((10, 100, 48, 8), (100, 100, 48, 48)):
        with pytest.raises(ValueError):
            ttiles.tile_grid(*bad)


class _Double(torch.nn.Module):
    upscale = 1

    def forward(self, x):
        return x * 2.0


def test_stitch_is_exact_for_linear_model():
    srv = ttiles.SwinIRTileServer(_Double(), tile=32, tile_batch=3, overlap=8, device="cpu")
    rng = np.random.default_rng(0)
    imgs = [rng.random((80, 50, 3)).astype(np.float32),
            rng.random((10, 20, 3)).astype(np.float32)]  # < tile: reflect-padded
    recs = srv.run([ttiles.TileRequest(i, im) for i, im in enumerate(imgs)])
    assert len(recs) == 2
    for r in recs:
        assert r["image"].shape == imgs[r["rid"]].shape
        np.testing.assert_allclose(r["image"], imgs[r["rid"]] * 2.0, atol=1e-6)


def test_batches_mix_requests_and_client_fault_cancels():
    srv = ttiles.SwinIRTileServer(_Double(), tile=32, tile_batch=4, overlap=0, device="cpu")
    rng = np.random.default_rng(1)
    for i in range(2):  # two 2-tile images: one batch carries both
        srv.submit(ttiles.TileRequest(i, rng.random((32, 64, 3)).astype(np.float32)))
    srv.warmup()
    srv.tick(0.0)
    assert srv.metrics()["mean_batch_occupancy"] == 1.0 and len(srv.delivered) == 2
    install_plan(FaultPlan.from_json([{"site": "serve.client", "action": "raise", "at": 1}]))
    try:
        srv = ttiles.SwinIRTileServer(_Double(), tile=16, tile_batch=2, overlap=0, device="cpu")
        recs = srv.run([ttiles.TileRequest(i, rng.random((16, 16, 3)).astype(np.float32))
                        for i in range(2)])
    finally:
        install_plan(None)
    assert srv.cancelled == [0] and [r["rid"] for r in recs] == [1]


TINY_SR = dict(upscale=2, embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=4,
               img_size=8)
TILE_IMAGES = ((24, 20), (16, 16), (10, 12))  # the last is reflect-padded up to the tile


def _tile_requests(module):
    rng = np.random.default_rng(2)
    return [module.TileRequest(i, rng.random((h, w, 3)).astype(np.float32))
            for i, (h, w) in enumerate(TILE_IMAGES)]


@pytest.fixture(scope="module")
def tiny_sr():
    """JAX's tile server over the tiny SwinIR (Pallas attention in
    interpret mode), once for the module: (params, records)."""
    model = JaxSwinIR(**TINY_SR, attn_impl="pallas")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    srv = jtiles.SwinIRTileServer(model, params, tile=16, tile_batch=2, overlap=4)
    recs = srv.run(_tile_requests(jtiles))
    assert srv.metrics()["steady_recompiles"] == 0
    return jax.device_get(params), {r["rid"]: r["image"] for r in recs}


def test_swinir_tile_server_matches_jax(tiny_sr):
    params, want = tiny_sr
    model = SwinIR(**TINY_SR)
    model.load_state_dict(swinir_state_dict_from_jax(params, img_size=TINY_SR["img_size"]))
    srv = ttiles.SwinIRTileServer(model, tile=16, tile_batch=2, overlap=4, device="cpu")
    recs = srv.run(_tile_requests(ttiles))
    assert [r["rid"] for r in recs] == [r for r in want]
    for r in recs:
        h, w = TILE_IMAGES[r["rid"]]
        assert r["image"].shape == (2 * h, 2 * w, 3)
        np.testing.assert_allclose(r["image"], want[r["rid"]], atol=TOL)
    m = srv.metrics()
    assert m["steady_recompiles"] == 0 and m["delivered"] == 3
    assert srv.programs == {((2, 16, 16, 3), "float32")}


# -- knobs, factory, facade ---------------------------------------------------------


def test_env_knobs_match_jax():
    env = {"GRAFT_SERVE_SLOTS": "8", "GRAFT_SERVE_PAGE": "4", "GRAFT_SERVE_BUCKETS": "16,4",
           "GRAFT_SERVE_TILE": "64", "GRAFT_SERVE_SPEC_K": "3", "GRAFT_SERVE_MAX_LEN": "128"}
    for e in (env, {}):
        assert tserve.serve_knobs_from_env(e) == jserve.serve_knobs_from_env(e)
        assert tserve.tile_knobs_from_env(e) == jserve.tile_knobs_from_env(e)
        assert tserve.slo_knobs_from_env(e) == jserve.slo_knobs_from_env(e)
    kw = tserve.serve_knobs_from_env(env)
    assert kw["prefill_buckets"] == (4, 16) and kw["num_pages"] is None


def test_build_engine_dispatches_on_model(state_dict, monkeypatch):
    monkeypatch.setenv("GRAFT_SERVE_SLOTS", "2")
    gpt = tg.GPT2(TCFG)
    gpt.load_state_dict(state_dict)
    eng = tserve.build_engine(gpt, page_size=8, max_len=32, prefill_chunk=8,
                              prefill_buckets=(8,), device="cpu")
    assert isinstance(eng, tengine.ServeEngine) and eng.n_slots == 2  # the env fills in
    srv = tserve.build_engine(SwinIR(**TINY_SR), device="cpu")
    assert isinstance(srv, ttiles.SwinIRTileServer) and srv.tile == 48
    with pytest.raises(TypeError, match="no serving engine"):
        tserve.build_engine(torch.nn.Linear(2, 2), {})


def test_stoke_serve_snapshots_live_weights(state_dict):
    from pytorch_distributedtraining_tpu_torch.stoke import Stoke, StokeOptimizer

    gpt = tg.GPT2(TCFG)
    gpt.load_state_dict(state_dict)
    stoke = Stoke(gpt, StokeOptimizer(optimizer="AdamW", optimizer_kwargs={"lr": 1e-2}),
                  loss=tg.cross_entropy_loss, device="cpu")
    kw = dict(n_slots=2, page_size=8, max_len=32, prefill_chunk=8, prefill_buckets=(8,))
    eng = stoke.serve(**kw)
    assert isinstance(eng, tengine.ServeEngine) and eng.device.type == "cpu"
    prompt = np.arange(5, dtype=np.int32)
    before = eng.run([tsched.Request(0, prompt, 4)], realtime=False)[0]["tokens"]
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16)))
    for _ in range(3):  # training moves the live weights, not the engine's
        logits = stoke.model(tok)
        stoke.backward(stoke.loss(logits[:, :-1], tok[:, 1:]))
        stoke.step()
    again = eng.run([tsched.Request(1, prompt, 4)], realtime=False)[-1]["tokens"]
    assert again == before
    assert not torch.equal(eng.model.transformer.wte.weight, gpt.transformer.wte.weight)

    sr = Stoke(SwinIR(**TINY_SR), StokeOptimizer(optimizer="AdamW"),
               loss=torch.nn.functional.mse_loss, device="cpu", fp16="bf16")
    srv = sr.serve(tile=16, tile_batch=2, overlap=4)
    assert isinstance(srv, ttiles.SwinIRTileServer) and srv.policy.compute_dtype == torch.bfloat16
    rec = srv.run([ttiles.TileRequest(0, np.zeros((20, 16, 3), np.float32))])[0]
    assert rec["image"].shape == (40, 32, 3) and np.isfinite(rec["image"]).all()
