"""Continuous-batching GPT-2 decode engine over the paged KV cache.

Counterpart of ``pytorch_distributedtraining_tpu/serve/engine.py``. The
engine runs a **closed set of programs** and serves an open-ended request
stream without ever changing a shape:

- one chunked-prefill program per bucket in ``prefill_buckets``: B=1,
  ``[1, bucket]`` tokens against the slot's page-table row. Longer prompts
  run as several chunks; the last samples the first new token.
- one decode program at ``[n_slots, 1]``: every slot steps together, each
  at its own length. Slots without an active decode get a **null
  page-table row** (all zeros, physical page 0) and length 0, so their
  writes land in trash and their sampled token is ignored.
- with ``spec_k >= 2``, exactly one more: the speculative verify step at
  ``[n_slots, spec_k]``. A host-side pass drafts ``spec_k - 1`` tokens per
  slot from the sequence's own history (the most recent earlier
  occurrence of its tail n-gram), the verify step scores them in one
  batched forward, and the longest prefix of drafts that matches the
  model's own greedy outputs is accepted: 1 to ``spec_k`` tokens a tick.
  The accepted tokens are the sequential greedy outputs by construction,
  so speculative decode is token-identical to vanilla and needs
  ``temperature == 0``. Rejected drafts' K/V past the accepted length is
  garbage that the write-before-read invariant absorbs.

PyTorch runs these programs eagerly; the counterpart of JAX's jit cache is
the set of (program, input shapes) the engine has dispatched
(:attr:`ServeEngine.programs`). :meth:`~ServeEngine.warmup` dispatches each
one, :meth:`~ServeEngine.mark_steady` snapshots the set, and
:meth:`~ServeEngine.steady_recompiles` counts signatures new since then:
0 under load. Admission, retirement and page accounting are host-side
(:mod:`.scheduler`), so a request joining or finishing never changes a
shape.

Tick loop (one iteration of :meth:`~ServeEngine.run`):

1. admit queue-head requests into free slots (``serve.admit`` fault site),
2. run ONE prefill chunk for the oldest still-prefilling request,
3. run ONE batched decode step for every decoding slot,
4. retire finished requests (``serve.client`` fault site at delivery:
   ``sleep`` = slow reader, ``raise`` = disconnect), freeing their pages.

Telemetry: per-bucket lanes ``serve.prefill`` / ``serve.decode`` /
``serve.spec_verify`` (:func:`..observe.trace.bucket_dispatch_span`), and a
lifecycle record per request (:mod:`..observe.slo`) whose phases sum to
its wall latency.

Waiting for later slices: quantized KV pages (``kv_wire``, the
quantized-KV slice); decode-state migration (``export_decode_state``,
``adopt``, ``migrate_out``) with the router and fleet, and the fleet
plane's rolling histograms and gauges (the serving-fleet slice); the
process-wide ``runtime_stats`` that the JAX analyze rules read (the
analyze slice).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..models.generate import PagedKVCache, init_paged_cache, sample_logits
from ..models.gpt2 import GPT2
from ..observe import slo as _slo
from ..observe import trace
from ..resilience.faults import InjectedFault, fault_point
from ..runtime.dist import resolve_device
from .kv_cache import PagePool, kv_bytes_per_slot, kv_wire_format
from .scheduler import DECODE, DROPPED, AdmissionScheduler, Request

FLEET = ("{} is not ported yet (the serving-fleet slice: decode-state migration, "
         "serve/router.py and serve/fleet.py)")

def accept_drafts(drafts, greedy, budget: int) -> int:
    """Longest-matching-prefix accept count for one slot's verify output.

    ``drafts``: the ``spec_k - 1`` tokens fed at verify positions
    ``1..spec_k-1``; ``greedy[j]``: the model's greedy token after input
    position ``j``. ``greedy[0]`` depends only on accepted context, so it is
    always accepted; ``greedy[n]`` counts iff every draft before it matched.
    ``budget`` (the request's remaining ``max_new_tokens``) caps the count.
    """
    n = 1
    k = len(greedy)
    while n < k and n < budget and int(drafts[n - 1]) == int(greedy[n - 1]):
        n += 1
    return min(n, max(1, int(budget)))


class ServeEngine:
    """Continuous-batching engine for GPT-2 decode.

    ``params``: a state dict of the port's ``GPT2`` (HF names), copied
    into the engine's own ``GPT2(cfg, decode=True, paged=...)`` on
    ``device``, so later training steps do not reach it.
    ``admission="continuous"`` or ``"static"`` (the gang baseline: a batch
    admits only into an empty engine).
    """

    def __init__(
        self,
        cfg,
        params: dict,
        *,
        n_slots: int = 4,
        page_size: int = 16,
        num_pages: int | None = None,
        max_len: int | None = None,
        prefill_chunk: int = 32,
        prefill_buckets: tuple[int, ...] = (8, 16, 32),
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int = 0,
        admission: str = "continuous",
        slo: _slo.SLOTracker | None = None,
        spec_k: int = 0,
        kv_wire=None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        # speculative decode: draft depth per tick (0/1 = off); the accept
        # rule compares drafts with greedy outputs, so sampling is refused
        self.spec_k = max(0, int(spec_k))
        if self.spec_k == 1:
            self.spec_k = 0  # k=1 proposes nothing: vanilla decode
        if self.spec_k and temperature != 0.0:
            raise ValueError(
                f"speculative decode (spec_k={self.spec_k}) requires greedy sampling "
                f"(temperature=0), got temperature={temperature}: the accepted prefix is "
                "defined as the greedy output")
        self.kv_wire = kv_wire_format(kv_wire)  # dense pages only
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len or cfg.n_positions)
        if self.max_len > cfg.n_positions:
            raise ValueError(f"max_len {self.max_len} exceeds n_positions {cfg.n_positions}")
        self.max_pages = math.ceil(self.max_len / self.page_size)
        # default pool: every slot can hold a max_len request, + null page
        self.num_pages = int(num_pages or 1 + self.n_slots * self.max_pages)
        self.prefill_buckets = tuple(sorted(int(b) for b in prefill_buckets))
        self.prefill_chunk = min(int(prefill_chunk), self.prefill_buckets[-1])
        self._sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))

        self.ledger = _slo.RequestLedger()
        self.slo = slo if slo is not None else _slo.SLOTracker(**_slo.slo_knobs_from_env())
        self.pool = PagePool(self.num_pages, self.page_size)
        self.sched = AdmissionScheduler(
            n_slots=self.n_slots, pool=self.pool, max_pages_per_slot=self.max_pages,
            prefill_chunk=self.prefill_chunk, prefill_buckets=self.prefill_buckets,
            admission=admission, ledger=self.ledger, spec_k=self.spec_k,
        )

        # the engine's own model, weights copied in: a snapshot
        with torch.device("meta"):
            model = GPT2(cfg, decode=True, paged=(self.num_pages, self.page_size))
        self.model = model.to_empty(device=self.device).requires_grad_(False).eval()
        self.model.load_state_dict(params, strict=True)
        self._pages: PagedKVCache = init_paged_cache(self.model)
        # host mirrors: the physical page table per slot and live lengths
        self._page_table = np.zeros((self.n_slots, self.max_pages), np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int32)

        self.programs: set = set()  # (program, input shapes) dispatched so far
        self._warm = False
        self._steady_programs: int | None = None
        self.cancelled: list[int] = []  # rids dropped at delivery
        self.delivered: list[dict] = []
        self._occupancy_samples: list[float] = []
        self._tick = 0
        self._slow_reader_s = 0.0
        # decode throughput and speculative accounting
        self._decode_s = 0.0
        self._draft_s = 0.0
        self._decode_tokens = 0
        self._spec_ticks = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_window: list[tuple[int, int]] = []  # last 256 verify ticks

    # -- the programs ------------------------------------------------------

    def _forward(self, program: str, tokens: np.ndarray, page_table: np.ndarray,
                 lengths: np.ndarray) -> torch.Tensor:
        """One dispatch of ``program``: host arrays to the device, the paged
        forward, its logits ``[B, T, V]`` (f32, on the device)."""
        self.programs.add((program, tokens.shape, page_table.shape, lengths.shape))
        dev = self.device
        with torch.inference_mode():
            return self.model(torch.from_numpy(tokens).to(dev), self._pages,
                              page_table=torch.from_numpy(page_table).to(dev),
                              lengths=torch.from_numpy(lengths).to(dev))

    def _prefill(self, bucket: int, tokens, ptrow, start: int, last: int) -> torch.Tensor:
        """One chunk; the token sampled after its ``last`` position, ``[1]``
        on the device (read by the host after the prompt's last chunk only)."""
        logits = self._forward(f"prefill_{bucket}", tokens, ptrow,
                               np.asarray([start], np.int32))
        return sample_logits(logits[:, last], self._generator, **self._sample_kw)

    def _decode(self, tokens, page_table, lengths) -> np.ndarray:
        logits = self._forward("decode", tokens, page_table, lengths)
        return sample_logits(logits[:, -1], self._generator, **self._sample_kw).cpu().numpy()

    def _spec_verify(self, tokens, page_table, lengths) -> np.ndarray:
        """The batched verify step at ``[n_slots, spec_k]``: column 0 holds
        each slot's newest token, columns 1.. the drafts; the model banks
        K/V for all of them and returns its greedy token after each."""
        logits = self._forward("spec_verify", tokens, page_table, lengths)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    # -- warmup / steady-state tracking ------------------------------------

    def warmup(self) -> dict:
        """Dispatch every program the engine can ever run, against the null
        page table (all writes land in the trash page), so no request
        shape is new after this. Returns seconds per program."""
        null_row = np.zeros((1, self.max_pages), np.int32)
        report = {}
        for b in self.prefill_buckets:
            t0 = time.perf_counter()
            with trace.bucket_dispatch_span(self, "serve.prefill", b):
                self._prefill(b, np.zeros((1, b), np.int32), null_row, 0, b - 1).cpu()
            report[f"prefill_{b}"] = time.perf_counter() - t0
        null_table = np.zeros((self.n_slots, self.max_pages), np.int32)
        zeros = np.zeros((self.n_slots,), np.int32)
        t0 = time.perf_counter()
        with trace.bucket_dispatch_span(self, "serve.decode", self.n_slots):
            self._decode(np.zeros((self.n_slots, 1), np.int32), null_table, zeros)
        report["decode"] = time.perf_counter() - t0
        if self.spec_k:
            t0 = time.perf_counter()
            with trace.bucket_dispatch_span(self, "serve.spec_verify", self.spec_k):
                self._spec_verify(np.zeros((self.n_slots, self.spec_k), np.int32),
                                  null_table, zeros)
            report["spec_verify"] = time.perf_counter() - t0
        self._warm = True
        return report

    def mark_steady(self) -> int:
        """Snapshot the program set; growth after this is a steady-state
        recompile."""
        self._steady_programs = len(self.programs)
        return self._steady_programs

    def steady_recompiles(self) -> int:
        """Program signatures added since :meth:`mark_steady` (0 = clean)."""
        if self._steady_programs is None:
            return 0
        return max(0, len(self.programs) - self._steady_programs)

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def _admit(self, now: float) -> None:
        for st in self.sched.admit(now):
            # physical pages -> 0-padded page-table row (0 = null page)
            row = np.zeros((self.max_pages,), np.int32)
            row[: len(st.pages)] = st.pages
            self._page_table[st.slot] = row
            self._lengths[st.slot] = 0

    def _prefill_tick(self, now: float) -> bool:
        st = self.sched.next_prefill()
        if st is None:
            return False
        start, size, bucket = self.sched.prefill_chunk_for(st)
        chunk = np.zeros((1, bucket), np.int32)
        chunk[0, :size] = st.req.prompt[start: start + size]
        t0 = time.perf_counter()
        with trace.bucket_dispatch_span(self, "serve.prefill", bucket):
            tok = self._prefill(bucket, chunk, self._page_table[st.slot: st.slot + 1], start,
                                size - 1)
            last = start + size == st.req.prompt_len
            if last:
                first = int(tok[0])  # the host read syncs: TTFT lands here
        st.prefilled += size
        if last:
            st.tokens.append(first)
            st.first_token_s = now
            st.first_token_pc = time.perf_counter()
            st.state = DECODE
            self._lengths[st.slot] = st.req.prompt_len
        # padding_fraction: the unused tail of the [1, bucket] dispatch
        self.ledger.add_phase(st.rid, "prefill", t0, time.perf_counter(), bucket=bucket,
                              tokens=size, padding_fraction=round(1.0 - size / bucket, 4))
        return True

    def _draft(self, st) -> list[int]:
        """Self-drafted proposal for one slot, ``spec_k - 1`` tokens: the
        tokens that followed the most recent earlier occurrence of the
        context's tail n-gram (longest of 3/2/1), else the newest token
        repeated. Any draft is safe: verify discards mismatches."""
        need = self.spec_k - 1
        ctx = st.req.prompt.tolist() + st.tokens
        out: list[int] = []
        for n in (3, 2, 1):
            if len(ctx) <= n:
                continue
            tail = ctx[-n:]
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    out = ctx[i + n:i + n + need]
                    break
            if out:
                break
        while len(out) < need:
            out.append(out[-1] if out else ctx[-1])
        return out[:need]

    def _spec_decode_tick(self, now: float) -> list:
        """One speculative quantum: host draft pass, one ``[n_slots,
        spec_k]`` verify dispatch, longest-matching-prefix accept. Each
        slot's length advances by its accept count; the newest accepted
        token is the next tick's column 0."""
        active = self.sched.decoding()
        if not active:
            return []
        k = self.spec_k
        pt = np.zeros_like(self._page_table)
        lens = np.zeros_like(self._lengths)
        toks = np.zeros((self.n_slots, k), np.int32)
        td0 = time.perf_counter()
        drafts: dict[int, list[int]] = {}
        for st in active:
            pt[st.slot] = self._page_table[st.slot]
            lens[st.slot] = self._lengths[st.slot]
            d = self._draft(st)
            drafts[st.slot] = d
            toks[st.slot, 0] = st.tokens[-1]
            toks[st.slot, 1:] = d
        t0 = time.perf_counter()
        with trace.bucket_dispatch_span(self, "serve.spec_verify", k):
            out = self._spec_verify(toks, pt, lens)  # the host read syncs
        t1 = time.perf_counter()
        draft_s, verify_s = t0 - td0, t1 - t0
        share = round(1.0 / len(active), 4)
        padding = round(1.0 - len(active) / self.n_slots, 4)
        finished = []
        tick_proposed = tick_accepted = 0
        for st in active:
            budget = st.req.max_new_tokens - len(st.tokens)
            greedy = [int(x) for x in out[st.slot]]
            n_acc = accept_drafts(drafts[st.slot], greedy, budget)
            st.tokens.extend(greedy[:n_acc])
            self._lengths[st.slot] += n_acc
            tick_proposed += k - 1
            tick_accepted += n_acc - 1
            # the whole tick bills to every resident slot as `decode`; the
            # attrs carry the draft/verify split and what speculation bought
            self.ledger.add_phase(
                st.rid, "decode", td0, t1, active_slots=len(active), share=share,
                padding_fraction=padding, spec_k=k, draft_s=round(draft_s, 6),
                verify_s=round(verify_s, 6), proposed=k - 1, accepted=n_acc - 1,
                tokens=n_acc)
            self._decode_tokens += n_acc
            if len(st.tokens) >= st.req.max_new_tokens:
                finished.append(st)
        self._decode_s += verify_s
        self._draft_s += draft_s
        self._spec_ticks += 1
        self._spec_proposed += tick_proposed
        self._spec_accepted += tick_accepted
        self._spec_window.append((tick_proposed, tick_accepted))
        if len(self._spec_window) > 256:
            del self._spec_window[0]
        return finished

    def spec_accept_rate(self, rolling: bool = True) -> float:
        """Accepted / proposed drafts (1.0 when speculation never ran);
        ``rolling`` keeps the last 256 verify ticks."""
        window = self._spec_window if rolling else [(self._spec_proposed, self._spec_accepted)]
        prop = sum(p for p, _ in window)
        acc = sum(a for _, a in window)
        return acc / prop if prop else 1.0

    def _decode_tick(self, now: float) -> list:
        if self.spec_k:
            return self._spec_decode_tick(now)
        active = self.sched.decoding()
        if not active:
            return []
        # every slot steps; idle ones take the null row, so their writes
        # (the shape is fixed) land in the trash page
        pt = np.zeros_like(self._page_table)
        lens = np.zeros_like(self._lengths)
        toks = np.zeros((self.n_slots, 1), np.int32)
        for st in active:
            pt[st.slot] = self._page_table[st.slot]
            lens[st.slot] = self._lengths[st.slot]
            toks[st.slot, 0] = st.tokens[-1]
        t0 = time.perf_counter()
        with trace.bucket_dispatch_span(self, "serve.decode", self.n_slots):
            out = self._decode(toks, pt, lens)  # the host read syncs
        t1 = time.perf_counter()
        # every resident request waits out the whole batched tick, so each
        # is billed all of it, with its residency share and the idle rows
        share = round(1.0 / len(active), 4)
        padding = round(1.0 - len(active) / self.n_slots, 4)
        finished = []
        for st in active:
            self.ledger.add_phase(st.rid, "decode", t0, t1, active_slots=len(active),
                                  share=share, padding_fraction=padding)
            st.tokens.append(int(out[st.slot]))
            self._lengths[st.slot] += 1
            if len(st.tokens) >= st.req.max_new_tokens:
                finished.append(st)
        self._decode_s += t1 - t0
        self._decode_tokens += len(active)
        return finished

    def _retire(self, finished, now: float) -> None:
        for st in finished:
            t0 = time.perf_counter()
            try:
                # "sleep" = slow reader holding the tick loop; "raise" =
                # client disconnect
                fault_point("serve.client", rid=st.rid)
                ok = True
            except InjectedFault:
                ok = False
            t1 = time.perf_counter()
            self._slow_reader_s += t1 - t0
            # reader time bills to `stall`: the tokens were already made
            self.ledger.add_phase(st.rid, "stall", t0, t1)
            self._page_table[st.slot] = 0
            self._lengths[st.slot] = 0
            if not ok:
                self.cancelled.append(st.rid)
                self.sched.retire(st, now, state=DROPPED)
                self.ledger.complete(st.rid, outcome=_slo.CANCELLED)
                continue
            self.sched.retire(st, now)
            td = time.perf_counter()
            rec = self._record(st, now)
            self.ledger.add_phase(st.rid, "deliver", td, time.perf_counter())
            life = self.ledger.complete(st.rid)
            rec.update(req_id=life["uid"], slot=life["slot"], wall_s=life["wall_s"],
                       phases=life["phases"])
            self.slo.observe(life["wall_s"], None if st.first_token_pc is None
                             else st.first_token_pc - life["t_start"])
            self.delivered.append(rec)

    def _record(self, st, now: float) -> dict:
        arr = st.req.arrival_s
        return {
            "rid": st.rid,
            "prompt_len": st.req.prompt_len,
            "new_tokens": len(st.tokens),
            "tokens": list(st.tokens),
            "latency_s": now - arr,
            "ttft_s": None if st.first_token_s is None else st.first_token_s - arr,
            "queue_s": st.admitted_s - arr,
        }

    # -- decode-state migration: the serving-fleet slice -------------------

    def export_decode_state(self, rids=None) -> dict:
        raise NotImplementedError(FLEET.format("ServeEngine.export_decode_state"))

    def adopt(self, snapshot: dict) -> list[int]:
        raise NotImplementedError(FLEET.format("ServeEngine.adopt"))

    def migrate_out(self, rids=None):
        raise NotImplementedError(FLEET.format("ServeEngine.migrate_out"))

    # -- driving loops -----------------------------------------------------

    def tick(self, now: float) -> None:
        """One scheduling quantum: admit, prefill chunk, decode, retire."""
        self._admit(now)
        self._prefill_tick(now)
        finished = self._decode_tick(now)
        self._occupancy_samples.append(len(self.sched.active) / self.n_slots)
        self._retire(finished, now)
        self._tick += 1

    def run(self, requests, *, realtime: bool = True) -> list[dict]:
        """Serve an open-loop trace: each request is submitted at its
        ``arrival_s`` (relative to loop start); ``realtime=False`` ignores
        arrival times (everything queues up front). Warms up and marks the
        steady state on first use; returns the delivery records."""
        if not self._warm:
            self.warmup()
        if self._steady_programs is None:
            self.mark_steady()
        pending = sorted(requests, key=lambda r: r.arrival_s)
        t0 = time.monotonic()
        while pending or not self.sched.idle:
            now = time.monotonic() - t0 if realtime else float(self._tick)
            while pending and (not realtime or pending[0].arrival_s <= now):
                self.submit(pending.pop(0))
            if realtime and pending and self.sched.idle and pending[0].arrival_s > now:
                time.sleep(min(0.001, pending[0].arrival_s - now))
                continue
            self.tick(now)
        self.steady_recompiles()
        return self.delivered

    # -- reporting ---------------------------------------------------------

    def occupancy(self) -> dict:
        occ = self.sched.occupancy()
        occ["mean_slot_occupancy"] = (float(np.mean(self._occupancy_samples))
                                      if self._occupancy_samples else 0.0)
        return occ

    def metrics(self) -> dict:
        """The engine's own accounting; latency percentiles come from the
        delivery records."""
        decode_wall = self._decode_s + self._draft_s
        return {
            "delivered": len(self.delivered),
            "dropped_at_admit": len(self.sched.dropped),
            "cancelled_at_delivery": len(self.cancelled),
            "ticks": self._tick,
            "mean_slot_occupancy": self.occupancy()["mean_slot_occupancy"],
            "steady_recompiles": self.steady_recompiles(),
            "compiled_programs": len(self.programs),
            "slow_reader_stall_s": self._slow_reader_s,
            "slo": self.slo.snapshot(),
            # tokens banked by decode/verify ticks over their wall time,
            # the draft pass included
            "decode_tokens": self._decode_tokens,
            "decode_s": decode_wall,
            "decode_tokens_per_sec": self._decode_tokens / decode_wall if decode_wall else 0.0,
            "spec": {
                "spec_k": self.spec_k,
                "ticks": self._spec_ticks,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_rate": self.spec_accept_rate(rolling=False),
                "rolling_accept_rate": self.spec_accept_rate(),
                "draft_s": self._draft_s,
                "verify_s": self._decode_s if self.spec_k else 0.0,
            },
            "kv": self.kv_metrics(),
        }

    def kv_metrics(self) -> dict:
        """Device bytes of one slot's full page reservation (dense pages)."""
        dense = kv_bytes_per_slot(
            None, n_layer=self.cfg.n_layer, n_head=self.cfg.n_head,
            head_dim=self.cfg.n_embd // self.cfg.n_head, page_size=self.page_size,
            max_pages_per_slot=self.max_pages,
            dense_bytes_per_elem=torch.finfo(self.cfg.dtype).bits // 8)
        return {"kv_wire": None, "kv_bytes_per_slot": int(dense),
                "kv_bytes_per_slot_dense": int(dense), "slots_per_hbm_gain": 1.0}

    def tail_attribution(self, q: float = 99.0) -> dict:
        """Phase attribution of the latency tail (>= q-th percentile)."""
        return _slo.tail_attribution(self.ledger.completed, q=q)

    def export_serve_trace(self, path: str | None = None) -> str:
        """Write completed lifecycles as the ``graft-serve`` Chrome-trace
        lane (one thread lane per slot, flow arrows per request)."""
        return _slo.export_serve_trace(self.ledger.completed, path)
