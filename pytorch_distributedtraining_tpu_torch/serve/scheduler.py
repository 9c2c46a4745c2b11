"""Admission scheduler: FIFO queue -> slots + pages, chunked-prefill plan.

Counterpart of ``pytorch_distributedtraining_tpu/serve/scheduler.py``.
Once the KV cache is paged, the programs never change shape, so continuous
batching is host-side scheduling: which request occupies which slot when,
and the accounting for it. Torch-free.

- **FIFO with head-of-line blocking**: requests admit in submission order;
  if the head does not fit (no free slot, or fewer free pages than its
  worst case), nothing behind it admits either.
- **Worst-case page reservation**: a request reserves pages for
  ``prompt_len + max_new_tokens`` at admission, so decode never waits for
  a page mid-request. Under speculative decode (``spec_k >= 2``) it adds
  ``spec_k - 1`` tokens of draft headroom: a verify tick writes K/V for up
  to ``spec_k`` positions past the live length, and the headroom keeps
  the last tick's rejected drafts inside the slot's own pages.
- **Slots are min-id first** and pages LIFO (``kv_cache``), so a retired
  request's resources go to the next admit, deterministically.
- ``admission="static"`` is the gang baseline: a batch admits only into an
  empty engine, as a fixed-batch ``generate()`` loop does.

Fault site ``serve.admit`` fires per admission decision: a ``raise`` drops
that request (counted; the engine keeps serving). With a
``observe.slo.RequestLedger``, the scheduler opens each request's
lifecycle at :meth:`~AdmissionScheduler.submit`, closes ``queue_wait`` at
admission, and gives shed requests their terminal ``shed`` phase.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..resilience.faults import InjectedFault, fault_point
from .kv_cache import PagePool

# request lifecycle states
QUEUED, PREFILL, DECODE, DONE, DROPPED = (
    "queued", "prefill", "decode", "done", "dropped",
)


@dataclass
class Request:
    """One generation request: a prompt and a token budget."""

    rid: int
    prompt: np.ndarray  # [T] int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1"
            )

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclass
class RequestState:
    """Scheduler-side view of an admitted request."""

    req: Request
    slot: int
    pages: list[int]
    state: str = PREFILL
    prefilled: int = 0          # prompt tokens already banked
    tokens: list[int] = field(default_factory=list)  # generated ids
    admitted_s: float = 0.0
    first_token_s: float | None = None  # TTFT clock (vs req.arrival_s)
    first_token_pc: float | None = None  # TTFT on the lifecycle clock
    done_s: float | None = None

    @property
    def rid(self) -> int:
        return self.req.rid


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets sorted ascending). ``n`` above the
    largest bucket is a caller bug: chunks are clamped to the bucket cap."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"chunk of {n} exceeds largest bucket {buckets[-1]}")


def chunk_plan(prompt_len: int, chunk: int,
               buckets: tuple[int, ...]) -> list[tuple[int, int, int]]:
    """[(start, size, bucket)] chunked-prefill plan for one prompt."""
    out = []
    start = 0
    while start < prompt_len:
        size = min(chunk, prompt_len - start)
        out.append((start, size, bucket_for(size, buckets)))
        start += size
    return out


class AdmissionScheduler:
    """FIFO admission over ``n_slots`` batch slots and a shared PagePool."""

    def __init__(
        self,
        *,
        n_slots: int,
        pool: PagePool,
        max_pages_per_slot: int,
        prefill_chunk: int = 32,
        prefill_buckets: tuple[int, ...] = (8, 16, 32),
        admission: str = "continuous",
        ledger=None,
        spec_k: int = 0,
    ):
        if admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if prefill_chunk > max(prefill_buckets):
            raise ValueError(
                f"prefill_chunk {prefill_chunk} exceeds largest bucket "
                f"{max(prefill_buckets)}"
            )
        self.n_slots = n_slots
        self.pool = pool
        self.max_pages_per_slot = max_pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.admission = admission
        self.ledger = ledger  # observe.slo.RequestLedger | None
        # speculative draft depth (0/1 = off): page reservations add
        # spec_k - 1 tokens of headroom per request (module docstring)
        self.spec_k = max(0, int(spec_k))
        self.queue: deque[Request] = deque()
        self.active: dict[int, RequestState] = {}  # slot -> state
        self.free_slots: list[int] = list(range(n_slots))  # min-id first
        self.done: list[RequestState] = []
        self.dropped: list[Request] = []
        self._admit_order: deque[int] = deque()  # slots, admission order

    # -- submission / admission -------------------------------------------

    def reserve_tokens(self, req: Request) -> int:
        """Worst-case token positions the request can ever write: its
        budget plus ``spec_k - 1`` draft-depth headroom (a final verify
        tick's rejected drafts land past the budget)."""
        return req.total_len + max(0, self.spec_k - 1)

    def submit(self, req: Request) -> None:
        need = self.pool.pages_for(self.reserve_tokens(req))
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"request {req.rid}: needs {need} pages "
                f"(prompt {req.prompt_len} + new {req.max_new_tokens}"
                + (
                    f" + spec headroom {self.spec_k - 1}"
                    if self.spec_k >= 2 else ""
                )
                + f" at page {self.pool.page_size}) > max_pages_per_slot "
                f"{self.max_pages_per_slot}"
            )
        self.queue.append(req)
        if self.ledger is not None:
            self.ledger.begin(req.rid)  # the queue_wait clock starts here

    def admit(self, now: float = 0.0) -> list[RequestState]:
        """Admit queue-head requests while slots + pages allow.

        Static admission (the gang baseline) only admits into an *empty*
        engine; continuous admission fills any free slot any tick.
        """
        if self.admission == "static" and self.active:
            return []
        admitted = []
        while self.queue and self.free_slots:
            req = self.queue[0]
            need = self.pool.pages_for(self.reserve_tokens(req))
            if need > self.pool.available:
                break  # head-of-line blocks: FIFO stays FIFO
            self.queue.popleft()
            # reserve FIRST (slot + worst-case pages), then let the
            # admission controller decide — real admission control sheds
            # *after* reservation (the reservation is what it is pricing),
            # so a shed on this path must hand back every reserved
            # resource or the pool leaks one request's pages per shed
            slot = self.free_slots.pop(0)
            pages = self.pool.alloc(need, req.rid)
            try:
                fault_point("serve.admit", rid=req.rid)
            except InjectedFault:
                self.pool.free(req.rid)  # shed-after-reservation: return
                self.free_slots.append(slot)  # the pages AND the slot
                self.free_slots.sort()
                self.dropped.append(req)  # shed, never crash the engine
                if self.ledger is not None:
                    self.ledger.shed(req.rid)  # terminal phase, closed
                continue
            st = RequestState(req, slot, pages, admitted_s=now)
            self.active[slot] = st
            self._admit_order.append(slot)
            admitted.append(st)
            if self.ledger is not None:
                self.ledger.note_admit(req.rid, slot=slot)
        return admitted

    # -- per-tick picks ----------------------------------------------------

    def next_prefill(self) -> RequestState | None:
        """Oldest admitted request still prefilling (chunked, one per
        tick: prefill interleaves with decode instead of stalling it)."""
        for slot in self._admit_order:
            st = self.active.get(slot)
            if st is not None and st.state == PREFILL:
                return st
        return None

    def prefill_chunk_for(self, st: RequestState) -> tuple[int, int, int]:
        """(start, size, bucket) of the request's next prompt chunk."""
        size = min(self.prefill_chunk, st.req.prompt_len - st.prefilled)
        return st.prefilled, size, bucket_for(size, self.prefill_buckets)

    def decoding(self) -> list[RequestState]:
        return [
            st for st in self.active.values() if st.state == DECODE
        ]

    # -- retirement --------------------------------------------------------

    def retire(self, st: RequestState, now: float = 0.0,
               state: str = DONE) -> list[int]:
        """Free the request's slot + pages; returns the freed page ids.

        Every terminal path funnels through here — DONE and DROPPED
        both free the slot and the pool reservation, so the
        pool invariant (owned + free == capacity, and ``pages_free``
        back to initial once the engine is idle) holds by construction.
        """
        st.state = state
        st.done_s = now
        del self.active[st.slot]
        self._admit_order.remove(st.slot)
        freed = self.pool.free(st.rid)
        self.free_slots.append(st.slot)
        self.free_slots.sort()
        if state == DONE:
            self.done.append(st)
        else:
            self.dropped.append(st.req)
        return freed

    # -- accounting --------------------------------------------------------

    def occupancy(self) -> dict:
        """Slot/page occupancy; the invariants the tests pin sum exactly."""
        self.pool.check_invariants()
        return {
            "slots_active": len(self.active),
            "slots_free": len(self.free_slots),
            "slots_total": self.n_slots,
            "pages_in_use": self.pool.in_use,
            "pages_free": self.pool.available,
            "pages_capacity": self.pool.capacity,
            "decoding": sum(
                1 for s in self.active.values() if s.state == DECODE
            ),
            "prefilling": sum(
                1 for s in self.active.values() if s.state == PREFILL
            ),
            "queued": len(self.queue),
        }

    @property
    def idle(self) -> bool:
        return not self.active and not self.queue
