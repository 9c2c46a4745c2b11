"""Host-side page allocator for the paged KV cache.

Counterpart of ``pytorch_distributedtraining_tpu/serve/kv_cache.py``. The
device-side layout and its primitives (scatter-write, gathered attention,
the null page, the write-before-read invariant) live in
``models/generate.py``; this module owns what the host must know: which
physical pages are free, who holds which, and the occupancy accounting.

- **Page 0 is the null page**, never allocated. Unassigned page-table
  entries are 0, so an idle slot's decode writes land in trash.
- Allocation is LIFO over a free stack: a retired request's pages are the
  next ones handed out, which keeps reuse deterministic.
- Torch-free: admission decisions are host-side and cheap.

Quantized page residency (``kv_wire``) waits for the quantized-KV slice:
:func:`kv_wire_format` and :func:`kv_bytes_per_slot` raise for any format
but dense.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..models.generate import QUANTIZED_KV


def kv_wire_format(spec):
    """Resolve a KV wire spelling: None (dense pages) is the only one the
    port has."""
    if spec is None:
        return None
    raise NotImplementedError(QUANTIZED_KV.format(f"kv_wire={spec!r}"))


def kv_bytes_per_slot(
    fmt,
    *,
    n_layer: int,
    n_head: int,
    head_dim: int,
    page_size: int,
    max_pages_per_slot: int,
    dense_bytes_per_elem: int = 2,
) -> int:
    """Device bytes one slot's full page reservation pins: K and V across
    all layers, ``dense_bytes_per_elem`` per element (2 for bf16, 4 for
    f32). ``fmt`` must be None (dense)."""
    kv_wire_format(fmt)
    elems = max_pages_per_slot * page_size * n_head * head_dim
    return n_layer * 2 * elems * dense_bytes_per_elem


@dataclass
class PagePool:
    """Free-list over ``num_pages`` physical KV pages (page 0 reserved).

    ``num_pages`` counts the null page, matching the device buffer's
    leading dimension; ``capacity`` (allocatable pages) is therefore
    ``num_pages - 1``.
    """

    num_pages: int
    page_size: int
    _free: list[int] = field(default_factory=list)
    _owned: dict[int, list[int]] = field(default_factory=dict)

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (null + 1 allocatable), got "
                f"{self.num_pages}"
            )
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        # LIFO stack, top = lowest id first so allocation order is stable
        self._free = list(range(self.num_pages - 1, 0, -1))

    # -- accounting --------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is not capacity)."""
        return self.num_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages a sequence of ``n_tokens`` needs."""
        return -(-max(1, n_tokens) // self.page_size)

    def holder_pages(self, owner) -> list[int]:
        return list(self._owned.get(owner, ()))

    # -- alloc/free --------------------------------------------------------

    def alloc(self, n: int, owner) -> list[int] | None:
        """Pop ``n`` pages for ``owner``; None when the pool can't cover it
        (the caller decides whether that blocks admission)."""
        if n < 1:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(got)
        return got

    def free(self, owner) -> list[int]:
        """Return all of ``owner``'s pages to the pool (LIFO: they are the
        next pages handed out). Returns the freed page ids."""
        pages = self._owned.pop(owner, [])
        # reversed: re-push so the earliest-allocated page is on top,
        # keeping alloc ids stable under churn
        self._free.extend(reversed(pages))
        return pages

    def check_invariants(self) -> None:
        """Occupancy must sum to capacity; page 0 must never be owned.
        Raises ``RuntimeError`` (not an assert, so it holds under -O)."""
        owned = [p for ps in self._owned.values() for p in ps]
        if 0 in owned:
            raise RuntimeError("null page was allocated")
        if 0 in self._free:
            raise RuntimeError("null page is on the free list")
        if len(owned) + len(self._free) != self.capacity:
            raise RuntimeError(
                f"pages leaked: {len(owned)} owned + {len(self._free)} free "
                f"!= {self.capacity} capacity"
            )
        if len(set(owned)) != len(owned):
            raise RuntimeError("page double-allocated")
