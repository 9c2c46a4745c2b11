"""Device memory accounting: the budget, the high-water, and a batch-size
search against the budget.

Counterpart of ``pytorch_distributedtraining_tpu/observe/memory.py``. JAX
reads XLA's memory plan of a compiled step ahead of time
(``compiled_memory_stats``). Eager torch has no such program, so the
port's :class:`MemoryStats` comes from a measured run instead:
``parallel.TrainStep.memory_analysis(batch)`` runs one forward and
backward at that batch and reads the caching allocator's peak (see its
docstring). The fields and ``peak_bytes`` are JAX's:

- :func:`device_hbm_budget`: the card's memory (the total of
  ``torch.cuda.mem_get_info``, the CUDA context's reserve included, as
  ``bytes_limit`` is the TPU's whole HBM); without a card the
  host's physical memory (:func:`host_memory_budget`), JAX's CPU stand-in,
  unless ``fallback=None`` asks for the strict None;
- :func:`record_hbm_stats`: :data:`runtime_stats` refreshed from
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.peak`` and
  ``.current``), for the crash flight record (``observe/trace.py`` reads
  the dict through ``sys.modules``);
- :func:`tune_batch_size`: JAX's search, unchanged: the largest batch
  whose peak fits ``safety`` of the budget, doubling from ``start`` and
  then bisecting; ``start`` as it is when the probe answers None (no
  analysis, as on the CPU), and :class:`NoMemoryBudget` without a budget.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Callable


@dataclass(frozen=True)
class MemoryStats:
    """Per-device memory of one step (bytes): ``argument_bytes`` what was
    resident before it (parameters, optimizer state, the batch),
    ``temp_bytes`` the rise to the allocator's peak during it; the output
    and alias terms stay 0 (an eager step updates in place)."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    generated_code_bytes: int

    @property
    def peak_bytes(self) -> int:
        """Live-at-once bytes: arguments + outputs + scratch, minus
        buffers counted on both sides of an alias."""
        return max(0, self.argument_bytes + self.output_bytes + self.temp_bytes
                   - self.alias_bytes)

    def as_dict(self) -> dict:
        d = asdict(self)
        d["peak_bytes"] = self.peak_bytes
        return d


# the crash flight record's memory block (read through sys.modules)
runtime_stats: dict = {
    "hbm_budget_bytes": None,      # the card's memory (or the host fallback)
    "hbm_high_water_bytes": None,  # allocator peak (allocated_bytes.all.peak)
    "hbm_in_use_bytes": None,      # allocator current (allocated_bytes.all.current)
    "projected_peak_bytes": None,  # the last measured step peak
    "budget_source": None,         # "device" | "host-fallback"
}

_HOST_FALLBACK = "host"


def host_memory_budget() -> int | None:
    """Total physical host memory in bytes (``sysconf``), or None where the
    platform does not report it: the stand-in for a device limit without
    a card."""
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        pages = os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None
    if page <= 0 or pages <= 0:
        return None
    return int(page) * int(pages)


def _cuda_device(device):
    """``device`` as a CUDA ``torch.device``, or None without a card (or
    for a CPU device)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    device = torch.device("cuda" if device is None else device)
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


def device_hbm_budget(device=None, *, fallback=_HOST_FALLBACK) -> int | None:
    """The card's memory in bytes. Without a card, the host's physical
    memory by default (:func:`host_memory_budget`); ``fallback=None`` gives
    None there (what :func:`tune_batch_size` uses, so it never guesses), an
    int gives that stand-in."""
    import torch

    if fallback is _HOST_FALLBACK:
        fallback = host_memory_budget()
    dev = _cuda_device(device)
    if dev is None:
        runtime_stats["hbm_budget_bytes"] = fallback
        runtime_stats["budget_source"] = "host-fallback" if fallback is not None else None
        return fallback
    limit = int(torch.cuda.mem_get_info(dev)[1])
    runtime_stats["hbm_budget_bytes"] = limit
    runtime_stats["budget_source"] = "device"
    return limit


def record_hbm_stats(device=None, projected_peak_bytes: int | None = None) -> dict:
    """Refresh :data:`runtime_stats` from the allocator's statistics (the
    peak and current allocated bytes) and return a copy; never raises."""
    try:
        import torch

        device_hbm_budget(device)
        dev = _cuda_device(device)
        if dev is not None:
            stats = torch.cuda.memory_stats(dev)
            peak = stats.get("allocated_bytes.all.peak")
            used = stats.get("allocated_bytes.all.current")
            if peak is not None:
                runtime_stats["hbm_high_water_bytes"] = int(peak)
            if used is not None:
                runtime_stats["hbm_in_use_bytes"] = int(used)
    except Exception:  # noqa: BLE001 -- accounting must not kill a run
        pass
    if projected_peak_bytes is not None:
        runtime_stats["projected_peak_bytes"] = int(projected_peak_bytes)
    return dict(runtime_stats)


class NoMemoryBudget(ValueError):
    """Strict refusal: no device memory budget and none was passed."""


def tune_batch_size(
    peak_bytes_fn: Callable[[int], int | None],
    *,
    budget_bytes: int | None = None,
    start: int = 1,
    max_batch: int = 4096,
    safety: float = 0.9,
    cache: dict | None = None,
) -> int:
    """Largest per-device batch whose peak fits the budget.

    ``peak_bytes_fn(batch)`` returns the step's peak for that batch (e.g.
    ``TrainStep.memory_analysis(batch).peak_bytes``) or None when no
    analysis is available; then ``start`` is returned unchanged. Doubles
    from ``start`` while fitting, then bisects between the last fit and the
    first overflow. ``cache`` (batch -> peak bytes) memoizes the probes,
    within this call or across calls sharing the dict.
    """
    if budget_bytes is None:
        budget_bytes = device_hbm_budget(fallback=None)
    if budget_bytes is None:
        raise NoMemoryBudget(
            "no device memory budget: pass budget_bytes= explicitly "
            "(no CUDA device reports its memory here)"
        )
    limit = budget_bytes * safety
    probed = cache if cache is not None else {}

    def fits(b: int) -> bool | None:
        if b in probed:
            peak = probed[b]
        else:
            peak = peak_bytes_fn(b)
            probed[b] = peak
        return None if peak is None else peak <= limit

    first = fits(start)
    if first is None:
        return start
    if not first:
        raise ValueError(
            f"batch={start} already exceeds the budget "
            f"({budget_bytes} B x safety {safety})"
        )
    lo = start
    hi = None
    b = start * 2
    while b <= max_batch:
        ok = fits(b)
        if ok is None:
            return lo
        if ok:
            lo = b
            b *= 2
        else:
            hi = b
            break
    if hi is None:
        return lo  # everything up to max_batch fits
    while hi - lo > 1:
        mid = (lo + hi) // 2
        ok = fits(mid)
        if ok is None:
            return lo
        if ok:
            lo = mid
        else:
            hi = mid
    return lo
