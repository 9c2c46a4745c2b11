"""Device prefetch: copy batches to the GPU ahead of the step that uses them.

Counterpart of ``pytorch_distributedtraining_tpu/data/prefetch.py``. The
loader's plain path copies each batch on the compute stream when the step
asks for it, so the copy waits behind the step before it and the step
behind the copy. :class:`DevicePrefetcher` keeps up to ``depth`` batches in
flight instead: each pinned host batch is copied on a side CUDA stream
(``non_blocking``, so the host does not wait either) with an event
recorded after its copies. When the consumer takes a batch, its stream
waits on that batch's event, and ``record_stream`` marks the batch's
tensors as used there, so the caching allocator does not hand their memory
to a later copy while the step still reads them. The next batch's copy is
issued before the taken one is returned.

``staged``, ``yielded``, ``wait_s`` and :meth:`overlap_fraction` keep the
JAX prefetcher's accounting: ``wait_s`` is the consumer's time blocked in
``next`` (the host's fetch and the issue of the copies; not the copies
themselves, which the consumer's stream waits for on the device). On
``device="cpu"`` the prefetcher passes the host batches through unchanged.
"""

from __future__ import annotations

import collections
import time

import torch

__all__ = ["DevicePrefetcher"]


class DevicePrefetcher:
    """Iterator staging up to ``depth`` batches (tuples of host tensors) on
    ``device`` ahead of the consumer."""

    def __init__(self, source, device, depth: int = 2):
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self.wait_s = 0.0
        self.yielded = 0
        self.staged = 0
        self._source = iter(source)
        self._queue: collections.deque = collections.deque()
        self._done = False
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _stage(self) -> None:
        """Pull one host batch and issue its copies (or, on the CPU, hold it)."""
        try:
            batch = next(self._source)
        except StopIteration:
            self._done = True
            return
        if self._stream is None:
            self._queue.append((tuple(batch), None))
        else:
            with torch.cuda.stream(self._stream):
                moved = tuple(t.to(self.device, non_blocking=True) for t in batch)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._queue.append((moved, event))
        self.staged += 1

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        while not self._done and len(self._queue) < self.depth:
            self._stage()
        if not self._queue:
            raise StopIteration
        batch, event = self._queue.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch:
                t.record_stream(consumer)
        if not self._done:
            self._stage()  # keep `depth` batches in flight while this one is used
        self.wait_s += time.perf_counter() - t0
        self.yielded += 1
        return batch

    def overlap_fraction(self, elapsed_s: float) -> float | None:
        """Share of a timed consumer window not spent blocked in ``next``:
        1.0 when the input pipeline hid entirely behind the steps. None
        before any batch."""
        if elapsed_s <= 0 or self.yielded == 0:
            return None
        return max(0.0, min(1.0, 1.0 - self.wait_s / elapsed_s))

    def close(self) -> None:
        """Drop the staged batches and stop pulling from the source
        (idempotent)."""
        self._done = True
        self._queue.clear()
