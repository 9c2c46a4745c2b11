"""DataLoader: batches of NHWC float tensors on the training device.

Counterpart of ``pytorch_distributedtraining_tpu/data/loader.py``. Index
order is the JAX loader's: the sampler's order (dataset order without a
sampler) is snapshotted per epoch and cut into batches, and the loader
bumps the epoch after each snapshot. Batches go to the GPU unless the
caller passes ``device="cpu"``; without a CUDA device the default raises.
Fetching runs on ``torch.utils.data`` worker processes (``num_workers``,
``persistent_workers``, ``multiprocessing_context``); samples are collated
by ``np.stack`` (the JAX loader's ``csrc.fast_stack`` took longer at the SR
paths' batches: ``benchmarks/collate.py``), land in pinned host memory
and reach the device by non-blocking copies, or, with ``device_prefetch``
(``device_iter``), through a :class:`~.prefetch.DevicePrefetcher` that
copies that many batches ahead on a side stream.

The epoch reaches an epoch-aware dataset transform (one with
``set_epoch``, as ``transforms.PairedRandomAug``), as in the JAX loader:
each index goes to the fetch together with the epoch of its snapshot, and
the dataset's transform is set to that epoch before the sample is read.
So a worker process, which holds its own copy of the dataset (pickled
once, and kept across epochs with ``persistent_workers``), draws each
epoch's augmentation, not epoch 0's again.

With telemetry on (``observe.trace``), the consumer's time blocked on each
batch is an ``input`` span (``input.fetch`` without workers,
``input.wait`` with them; through the prefetcher, that span of the host
batch and the prefetcher's ``input.wait``, as JAX's loader records them),
which the goodput ledger bills as ``input_wait``.

:func:`stack_windows` groups batches into ``[k, B, ...]`` stacks, the feed
of ``parallel.MultiStep`` (JAX's ``stack_windows``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.utils.data

from ..observe import trace as telemetry
from ..runtime.dist import resolve_device
from .prefetch import DevicePrefetcher
from .sampler import DistributedSampler


class _EpochBatches:
    """Batch sampler that replays the batches the loader snapshotted, each
    index paired with the snapshot's epoch."""

    def __init__(self):
        self.batches: list[list[tuple[int, int]]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def stack_windows(batches, k: int):
    """Group an iterable of batches (a tensor or array, or a tuple of them)
    into ``[k, B, ...]`` stacks, one for each ``k`` consecutive batches; a
    trailing partial window is dropped (``MultiStep`` runs a fixed K).
    Device tensors stack on their device (``torch.stack``), numpy arrays
    with ``np.stack``::

        multi = MultiStep(step, k=8)
        for stacked in stack_windows(loader, 8):
            metrics = multi(stacked)
    """
    if k < 1:  # checked now, not at the generator's first step
        raise ValueError(f"k must be >= 1, got {k}")

    def stack(xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)

    def gen():
        window = []
        for b in batches:
            window.append(b)
            if len(window) == k:
                if isinstance(window[0], (tuple, list)):
                    yield type(window[0])(stack(list(xs)) for xs in zip(*window))
                else:
                    yield stack(window)
                window = []

    return gen()


def _epoch_transform(dataset):
    tf = getattr(dataset, "transform", None)
    return tf if tf is not None and hasattr(tf, "set_epoch") else None


class _EpochDataset(torch.utils.data.Dataset):
    """Fetches ``(epoch, idx)``: sets an epoch-aware transform of the
    dataset to ``epoch``, then reads ``dataset[idx]``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, idx = key
        tf = _epoch_transform(self.dataset)
        if tf is not None:
            tf.set_epoch(epoch)
        return self.dataset[idx]


def _collate(samples):
    return tuple(torch.from_numpy(np.stack(field)) for field in zip(*samples))


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1,
                 sampler: DistributedSampler | None = None, num_workers: int = 0,
                 drop_last: bool = False, device: str | torch.device = "cuda",
                 persistent_workers: bool = False, multiprocessing_context=None,
                 device_prefetch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self.device_prefetch = max(0, int(device_prefetch))
        self._epoch = 0
        self._batches = _EpochBatches()
        workers = num_workers > 0
        self._loader = torch.utils.data.DataLoader(
            _EpochDataset(dataset),
            batch_sampler=self._batches,
            num_workers=num_workers,
            collate_fn=_collate,
            pin_memory=self.device.type == "cuda",
            persistent_workers=persistent_workers and workers,
            multiprocessing_context=multiprocessing_context if workers else None,
        )

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def epoch(self) -> int:
        """The epoch the next iteration snapshots."""
        return self._epoch

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch: the sampler's shuffle and the transform's draws."""
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)
        tf = _epoch_transform(self.dataset)
        if tf is not None:
            tf.set_epoch(epoch)

    def _index_batches(self) -> list[list[int]]:
        if self.sampler is not None:
            order = list(self.sampler)
        else:
            order = list(range(len(self.dataset)))
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _host_batches(self):
        """Snapshot this epoch's batches, bump the epoch, and iterate the
        collated (pinned, on a CUDA run) host batches."""
        epoch = self._epoch
        self._batches.batches = [[(epoch, i) for i in b] for b in self._index_batches()]
        self._epoch += 1
        if self.sampler is not None:
            self.sampler.set_epoch(self._epoch)
        return iter(self._loader)

    def __iter__(self):
        if self.device_prefetch > 0:
            return self.device_iter(depth=self.device_prefetch)
        return self._plain_iter()

    def _timed(self, batches):
        # the time blocked on the next host batch is the goodput ledger's
        # input_wait: a synchronous fetch and collate without workers
        # ("input.fetch"), the wait for a worker's batch with them; JAX's
        # loader records it with or without the device prefetcher after it
        name = "input.wait" if self._loader.num_workers > 0 else "input.fetch"
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            if telemetry.enabled():
                telemetry.add_span(name, "input", t0, time.perf_counter() - t0)
            yield batch

    def _plain_iter(self):
        for batch in self._timed(self._host_batches()):
            yield tuple(t.to(self.device, non_blocking=True) for t in batch)

    def device_iter(self, depth: int = 2, probe=None) -> DevicePrefetcher:
        """This epoch's batches through a :class:`~.prefetch.DevicePrefetcher`
        that keeps ``depth`` of them copied (or copying) to the device ahead
        of the consumer; ``probe`` (an ``observe.profiling.
        TransferOverlapProbe``) receives its waits."""
        return DevicePrefetcher(self._timed(self._host_batches()), self.device, depth=depth,
                                probe=probe)

    def shutdown_workers(self) -> None:
        """Stop persistent worker processes now rather than at exit."""
        it = self._loader._iterator
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
        self._loader._iterator = None
