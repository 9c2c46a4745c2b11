"""DataLoader: batches of NHWC float tensors on the training device.

Counterpart of ``pytorch_distributedtraining_tpu/data/loader.py``. Index
order is the JAX loader's: the sampler's order (dataset order without a
sampler) is snapshotted per epoch and cut into batches, and the loader
bumps the sampler's epoch after each snapshot. Batches go to the GPU
unless the caller passes ``device="cpu"``; without a CUDA device the
default raises. Fetching runs on ``torch.utils.data`` worker processes
(``num_workers``, ``persistent_workers``, ``multiprocessing_context``);
batches land in pinned host memory and reach the device by non-blocking
copies.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.data

from ..runtime.dist import resolve_device
from .sampler import DistributedSampler


class _EpochBatches:
    """Batch sampler that replays the batches the loader snapshotted."""

    def __init__(self):
        self.batches: list[list[int]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _collate(samples):
    return tuple(torch.from_numpy(np.stack(field)) for field in zip(*samples))


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1,
                 sampler: DistributedSampler | None = None, num_workers: int = 0,
                 drop_last: bool = False, device: str | torch.device = "cuda",
                 persistent_workers: bool = False, multiprocessing_context=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self._epoch = 0
        self._batches = _EpochBatches()
        workers = num_workers > 0
        self._loader = torch.utils.data.DataLoader(
            dataset,
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

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _index_batches(self) -> list[list[int]]:
        if self.sampler is not None:
            order = list(self.sampler)
        else:
            order = list(range(len(self.dataset)))
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        self._batches.batches = self._index_batches()
        self.set_epoch(self._epoch + 1)
        for batch in self._loader:
            yield tuple(t.to(self.device, non_blocking=True) for t in batch)

    def shutdown_workers(self) -> None:
        """Stop persistent worker processes now rather than at exit."""
        it = self._loader._iterator
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
        self._loader._iterator = None
