"""DistributedSampler: deterministic per-process index sharding.

Counterpart of ``pytorch_distributedtraining_tpu/data/sampler.py``, with the
same seeded permutation (numpy ``default_rng(seed + epoch)``), so batch
order matches the JAX run: strided shard ``rank::num_replicas``, pad by
wrapping or drop to equal per-rank length, and ``set_epoch`` for a fresh
shuffle each epoch (the port's loader calls it). Replicas default to the
process's ``WORLD_SIZE``/``RANK``.
"""

from __future__ import annotations

import math

import numpy as np

from ..runtime import dist


class DistributedSampler:
    def __init__(self, dataset, num_replicas: int | None = None, rank: int | None = None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        num_replicas = dist.world_size() if num_replicas is None else num_replicas
        rank = dist.rank() if rank is None else rank
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        if drop_last and n % num_replicas:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            indices = np.arange(n)
        if self.drop_last:
            indices = indices[: self.total_size]
        else:  # pad by wrapping (repeatedly, for num_replicas >> n)
            pad = self.total_size - n
            if pad > 0:
                reps = -(-pad // n)
                indices = np.concatenate([indices] + [indices] * reps)[: self.total_size]
        shard = indices[self.rank :: self.num_replicas]
        if len(shard) != self.num_samples:
            raise RuntimeError(f"shard has {len(shard)} indices, expected {self.num_samples}")
        return iter(shard.tolist())
