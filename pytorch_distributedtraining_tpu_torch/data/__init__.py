"""Data layer: datasets, paired augmentation, the distributed sampler, the
device loader and its prefetcher."""

from .dataset import (CustomDataset, Dataset, PatchStore, Subset, SyntheticSRDataset,
                      random_split)
from .loader import DataLoader, stack_windows
from .prefetch import DevicePrefetcher
from .sampler import DistributedSampler
from .transforms import PairedRandomAug

__all__ = [
    "CustomDataset", "DataLoader", "Dataset", "DevicePrefetcher", "DistributedSampler",
    "PairedRandomAug", "PatchStore", "Subset", "SyntheticSRDataset", "random_split",
    "stack_windows",
]
