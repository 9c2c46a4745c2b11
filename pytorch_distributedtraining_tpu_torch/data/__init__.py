"""Data layer: datasets, the distributed sampler and the device loader."""

from .dataset import CustomDataset, Dataset, Subset, SyntheticSRDataset, random_split
from .loader import DataLoader
from .sampler import DistributedSampler

__all__ = [
    "CustomDataset", "DataLoader", "Dataset", "DistributedSampler", "Subset",
    "SyntheticSRDataset", "random_split",
]
