"""Device resolution and rank/world-size reads for one process.

Counterpart of ``pytorch_distributedtraining_tpu/runtime/dist.py`` for this
slice, which trains on one GPU: the rank and world size come from the
launcher's ``RANK``/``WORLD_SIZE`` (``torch.distributed``'s env contract),
defaulting to a world of one. Process groups, several GPUs and the
launcher are a later slice.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a run asked for. ``"cuda"`` without a CUDA device raises:
    the port never quietly trains on the CPU; pass ``"cpu"`` to ask for it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw in (None, "", "None"):
        return default
    return int(raw)


def world_size() -> int:
    return _env_int("WORLD_SIZE", 1)


def rank() -> int:
    return _env_int("RANK", 0)

