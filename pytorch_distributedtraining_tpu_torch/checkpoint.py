"""Checkpoints over ``torch.save``: the facade's name-stamped save and the
strict, optionally ``'params'``-nested state-dict load.

Counterpart of ``pytorch_distributedtraining_tpu/checkpoint.py``
(``save_checkpoint`` and ``load_params_dict``, ``checkpoint.py:127-186``).
State dicts are the native format here, so a file holds
``{"params": model.state_dict(), ...}`` and loads back with torch's own
``load_state_dict`` after the same strict key and shape checks. The
facade's ``save`` writes ``TrainState.state_dict()`` (params, the
gathered optimizer state, meta) through :func:`save_checkpoint` and its
``load`` reads it back through :func:`load_file`; the sharded and
portable formats live in ``checkpoint_sharded``.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch


class IncompatibleKeys(NamedTuple):
    missing_keys: list
    unexpected_keys: list


def save_checkpoint(path: str, name: str, trees: dict[str, Any]) -> tuple[str, str]:
    """Write one checkpoint ``{path}/{name}.pt``; returns ``(full_path, tag)``."""
    os.makedirs(path, exist_ok=True)
    tag = f"{name}.pt"
    full = os.path.join(path, tag)
    tmp = f"{full}.tmp"
    torch.save(trees, tmp)
    os.replace(tmp, full)  # a reader never sees half a file
    return full, tag


def load_file(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params_dict(source: dict, template: dict, strict: bool = True,
                     param_key: str = "params") -> tuple[dict, IncompatibleKeys]:
    """Pick the state dict out of ``source`` (nested under ``param_key`` or
    not) and check it against ``template``: with ``strict``, missing or
    unexpected keys raise; shapes must match either way. Returns the
    matching entries and the keys that did not line up."""
    src = source[param_key] if param_key in source else source
    missing = sorted(set(template) - set(src))
    unexpected = sorted(set(src) - set(template))
    if strict and (missing or unexpected):
        raise ValueError(
            f"strict load failed - missing: {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}, unexpected: {unexpected[:5]}"
            f"{'...' if len(unexpected) > 5 else ''}"
        )
    out = {}
    for k, v in src.items():
        if k not in template:
            continue
        if tuple(v.shape) != tuple(template[k].shape):
            raise ValueError(
                f"shape mismatch for {k}: checkpoint {tuple(v.shape)} vs model "
                f"{tuple(template[k].shape)}"
            )
        out[k] = v
    return out, IncompatibleKeys(missing, unexpected)
