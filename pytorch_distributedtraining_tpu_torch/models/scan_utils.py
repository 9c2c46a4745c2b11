"""Scan-layout converters for SwinIR parameter trees, in numpy.

Counterpart of ``stack_swinir_layer_params`` / ``unstack_swinir_layer_params``
(``pytorch_distributedtraining_tpu/models/swinir.py``) and the
``stack_trees`` / ``unstack_tree`` they use (``models/scan_utils.py``
there). A JAX SwinIR built with ``scan_layers=True`` keeps each residual
block's layers as one stacked pair: ``rstb_{i}/layers/a`` (the unshifted
layers ``layer_{2j}``) and ``rstb_{i}/layers/b`` (the shifted
``layer_{2j+1}``), each leaf with a leading axis of ``depth // 2``. These
functions convert between that layout and the per-layer one on nested
dicts of numpy arrays, so ``interop.swinir_state_dict_from_jax`` can load
either. The port's SwinIR itself runs the per-layer loop.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_trees(trees: Sequence[dict]) -> dict:
    """Stack identical-structure trees leaf-wise on a new leading axis."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    return _map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def unstack_tree(tree: dict, n: int) -> list[dict]:
    """Inverse of :func:`stack_trees`: split the leading axis into ``n`` trees."""
    return [_map(lambda x: np.asarray(x)[i], tree) for i in range(n)]


def stack_swinir_layer_params(params: dict, depths: Sequence[int]) -> dict:
    """Per-layer layout -> scan layout for every ``rstb_{i}`` subtree:
    ``layer_{2j}`` stacks under ``layers/a`` and ``layer_{2j+1}`` under
    ``layers/b``, leading axis ``depth // 2``. Returns a new dict."""
    out = dict(params)
    for i, depth in enumerate(depths):
        rstb = dict(out[f"rstb_{i}"])
        a = [rstb.pop(f"layer_{2 * j}") for j in range(depth // 2)]
        b = [rstb.pop(f"layer_{2 * j + 1}") for j in range(depth // 2)]
        rstb["layers"] = {"a": stack_trees(a), "b": stack_trees(b)}
        out[f"rstb_{i}"] = rstb
    return out


def unstack_swinir_layer_params(params: dict, depths: Sequence[int] | None = None) -> dict:
    """Scan layout -> per-layer layout (inverse of
    :func:`stack_swinir_layer_params`). ``depths`` defaults to twice the
    leading axis of each block's stacked pair; blocks already in the
    per-layer layout pass through. Returns a new dict."""
    out = dict(params)
    i = 0
    while f"rstb_{i}" in out:
        rstb = dict(out[f"rstb_{i}"])
        if "layers" in rstb:
            layers = rstb.pop("layers")
            n = len(_leaf(layers["a"])) if depths is None else depths[i] // 2
            for j, tree in enumerate(unstack_tree(layers["a"], n)):
                rstb[f"layer_{2 * j}"] = tree
            for j, tree in enumerate(unstack_tree(layers["b"], n)):
                rstb[f"layer_{2 * j + 1}"] = tree
        out[f"rstb_{i}"] = rstb
        i += 1
    return out


def _leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)
