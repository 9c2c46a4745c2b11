"""Named activation-rematerialisation policies.

Counterpart of ``pytorch_distributedtraining_tpu/parallel/remat.py``: the
same names, resolved by :func:`resolve_remat` with the same errors, mapped
onto ``torch.utils.checkpoint`` by :func:`apply_remat`:

``none``
    No checkpointing.
``full``
    ``checkpoint(fn, use_reentrant=False)``: backward recomputes the whole
    forward, every kernel of it included (the forward kernels run twice).
``dots``
    Selective checkpointing that saves the outputs of matrix products
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and recomputes the rest, JAX's
    ``checkpoint_dots``.
``offload``
    ``torch.autograd.graph.save_on_cpu``: every saved activation goes to
    pinned host memory and comes back for backward. JAX offloads only the
    ``checkpoint_name``-tagged set; torch has no tags, so this offloads all.
``names``
    JAX saves the activations its models tag with ``checkpoint_name``;
    torch has no such tags, so it raises until the named-activation
    checkpointing slice brings them.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

CHECKPOINT_SAVED_NAMES = ("attn_out",)
REMAT_POLICIES = ("none", "full", "dots", "names", "offload")
NAMES_UNSUPPORTED = (
    "remat='names' saves the activations the JAX models tag with checkpoint_name; "
    "torch has no such tags, and they wait for the named-activation checkpointing "
    "slice: use 'full', 'dots' or 'offload'")


def resolve_remat(remat: bool | str | None) -> str:
    """Canonicalize a remat spec (bool | str | None) to a policy name."""
    if remat is None or remat is False:
        return "none"
    if remat is True:
        return "full"
    name = str(remat).strip().lower()
    if name in ("", "0", "false", "off"):
        return "none"
    if name in ("1", "true", "on"):
        return "full"
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat!r}; valid: "
            + ", ".join(REMAT_POLICIES)
            + " (or a bool)"
        )
    return name


def _matmul_ops() -> set:
    aten = torch.ops.aten
    return {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _matmul_ops():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn: Callable, remat: bool | str | None) -> Callable:
    """``fn`` under the named policy; ``none`` returns it unwrapped."""
    name = resolve_remat(remat)
    if name == "none":
        return fn
    if name == "names":
        raise NotImplementedError(NAMES_UNSUPPORTED)
    from torch.utils.checkpoint import checkpoint

    if name == "full":
        @functools.wraps(fn)
        def full(*args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return full
    if name == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)

        @functools.wraps(fn)
        def dots(*args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)
        return dots

    @functools.wraps(fn)
    def offload(*args, **kwargs):  # name == "offload"
        with torch.autograd.graph.save_on_cpu(pin_memory=torch.cuda.is_available()):
            return fn(*args, **kwargs)
    return offload
