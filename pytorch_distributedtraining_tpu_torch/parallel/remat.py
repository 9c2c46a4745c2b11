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
``names``
    Selective checkpointing that saves exactly the activations the models
    tag with :func:`checkpoint_name` under a name in
    :data:`CHECKPOINT_SAVED_NAMES` (JAX's ``save_only_these_names``) and
    recomputes the rest. A model with no tag (ESPCN) gets ``full``'s
    recompute, as in JAX.
``offload``
    The same tagged set, kept in pinned host memory from the forward to
    the recompute (JAX's ``save_and_offload_only_these_names`` to
    ``pinned_host``), the rest recomputed. On the CPU it is ``names``.

The tag is a ``torch.library`` custom op, an identity the autograd graph
and the dispatcher see, so a selective-checkpointing policy can name it.
Custom ops may not return an alias of an input, so a tag copies its input
(one ``[B, T, D]`` copy a tagged site); outside a ``names`` or ``offload``
region :func:`checkpoint_name` returns its input untouched and costs
nothing. The hand kernels are not dispatcher ops: a recompute runs the
window and flash kernels of a block again (K1 under ``names`` and
``offload`` as under ``full``), and the tagged output is served from the
saved copy.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the tags the models set (JAX's CHECKPOINT_SAVED_NAMES): the softmax·V
# product of each attention, the expensive part of a block to recompute
CHECKPOINT_SAVED_NAMES = ("attn_out",)
REMAT_POLICIES = ("none", "full", "dots", "names", "offload")


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


@torch.library.custom_op("graft_torch::checkpoint_name", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_tag.register_fake
def _(x, name):
    return torch.empty_like(x)


def _tag_setup(ctx, inputs, output):
    pass


def _tag_backward(ctx, grad):
    return grad, None


_tag.register_autograd(_tag_backward, setup_context=_tag_setup)
TAG_OP = torch.ops.graft_torch.checkpoint_name.default

_regions = threading.local()  # how many names/offload regions are open on this thread


def _tagging() -> bool:
    return getattr(_regions, "depth", 0) > 0


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` as the activation ``name`` (JAX's ``checkpoint_name``):
    inside a ``names`` or ``offload`` region an identity op the policy
    saves; elsewhere ``x`` itself."""
    if not _tagging():
        return x
    return _tag(x, name)


def _saved_tag(op, args) -> bool:
    return op is TAG_OP and args[1] in CHECKPOINT_SAVED_NAMES


def _matmul_ops() -> set:
    aten = torch.ops.aten
    return {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _matmul_ops():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_names(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if _saved_tag(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Keep(TorchDispatchMode):
    """``offload``'s forward context: each saved tag's output is kept as a
    pinned host copy, copied on the current stream (so the device tensor's
    memory is reused only after the copy); on the CPU the output itself."""

    def __init__(self, saved: list):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _saved_tag(func, args):
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                self.saved.append((host, out.device))
            else:
                self.saved.append((out.detach(), None))
        return out


class _Serve(TorchDispatchMode):
    """``offload``'s recompute context: the saved tags, in order, copied
    back to the device in place of the tag ops; every other op runs."""

    def __init__(self, saved: list):
        super().__init__()
        self.saved = saved
        self.i = 0

    def __enter__(self):
        self.i = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _saved_tag(func, args):
            host, device = self.saved[self.i]
            self.i += 1
            return host.detach() if device is None else host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


class _Region:
    """``ctx`` inside a tagging region (re-entrant: a second backward
    enters the recompute's context again)."""

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        _regions.depth = getattr(_regions, "depth", 0) + 1
        return self.ctx.__enter__()

    def __exit__(self, *exc):
        _regions.depth -= 1
        return self.ctx.__exit__(*exc)


def _names_contexts(offload: bool):
    """``checkpoint``'s ``context_fn`` for ``names`` (selective
    checkpointing whose policy saves the tags) and ``offload`` (the tags
    kept on the host); both open a tagging region."""
    if offload:
        saved: list = []
        fwd, rec = _Keep(saved), _Serve(saved)
    else:
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        fwd, rec = create_selective_checkpoint_contexts(_save_names)
    return _Region(fwd), _Region(rec)


def apply_remat(fn: Callable, remat: bool | str | None) -> Callable:
    """``fn`` under the named policy; ``none`` returns it unwrapped."""
    name = resolve_remat(remat)
    if name == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    if name == "full":
        @functools.wraps(fn)
        def full(*args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return full
    if name == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    else:
        context_fn = functools.partial(_names_contexts, name == "offload")

    @functools.wraps(fn)
    def selective(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)
    return selective
