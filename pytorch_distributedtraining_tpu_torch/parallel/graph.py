"""Train and eval steps as captured CUDA graphs: the runner under
``MultiStep``, ``Stoke.fused_step``, ``EvalStep`` and every program of the
Stoke facade (the deferred window's, the early reads' and the eval ones).

JAX answers a host-bound step with one compiled program per step (or per K
steps); on the card the matching answer is a ``torch.cuda.CUDAGraph`` of
the step's kernels, replayed by one launch. :class:`StepGraph` runs
``fn(inputs) -> outputs`` of an *owner* (:class:`GraphOwner`: a
``TrainStep``, an ``EvalStep``, or the facade, whose programs are JAX's
``eager_step``, ``_jit_acc_first``/``_jit_acc``, ``_jit_apply``,
``_jit_fwd`` and ``_jit_loss``) that way:

- the first call, and any call whose inputs change shape or dtype, copies
  the inputs into static buffers and captures. Before the capture ``fn``
  runs :data:`WARMUP` times on a side stream, between a snapshot of the
  owner's state and its restore: the warm-up builds the kernels, cuDNN's
  and cuBLAS's handles and every cache at first use (masks, plans, the
  probe's index vectors) without taking a step. Autocast's weight-cast
  cache is off through warm-up and capture (a cached cast would be freed
  while the graph still reads it);
- every call copies its inputs into the static buffers, writes the step's
  host values into its device scalars (``owner.prepare``: the lr factor,
  the step counter), binds each of ``owner.bound_grads()``'s ``.grad``
  back to the tensor the graph writes (a per-leaf optimizer drops grads
  between steps), replays, and returns a copy of the outputs, so one
  call's outputs do not change at the next replay.

The capture runs with Python's garbage collector held off, after one
collection: an unreachable graph that a collection freed inside a capture
would destroy its executable there, which CUDA refuses, and the capture
would be lost (seen on the card when ``tune_multi_step_k``'s arms, each
its own graph, followed earlier phases' graphs).

Every input and output of a kernel inside lies in the graph's static
buffers, its private memory pool or the owner's own tensors: the window
and flash kernels launch on the current stream with raw pointers, which a
replay reuses. Streams other than the capture's join it by PyTorch's own
waits: FSDP2's (ZeRO-3) fork from the current stream and are waited on
again within the step, and a ``DistributedDataParallel`` model's
AccumulateGrad nodes, which its reducer keeps, sit on the side stream
``parallel.state`` builds the wrapper under (a node of the default stream
would invalidate the capture). A failed capture or replay raises; nothing
falls back to eager. On the CPU, and with ``capture=False`` (the facade's
per-leaf offloaded parameters), there is no graph: ``fn`` runs as it is,
the same code path. :meth:`StepGraph.eager` runs ``fn`` uncaptured on the
card too: the graph's twin for a bitwise check.
"""

from __future__ import annotations

import gc
from typing import Callable, Protocol

import torch

WARMUP = 1  # calls of fn on a side stream before a capture


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def signature(inputs) -> tuple:
    """The shapes and dtypes of the tensors of ``inputs``: a graph's key."""
    return tuple((tuple(t.shape), t.dtype) for t in _tensors(inputs))


class GraphOwner(Protocol):
    """What :class:`StepGraph` asks of the owner of ``fn``'s state."""

    device: torch.device

    def prepare(self, *host) -> None:
        """Write the next call's host values into the owner's device
        scalars (fills, outside the capture)."""

    def state_snapshot(self):
        """A copy of every tensor ``fn`` writes."""

    def restore_state(self, snapshot) -> None:
        """Put a snapshot back in place (the storages stay)."""

    def bound_grads(self) -> list:
        """The parameters whose ``.grad`` the graph writes from its pool
        and that must be bound back before each replay; empty where the
        grads stay bound (flat views, or buffers the owner binds)."""


class StepGraph:
    """``fn(inputs)`` of ``owner`` as one captured CUDA graph on the card,
    ``fn`` itself on the CPU or with ``capture=False``. ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) is a memory pool shared with the
    owner's other graphs: safe where no graph's pool memory must outlive
    another's replay (each call's outputs are copied out, and the inputs,
    the state and the grads lie outside the pools) and the graphs replay
    one at a time on one stream."""

    def __init__(self, owner: GraphOwner, fn: Callable, capture: bool = True, pool=None):
        self.owner = owner
        self.fn = fn
        self.capture = bool(capture)
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self._inputs = None
        self._outputs = None
        self._grads = None
        self._signature = None
        self.captures = 0
        self.replays = 0

    def eager(self, inputs, *host):
        """``fn`` uncaptured after the same ``owner.prepare``: the graph's
        twin (and the whole path where there is no graph)."""
        self.owner.prepare(*host)
        return self.fn(inputs)

    def __call__(self, inputs, *host):
        owner = self.owner
        if owner.device.type != "cuda" or not self.capture:
            return self.eager(inputs, *host)
        if self.graph is None or signature(inputs) != self._signature:
            self._capture(inputs, host)
        for static, new in zip(_tensors(self._inputs), _tensors(inputs)):
            static.copy_(new, non_blocking=True)
        owner.prepare(*host)
        if self._grads is not None:
            for p, g in zip(owner.bound_grads(), self._grads):
                p.grad = g
        self.graph.replay()
        self.replays += 1
        return _map(torch.clone, self._outputs)

    def _capture(self, inputs, host) -> None:
        owner = self.owner
        self.graph = self._outputs = self._grads = None  # the old graph's pool goes first
        self._inputs = _map(lambda t: t.to(owner.device, copy=True), inputs)
        self._signature = signature(inputs)
        snapshot = owner.state_snapshot()
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            side = torch.cuda.Stream(owner.device)
            side.wait_stream(torch.cuda.current_stream(owner.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    owner.prepare(*host)
                    self.fn(self._inputs)
            torch.cuda.current_stream(owner.device).wait_stream(side)
            owner.restore_state(snapshot)
            owner.prepare(*host)
            graph = torch.cuda.CUDAGraph()
            gc.collect()  # the module docstring: no graph may be freed inside
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    outputs = self.fn(self._inputs)
            except BaseException:
                # a failed capture leaves the default generator's state
                # "capturing", and every later random draw on the card
                # raises; a fresh copy of its state repairs it
                gen = torch.cuda.default_generators[owner.device.index or 0]
                gen.graphsafe_set_state(gen.clone_state())
                raise
            finally:
                if collecting:
                    gc.enable()
        finally:
            torch.set_autocast_cache_enabled(cache)
        self.graph, self._outputs = graph, outputs
        bound = owner.bound_grads()
        if bound:  # the grads the graph writes, bound back before each replay
            self._grads = [p.grad for p in bound]
        self.captures += 1
