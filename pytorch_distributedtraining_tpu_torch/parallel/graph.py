"""Train steps as captured CUDA graphs: the runner under ``MultiStep`` and
``Stoke.fused_step``.

JAX answers a host-bound step with one compiled program per step (or per K
steps); on the card the matching answer is a ``torch.cuda.CUDAGraph`` of
the step's kernels, replayed by one launch. :class:`StepGraph` runs
``fn(inputs) -> outputs`` (the work of one ``TrainStep``'s steps) that way:

- the first call, and any call whose inputs change shape or dtype, copies
  the inputs into static buffers and captures. Before the capture ``fn``
  runs :data:`WARMUP` times on a side stream, between a snapshot of the
  step's state and its restore: the warm-up builds the kernels, cuDNN's
  and cuBLAS's handles and every cache at first use (masks, plans, the
  probe's index vectors) without taking a step. Autocast's weight-cast
  cache is off through warm-up and capture (a cached cast would be freed
  while the graph still reads it);
- every call copies its inputs into the static buffers, writes the step's
  host values into its device scalars (``TrainStep.prepare``: the lr
  factor, the step counter), binds each parameter's ``.grad`` back to the
  tensor the graph writes (a per-leaf optimizer drops grads between
  steps), replays, and returns a copy of the outputs, so one call's
  metrics do not change at the next replay.

The capture runs with Python's garbage collector held off, after one
collection: an unreachable graph that a collection freed inside a capture
would destroy its executable there, which CUDA refuses, and the capture
would be lost (seen on the card when ``tune_multi_step_k``'s arms, each
its own graph, followed earlier phases' graphs).

Every input and output of a kernel inside lies in the graph's static
buffers or its private memory pool: the window and flash kernels launch on
the current stream with raw pointers, which a replay reuses. A failed
capture or replay raises; nothing falls back to eager. On the CPU there is
no graph: ``fn`` runs as it is, the same code path.
"""

from __future__ import annotations

import gc
from typing import Callable

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


def _signature(inputs) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _tensors(inputs))


class StepGraph:
    """``fn(inputs)`` of ``step`` (a ``TrainStep``) as one captured CUDA
    graph on the card, ``fn`` itself on the CPU."""

    def __init__(self, step, fn: Callable):
        self.step = step
        self.fn = fn
        self.graph: torch.cuda.CUDAGraph | None = None
        self._inputs = None
        self._outputs = None
        self._grads = None
        self._signature = None
        self.captures = 0
        self.replays = 0

    def __call__(self, inputs, lr_factor):
        step = self.step
        if step.device.type != "cuda":
            step.prepare(lr_factor)
            return self.fn(inputs)
        if self.graph is None or _signature(inputs) != self._signature:
            self._capture(inputs, lr_factor)
        for static, new in zip(_tensors(self._inputs), _tensors(inputs)):
            static.copy_(new, non_blocking=True)
        step.prepare(lr_factor)
        if self._grads is not None:
            for p, g in zip(step.tx.params, self._grads):
                p.grad = g
        self.graph.replay()
        self.replays += 1
        return _map(torch.clone, self._outputs)

    def _capture(self, inputs, lr_factor) -> None:
        step = self.step
        self.graph = self._outputs = self._grads = None  # the old graph's pool goes first
        self._inputs = _map(lambda t: t.to(step.device, copy=True), inputs)
        self._signature = _signature(inputs)
        snapshot = step.state_snapshot()
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            side = torch.cuda.Stream(step.device)
            side.wait_stream(torch.cuda.current_stream(step.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    step.prepare(lr_factor)
                    self.fn(self._inputs)
            torch.cuda.current_stream(step.device).wait_stream(side)
            step.restore_state(snapshot)
            step.prepare(lr_factor)
            graph = torch.cuda.CUDAGraph()
            gc.collect()  # the module docstring: no graph may be freed inside
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    outputs = self.fn(self._inputs)
            except BaseException:
                # a failed capture leaves the default generator's state
                # "capturing", and every later random draw on the card
                # raises; a fresh copy of its state repairs it
                gen = torch.cuda.default_generators[step.device.index or 0]
                gen.graphsafe_set_state(gen.clone_state())
                raise
            finally:
                if collecting:
                    gc.enable()
        finally:
            torch.set_autocast_cache_enabled(cache)
        self.graph, self._outputs = graph, outputs
        if step.fused is None:  # per-leaf: the grads the graph writes
            self._grads = [p.grad for p in step.tx.params]
        self.captures += 1
