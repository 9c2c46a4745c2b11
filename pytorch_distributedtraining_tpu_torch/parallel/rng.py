"""The train step's random stream and the models' dropout.

JAX's step folds its state's key with the step (``fold_in(state.rng,
step)``, ``parallel/step.py:244``) and each micro-batch's index
(``:256``), and flax's ``nn.Dropout`` draws every mask from the key that
reaches it. The port fixes the same things by plain integers:

- :class:`StepRng` is the train state's stream: a seed and the step
  count. ``TrainStep`` advances it once a step, and
  ``TrainState.state_dict`` carries it, so a resumed run draws the masks
  the unbroken run drew.
- :class:`DropoutKey` is one micro-batch's key, ``(seed, step, micro)``.
  A mask is a counter-based draw: each element's bits are a hash of the
  key, the dropout site (the site's place in the model's forward) and the
  element's index, computed by integer tensor ops on the mask's device
  (:func:`keep_mask`), never drawn from a generator that advances. So a
  forward that ``torch.utils.checkpoint`` recomputes in backward draws the
  same masks again (checkpoint restores the default CPU and CUDA
  generators only, and an advancing explicit generator would give the
  recompute new masks and a wrong gradient), the CPU and the card draw the
  same bits, and ``step`` may be a device tensor: a captured CUDA graph
  (``parallel.MultiStep``, ``Stoke.fused_step``) reads the step from a
  device counter that it advances itself, where a seed computed on the
  host would be baked into the graph. A reseeded Philox generator cannot
  serve there: a generator's seed cannot change during a capture, and a
  graph's registered generator hands each draw an offset by capture order,
  which neither the eager step nor a remat recompute reproduces.
- :func:`dropout` is flax's ``nn.Dropout``: with ``deterministic`` or a
  rate of 0 it returns its input; else ``x / (1 - rate)`` where the mask
  keeps and 0 elsewhere (all zeros at rate 1).

The models take ``generator=`` for the key: a :class:`DropoutKey` or any
object with the :meth:`DropoutKey.mask` method (a test feeds the JAX
package's own masks that way). A ``torch.Generator`` is refused: nothing
would advance it from step to step, so every step would draw the same
masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mix_seed(*values: int) -> int:
    """A 63-bit generator seed from integers (splitmix64 over each in turn)."""
    h = 0
    for v in values:
        h = _splitmix64(h ^ (int(v) & _M64))
    return h >> 1


_M32 = 0xFFFFFFFF


def _mix32_(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche (the lowbias32 shape) of int64 lanes that hold
    values below 2**32, in place: every product stays below 2**63, so the
    bits are exact and equal on every device."""
    x.bitwise_xor_(x >> 16)
    x.mul_(0x7FEB352D).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 15)
    x.mul_(0x6A09E667).bitwise_and_(_M32)
    return x.bitwise_xor_(x >> 16)


def keep_mask(seed: int, step, micro: int, site: int, shape, keep: float,
              device) -> torch.Tensor:
    """The keep mask (bool, ``shape``) of dropout site ``site`` under the key
    ``(seed, step, micro)``: each element kept with probability ``keep``.
    ``step`` is an int or an integer device tensor (0-d); both give the same
    bits. Nothing is read back to the host."""
    device = torch.device(device)
    n = math.prod(tuple(shape))
    if n >= 1 << 31:
        raise ValueError(f"dropout mask of {n} elements: at most 2**31 - 1")
    if isinstance(step, torch.Tensor):
        k = step.to(device=device, dtype=torch.int64).reshape(())
    else:
        k = torch.full((), int(step), dtype=torch.int64, device=device)
    k = _mix32_((k & 0x7FFFFFFF).mul_(0x9E3779B1).bitwise_xor_(
        mix_seed(seed, micro, site) & _M32).bitwise_and_(_M32))
    h = torch.arange(n, dtype=torch.int64, device=device).mul_(0x85EBCA77)
    h = _mix32_(h.add_(k).bitwise_and_(_M32))
    return (h < int(keep * (1 << 32))).reshape(tuple(shape))


@dataclass(frozen=True)
class DropoutKey:
    """The key of one micro-batch's forward: each site's mask is a function
    of ``(seed, step, micro, site)`` alone. ``step`` is an int or a 0-d
    integer device tensor (a train step's counter)."""

    seed: int
    step: object = 0
    micro: int = 0

    def mask(self, site: int, shape, keep: float, device) -> torch.Tensor:
        """The keep mask (bool, ``shape``) of dropout site ``site``: each
        element kept with probability ``keep``."""
        return keep_mask(self.seed, self.step, self.micro, site, shape, keep, device)


def as_key(generator):
    """A model's ``generator=`` as a mask source: None or a
    :class:`DropoutKey` (or another object with ``mask``)."""
    if generator is None or hasattr(generator, "mask"):
        return generator
    raise TypeError(f"generator must be a DropoutKey(seed, step, micro) or None, got "
                    f"{type(generator).__name__}: a key fixed by the step draws new masks "
                    f"each step, where one generator would repeat them")


def dropout(x: torch.Tensor, rate: float, key, site: int,
            deterministic: bool = True) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic)`` with the mask of ``site``
    from ``key`` (see :func:`as_key`)."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if key is None:
        raise ValueError("dropout with deterministic=False needs a generator= (a "
                         "DropoutKey), as flax needs a 'dropout' rng")
    keep = 1.0 - rate
    return torch.where(key.mask(site, x.shape, keep, x.device), x / keep, 0.0)


class StepRng:
    """The train state's random stream: ``seed`` and the number of steps
    taken (``step``, the host's record); :meth:`key` is micro-batch
    ``micro``'s key at the current step. A train step keys its micro-batches
    by a device copy of ``step`` that it advances on the device, and the
    host count here after each call (``TrainStep``) or window
    (``MultiStep``)."""

    def __init__(self, seed: int = 0, step: int = 0):
        self.seed = int(seed)
        self.step = int(step)

    def key(self, micro: int = 0) -> DropoutKey:
        return DropoutKey(self.seed, self.step, micro)

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    def __repr__(self) -> str:
        return f"StepRng(seed={self.seed}, step={self.step})"
