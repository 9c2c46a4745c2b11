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
  A mask is drawn from a generator seeded by a hash of the key and the
  dropout site (the site's place in the model's forward), never from a
  generator that advances. So a forward that ``torch.utils.checkpoint``
  recomputes in backward draws the same masks again: checkpoint restores
  the default CPU and CUDA generators only, and an advancing explicit
  generator would give the recompute new masks and a wrong gradient.
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


_GENERATORS: dict = {}


def _generator(device: torch.device) -> torch.Generator:
    """One reusable generator per device; every draw reseeds it first."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _GENERATORS.get(device)
    if g is None:
        g = _GENERATORS[device] = torch.Generator(device=device)
    return g


@dataclass(frozen=True)
class DropoutKey:
    """The key of one micro-batch's forward: each site's mask is a function
    of ``(seed, step, micro, site)`` alone."""

    seed: int
    step: int = 0
    micro: int = 0

    def mask(self, site: int, shape, keep: float, device) -> torch.Tensor:
        """The keep mask (bool, ``shape``) of dropout site ``site``: each
        element kept with probability ``keep``."""
        g = _generator(device)
        g.manual_seed(mix_seed(self.seed, self.step, self.micro, site))
        return torch.rand(tuple(shape), generator=g, device=device) < keep


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
    taken (``step``); :meth:`key` is micro-batch ``micro``'s key at the
    current step."""

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
