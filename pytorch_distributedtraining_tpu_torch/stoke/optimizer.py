"""StokeOptimizer: the optimizer-spec dict the facade consumes.

Counterpart of ``pytorch_distributedtraining_tpu/stoke/optimizer.py``:
``StokeOptimizer(optimizer="AdamW", optimizer_kwargs={"lr": ..., ...})``.
``optimizer`` may be a name, a factory of ``..optim`` or a class whose
``__name__`` names one (``torch.optim.AdamW`` maps to the port's AdamW,
``"SGD"`` or ``torch.optim.SGD`` to its SGD).
"""

from __future__ import annotations

from typing import Any, Callable

from .. import optim as _optim


class StokeOptimizer(dict):
    """Dict with keys ``optimizer`` and ``optimizer_kwargs``."""

    def __init__(self, optimizer: Any, optimizer_kwargs: dict | None = None):
        super().__init__(optimizer=optimizer, optimizer_kwargs=optimizer_kwargs or {})

    @staticmethod
    def resolve(spec: "StokeOptimizer | dict") -> tuple[Callable, dict]:
        """Return ``(factory, kwargs)`` with torch-parity kwarg names."""
        opt = spec["optimizer"]
        kwargs = dict(spec.get("optimizer_kwargs") or {})
        name = opt if isinstance(opt, str) else getattr(opt, "__name__", str(opt))
        key = name.lower()
        if key not in _optim.OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_optim.OPTIMIZERS)}")
        return _optim.OPTIMIZERS[key], kwargs
