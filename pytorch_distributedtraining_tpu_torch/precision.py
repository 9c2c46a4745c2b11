"""Mixed precision: compute policy as ``torch.autocast``, fp16 loss scaler.

Counterpart of ``pytorch_distributedtraining_tpu/precision.py``. Parameters
and optimizer state stay f32; ``Policy`` names the compute dtype of the
forward (``None`` = f32, ``bfloat16``, ``float16``) and enters
``torch.autocast`` for it. ``DynamicLossScaler`` is the ``--fp16 amp``
GradScaler twin: scale the loss, unscale the grads, skip the update and
halve the scale on a non-finite gradient, grow it after
``growth_interval`` clean steps; ``state_dict``/``load_state_dict``
carry it across a resume. fp8 is not ported yet.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype | None = None  # None: f32, no autocast

    @staticmethod
    def from_name(name: str | None) -> "Policy":
        if name in (None, "fp32", "float32", "none"):
            return Policy()
        if name in ("bf16", "bfloat16"):
            return Policy(torch.bfloat16)
        if name in ("fp16", "float16", "amp"):
            return Policy(torch.float16)
        raise ValueError(f"unknown precision policy {name!r}")

    def autocast(self, device: torch.device):
        """The forward's context: autocast to the compute dtype, or nothing."""
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device_type=device.type, dtype=self.compute_dtype)


class DynamicLossScaler:
    def __init__(self, init_scale: float = 2.0**14, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000):
        self.scale = float(init_scale)
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.growth_count = 0

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale

    def unscale(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        return torch._foreach_mul(grads, 1.0 / self.scale)

    @staticmethod
    def grads_finite(grads: list[torch.Tensor]) -> bool:
        """One host read per optimizer step: whether the update may apply."""
        norms = torch.stack(torch._foreach_norm(grads))
        return bool(torch.isfinite(norms).all())

    def update(self, finite: bool) -> None:
        if not finite:
            self.scale *= self.backoff_factor
            self.growth_count = 0
            return
        self.growth_count += 1
        if self.growth_count >= self.growth_interval:
            self.scale *= self.growth_factor
            self.growth_count = 0

    def state_dict(self) -> dict:
        return {"scale": self.scale, "growth_count": self.growth_count}

    def load_state_dict(self, state: dict) -> None:
        """Restore what :meth:`state_dict` returned: the scale and the count
        of clean steps since the last change."""
        self.scale = float(state["scale"])
        self.growth_count = int(state["growth_count"])
