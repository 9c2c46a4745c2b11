"""Mixed precision: compute policy as ``torch.autocast``, fp16 loss scaler.

Counterpart of ``pytorch_distributedtraining_tpu/precision.py``. Parameters
and optimizer state stay f32; ``Policy`` names the compute dtype of the
forward (``None`` = f32, ``bfloat16``, ``float16``) and enters
``torch.autocast`` for it. ``DynamicLossScaler`` is the ``--fp16 amp``
GradScaler twin and JAX's ``DynamicLossScaler`` with its ``ScalerState``:
scale the loss, unscale the grads, skip the update and halve the scale on
a non-finite gradient, grow it after ``growth_interval`` clean steps. Its
scale and growth count are 0-d tensors on the device and the update is a
select on the finite flag (JAX's branchless ``jnp.where``), so it runs
inside a train step, also a captured CUDA graph, with no read on the host;
``state_dict``/``load_state_dict`` carry it across a resume. fp8 is not
ported yet.
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
    """``scale`` (f32) and ``growth_count`` (int32) are 0-d tensors on
    ``device``; :meth:`to` moves them (before a graph captures them)."""

    def __init__(self, init_scale: float = 2.0**14, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000,
                 device: str | torch.device = "cpu"):
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.scale = torch.full((), float(init_scale), dtype=torch.float32, device=device)
        self.growth_count = torch.zeros((), dtype=torch.int32, device=device)

    def to(self, device) -> "DynamicLossScaler":
        """The state on ``device`` (moved once; a no-op where it lies),
        rebuilt there from its values by fills, so a scaler built on the
        CPU reaches the card without a copy from pageable host memory."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.scale.device != device:
            self.scale = torch.full((), float(self.scale), dtype=torch.float32, device=device)
            self.growth_count = torch.full((), int(self.growth_count), dtype=torch.int32,
                                           device=device)
        return self

    def state_tensors(self) -> list[torch.Tensor]:
        return [self.scale, self.growth_count]

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale.to(loss.dtype)

    def unscale(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """``g · (1/scale)`` in f32, JAX's ``unscale_grads``."""
        return torch._foreach_mul(grads, torch.reciprocal(self.scale))

    @staticmethod
    def grads_finite(grads: list[torch.Tensor]) -> torch.Tensor:
        """Whether every gradient is finite, a device bool (each leaf's
        largest magnitude, which a finite leaf never overflows)."""
        norms = torch.stack(torch._foreach_norm(grads, float("inf"), dtype=torch.float32))
        return torch.isfinite(norms).all()

    @torch.no_grad()
    def update(self, finite) -> None:
        """Back off on a non-finite step (``finite`` a device bool, or a
        Python bool), grow after ``growth_interval`` clean ones; both reset
        the count. In place, by selects."""
        finite = torch.as_tensor(finite, device=self.scale.device)
        grew = self.growth_count + 1 >= self.growth_interval
        scale = torch.where(finite, torch.where(grew, self.scale * self.growth_factor, self.scale),
                            self.scale * self.backoff_factor)
        count = torch.where(finite, torch.where(grew, 0, self.growth_count + 1), 0)
        self.scale.copy_(scale)
        self.growth_count.copy_(count)

    def state_dict(self) -> dict:
        return {"scale": float(self.scale), "growth_count": int(self.growth_count)}

    def load_state_dict(self, state: dict) -> None:
        """Restore what :meth:`state_dict` returned: the scale and the count
        of clean steps since the last change."""
        self.scale.fill_(float(state["scale"]))
        self.growth_count.fill_(int(state["growth_count"]))
