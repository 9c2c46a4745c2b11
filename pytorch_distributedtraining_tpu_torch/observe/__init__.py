"""Metrics sinks, the wandb-compatible module the driver logs through, span
telemetry with the crash flight record (``trace``), request-lifecycle SLO
accounting (``slo``), training numerics (``numerics``: the step's probe and
the divergence watchdog), goodput and MFU (``goodput``: the time ledger,
analytic FLOPs, straggler detection) and device memory (``memory``: the
budget, the high-water, the batch-size search)."""

from . import goodput, memory, numerics, trace
from . import wandb_compat as wandb

__all__ = ["goodput", "memory", "numerics", "trace", "wandb"]
