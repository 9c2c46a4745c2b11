"""Metrics sinks, the wandb-compatible module the driver logs through, span
telemetry with the crash flight record (``trace``) and request-lifecycle
SLO accounting (``slo``)."""

from . import wandb_compat as wandb

__all__ = ["wandb"]
