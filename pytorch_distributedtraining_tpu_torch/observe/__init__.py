"""Metrics sinks and the wandb-compatible module the driver logs through."""

from . import wandb_compat as wandb

__all__ = ["wandb"]
