"""Runtime: device resolution and the process's rank and world size."""

from . import dist

__all__ = ["dist"]
