"""Runtime: device resolution, the process group and the device mesh."""

from . import dist, mesh

__all__ = ["dist", "mesh"]
