"""Training steps of the port: ``TrainStep`` on one device."""

from .step import TrainStep

__all__ = ["TrainStep"]
