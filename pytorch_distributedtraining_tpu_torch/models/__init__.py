"""Models of the port: SwinIR-S and the ESPCN ``Net``."""

from .sr_espcn import Net, pixel_shuffle
from .swinir import SwinIR

__all__ = ["Net", "SwinIR", "pixel_shuffle"]
