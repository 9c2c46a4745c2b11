"""Models of the port: SwinIR-S, the ESPCN ``Net`` and GPT-2 (training path)."""

from .gpt2 import GPT2, GPT2Config, cross_entropy_loss
from .sr_espcn import Net, pixel_shuffle
from .swinir import SwinIR

__all__ = ["GPT2", "GPT2Config", "Net", "SwinIR", "cross_entropy_loss", "pixel_shuffle"]
