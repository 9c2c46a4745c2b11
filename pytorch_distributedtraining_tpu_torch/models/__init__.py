"""Models of the port: SwinIR (its three tails), the ESPCN ``Net``, GPT-2
(training path) and the VGG-16 feature column of the perceptual loss."""

from .gpt2 import GPT2, GPT2Config, cross_entropy_loss
from .sr_espcn import Net, pixel_shuffle
from .swinir import SwinIR
from .vgg import VGG16Features

__all__ = ["GPT2", "GPT2Config", "Net", "SwinIR", "VGG16Features", "cross_entropy_loss",
           "pixel_shuffle"]
