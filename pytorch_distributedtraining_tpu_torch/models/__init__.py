"""Models of the port: SwinIR (its three tails), the ESPCN ``Net``, GPT-2
(training and KV-cache decode; ``generate`` decodes), the VGG-16 feature column of the perceptual loss, and the
ladder's image models, ResNet-18/34/50/101 and ViT-B/16."""

from .gpt2 import GPT2, GPT2Config, cross_entropy_loss
from .resnet import BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet34, ResNet50, ResNet101
from .sr_espcn import Net, pixel_shuffle
from .swinir import SwinIR
from .vgg import VGG16Features
from .vit import ViT, ViTB16, ViTConfig

__all__ = ["BasicBlock", "BottleneckBlock", "GPT2", "GPT2Config",
           "Net", "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "SwinIR",
           "VGG16Features", "ViT", "ViTB16", "ViTConfig", "cross_entropy_loss", "pixel_shuffle"]
