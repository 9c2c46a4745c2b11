"""VGG-16 feature column: the backbone of the perceptual ``VGGFeatLoss``.

Counterpart of ``pytorch_distributedtraining_tpu/models/vgg.py``. The
``features`` ``nn.Sequential`` is indexed as torchvision's ``vgg16`` (plan
"D": the conv at index N is ``features.N``, ReLUs and 2x2 max-pools
between), so a torchvision state dict loads with no key map once its
``classifier.*`` keys are dropped. Images go in NHWC in [0, 1], are
ImageNet-normalised inside, and the activations at the ReLUs of
``RELU_TAPS`` (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) come out NHWC,
as the JAX model returns them. The convolutions are cuDNN's: the JAX model
runs them as XLA convolutions, not in Pallas.

``generator`` seeds the initialisation with the JAX model's distribution
(flax's default ``lecun_normal``: a truncated normal of variance
1 / fan_in, zero biases), so the no-checkpoint loss is reproducible from a
seed.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# torchvision vgg16 cfg "D": conv channel plan with 'M' = 2x2 max-pool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
RELU_TAPS = (3, 8, 15, 22, 29)  # features indices of the tapped ReLUs
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the stddev of a unit normal truncated to [-2, 2]: flax's truncated_normal
# variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


class VGG16Features(nn.Module):
    """NHWC VGG-16 feature column; returns the activations at ``taps``."""

    def __init__(self, taps: Sequence[int] = RELU_TAPS, generator: torch.Generator | None = None):
        super().__init__()
        self.taps = tuple(taps)
        layers: list[nn.Module] = []
        cin = 3
        for item in VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
            cin = item
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:  # [B, H, W, 3] in [0, 1]
        x = ((x - self.mean.to(x.dtype)) / self.std.to(x.dtype)).permute(0, 3, 1, 2)
        feats = []
        last = max(self.taps)
        for i, m in enumerate(self.features):
            if i > last:
                break
            x = m(x)
            if i in self.taps:
                feats.append(x.permute(0, 2, 3, 1))
        return feats
