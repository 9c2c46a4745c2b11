"""``Net``: ESPCN-style sub-pixel convolution super-resolution model.

Counterpart of ``pytorch_distributedtraining_tpu/models/sr_espcn.py``. The
public layout stays NHWC ``[B, H, W, C]`` as in the JAX model; the convs run
on a channels-last view of it (``permute`` of a contiguous NHWC tensor is a
channels-last NCHW tensor, so no copy is made).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C*r^2] -> [B, H*r, W*r, C] with the JAX channel order.

    Channel ``(i*r + j)*C + c`` lands at sub-pixel ``(i, j)`` of channel
    ``c`` (a reshape to ``(r, r, C)``). ``F.pixel_shuffle`` reads channel
    ``c*r*r + i*r + j`` instead, so weights carried over from the JAX model
    would come out scrambled through it.
    """
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)  # B, H, r, W, r, C
    return x.reshape(b, h * r, w * r, c)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor; returns NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Net(nn.Module):
    """ESPCN: conv5x5(64) -> conv3x3(32) -> conv3x3(C*r^2) -> pixel shuffle."""

    def __init__(self, upscale_factor: int = 2, channels: int = 3, features=(64, 32)):
        super().__init__()
        r = upscale_factor
        self.upscale_factor = r
        self.conv1 = nn.Conv2d(channels, features[0], 5, padding=2)
        self.conv2 = nn.Conv2d(features[0], features[1], 3, padding=1)
        self.conv3 = nn.Conv2d(features[1], channels * r * r, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv_nhwc(self.conv1, x))
        x = F.relu(conv_nhwc(self.conv2, x))
        x = conv_nhwc(self.conv3, x)
        return pixel_shuffle(x, self.upscale_factor).float()
