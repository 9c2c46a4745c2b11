"""Losses: MSE, L1 and the perceptual ``feat_loss``.

Counterpart of ``pytorch_distributedtraining_tpu/losses.py``. ``FeatLoss``
builds the same fixed random filters from the same host-numpy seed path, so
the port's loss is the JAX loss, value for value. Images are NHWC.

The filters are 3x3 stride-2 convs with XLA's ``SAME`` padding. On an even
size XLA pads 0 before and 1 after; ``padding=1`` in torch would pad 1 on
both sides and shift the sampling grid. ``same_pad`` computes XLA's split
explicitly. ``VGGFeatLoss`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse_loss(outputs, targets):
    return torch.mean((outputs - targets) ** 2)


def l1_loss(outputs, targets):
    return torch.mean(torch.abs(outputs - targets))


def _fixed_filters(rng, cin: int, cout: int) -> np.ndarray:
    """Deterministic random 3x3 filters (HWIO), unit-normalized."""
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    return w / np.sqrt(np.sum(w**2, axis=(0, 1, 2), keepdims=True) + 1e-8)


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA ``SAME`` padding (before, after) for one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _feature_pyramid(x, filters):
    feats = []
    x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
    for w in filters:
        top, bottom = same_pad(x.shape[2], 3, 2)
        left, right = same_pad(x.shape[3], 3, 2)
        x = F.relu(F.conv2d(F.pad(x, (left, right, top, bottom)), w.to(x.dtype), stride=2))
        feats.append(x)
    return feats


class FeatLoss:
    """Perceptual loss with fixed random conv features plus pixel L1.

    ``FeatLoss()(outputs, targets)`` on NHWC images; the filters move to the
    outputs' device on first use and stay there.
    """

    def __init__(self, depths=(16, 32, 64), pixel_weight: float = 1.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        cins = (3,) + tuple(depths[:-1])
        # HWIO -> OIHW for F.conv2d
        self._host = [
            torch.from_numpy(_fixed_filters(rng, cin, cout).transpose(3, 2, 0, 1).copy())
            for cin, cout in zip(cins, depths)
        ]
        self._on: dict = {}
        self.pixel_weight = pixel_weight

    def filters(self, device) -> list[torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = [w.to(device) for w in self._host]
        return self._on[device]

    def __call__(self, outputs, targets):
        filters = self.filters(outputs.device)
        fo = _feature_pyramid(outputs, filters)
        ft = _feature_pyramid(targets, filters)
        feat = sum(torch.mean(torch.abs(a - b)) for a, b in zip(fo, ft))
        return feat / len(fo) + self.pixel_weight * l1_loss(outputs, targets)


def __getattr__(name):
    # built on first use, so importing the module constructs nothing
    if name == "feat_loss":
        obj = FeatLoss()
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
