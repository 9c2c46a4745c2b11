"""Losses: MSE, L1, the perceptual ``feat_loss`` and ``VGGFeatLoss``.

Counterpart of ``pytorch_distributedtraining_tpu/losses.py``. ``FeatLoss``
builds the same fixed random filters from the same host-numpy seed path, so
the port's loss is the JAX loss, value for value. Images are NHWC.

The filters are 3x3 stride-2 convs with XLA's ``SAME`` padding. On an even
size XLA pads 0 before and 1 after; ``padding=1`` in torch would pad 1 on
both sides and shift the sampling grid. ``same_pad`` computes XLA's split
explicitly.

``VGGFeatLoss`` compares VGG-16 activations (``models.vgg``) at five ReLU
taps with L1 and mixes in pixel L1, as the JAX ``VGGFeatLoss``. Its VGG
parameters are frozen: they take no gradient and belong to no optimizer.
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


class VGGFeatLoss:
    """VGG-16 perceptual loss: ``feat_weight`` x the mean over the taps of
    the L1 between the feature maps of outputs and targets, plus
    ``pixel_weight`` x the pixel L1. Images are NHWC in [0, 1].

    ``params`` is a state dict of :class:`~.models.vgg.VGG16Features`
    (``interop.vgg16_state_dict_from_jax`` carries the JAX model's over);
    without one the column is initialised from ``torch.Generator`` seed
    ``seed`` (the JAX loss's no-argument form initialises from
    ``jax.random.PRNGKey(seed)``: same distribution, other values).
    :meth:`from_torch` loads a torchvision ``vgg16`` file. The column lives
    on ``device`` (the GPU unless ``"cpu"`` is asked for).
    """

    def __init__(self, params: dict | None = None, feat_weight: float = 1.0,
                 pixel_weight: float = 1.0, seed: int = 0,
                 device: str | torch.device = "cuda"):
        from .models.vgg import VGG16Features
        from .runtime.dist import resolve_device

        self.net = VGG16Features(generator=torch.Generator().manual_seed(seed))
        if params is not None:
            self.net.load_state_dict(params, strict=True)
        self.net.requires_grad_(False).eval()
        self.net.to(resolve_device(device))
        self.feat_weight = feat_weight
        self.pixel_weight = pixel_weight

    @classmethod
    def from_torch(cls, path: str, **kw) -> "VGGFeatLoss":
        """Load torchvision ``vgg16`` weights (a bare state dict or one
        wrapped as ``interop.load_torch_checkpoint`` reads it); strict on
        the conv leaves, the ``classifier.*`` head dropped."""
        from .interop import load_torch_checkpoint

        sd = {k: v for k, v in load_torch_checkpoint(path).items()
              if not k.startswith("classifier.")}
        return cls(params=sd, **kw)

    def __call__(self, outputs, targets):
        fo = self.net(outputs)
        ft = self.net(targets)
        feat = sum(torch.mean(torch.abs(a - b)) for a, b in zip(fo, ft)) / len(fo)
        return self.feat_weight * feat + self.pixel_weight * l1_loss(outputs, targets)


def __getattr__(name):
    # built on first use, so importing the module constructs nothing
    if name == "feat_loss":
        obj = FeatLoss()
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
