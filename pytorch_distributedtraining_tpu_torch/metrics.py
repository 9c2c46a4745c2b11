"""Image-quality metrics: MAE, MSE, PSNR and SSIM on NHWC images.

Counterpart of ``pytorch_distributedtraining_tpu/metrics.py``. Results stay
0-d tensors on the inputs' device, so a validation loop sums them without a
host sync per batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .losses import mse_loss

# MSE floor for psnr: exact-match outputs would otherwise give log10(x/0) =
# inf, which poisons every sink it reaches. 1e-10 caps PSNR at a finite
# 100 dB for data_range=1, clearly a sentinel.
PSNR_MSE_EPS = 1e-10


def mae(outputs, targets):
    """Mean absolute error over all pixels and channels."""
    return torch.mean(torch.abs(outputs - targets))


def mse(outputs, targets):
    return mse_loss(outputs, targets)


def psnr(outputs, targets, data_range: float = 1.0):
    """Peak signal-to-noise ratio in dB, finite by construction (the MSE is
    floored at :data:`PSNR_MSE_EPS`)."""
    err = torch.clamp(mse(outputs, targets), min=PSNR_MSE_EPS)
    return 10.0 * torch.log10(data_range**2 / err)


def ssim(outputs, targets, data_range: float = 1.0):
    """Structural similarity: 11x11 gaussian window (sigma 1.5), K1=0.01,
    K2=0.03, channels compared independently. HWC or NHWC inputs."""
    x = outputs.float()
    y = targets.float()
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.dim() not in (3, 4):
        raise ValueError(f"ssim expects HWC or NHWC, got shape {tuple(x.shape)}")
    if x.dim() == 3:
        x, y = x[None], y[None]
    if x.shape[1] < 11 or x.shape[2] < 11:
        raise ValueError(f"ssim needs >=11x11 images, got {tuple(x.shape[1:3])}")
    coords = torch.arange(11, dtype=torch.float32, device=x.device) - 5.0
    g = torch.exp(-(coords**2) / (2.0 * 1.5**2))
    g = g / g.sum()
    c = x.shape[-1]
    kern = torch.outer(g, g)[None, None].repeat(c, 1, 1, 1)  # depthwise OIHW
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)

    def win(t):
        return F.conv2d(t, kern, groups=c)

    mu_x, mu_y = win(x), win(y)
    var_x = win(x * x) - mu_x * mu_x
    var_y = win(y * y) - mu_y * mu_y
    cov = win(x * y) - mu_x * mu_y
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2.0 * mu_x * mu_y + c1) * (2.0 * cov + c2)) / (
        (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2)
    )
    return torch.mean(s)
