"""ResNet-18/34/50/101: the ladder's image rungs 1-3.

Counterpart of ``pytorch_distributedtraining_tpu/models/resnet.py``.
Images go in NHWC (``[B, H, W, C]``) and are read as an NCHW view with
``channels_last`` strides, which cuDNN convolves as NHWC without a copy
(on the CPU the view is made contiguous, see :meth:`ResNet.forward`);
the logits come out ``[B, num_classes]`` in f32. Module names are
torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}`` / ``bn{k}``,
``downsample.0`` / ``.1``, ``fc``), so a torchvision ``resnet18`` /
``resnet50`` state dict loads strictly with no key map.

The numerics are flax's, not torch's defaults:

- ``SAME`` padding, which is asymmetric at stride 2: ``total // 2``
  before and the rest after, so the 7x7/2 stem pads (2, 3) on an even
  size, every 3x3/2 convolution (0, 1), and the 3x3/2 max pool (0, 1)
  with -inf (:func:`same_pads`). torch's even ``padding=3`` / ``=1`` would
  shift every stride-2 window by one pixel.
- BatchNorm is flax's (``parallel.sync_bn.BatchNorm``): statistics in f32
  whatever ``dtype`` is, the *biased* variance into ``running_var``.
- The last BatchNorm of each block starts at scale zero, and convolution
  and dense kernels at flax's ``lecun_normal`` (:meth:`ResNet.init_weights`).

BatchNorm is synchronous over the data group, as JAX's, whose ``jit``
sees the global batch: ``parallel.create_train_state`` hands the mesh's
data group to every BatchNorm (``parallel.sync_bn``).

``train`` (default: the module's ``training`` flag, so ``module.eval()``
does the same as ``train=False``) selects batch statistics, which update
the running statistics in place, or the running statistics.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sync_bn import BatchNorm
from .gpt2 import _dense

# the stddev of a unit normal truncated to [-2, 2]: flax's truncated_normal
# variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dimension: ``(before, after)``."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` (NCHW) padded as ``SAME`` asks where that is asymmetric, and the
    symmetric padding left for the op itself: ``(x, (ph, pw))``."""
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv_same(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False, dtype=...)`` with the
    weight of a torch ``Conv2d`` (OIHW)."""
    k, s = conv.kernel_size[0], conv.stride[0]
    x, pad = _pad_same(x, k, s)
    return F.conv2d(x, conv.weight.to(dtype), None, s, pad)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: pads of -inf."""
    x, pad = _pad_same(x, k, s, float("-inf"))
    return F.max_pool2d(x, k, s, pad)


def _downsample(cin: int, cout: int, stride: int, dtype) -> nn.Sequential | None:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), BatchNorm(cout, dtype=dtype))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(cin, filters, 3, stride, bias=False)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters, dtype=dtype, zero_init=True)
        self.downsample = _downsample(cin, filters, stride, dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv_same(self.conv1, x, dt), train))
        y = self.bn2(conv_same(self.conv2, y, dt), train)
        if self.downsample is not None:
            x = self.downsample[1](conv_same(self.downsample[0], x, dt), train)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 down, 3x3 (the stride), 1x1 up (x4) residual block (ResNet-50/101)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out = filters * 4
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, bias=False)
        self.bn2 = BatchNorm(filters, dtype=dtype)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = BatchNorm(out, dtype=dtype, zero_init=True)
        self.downsample = _downsample(cin, out, stride, dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv_same(self.conv1, x, dt), train))
        y = F.relu(self.bn2(conv_same(self.conv2, y, dt), train))
        y = self.bn3(conv_same(self.conv3, y, dt), train)
        if self.downsample is not None:
            x = self.downsample[1](conv_same(self.downsample[0], x, dt), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """Configurable ResNet. ``forward(images [B, H, W, C], train=None) ->
    logits [B, num_classes]`` (f32).

    ``small_inputs`` is the CIFAR stem: a 3x3/1 convolution and no max pool.
    ``dtype`` is the compute type of convolutions, the dense head and the
    BatchNorm outputs (parameters stay f32, statistics are f32).
    ``generator`` seeds :meth:`init_weights`.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls=BasicBlock, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 small_inputs: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.small_inputs = dtype, small_inputs
        self.stage_sizes = tuple(stage_sizes)
        if small_inputs:
            self.conv1 = nn.Conv2d(3, num_filters, 3, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, num_filters, 7, 2, bias=False)
        self.bn1 = BatchNorm(num_filters, dtype=dtype)
        cin = num_filters
        for i, n in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2**i, stride, dtype))
                cin = num_filters * 2**i * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initialisation: ``lecun_normal`` convolution and dense
        kernels (a truncated normal of variance 1 / fan_in), zero dense
        bias, BatchNorm scale one (zero on each block's last) and bias zero;
        running statistics reset."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                (nn.init.zeros_ if m.zero_init else nn.init.ones_)(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor, train: bool | None = None) -> torch.Tensor:
        train = self.training if train is None else train
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> an NCHW view, channels_last strides
        if x.device.type == "cpu":
            # oneDNN's channels_last backward of a 1x1/2 convolution corrupts
            # the heap at some shapes (8 -> 16 channels at 32x32, torch 2.13):
            # the CPU runs NCHW, the same numbers
            x = x.contiguous()
        x = F.relu(self.bn1(conv_same(self.conv1, x, dt), train))
        if not self.small_inputs:
            x = max_pool_same(x)
        for i in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, train)
        return _dense(self.fc, x.mean((2, 3)), dt).float()


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock)
