"""flax's BatchNorm, synchronous over the data group, and the helpers the
runtime uses to reach it: :func:`sync_batch_norm` hands a group to every
:class:`BatchNorm` of a model, :func:`batch_norm_state` lists the model
state a training forward updates in place.

In JAX, ``jit`` sees the global batch, so its BatchNorm statistics are
always the global batch's. Here each rank holds a shard of the batch, so
a BatchNorm with a ``process_group`` of more than one rank all-reduces its
per-channel sum, sum of squares and count through a differentiable
all-reduce whose backward sums the gradients of the statistics as well:
forward and backward are the global batch's. Without a group, or at one
rank, no collective is issued.

The numerics are flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
torch's defaults: statistics in f32 whatever the compute type is, the
variance as ``mean(x²) - mean(x)²``, the momentum on the old value, and
the *biased* variance into ``running_var`` (torch's ``BatchNorm2d``
stores the unbiased one).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.distributed.nn.functional as tdist_fn
from torch import nn

MOMENTUM = 0.9  # flax's: the weight of the old running value
EPS = 1e-5


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of an NCHW tensor, under
    torch's parameter and buffer names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), synchronous
    over ``process_group`` when it has more than one rank. ``dtype`` is the
    output's type; ``zero_init`` starts the scale at zero (flax's
    ``scale_init=zeros``, a residual block's last BatchNorm)."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False):
        super().__init__()
        self.dtype, self.zero_init = dtype, zero_init
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.process_group = None

    def _batch_stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean and biased variance per channel, over every rank of the group."""
        s, ss = x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))
        count = float(x.numel() // x.shape[1])
        group = self.process_group
        if group is not None and tdist.get_world_size(group) > 1:
            c = s.shape[0]
            stats = tdist_fn.all_reduce(torch.cat([s, ss, s.new_full((1,), count)]), group=group)
            s, ss, count = stats[:c], stats[c:2 * c], stats[2 * c]
        mean = s / count
        return mean, torch.clamp_min(ss / count - mean * mean, 0.0)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var = self._batch_stats(xf)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_(mean.detach(), alpha=1 - MOMENTUM)
                self.running_var.mul_(MOMENTUM).add_(var.detach(), alpha=1 - MOMENTUM)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        # (x - mean) * a + bias, as x * a + (bias - mean * a): one full-size pass
        a = torch.rsqrt(var + EPS) * self.weight
        b = self.bias - mean * a
        return torch.addcmul(b[:, None, None], xf, a[:, None, None]).to(self.dtype)


def sync_batch_norm(module: nn.Module, group) -> None:
    """Make every :class:`BatchNorm` of ``module`` synchronous over ``group``
    (None: each rank's own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group


def batch_norm_state(module: nn.Module) -> list[torch.Tensor]:
    """The model state a training forward updates in place: every
    :class:`BatchNorm`'s running statistics and counter (JAX's
    ``batch_stats`` collection)."""
    return [t for m in module.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var, m.num_batches_tracked)]
