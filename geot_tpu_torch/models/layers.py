"""Building blocks of the flagship model, channels-last
(``geot_tpu/models/layers/common.py``).

Pointwise ``Conv1d``/``Conv2d`` of the reference are ``nn.Linear`` on the
last axis. Normalisations take channels-last input too. Dropout and
DropPath are identity at eval and take their masks from an explicit
``torch.Generator`` in training.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor; eps 1e-5.

    Training mode normalises with the batch's biased variance and updates
    the running statistics as flax ``nn.BatchNorm(momentum=0.9)`` does
    (``geot_tpu/models/layers/common.py:59-69``): ``running = 0.9 * running
    + 0.1 * batch`` with the BIASED batch variance, where torch's own
    ``BatchNorm1d`` would take the unbiased one. Eval mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if not self.training:
            return super().forward(x2).reshape(shape)
        mean = x2.mean(dim=0)
        var = ((x2 * x2).mean(dim=0) - mean * mean).clamp_min(0.0)
        y = (x2 - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked += 1
        return y.reshape(shape)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over a channels-last (B, ..., C) tensor: statistics per
    sample and group over every non-batch axis, like flax ``GroupNorm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xg = x.reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class DropPath(nn.Module):
    """Per-sample stochastic depth (``common.py:DropPath``); identity at
    eval. Masks come from ``generator`` (torch's default generator when it
    is None)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return _keep_mask(x, (x.shape[0],) + (1,) * (x.dim() - 1),
                          1.0 - self.rate, generator)


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``); identity at eval. Masks
    come from ``generator`` (torch's default generator when it is None)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return _keep_mask(x, x.shape, 1.0 - self.rate, generator)


def _keep_mask(x, shape, keep, generator):
    """Keep with probability ``keep`` and scale by 1 / keep, as flax does."""
    mask = torch.rand(shape, dtype=x.dtype, device=x.device,
                      generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MlpBlock(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> fc2 (the flagship's dropout
    rate here is 0)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _BN(nn.Module):
    """Holds ``bn`` so parameter names read ``layer{i}.bn.bn.*`` as in the
    reference SharedMLP state_dict."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class _SharedMLPLayer(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Linear(cin, cout, bias=False)
        self.bn = _BN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Module):
    """Pointwise Linear (no bias) + BN + ReLU per layer; ``channels`` are
    [in, out_0, out_1, ...]."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}",
                            _SharedMLPLayer(channels[i], channels[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
        return x
