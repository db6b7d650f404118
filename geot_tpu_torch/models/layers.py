"""Building blocks of the flagship model, channels-last
(``geot_tpu/models/layers/common.py``).

Pointwise ``Conv1d``/``Conv2d`` of the reference are ``nn.Linear`` on the
last axis. Normalisations take channels-last input too. Dropout and
DropPath are identity at eval.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor; eps 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)


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
    """Per-sample stochastic depth; identity at eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, dtype=x.dtype, device=x.device) < keep
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
