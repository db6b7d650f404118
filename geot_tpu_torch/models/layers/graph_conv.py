"""Graph convolutions (``geot_tpu/models/layers/graph_conv.py``),
channels-last: features (B, N, C), edge indices (B, N, K).

A layer's MLP is Dense (no bias) + BatchNorm + ReLU, held as ``nn`` with
``conv`` and ``bn`` (the flax names). ``MRConv`` aggregates ``max_k(x_j
- x_i)`` and runs the MLP on ``[x_i, aggregate]`` (DeepGCN's max-relative
conv); ``EdgeConv`` runs it on ``[x_i, x_j - x_i]`` per edge and takes the
max over neighbours. ``DynConv`` rebuilds the dilated kNN graph in feature
space at every call through the port's ``knn`` (k * d neighbours wider
than xyz: the exact int64 ``topk`` search, plain PyTorch on both devices,
as ``geot_tpu``'s is XLA). flax infers input widths; here they are
arguments."""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
import torch.nn.functional as F

from ...ops import grouping_operation
from .common import BatchNorm, Dense
from .knn import DilatedKNN


def gather_features(features: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """Channels-first: features (B, C, N, 1), indices (B, N, K) ->
    (B, C, N, K)."""
    out = grouping_operation(features[..., 0].transpose(1, 2), indices)
    return out.permute(0, 3, 1, 2)


class _ConvBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = Dense(in_channels, channels, bias=False)
        self.bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class MRConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nn = _ConvBlock(2 * in_channels, out_channels)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor):
        rel = (grouping_operation(x, edge_index) - x[:, :, None, :]).amax(2)
        return self.nn(torch.cat([x, rel], dim=-1))


class EdgeConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nn = _ConvBlock(2 * in_channels, out_channels)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor):
        x_j = grouping_operation(x, edge_index)
        xi = x[:, :, None, :].expand_as(x_j)
        return self.nn(torch.cat([xi, x_j - xi], dim=-1)).amax(dim=2)


_GCN_LAYERS = {"mrconv": MRConv, "edgeconv": EdgeConv, "edge": EdgeConv}


def _layer(conv: Any, in_channels: int, out_channels: int) -> nn.Module:
    cls = _GCN_LAYERS[conv] if isinstance(conv, str) else conv
    return cls(in_channels, out_channels)


class GraphConv(nn.Module):
    """A static graph conv, ``conv`` by name (mrconv, edgeconv, edge) or
    class, held as ``gconv``."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv: Any = "edge"):
        super().__init__()
        self.gconv = _layer(conv, in_channels, out_channels)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor):
        return self.gconv(x, edge_index)


class DynConv(nn.Module):
    """The dilated kNN graph of ``x`` in feature space (k * dilation
    neighbours, every dilation-th kept), then ``gconv``."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv: Any = "edge", k: int = 9, dilation: int = 1):
        super().__init__()
        self.knn = DilatedKNN(k, dilation)
        self.gconv = _layer(conv, in_channels, out_channels)

    def forward(self, x: torch.Tensor):
        _, edge_index = self.knn(x)
        return self.gconv(x, edge_index)


class ResDynBlock(nn.Module):
    """``body(x) + x``, ``body`` a ``DynConv`` of ``channels``."""

    def __init__(self, channels: int, conv: Any = "edge", k: int = 9,
                 dilation: int = 1):
        super().__init__()
        self.body = DynConv(channels, channels, conv, k, dilation)

    def forward(self, x: torch.Tensor):
        return self.body(x) + x


class DenseDynBlock(nn.Module):
    """``[x, body(x)]``, ``body`` a ``DynConv`` to ``out_channels -
    in_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv: Any = "edge", k: int = 9, dilation: int = 1):
        super().__init__()
        assert out_channels > in_channels, \
            "#out channels should be larger than #in channels"
        self.body = DynConv(in_channels, out_channels - in_channels, conv, k,
                            dilation)

    def forward(self, x: torch.Tensor):
        return torch.cat([x, self.body(x)], dim=-1)
