"""DGCNN backbone, channels-last (``geot_tpu/models/backbone/dgcnn.py:19-71``).

Edge convolutions over a kNN graph: the first (``head``) on the points'
xyz, each later one (``block_{i}``) on a graph rebuilt in the previous
block's feature space; the blocks' outputs are concatenated and fused to
``embed_dim``. Every search is the exact kNN of ``ops.knn`` (k > 4: the
tiled path, as in ``geot_tpu``), ties to the smaller index. Module names
follow the flax tree.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.config import MODELS
from ...ops import grouping_operation, knn
from ..layers import BatchNorm, Dense, LeakyReLU


class EdgeConv(nn.Module):
    """max over the k neighbours of LeakyReLU(0.2)(BN(Linear([x_i ; x_j -
    x_i])))."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = Dense(2 * in_channels, channels, bias=False)
        self.bn = BatchNorm(channels)
        self.act = LeakyReLU(0.2)

    def forward(self, feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        neigh = grouping_operation(feats, idx)               # (B, N, k, C)
        center = feats[:, :, None, :].expand_as(neigh)
        edge = torch.cat([center, neigh - center], dim=-1)
        return self.act(self.bn(self.conv(edge))).amax(dim=2)


@MODELS.register_module(name="DGCNN")
class DGCNN(nn.Module):
    """``n_blocks - 1`` edge convolutions of ``channels`` each, fused to
    ``embed_dim``; ``forward`` returns (B, N, embed_dim). ``is_seg`` is
    accepted and unread, as in ``geot_tpu``."""

    def __init__(self, in_channels: int = 3, channels: int = 64,
                 embed_dim: int = 1024, n_blocks: int = 5, k: int = 20,
                 is_seg: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.k = k
        self.n = n_blocks - 2
        self.head = EdgeConv(in_channels, channels)
        for i in range(self.n):
            self.add_module(f"block_{i}", EdgeConv(channels, channels))
        self.fusion = Dense(channels * (self.n + 1), embed_dim, bias=False)
        self.fusion_bn = BatchNorm(embed_dim)
        self.act = LeakyReLU(0.2)
        self.out_channels = embed_dim
        self.cls_channels = 2 * embed_dim

    def forward(self, pts, features=None):
        if features is None:
            features = pts
        if features.shape[-1] != self.in_channels:
            raise ValueError(f"DGCNN: features have {features.shape[-1]} "
                             f"channels, in_channels is {self.in_channels}")
        _, idx = knn(pts, pts, self.k)
        feats = [self.head(features, idx)]
        for i in range(self.n):
            _, fidx = knn(feats[-1], feats[-1], self.k)
            feats.append(getattr(self, f"block_{i}")(feats[-1], fidx))
        return self.act(self.fusion_bn(self.fusion(torch.cat(feats, -1))))

    def forward_seg_feat(self, pts, features=None):
        return pts, self(pts, features)

    def forward_cls_feat(self, pts, features=None):
        """The max and the mean over the points of the fused features,
        concatenated: (B, ``cls_channels``) = (B, 2 ``embed_dim``)."""
        fused = self(pts, features)
        return torch.cat([fused.amax(dim=1), fused.mean(dim=1)], dim=-1)


@MODELS.register_module(name="DGCNNGenEncoder")
class DGCNNGenEncoder(DGCNN):
    """DGCNN for the pretraining stage's generator
    (``geot_tpu/models/backbone/dgcnn.py:74``): ``forward_cls_feat``
    returns the per-point features and the points. It also takes the batch
    dict (``pos``, ``x``) that ``ViewGenBase`` passes."""

    def forward_cls_feat(self, pts, features: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        if isinstance(pts, dict):
            pts, features = pts["pos"], pts.get("x")
        return self(pts, features), pts
