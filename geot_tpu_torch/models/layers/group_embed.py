"""Tokenizers: a point cloud -> subsampled groups
(``geot_tpu/models/layers/group_embed.py``).

- ``SubsampleGroup``: FPS subsample + ball-query or kNN grouping (the
  cls-token encoders' and the patch embeddings' grouper);
- ``GroupTokenizer``: the Point Transformer backbones' FPS centers + kNN
  neighbourhoods less their center.

Both hold no parameters, so they are plain classes. FPS reads float32
coordinates whatever the dtype (the kernel's contract), through
``geot::fps``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops import fps, gather_points, grouping_operation, knn
from .group import KNNGroup, QueryAndGroup


def _fps_idx(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return fps(xyz.float().contiguous(), npoint)


class SubsampleGroup:
    """``num_groups`` FPS centers, each with ``group_size`` neighbours by
    ball query (``group`` "ballquery", within ``radius``) or kNN ("knn").
    ``__call__(p)`` returns ``(grouped_p (B, G, K, 3) relative to the
    center, center_p (B, G, 3))``; ``__call__(p, x)`` also the neighbours'
    features and the centers' ``(grouped_p, center_p, fj, center_x)``."""

    def __init__(self, num_groups: int = 256, group_size: int = 32,
                 subsample: str = "fps", group: str = "ballquery",
                 radius: float = 0.1, **kwargs):
        self.num_groups = num_groups
        self.group_size = group_size
        self.subsample = subsample.lower()
        if not any(s in self.subsample
                   for s in ("fps", "furthest", "farthest")):
            raise NotImplementedError(subsample)
        if "ball" in group.lower() or "query" in group.lower():
            self.grouper = QueryAndGroup(radius, group_size)
        elif "knn" in group.lower():
            self.grouper = KNNGroup(group_size)
        else:
            raise NotImplementedError(group)

    def __call__(self, p: torch.Tensor, x: Optional[torch.Tensor] = None):
        p = p.contiguous()
        idx = _fps_idx(p, self.num_groups)
        center_p = gather_points(p, idx)
        if x is not None:
            grouped_p, fj = self.grouper(center_p, p, x)
            return grouped_p, center_p, fj, gather_points(x, idx)
        grouped_p, _ = self.grouper(center_p, p)
        return grouped_p, center_p


class GroupTokenizer:
    """FPS centers + their ``group_size`` nearest points, less the center.

    ``__call__(xyz)`` returns ``(neighborhood (B, G, K, 3), center (B, G,
    3), idx (B, G, K))`` as ``geot_tpu``'s. ``group(xyz, fps_pts)`` takes
    the centers as the first ``num_group`` rows of ``fps_pts`` (the
    flagship's one FPS run, whose prefixes also give its decoder pyramid)
    and returns the same three."""

    def __init__(self, num_group: int, group_size: int):
        self.num_group = num_group
        self.group_size = group_size

    def group(self, xyz: torch.Tensor, fps_pts: torch.Tensor):
        center = fps_pts[:, :self.num_group]
        _, idx = knn(center, xyz, self.group_size)               # (B, G, K)
        neighborhood = grouping_operation(xyz, idx) - center[:, :, None, :]
        return neighborhood, center, idx

    def __call__(self, xyz: torch.Tensor):
        xyz = xyz.contiguous()
        return self.group(xyz, gather_points(xyz, _fps_idx(xyz,
                                                           self.num_group)))
