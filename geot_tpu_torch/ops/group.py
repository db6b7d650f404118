"""Gather and grouping by index, channels-last
(``geot_tpu/ops/group.py:16-30``)."""
from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    idx = idx.long()
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def grouping_operation(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    B, M, K = idx.shape
    out = gather_points(points, idx.reshape(B, M * K))
    return out.reshape(B, M, K, points.shape[-1])


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pointops.index_points`` (``geot_tpu/ops/group.py:33``): idx
    (B, M) gathers (B, M, C), idx (B, M, K) groups (B, M, K, C)."""
    if idx.dim() == 2:
        return gather_points(points, idx)
    return grouping_operation(points, idx)


def torch_grouping_operation(features: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Channels-first grouping (``geot_tpu/ops/group.py:42``): features
    (B, C, N), idx (B, M, K) -> (B, C, M, K)."""
    out = grouping_operation(features.transpose(1, 2), idx)
    return out.permute(0, 3, 1, 2)
