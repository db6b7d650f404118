"""Grouping layers, channels-last (``geot_tpu/models/layers/group.py``):
a grouper returns ``grouped_xyz (B, M, K, 3)`` and ``grouped_features
(B, M, K, C)``."""
from __future__ import annotations

import copy

import torch

from ...ops import ball_query, grouping_operation, knn


class QueryAndGroup:
    """Ball-query grouping: the first ``nsample`` support points within
    ``radius`` of each query, their xyz relative to it (over ``radius``
    with ``normalize_dp``)."""

    def __init__(self, radius: float, nsample: int, relative_xyz: bool = True,
                 normalize_dp: bool = False, return_only_idx: bool = False,
                 **kwargs):
        self.radius = radius
        self.nsample = nsample
        self.relative_xyz = relative_xyz
        self.normalize_dp = normalize_dp
        self.return_only_idx = return_only_idx

    def __call__(self, query_xyz, support_xyz, features=None):
        idx = ball_query(self.radius, self.nsample, support_xyz, query_xyz)
        if self.return_only_idx:
            return idx
        grouped_xyz = grouping_operation(support_xyz, idx)
        if self.relative_xyz:
            grouped_xyz = grouped_xyz - query_xyz[:, :, None, :]
            if self.normalize_dp:
                grouped_xyz = grouped_xyz / self.radius
        grouped_features = (grouping_operation(features, idx)
                            if features is not None else None)
        return grouped_xyz, grouped_features


class KNNGroup:
    """kNN grouping: the ``nsample`` nearest support points of each query;
    ``normalize_dp`` divides by each cloud's largest neighbour distance."""

    def __init__(self, nsample: int, relative_xyz: bool = True,
                 normalize_dp: bool = False, return_only_idx: bool = False,
                 **kwargs):
        self.nsample = nsample
        self.relative_xyz = relative_xyz
        self.normalize_dp = normalize_dp
        self.return_only_idx = return_only_idx

    def __call__(self, query_xyz, support_xyz, features=None):
        _, idx = knn(query_xyz, support_xyz, self.nsample)
        if self.return_only_idx:
            return idx
        grouped_xyz = grouping_operation(support_xyz, idx)
        if self.relative_xyz:
            grouped_xyz = grouped_xyz - query_xyz[:, :, None, :]
        if self.normalize_dp:
            norm = (grouped_xyz ** 2).sum(-1).sqrt()
            grouped_xyz = grouped_xyz / norm.amax(dim=(1, 2))[:, None, None,
                                                              None]
        grouped_features = (grouping_operation(features, idx)
                            if features is not None else None)
        return grouped_xyz, grouped_features


class GroupAll:
    """One group holding the whole cloud."""

    def __call__(self, new_xyz, xyz, features=None):
        return (xyz[:, None], features[:, None] if features is not None
                else None)


def get_aggregation_features(p, dp, f, fj, feature_type: str = "dp_fj"):
    """The neighbourhood features of ``feature_type``: p (B, M, 3), dp
    (B, M, K, 3), f (B, M, C), fj (B, M, K, C)."""
    if feature_type == "dp_fj":
        return torch.cat([dp, fj], dim=-1)
    if feature_type == "dp_fj_df":
        return torch.cat([dp, fj, fj - f[:, :, None, :]], dim=-1)
    if feature_type == "pi_dp_fj_df":
        pi = p[:, :, None, :].expand(*dp.shape[:3], p.shape[-1])
        return torch.cat([pi, dp, fj, fj - f[:, :, None, :]], dim=-1)
    if feature_type == "dp_df":
        return torch.cat([dp, fj - f[:, :, None, :]], dim=-1)
    raise ValueError(f"unknown feature_type {feature_type}")


def create_grouper(group_args):
    """``NAME`` ballquery (default) or knn with ``radius`` and ``nsample``;
    ``nsample: None`` groups the whole cloud."""
    args = copy.deepcopy(dict(group_args))
    method = args.pop("NAME", "ballquery")
    radius = args.pop("radius", 0.1)
    nsample = args.pop("nsample", 20)
    if nsample is None:
        return GroupAll()
    if method == "ballquery":
        return QueryAndGroup(radius, nsample, **args)
    if method == "knn":
        return KNNGroup(nsample, **args)
    raise ValueError(f"unknown grouper {method}")
