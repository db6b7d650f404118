"""Local aggregation, the ``convpool`` operator
(``geot_tpu/models/layers/local_aggregation.py:97``): group the support
around each query, assemble the neighbourhood features of
``feature_type``, run a shared pointwise MLP, reduce over the
neighbourhood."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from .common import SharedMLP
from .group import create_grouper, get_aggregation_features

# feature_type -> input width of the shared MLP for C support channels,
# for the types get_aggregation_features assembles
CHANNEL_MAP = {
    "dp_fj": lambda x: 3 + x,
    "dp_fj_df": lambda x: x * 2 + 3,
    "pi_dp_fj_df": lambda x: x * 2 + 6,
    "dp_df": lambda x: x + 3,
}


def _reduce(fj: torch.Tensor, reduction: str, dim: int = 2) -> torch.Tensor:
    if reduction in ("max", "maxpool"):
        return fj.amax(dim=dim)
    if reduction in ("mean", "avg"):
        return fj.mean(dim=dim)
    if reduction == "sum":
        return fj.sum(dim=dim)
    raise ValueError(reduction)


class LocalAggregation(nn.Module):
    """``convs`` is the shared MLP from ``CHANNEL_MAP[feature_type]
    (in_channels)`` through ``channels``. The ASSA operator is not
    ported."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 group_args: Dict[str, Any], feature_type: str = "dp_fj",
                 reduction: str = "max"):
        super().__init__()
        self.grouper = create_grouper(group_args)
        self.feature_type = feature_type
        self.reduction = reduction
        self.convs = SharedMLP([CHANNEL_MAP[feature_type](in_channels)]
                               + list(channels))

    def forward(self, query_xyz, support_xyz, support_features):
        dp, fj = self.grouper(query_xyz, support_xyz, support_features)
        f_center = None
        if "df" in self.feature_type or "fi" in self.feature_type:
            # the support features of the first M points stand for the
            # queries' own, as in geot_tpu
            f_center = support_features[:, :query_xyz.shape[1]]
        fj = get_aggregation_features(query_xyz, dp, f_center, fj,
                                      self.feature_type)
        return _reduce(self.convs(fj), self.reduction)
