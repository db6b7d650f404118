"""Local aggregation (``geot_tpu/models/layers/local_aggregation.py``).

``LocalAggregation`` is the ``convpool`` operator: group the support
around each query, assemble the neighbourhood features of
``feature_type``, run a shared pointwise MLP, reduce over the
neighbourhood; with ``aggr_type="assa"`` (or ``feature_type="assa"``) it
is ``ASSA``, held as ``assa``. ``ASSA`` (ASSANet's anisotropic separable
set abstraction): pointwise pre-convs on the support features, the
neighbourhood's outer product with its 3 relative coordinates (3 x the
channels), the reduction, pointwise post-convs and a residual. Module
names are the flax ones (``pre_{i}``, ``pre_bn_{i}``, ``post_{i}``,
``post_bn_{i}``, ``skip``)."""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .common import BatchNorm, Dense, SharedMLP
from .group import create_grouper, get_aggregation_features

# feature_type -> input width of the shared MLP for C support channels
CHANNEL_MAP = {
    "fj": lambda x: x,
    "df": lambda x: x,
    "assa": lambda x: x * 3,
    "assa_dp": lambda x: x * 3 + 3,
    "dp_fj": lambda x: 3 + x,
    "pj": lambda x: x,
    "dp": lambda x: 3,
    "pi_dp": lambda x: x + 3,
    "pj_dp": lambda x: x + 3,
    "dp_fj_df": lambda x: x * 2 + 3,
    "dp_fi_df": lambda x: x * 2 + 3,
    "pi_dp_fj_df": lambda x: x * 2 + 6,
    "pj_dp_fj_df": lambda x: x * 2 + 6,
    "pj_dp_df": lambda x: x + 6,
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


class ASSA(nn.Module):
    """``channels`` are the convs' output widths (the input's,
    ``in_channels``, excluded): the first ceil(len / 2) are pre-convs, the
    last of them cut to ceil(c / 3) so that the outer product with the 3
    coordinates restores about c; the rest are post-convs, the last one
    without ReLU when ``use_res``. The residual is the pre-convs' output
    at the first M support points (through ``skip`` when the widths
    differ)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 group_args: Dict[str, Any], reduction: str = "mean",
                 use_res: bool = True):
        super().__init__()
        chans = list(channels)
        self.num_pre = math.ceil(len(chans) / 2)
        pre = chans[:self.num_pre]
        pre[-1] = math.ceil(pre[-1] / 3.0)
        self.post = chans[self.num_pre:]
        self.reduction = reduction
        self.use_res = use_res
        self.grouper = create_grouper(group_args)
        width = in_channels
        for i, c in enumerate(pre):
            self.add_module(f"pre_{i}", Dense(width, c, bias=False))
            self.add_module(f"pre_bn_{i}", BatchNorm(c))
            width = c
        skip_width = width
        width *= 3
        for i, c in enumerate(self.post):
            self.add_module(f"post_{i}", Dense(width, c, bias=False))
            self.add_module(f"post_bn_{i}", BatchNorm(c))
            width = c
        self.skip = (Dense(skip_width, width, bias=False)
                     if use_res and skip_width != width else None)

    def forward(self, query_xyz, support_xyz, support_features):
        f = support_features
        for i in range(self.num_pre):
            f = F.relu(getattr(self, f"pre_bn_{i}")(
                getattr(self, f"pre_{i}")(f)))
        skip = f[:, :query_xyz.shape[1]]
        dp, fj = self.grouper(query_xyz, support_xyz, f)
        fj = fj[..., None, :] * dp[..., :, None]           # (B, M, K, 3, C')
        out = _reduce(fj.reshape(*fj.shape[:3], -1), self.reduction)
        for i in range(len(self.post)):
            out = getattr(self, f"post_bn_{i}")(getattr(self, f"post_{i}")(out))
            if not (self.use_res and i == len(self.post) - 1):
                out = F.relu(out)
        if self.use_res:
            if self.skip is not None:
                skip = self.skip(skip)
            out = F.relu(out + skip)
        return out


class LocalAggregation(nn.Module):
    """``convs`` is the shared MLP from ``CHANNEL_MAP[feature_type]
    (in_channels)`` through ``channels``; ``aggr_type="assa"`` (or
    ``feature_type="assa"``) runs ``ASSA`` instead."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 group_args: Dict[str, Any], feature_type: str = "dp_fj",
                 reduction: str = "max", aggr_type: str = "convpool",
                 use_res: bool = True):
        super().__init__()
        self.feature_type = feature_type
        self.reduction = reduction
        if aggr_type.lower() == "assa" or feature_type == "assa":
            self.assa = ASSA(in_channels, channels, group_args, reduction,
                             use_res)
            return
        self.assa = None
        self.grouper = create_grouper(group_args)
        self.convs = SharedMLP([CHANNEL_MAP[feature_type](in_channels)]
                               + list(channels))

    def forward(self, query_xyz, support_xyz, support_features):
        if self.assa is not None:
            return self.assa(query_xyz, support_xyz, support_features)
        dp, fj = self.grouper(query_xyz, support_xyz, support_features)
        f_center = None
        if "df" in self.feature_type or "fi" in self.feature_type:
            # the support features of the first M points stand for the
            # queries' own, as in geot_tpu
            f_center = support_features[:, :query_xyz.shape[1]]
        fj = get_aggregation_features(query_xyz, dp, f_center, fj,
                                      self.feature_type)
        return _reduce(self.convs(fj), self.reduction)
