"""Point patch embeddings (``geot_tpu/models/layers/patch_embed.py``): a
cloud -> subsampled groups -> a shared MLP per neighbour -> a token per
group (the max over its neighbours).

The shared MLP's input width is fixed when the module is built, where
``geot_tpu`` infers it from the first call: ``in_channels`` is the width
of the features ``x`` the module is called with (0 for a call with
positions only), so the first layer takes 3 + ``in_channels`` (the
neighbours' relative xyz, then their features).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...core.config import register_model
from .common import SharedMLP
from .group_embed import SubsampleGroup


@register_model("PointPatchEmbed")
class PointPatchEmbed(nn.Module):
    """FPS to ``sample_ratio`` of the points, ball-query or kNN groups of
    ``group_size``, ``convs`` (a ``SharedMLP`` of ``channels``) and the
    max over each group. ``forward(p, x=None)`` (or a dict with ``pos``
    and ``x``) returns ``(tokens (B, G, channels[-1]), centers (B, G,
    3))``."""

    def __init__(self, sample_ratio: float = 0.0625, group_size: int = 32,
                 in_channels: int = 0, channels: Sequence[int] = (128, 256),
                 subsample: str = "fps", group: str = "knn",
                 radius: float = 0.1, feature_type: str = "dp_fj"):
        super().__init__()
        self.sample_ratio = sample_ratio
        self.in_channels = int(in_channels)
        self.group_args = (group_size, subsample, group, radius)
        self.convs = SharedMLP([3 + self.in_channels] + list(channels))
        self.out_channels = list(channels)[-1]

    def forward(self, p, x: Optional[torch.Tensor] = None):
        if isinstance(p, dict):
            p, x = p["pos"], p.get("x")
        width = 0 if x is None else x.shape[-1]
        if width != self.in_channels:
            raise ValueError(f"PointPatchEmbed built for features of width "
                             f"{self.in_channels} (in_channels), called "
                             f"with {width}")
        num_groups = max(int(p.shape[1] * self.sample_ratio), 1)
        grouper = SubsampleGroup(num_groups, *self.group_args)
        if x is None:
            feats, center = grouper(p)            # (B, G, K, 3) relative
        else:
            grouped_p, center, fj, _ = grouper(p, x)
            feats = torch.cat([grouped_p, fj], dim=-1)
        return self.convs(feats).amax(dim=2), center


@register_model("P3Embed")
class P3Embed(nn.Module):
    """``stages`` ``PointPatchEmbed`` stages (``stage_{s}``), each on the
    last one's centers and tokens, with one layer of ``channels[s]`` (the
    last width repeated past the list). The first stage's features are
    ``x``, or the positions themselves without ``x``: ``in_channels`` is
    their width. Returns ``(tokens, centers)`` of the last stage."""

    def __init__(self, stages: int = 3, sample_ratio: float = 0.25,
                 group_size: int = 32,
                 channels: Sequence[int] = (64, 128, 256),
                 in_channels: int = 3):
        super().__init__()
        self.stages = stages
        width = in_channels
        for s in range(stages):
            c = channels[min(s, len(channels) - 1)]
            self.add_module(f"stage_{s}", PointPatchEmbed(
                sample_ratio=sample_ratio, group_size=group_size,
                in_channels=width, channels=(c,)))
            width = c
        self.out_channels = width

    def forward(self, p, x: Optional[torch.Tensor] = None):
        if isinstance(p, dict):
            p, x = p["pos"], p.get("x")
        feats = x if x is not None else p
        for s in range(self.stages):
            feats, p = getattr(self, f"stage_{s}")(p, feats)
        return feats, p
