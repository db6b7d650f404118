"""VoteNet's PointNet++ set-abstraction modules
(``geot_tpu/models/backbone/pointnet2_votes.py``), channels-last: the
"Votes" SA variants, which also return the sampled indices, and the
learnable multi-scale feature propagation.

``mlp[0]`` is the reference's feature input width (without the 3 that
``use_xyz`` adds); flax infers the width, here the shared MLPs are built
from it: ``mlp[0] + 3`` with ``use_xyz`` for the grouped modules, ``mlp[0]
+ 3`` for ``_nogrouping`` (zeros stand in for the coordinates),
``post_mlp[0]`` for the propagation's post-MLP. Module names are the flax
ones (``mlp_module``, ``mlp_{i}``, ``post_mlp``). FPS is the port's
``ops.fps`` (the FPS kernel on a CUDA tensor); ball query and grouping are
plain PyTorch on both devices.

``sample_uniformly`` refills a ball's duplicate slots with its unique
indices, ascending and cycled (``unique_fill``), as ``geot_tpu`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops import ball_query, fps, gather_points, grouping_operation
from ..layers.common import SharedMLP

_BIG = 2 ** 30


def unique_fill(idx: torch.Tensor):
    """idx (B, M, K) -> (filled, unique_cnt): ``filled[..., :u]`` the
    unique indices ascending, the other slots cycling through them;
    ``unique_cnt`` u per ball, int32."""
    s = torch.sort(idx, dim=-1).values
    isnew = torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool),
                       s[..., 1:] != s[..., :-1]], dim=-1)
    unique_cnt = isnew.sum(dim=-1).to(torch.int32)
    uniques = torch.sort(torch.where(isnew, s, torch.full_like(s, _BIG)),
                         dim=-1).values
    k = torch.arange(idx.shape[-1], dtype=torch.int32, device=idx.device)
    slot = (k % unique_cnt[..., None]).long()
    return torch.gather(uniques, -1, slot).to(torch.int32), unique_cnt


def _pool(new_features, grouped_xyz, pooling: str, sigma, nsample):
    """Pool (B, M, K, C) over the neighbours: max, avg, or an RBF of the
    (centred, normalised) grouped coordinates summed over ``nsample``."""
    if pooling == "max":
        return new_features.amax(dim=2)
    if pooling == "avg":
        return new_features.mean(dim=2)
    if pooling == "rbf":
        rbf = torch.exp(-(grouped_xyz ** 2).sum(-1) / (sigma ** 2) / 2)
        return (new_features * rbf[..., None]).sum(dim=2) / float(nsample)
    raise ValueError(f"unknown pooling {pooling!r}")


def _grouped(xyz, new_xyz, features, radius, nsample, sample_uniformly,
             use_xyz, normalize_xyz=False):
    idx = ball_query(radius, nsample, xyz, new_xyz)
    unique_cnt = None
    if sample_uniformly:
        idx, unique_cnt = unique_fill(idx)
    grouped_xyz = grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    grouped = (grouping_operation(features, idx) if features is not None
               else None)
    if use_xyz:
        grouped = (grouped_xyz if grouped is None
                   else torch.cat([grouped_xyz, grouped], dim=-1))
    return grouped_xyz, grouped, unique_cnt


def _fps(xyz, npoint):
    return fps(xyz.float().contiguous(), npoint)


class _VotesBase(nn.Module):
    def __init__(self, mlp: Sequence[int], npoint: Optional[int] = None,
                 radius: Optional[float] = None,
                 nsample: Optional[int] = None, use_xyz: bool = True,
                 pooling: str = "max", sigma: Optional[float] = None,
                 normalize_xyz: bool = False, sample_uniformly: bool = False,
                 ret_unique_cnt: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz, self.pooling = use_xyz, pooling
        self.sigma = sigma if sigma is not None else (
            radius / 2 if radius is not None else None)
        self.normalize_xyz = normalize_xyz
        self.sample_uniformly = sample_uniformly
        self.ret_unique_cnt = ret_unique_cnt
        self.mlp_module = SharedMLP([self.in_width(mlp)] + list(mlp[1:]))

    def in_width(self, mlp: Sequence[int]) -> int:
        """The shared MLP's input width: the features and, with
        ``use_xyz``, the 3 coordinates."""
        return mlp[0] + 3 * bool(self.use_xyz)


class PointnetSAModuleVotes(_VotesBase):
    """Single-scale SA: FPS to ``npoint`` (or the given ``inds``), ball
    query, grouping, shared MLP, pooling; ``npoint=None`` groups the whole
    cloud. Returns ``(new_xyz, new_features, inds)``, and ``unique_cnt``
    with ``ret_unique_cnt``."""

    def forward(self, xyz, features=None, inds=None):
        unique_cnt = None
        if self.npoint is not None:
            if inds is None:
                inds = _fps(xyz, self.npoint)
            new_xyz = gather_points(xyz, inds)
            grouped_xyz, grouped, unique_cnt = _grouped(
                xyz, new_xyz, features, self.radius, self.nsample,
                self.sample_uniformly, self.use_xyz, self.normalize_xyz)
        else:
            new_xyz = None
            grouped_xyz = xyz[:, None]
            grouped = features[:, None] if features is not None else None
            if self.use_xyz:
                grouped = (grouped_xyz if grouped is None
                           else torch.cat([grouped_xyz, grouped], dim=-1))
        new_features = _pool(self.mlp_module(grouped), grouped_xyz,
                             self.pooling, self.sigma, self.nsample)
        if not self.ret_unique_cnt:
            return new_xyz, new_features, inds
        return new_xyz, new_features, inds, unique_cnt


class PointnetSAModuleVotes_nofps(_VotesBase):
    """SA on a neighbourhood grouped upstream: ``xyz`` is the grouped
    (B, npoint, nsample, C) tensor, C = ``mlp[0]`` + 3 with ``use_xyz``;
    ``new_xyz`` echoes it, and ``unique_cnt`` echoes the grouped tensor."""

    def forward(self, xyz, features=None, inds=None):
        new_features = _pool(self.mlp_module(xyz), xyz, self.pooling,
                             self.sigma, self.nsample)
        if not self.ret_unique_cnt:
            return xyz, new_features, inds
        return xyz, new_features, inds, xyz


class PointnetSAModuleVotes_nogrouping(_VotesBase):
    """SA without a neighbourhood: FPS, then the shared MLP pointwise on
    ``[zeros(3), features]`` (features already at the sampled
    resolution)."""

    def in_width(self, mlp: Sequence[int]) -> int:
        return mlp[0] + 3

    def forward(self, xyz, features, inds=None):
        if inds is None:
            inds = _fps(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds) if self.npoint is not None \
            else None
        new_features = self.mlp_module(torch.cat(
            [torch.zeros_like(new_xyz), features], dim=-1))
        if not self.ret_unique_cnt:
            return new_xyz, new_features, inds
        return new_xyz, new_features, inds, None


class PointnetSAModuleMSGVotes(nn.Module):
    """Multi-scale SA with index passthrough: one FPS, then per scale ball
    query, grouping, shared MLP ``mlp_{i}`` and max-pool; concatenated."""

    def __init__(self, mlps: Sequence[Sequence[int]],
                 npoint: Optional[int] = None, radii: Sequence[float] = (),
                 nsamples: Sequence[int] = (), use_xyz: bool = True,
                 sample_uniformly: bool = False):
        super().__init__()
        assert len(mlps) == len(radii) == len(nsamples)
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.use_xyz, self.sample_uniformly = use_xyz, sample_uniformly
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp_{i}", SharedMLP(
                [mlp[0] + 3 * bool(use_xyz)] + list(mlp[1:])))

    def forward(self, xyz, features=None, inds=None):
        if inds is None:
            inds = _fps(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds) if self.npoint is not None \
            else None
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            _, grouped, _ = _grouped(xyz, new_xyz, features, radius, nsample,
                                     self.sample_uniformly, self.use_xyz)
            outs.append(getattr(self, f"mlp_{i}")(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), inds


class PointnetLFPModuleMSG(nn.Module):
    """Learnable multi-scale propagation from ``xyz1`` onto ``xyz2``: per
    scale, ``features1`` ball-grouped at the ``xyz2`` queries, shared MLP
    ``mlp_{i}`` and max-pool, ``features2`` appended, then the one
    ``post_mlp`` (input ``post_mlp[0]``); scales concatenated."""

    def __init__(self, mlps: Sequence[Sequence[int]],
                 radii: Sequence[float] = (), nsamples: Sequence[int] = (),
                 post_mlp: Sequence[int] = (), use_xyz: bool = True,
                 sample_uniformly: bool = False):
        super().__init__()
        assert len(mlps) == len(radii) == len(nsamples)
        self.radii, self.nsamples = radii, nsamples
        self.use_xyz, self.sample_uniformly = use_xyz, sample_uniformly
        self.post_mlp = SharedMLP(list(post_mlp))
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp_{i}", SharedMLP(
                [mlp[0] + 3 * bool(use_xyz)] + list(mlp[1:])))

    def forward(self, xyz2, xyz1, features2, features1):
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            _, grouped, _ = _grouped(xyz1, xyz2, features1, radius, nsample,
                                     self.sample_uniformly, self.use_xyz)
            f = getattr(self, f"mlp_{i}")(grouped).amax(dim=2)
            if features2 is not None:
                f = torch.cat([f, features2], dim=-1)
            outs.append(self.post_mlp(f))
        return torch.cat(outs, dim=-1)
