"""The reference's op APIs over the port's ops (``geot_tpu/ops/compat.py``),
so reference call sites run unchanged:

- ``pointops``: the top-level ``pointops`` API (``knn``, ``fps``,
  ``fps_weight``, ``index_points``);
- ``openpoints_pointops``: its ``openpoints`` superset (``queryandgroup``,
  ``querygroup``, ``interpolation``, ``subtraction``, ``aggregation``) on
  dense batches; ``offset`` arguments are taken and ignored, and 2-D inputs
  are one batch and come back 2-D;
- ``pointnet2_utils``: the ``pointnet2.pointnet2_utils`` API, features
  channels-first (B, C, N) as in the reference.

Each call goes through the port's ops: on a CUDA tensor ``fps`` and
``furthest_point_sample`` launch ``geot::fps``, and a search with k <= 4 on
xyz with at least 128 queries (``knn``, ``three_nn``, ``interpolation``
at k = 3) launches ``geot::knn_small_k``. Larger k, ball query, weighted
FPS and the gathers are plain PyTorch on both devices, as ``geot_tpu``
computes them in XLA.
"""
from __future__ import annotations

import torch

from .ball_query import ball_query as _ball_query
from .fps import fps as _fps
from .fps import fps_weighted as _fps_weighted
from .group import gather_points as _gather
from .group import grouping_operation as _group
from .group import index_points as _index_points
from .interpolate import three_interpolate as _three_interp
from .interpolate import three_interpolation as _three_interpolation
from .interpolate import three_nn as _three_nn
from .knn import knn as _knn
from .vector_attn import aggregation as _aggregation
from .vector_attn import subtraction as _subtraction


def _xyz(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous()


class pointops:
    """The top-level ``pointops`` API."""

    @staticmethod
    def knn(x, src, k, transpose=False):
        """(idx, squared dists) of each x point's k nearest in src;
        ``transpose`` takes channels-first (B, 3, N) inputs."""
        if transpose:
            x, src = x.transpose(1, 2), src.transpose(1, 2)
        d, i = _knn(x, src, k, squared=True)
        return i, d

    @staticmethod
    def fps(x, k):
        """(B, N, 3) -> the sampled coordinates (B, k, 3)."""
        return _gather(x, _fps(_xyz(x), k))

    @staticmethod
    def fps_weight(x, k, weight=None):
        assert weight is not None, \
            "the weight should be defined if using weighted fps"
        return _gather(x, _fps_weighted(x, weight, k))

    @staticmethod
    def index_points(points, idx):
        return _index_points(points, idx)


class openpoints_pointops(pointops):
    """The ``openpoints`` ``pointops`` helpers on dense (B, n, ...) batches;
    a 2-D first input is one cloud, and the result comes back without the
    batch axis."""

    @staticmethod
    def _batched(*arrs):
        squeeze = arrs[0] is not None and arrs[0].dim() == 2
        return squeeze, tuple(a[None] if (a is not None and squeeze) else a
                              for a in arrs)

    @staticmethod
    def queryandgroup(nsample, xyz, new_xyz, feat, idx=None, offset=None,
                      new_offset=None, use_xyz=True):
        """Each new_xyz point's kNN neighbourhood: relative coordinates and
        (with ``use_xyz``) the features after them, channels-last
        (..., m, nsample, 3 + c)."""
        squeeze, (xyz, new_xyz, feat) = openpoints_pointops._batched(
            xyz, new_xyz, feat)
        if new_xyz is None:
            new_xyz = xyz
        if idx is None:
            _, idx = _knn(new_xyz, xyz, nsample)
        elif idx.dim() == 2:
            idx = idx[None]
        out = _group(xyz, idx) - new_xyz[:, :, None, :]
        if feat is not None:
            grouped_feat = _group(feat, idx)
            out = (torch.cat([out, grouped_feat], dim=-1) if use_xyz
                   else grouped_feat)
        return out[0] if squeeze else out

    @staticmethod
    def querygroup(nsample, xyz, new_xyz, feat, offset=None, new_offset=None,
                   radius=None, query_method="knn", normalize_dp=False,
                   idx=None):
        """kNN or ball query and grouping: ``(grouped_xyz, grouped_feat)``;
        ``normalize_dp`` divides the relative coordinates by each group's
        largest norm (kNN, + 1e-8) or by the radius."""
        squeeze, (xyz, new_xyz, feat) = openpoints_pointops._batched(
            xyz, new_xyz, feat)
        if new_xyz is None:
            new_xyz = xyz
        by_knn = query_method in ("knn", "knnquery")
        if idx is None:
            idx = (_knn(new_xyz, xyz, nsample)[1] if by_knn
                   else _ball_query(radius, nsample, xyz, new_xyz))
        elif idx.dim() == 2:
            idx = idx[None]
        grouped_xyz = _group(xyz, idx) - new_xyz[:, :, None, :]
        if normalize_dp:
            if by_knn:
                max_dist = torch.linalg.vector_norm(
                    grouped_xyz, dim=-1, keepdim=True).amax(
                        dim=-2, keepdim=True) + 1e-8
            else:
                max_dist = radius
            grouped_xyz = grouped_xyz / max_dist
        grouped_feat = _group(feat, idx) if feat is not None else None
        if squeeze:
            return grouped_xyz[0], (None if grouped_feat is None
                                    else grouped_feat[0])
        return grouped_xyz, grouped_feat

    @staticmethod
    def interpolation(xyz, new_xyz, feat, offset=None, new_offset=None, k=3):
        """Inverse-distance kNN interpolation of ``feat`` at xyz onto
        new_xyz; k = 3 is ``three_interpolation``."""
        squeeze, (xyz, new_xyz, feat) = openpoints_pointops._batched(
            xyz, new_xyz, feat)
        if k == 3:
            out = _three_interpolation(new_xyz, xyz, feat)
        else:
            dist, idx = _knn(new_xyz, xyz, k)
            w = 1.0 / (dist + 1e-8)
            w = w / w.sum(dim=-1, keepdim=True)
            out = (_group(feat, idx) * w[..., None].to(feat.dtype)).sum(dim=2)
        return out[0] if squeeze else out

    @staticmethod
    def subtraction(feat1, feat2, idx):
        return _subtraction(feat1, feat2, idx)

    @staticmethod
    def aggregation(feat, weight, idx):
        return _aggregation(feat, weight, idx)


class pointnet2_utils:
    """The ``pointnet2.pointnet2_utils`` API; feature tensors are
    channels-first (B, C, N)."""

    @staticmethod
    def furthest_point_sample(xyz, npoint):
        return _fps(_xyz(xyz), npoint)

    @staticmethod
    def gather_operation(features, idx):
        """features (B, C, N), idx (B, M) -> (B, C, M)."""
        return _gather(features.transpose(1, 2), idx).transpose(1, 2)

    @staticmethod
    def three_nn(unknown, known):
        return _three_nn(unknown, known)

    @staticmethod
    def three_interpolate(features, idx, weight):
        """features (B, C, m) -> (B, C, n)."""
        return _three_interp(features.transpose(1, 2), idx,
                             weight).transpose(1, 2)

    @staticmethod
    def grouping_operation(features, idx):
        """features (B, C, N), idx (B, M, K) -> (B, C, M, K)."""
        return _group(features.transpose(1, 2), idx).permute(0, 3, 1, 2)

    @staticmethod
    def ball_query(radius, nsample, xyz, new_xyz):
        return _ball_query(radius, nsample, xyz, new_xyz)
