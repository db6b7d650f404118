"""three_nn / three_interpolate: inverse-distance-weighted 3-NN feature
propagation (``geot_tpu/ops/interpolate.py:17-60``)."""
from __future__ import annotations

import torch

from .group import gather_points
from .knn import knn


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(B, n, 3), (B, m, 3) -> dist (B, n, 3) euclidean ascending,
    idx (B, n, 3) int32."""
    return knn(unknown, known, 3, squared=False)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, m, C), idx (B, n, 3), weight (B, n, 3) -> (B, n, C)."""
    w = weight.to(features.dtype)
    out = None
    for j in range(idx.shape[-1]):
        term = gather_points(features, idx[..., j]) * w[..., j:j + 1]
        out = term if out is None else out + term
    return out


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_features: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """3-NN + inverse-distance weights + interpolate. The search runs in
    float32; the weights in float32 or the features' dtype if wider."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    dist = dist.to(torch.promote_types(dist.dtype, known_features.dtype))
    dist_recip = 1.0 / (dist + eps)
    norm = dist_recip.sum(dim=2, keepdim=True)
    return three_interpolate(known_features, idx, dist_recip / norm)
