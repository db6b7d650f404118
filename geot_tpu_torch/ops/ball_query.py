"""Ball query with first-hit padding (``geot_tpu/ops/ball_query.py``).

Plain PyTorch, as ``geot_tpu`` computes it in XLA outside any Pallas
kernel: for each query point, the first ``nsample`` support indices in
ascending index order whose squared distance is strictly below radius^2;
slots past the last hit repeat the first hit; a query with no hit gets
index 0 everywhere. "The first k valid indices" is the k smallest of the
valid indices (the others keyed 2^30), merged over support chunks so that
no (Q, N) block larger than (Q, ``chunk_size``) exists.
"""
from __future__ import annotations

import torch

from .knn import pairwise_dist2

_NONE = 2 ** 30          # key of a support point outside the ball


def ball_query(radius: float, nsample: int, support: torch.Tensor,
               query: torch.Tensor, chunk_size: int = 2048) -> torch.Tensor:
    """(B, N, 3) support, (B, M, 3) ball centres -> (B, M, nsample) int32
    indices; distances in float32 (argument order as the reference
    ``ball_query(radius, nsample, xyz, new_xyz)``)."""
    query = query.float()
    support = support.float()
    B, M, _ = query.shape
    N = support.shape[1]
    # radius^2 rounded to float32 once, as JAX's weakly typed constant
    r2 = torch.tensor(radius * radius, dtype=torch.float32,
                      device=query.device)
    best = torch.full((B, M, nsample), _NONE, dtype=torch.int32,
                      device=query.device)
    for c0 in range(0, N, chunk_size):
        sup = support[:, c0:c0 + chunk_size]
        idx = torch.arange(c0, c0 + sup.shape[1], dtype=torch.int32,
                           device=query.device)
        key = torch.where(pairwise_dist2(query, sup) < r2, idx,
                          torch.tensor(_NONE, dtype=torch.int32,
                                       device=query.device))
        best = torch.topk(torch.cat([best, key], dim=-1), nsample,
                          dim=-1, largest=False, sorted=True).values
    found = best < _NONE
    first = torch.where(found[..., :1], best[..., :1], 0)
    return torch.where(found, best, first)
