"""The 3D manifold regulariser of the instance transition matrices
(``geot_tpu/losses/inst_loss.py:16-160``, ``threed_space_loss`` with
``anchors=0``): neighbours in xyz should have similar matrices when their
pseudo-labels agree."""
from __future__ import annotations

import torch

from ..ops import knn


def _neighbour_weights(positions: torch.Tensor, labels: torch.Tensor, k: int,
                       sigma: float, same_val: float, diff_val: float):
    """k nearest neighbours of every point (itself dropped) in xyz and
    their weights ``(same/diff label value) * exp(-d2 / 2 sigma^2)``,
    detached (``inst_loss.py:16``). The k + 1 search is exact; its squared
    distances are the d2 the weights need."""
    d2, idx = knn(positions, positions, k + 1, squared=True)
    # the search runs in float32; the weights in the positions' dtype if
    # wider
    d2 = d2[:, :, 1:].to(torch.promote_types(d2.dtype, positions.dtype))
    idx = idx[:, :, 1:].long()
    eij = torch.exp(-d2 / (2.0 * sigma * sigma))
    B = labels.shape[0]
    neigh = torch.gather(labels, 1, idx.reshape(B, -1)).reshape(idx.shape)
    agree = neigh == labels[:, :, None]
    weight = torch.where(agree, same_val, diff_val) * eij
    return idx, weight.detach()


def _weighted_t_dist_sum(ins_T: torch.Tensor, idx: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """sum_j w_ij ||T_i - T_j||^2 per point (``inst_loss.py:59``), as
    ``|T_i|^2 sum_j w_ij + sum_j w_ij |T_j|^2 - 2 T_i . sum_j w_ij T_j``
    with one gather per neighbour rank, so no (B, N, k, C*C) block is
    built. ins_T (B*N, C, C), idx and w (B, N, k) -> (B, N)."""
    B, M, k = idx.shape
    C = ins_T.shape[-1]
    t = ins_T.reshape(B, -1, C * C)
    tsq = (t * t).sum(dim=-1)                                   # (B, N)
    tsq_j = torch.gather(tsq, 1, idx.reshape(B, -1)).reshape(B, M, k)
    s = None
    for j in range(k):
        gj = torch.gather(t, 1, idx[:, :, j, None].expand(-1, -1, C * C))
        term = gj * w[:, :, j, None]
        s = term if s is None else s + term
    cross = (t * s).sum(dim=-1)
    return tsq * w.sum(-1) + (w * tsq_j).sum(-1) - 2.0 * cross


class threed_space_loss:
    """Mean over points of the weighted T distance to the k nearest xyz
    neighbours, weights 1 (same pseudo-label) or 0, normalised per point
    (``inst_loss.py:108``). ``anchors`` (a subsampled estimator in
    ``geot_tpu``) is not ported: the flagship has it at 0."""

    def __init__(self, k: int = 7, sigma: float = 1.0):
        self.k, self.sigma = k, sigma

    def __call__(self, positions: torch.Tensor, labels: torch.Tensor,
                 ins_T: torch.Tensor) -> torch.Tensor:
        idx, w = _neighbour_weights(positions, labels, self.k, self.sigma,
                                    1.0, 0.0)
        wtd = _weighted_t_dist_sum(ins_T, idx, w)
        return (wtd / (w.sum(dim=-1) + 0.001)).mean()
