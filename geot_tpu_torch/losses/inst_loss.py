"""Geometry-guided regularisers of the instance transition matrices
(``geot_tpu/losses/inst_loss.py``): neighbours in softmax space
(``feature_space_loss``) or in xyz (``threed_space_loss``) should have
similar matrices when their pseudo-labels agree, and ``identity_loss``
pulls each matrix's diagonal to 1. ``ins_T`` is the (B*N, C, C) output of
the T-predictor. The neighbour searches are exact.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import grouping_operation, knn


def _neighbour_weights(anchor_feats: torch.Tensor, labels: torch.Tensor,
                       k: int, sigma: float, same_val: float,
                       diff_val: float,
                       support_feats: Optional[torch.Tensor] = None,
                       support_labels: Optional[torch.Tensor] = None):
    """The k nearest supports of every anchor (its own hit, column 0 of
    the k + 1 search, dropped) and their weights ``(same/diff label value)
    * exp(-d2 / 2 sigma^2)``, detached (``inst_loss.py:16``). The supports
    default to the anchors; anchors drawn from the supports find themselves
    first.

    xyz (C <= 4): the search's squared distances (float32) are the d2 the
    weights need. Features (C > 4): the search ranks by the |q|^2 - 2 q.s + |s|^2
    expansion, and d2 is recomputed from explicit differences, as there."""
    if support_feats is None:
        support_feats = anchor_feats
    if support_labels is None:
        support_labels = labels
    d2, idx = knn(anchor_feats, support_feats, k + 1, squared=True)
    idx = idx[:, :, 1:].long()
    if anchor_feats.shape[-1] <= 4:
        # the search's float32 d2, so float32 weights in every dtype, as
        # there
        d2 = d2[:, :, 1:]
    else:
        neigh = grouping_operation(support_feats, idx)       # (B, M, k, C)
        d2 = ((anchor_feats[:, :, None, :] - neigh) ** 2).sum(-1)
    eij = torch.exp(-d2 / (2.0 * sigma * sigma))
    B = support_labels.shape[0]
    neigh_labels = torch.gather(support_labels, 1,
                                idx.reshape(B, -1)).reshape(idx.shape)
    agree = neigh_labels == labels[:, :, None]
    weight = torch.where(agree, same_val, diff_val) * eij
    return idx, weight.detach()


def _weighted_t_dist_sum(ins_T: torch.Tensor, idx: torch.Tensor,
                         w: torch.Tensor,
                         anchor_idx: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """sum_j w_ij ||T_i - T_j||^2 per anchor (``inst_loss.py:59``), as
    ``|T_i|^2 sum_j w_ij + sum_j w_ij |T_j|^2 - 2 T_i . sum_j w_ij T_j``
    with one gather per neighbour rank, so no (B, M, k, C*C) block is
    built. ins_T (B*N, C, C); idx and w (B, M, k), idx into all N points;
    ``anchor_idx`` (B, M) the anchors' rows (None: every point, M = N) ->
    (B, M)."""
    B, M, k = idx.shape
    C = ins_T.shape[-1]
    t = ins_T.reshape(B, -1, C * C)
    tsq = (t * t).sum(dim=-1)                                   # (B, N)
    if anchor_idx is None:
        t_i, tsq_i = t, tsq
    else:
        anchor_idx = anchor_idx.long()
        t_i = torch.gather(t, 1, anchor_idx[..., None].expand(-1, -1, C * C))
        tsq_i = torch.gather(tsq, 1, anchor_idx)
    tsq_j = torch.gather(tsq, 1, idx.reshape(B, -1)).reshape(B, M, k)
    s = None
    for j in range(k):
        gj = torch.gather(t, 1, idx[:, :, j, None].expand(-1, -1, C * C))
        term = gj * w[:, :, j, None]
        s = term if s is None else s + term
    cross = (t_i * s).sum(dim=-1)
    return tsq_i * w.sum(-1) + (w * tsq_j).sum(-1) - 2.0 * cross


class feature_space_loss:
    """kNN in softmax space, weights +1 (same pseudo-label) or -1 times the
    gaussian affinity, the weighted T distances averaged over points and
    neighbours (``inst_loss.py:94``)."""

    def __init__(self, k: int = 7, sigma: float = 1.0,
                 num_classes: int = 17):
        self.k, self.sigma = k, sigma

    def __call__(self, probs: torch.Tensor, labels: torch.Tensor,
                 ins_T: torch.Tensor) -> torch.Tensor:
        idx, w = _neighbour_weights(probs, labels, self.k, self.sigma, 1.0,
                                    -1.0)
        return _weighted_t_dist_sum(ins_T, idx, w).mean() / self.k


class threed_space_loss:
    """Mean over points of the weighted T distance to the k nearest xyz
    neighbours, weights 1 (same pseudo-label) or 0, normalised per point
    (``inst_loss.py:108``).

    ``anchors=M`` (0: every point) averages over M anchors per cloud drawn
    uniformly with replacement instead: an unbiased estimator of the same
    mean, the neighbours still searched in the whole cloud. The anchors
    come from ``generator``, or are ``anchor_idx`` (B, M) when given."""

    def __init__(self, k: int = 7, sigma: float = 1.0,
                 num_classes: int = 17, anchors: int = 0):
        self.k, self.sigma, self.anchors = k, sigma, int(anchors)

    def __call__(self, positions: torch.Tensor, labels: torch.Tensor,
                 ins_T: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 anchor_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N = labels.shape
        if self.anchors and self.anchors < N:
            if anchor_idx is None:
                if generator is None:
                    raise ValueError("threed_space_loss(anchors=M) needs a "
                                     "generator or anchor_idx")
                anchor_idx = torch.randint(0, N, (B, self.anchors),
                                           generator=generator,
                                           device=positions.device)
            anchor_idx = anchor_idx.long()
            a_pos = torch.gather(positions, 1,
                                 anchor_idx[..., None].expand(-1, -1, 3))
            a_labels = torch.gather(labels, 1, anchor_idx)
            idx, w = _neighbour_weights(a_pos, a_labels, self.k, self.sigma,
                                        1.0, 0.0, support_feats=positions,
                                        support_labels=labels)
            wtd = _weighted_t_dist_sum(ins_T, idx, w, anchor_idx)
        else:
            idx, w = _neighbour_weights(positions, labels, self.k,
                                        self.sigma, 1.0, 0.0)
            wtd = _weighted_t_dist_sum(ins_T, idx, w)
        return (wtd / (w.sum(dim=-1) + 0.001)).mean()


class identity_loss:
    """Mean over points of the squared distance of each matrix's diagonal
    to ``identity``'s (default: I), over the diagonal's length
    (``inst_loss.py:145``)."""

    def __call__(self, ins_T: torch.Tensor,
                 identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        C = ins_T.shape[-1]
        eye = (torch.eye(C, dtype=ins_T.dtype, device=ins_T.device)
               if identity is None else identity)
        diff = (ins_T - eye[None]) ** 2
        return ((diff * eye[None]).sum(dim=(1, 2)) / eye.sum()).mean()


# the reference's spellings (``utils/insT_loss.py:61,113``)
Idenyity_loss = identity_loss
threeD_space_loss = threed_space_loss
