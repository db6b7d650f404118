"""Point Transformer's vector-attention primitives
(``geot_tpu/ops/vector_attn.py``): pairwise subtraction and the weighted
neighbourhood sum with channel-sharing weights, each a gather
(``grouping_operation``) and elementwise work, differentiable by
autograd."""
from __future__ import annotations

import torch

from .group import grouping_operation


def subtraction(feat1: torch.Tensor, feat2: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """feat1 (B, N, C) centres, feat2 (B, N', C) support, idx (B, N, K) ->
    (B, N, K, C) of ``feat1[i] - feat2[idx[i, k]]``."""
    return feat1[:, :, None, :] - grouping_operation(feat2, idx)


def aggregation(feat: torch.Tensor, weight: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """feat (B, N', C), weight (B, N, K, C') with C = C' * s, idx (B, N, K)
    -> (B, N, C): ``out[i, c] = sum_k w[i, k, c // s] * feat[idx[i, k],
    c]``."""
    B, N, K = idx.shape
    C = feat.shape[-1]
    Cp = weight.shape[-1]
    neigh = grouping_operation(feat, idx).reshape(B, N, K, Cp, C // Cp)
    return (neigh * weight[..., None]).sum(dim=2).reshape(B, N, C)
