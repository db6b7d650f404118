"""Fixed-iteration k-means and the k-means tokenizer
(``geot_tpu/models/layers/kmeans.py``).

``kmeans`` runs ``iters`` Lloyd steps from the first k points, or from
``init_idx`` (drawn from ``generator`` as k distinct indices, where
``geot_tpu`` draws them from a ``jax.random`` key). Assignments take the
nearest centre by the port's ``pairwise_dist2``, ties to the smaller
index (``argmin``'s first minimum); an empty cluster keeps its centre.
``KMeansEmbed`` clusters each cloud, then embeds each point's relative
coordinates through two Linear + LayerNorm + ReLU + Linear stacks with a
per-cluster max between them (module names ``conv1_fc1``, ``conv1_ln``,
... as in flax); an empty cluster's token is -inf, as
``jax.ops.segment_max`` leaves it."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ...ops import pairwise_dist2, segment_max
from .common import Dense, LayerNorm


def kmeans(x: torch.Tensor, k: int, iters: int = 10,
           generator: Optional[torch.Generator] = None,
           init_idx: Optional[torch.Tensor] = None):
    """x (N, C) -> (assignments (N,) int64, centres (k, C))."""
    N = x.shape[0]
    if init_idx is None:
        init_idx = (torch.randperm(N, generator=generator)[:k]
                    if generator is not None else torch.arange(k))
    centers = x[torch.as_tensor(init_idx).long().to(x.device)]
    for _ in range(iters):
        assign = torch.argmin(pairwise_dist2(x, centers), dim=1)
        onehot = F.one_hot(assign, k).to(x.dtype)
        sums = onehot.t() @ x
        counts = onehot.sum(dim=0)[:, None]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0),
                              centers)
    return torch.argmin(pairwise_dist2(x, centers), dim=1), centers


def _batched_segment_max(data: torch.Tensor, labels: torch.Tensor,
                         K: int) -> torch.Tensor:
    """(B, N, C), (B, N) -> (B, K, C) per-cloud segment maxima."""
    B, N, C = data.shape
    ids = labels + K * torch.arange(B, device=labels.device)[:, None]
    return segment_max(data.reshape(B * N, C), ids.reshape(-1),
                       B * K).reshape(B, K, C)


class KMeansEmbed(nn.Module):
    """(xyz (B, N, 3)) -> (centroids (B, K, 3), tokens (B, K, D), each
    point's centroid p_i (B, N, 3), labels (B, N)); ``feature_type`` is
    dp, pj_dp or pi_dp."""

    def __init__(self, num_groups: int = 256, encoder_dim: int = 256,
                 feature_type: str = "dp", kmeans_iters: int = 10):
        super().__init__()
        if feature_type not in ("dp", "pj_dp", "pi_dp"):
            raise ValueError(f"feature_type {feature_type} unsupported "
                             f"(reference supports dp/pj_dp/pi_dp)")
        self.num_groups = num_groups
        self.feature_type = feature_type
        self.kmeans_iters = kmeans_iters
        width = 3 if feature_type == "dp" else 6
        for name, (cin, hidden, out) in (("conv1", (width, 128, 256)),
                                         ("conv2", (512, 512, encoder_dim))):
            self.add_module(f"{name}_fc1", Dense(cin, hidden))
            self.add_module(f"{name}_ln", LayerNorm(hidden, eps=1e-5))
            self.add_module(f"{name}_fc2", Dense(hidden, out))

    def _mlp(self, x, name):
        x = getattr(self, f"{name}_fc1")(x)
        x = F.relu(getattr(self, f"{name}_ln")(x))
        return getattr(self, f"{name}_fc2")(x)

    def forward(self, xyz: torch.Tensor, features=None):
        K = self.num_groups
        labels, centroids = zip(*(kmeans(p, K, iters=self.kmeans_iters)
                                  for p in xyz))
        labels, centroids = torch.stack(labels), torch.stack(centroids)
        p_i = torch.gather(centroids, 1, labels[..., None].expand(-1, -1, 3))
        rel = xyz - p_i
        f = {"dp": rel, "pj_dp": torch.cat([xyz, rel], dim=-1),
             "pi_dp": torch.cat([p_i, rel], dim=-1)}[self.feature_type]
        f = self._mlp(f, "conv1")
        pooled = _batched_segment_max(f, labels, K)
        rep = torch.gather(pooled, 1,
                           labels[..., None].expand(-1, -1, f.shape[-1]))
        f = self._mlp(torch.cat([rep, f], dim=-1), "conv2")
        return centroids, _batched_segment_max(f, labels, K), p_i, labels
