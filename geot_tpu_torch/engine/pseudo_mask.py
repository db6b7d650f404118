"""Pseudo-label refinement by fusing each point's class probabilities
with its xyz neighbours' (``geot_tpu/engine/pseudo_mask.py``): one exact
kNN and one gather, then a noisy-OR fusion, then a confidence or margin
threshold. Channels-last (B, N, C).

Column 0 of the k + 1 self-search is dropped as "self". With duplicate
points it is the smallest index among the query's copies, which is the
index ``geot_tpu``'s search drops too (ties go to the smaller index).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import grouping_operation, knn

# per-class neighbour-agreement joint probabilities (reference
# ``pseudo_mask.py:56-61``; ``geot_tpu/engine/pseudo_mask.py:18``)
E_JOINT = np.array([
    0.9698153347167245, 0.9595924029774019, 0.9596092881209647,
    0.9617471101196512, 0.9662687092798028, 0.9684095068416779,
    0.9766432433032493, 0.9754884408811396, 0.9629032258064516,
    0.9596091749248413, 0.9584221215955251, 0.9619788870996601,
    0.9666700999073025, 0.968204136476084, 0.9760611218051148,
    0.9746949382049295, 0.966996699669967], dtype=np.float32)

BETA = float(np.exp(-0.5))


def get_neighbor_probs(probs: torch.Tensor, pos: torch.Tensor, n: int):
    """probs (B, N, C), pos (B, N, 3) -> the n nearest neighbours' probs
    (B, N, n, C) and distances (B, N, n), self excluded
    (``pseudo_mask.py:30``)."""
    dist, idx = knn(pos, pos, n + 1)
    return grouping_operation(probs, idx[:, :, 1:]), dist[:, :, 1:]


def _fused(probs: torch.Tensor, pos: torch.Tensor, neighborhood_size: int,
           n_neighbors: int, upper=None) -> torch.Tensor:
    """Noisy-OR fusion with the per-class top ``n_neighbors`` of the
    neighbours' probabilities; ``upper(fused, q)`` replaces the BETA
    weighting (the margin_v1 variant)."""
    neigh, _ = get_neighbor_probs(probs, pos, neighborhood_size)
    top = torch.topk(neigh.transpose(2, 3), n_neighbors, dim=-1).values
    fused = probs
    for j in range(n_neighbors):
        q = top[..., j]
        if upper is None:
            fused = fused + BETA * q - BETA * fused * q
        else:
            fused = fused + q - fused * upper(fused, q)
    return fused.detach()


def _margin(fused: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(fused, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def pseudo_label_refine(probs: torch.Tensor, th: float, pos: torch.Tensor,
                        neighborhood_size: int = 4,
                        n_neighbors: int = 1) -> torch.Tensor:
    """The fused confidence >= th, a bool (B, N) mask
    (``pseudo_mask.py:38``)."""
    fused = _fused(probs, pos, neighborhood_size, n_neighbors)
    return fused.amax(dim=-1) >= th


def pseudo_label_refine_margin(probs: torch.Tensor, th: float,
                               pos: torch.Tensor, neighborhood_size: int = 4,
                               n_neighbors: int = 1):
    """The fused top-1 - top-2 margin >= th: ``(mask, margin)``
    (``pseudo_mask.py:53``)."""
    margin = _margin(_fused(probs, pos, neighborhood_size, n_neighbors))
    return margin >= th, margin


def pseudo_label_refine_margin_v1(probs: torch.Tensor, th: float,
                                  drop_percent: float, pos: torch.Tensor,
                                  neighborhood_size: int = 4,
                                  n_neighbors: int = 1):
    """The margin variant with the per-class joint-probability upper bound
    ``E_JOINT * fused / q``: ``(mask, margin, th)``
    (``pseudo_mask.py:68``)."""
    C = probs.shape[-1]
    E = torch.from_numpy(E_JOINT[:C]).to(probs).reshape(1, 1, C)
    fused = _fused(probs, pos, neighborhood_size, n_neighbors,
                   upper=lambda f, q: E * f / q.clamp_min(1e-8))
    margin = _margin(fused)
    return margin >= th, margin, th


class NeighborAccCounter:
    """Per-class counts of points and of points whose nearest xyz
    neighbour has the same prediction (``pseudo_mask.py:88``)."""

    def __init__(self, num_classes: int = 17):
        self.num_classes = num_classes
        self.acc = np.zeros((num_classes, 2), dtype=np.int64)

    def update(self, pred: torch.Tensor, pos: torch.Tensor) -> None:
        _, idx = knn(pos, pos, 2)
        nn_pred = torch.gather(pred, 1, idx[:, :, 1].long())
        agree = (pred == nn_pred).cpu().numpy()
        pred_np = pred.cpu().numpy()
        for c in range(self.num_classes):
            mask = pred_np == c
            self.acc[c, 0] += int(mask.sum())
            self.acc[c, 1] += int((agree & mask).sum())

    @property
    def rates(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.acc[:, 1] / np.maximum(self.acc[:, 0], 1)

