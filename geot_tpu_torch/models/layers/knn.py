"""kNN layer wrappers (``geot_tpu/models/layers/knn.py``) over the port's
``ops.knn``: ``KNN``, ``DenseDilated`` and ``DilatedKNN``.

``DenseDilated``'s stochastic branch (training only) draws one gate
U[0, 1) and one permutation of the k * d candidates a call, from
``generator``, where ``geot_tpu`` splits a ``jax.random`` key; ``draws``
gives ``(gate, permutation)`` instead. Without a generator or draws it
keeps every d-th column, as ``geot_tpu`` does without a key.
``knn_point`` is ``ops.knn_point``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops import knn as _ops_knn, knn_point


class KNN:
    """Configured with a neighbour count, called with (query, support)."""

    def __init__(self, neighbors: int, farthest: bool = False, **kwargs):
        if farthest:
            raise NotImplementedError(
                "farthest-neighbour mode is unused in GeoT")
        self.neighbors = neighbors

    def __call__(self, query, support=None):
        return _ops_knn(query, query if support is None else support,
                        self.neighbors)


class DenseDilated:
    """Dilated selection over a dense (B, N, k * d) edge index: every d-th
    column, or in stochastic training mode, with probability ``epsilon``,
    a random k of the k * d columns (one draw a call)."""

    def __init__(self, k: int = 9, dilation: int = 1,
                 stochastic: bool = False, epsilon: float = 0.0):
        self.k = k
        self.dilation = dilation
        self.stochastic = stochastic
        self.epsilon = epsilon

    def draw(self, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One call's (gate, permutation of k * d)."""
        return (torch.rand((), generator=generator),
                torch.randperm(self.k * self.dilation, generator=generator))

    def __call__(self, edge_index: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = False, draws=None) -> torch.Tensor:
        strided = edge_index[..., ::self.dilation]
        if not (self.stochastic and training) or (generator is None
                                                  and draws is None):
            return strided
        gate, perm = draws if draws is not None else self.draw(generator)
        if float(gate) < self.epsilon:
            return edge_index[..., torch.as_tensor(perm)[:self.k].long()
                              .to(edge_index.device)]
        return strided


class DilatedKNN:
    """Search k * d neighbours, keep a dilated k of them
    (``DenseDilated``), the same columns for distances and indices."""

    def __init__(self, k: int, dilation: int = 1, stochastic: bool = False,
                 epsilon: float = 0.0, **kwargs):
        self.k = k
        self.dilation = dilation
        self._dilated = DenseDilated(k, dilation, stochastic, epsilon)

    def __call__(self, query, support=None,
                 generator: Optional[torch.Generator] = None,
                 training: bool = False, draws=None):
        d, i = knn_point(self.k * self.dilation, query, support)
        if draws is None and generator is not None and training \
                and self._dilated.stochastic:
            draws = self._dilated.draw(generator)
        return (self._dilated(d, None, training, draws),
                self._dilated(i, None, training, draws))
