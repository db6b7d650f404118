"""three_nn / three_interpolate: inverse-distance-weighted 3-NN feature
propagation (``geot_tpu/ops/interpolate.py:17-60``)."""
from __future__ import annotations

import torch

from .group import gather_points, grouping_operation
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


def three_nn_weights(unknown: torch.Tensor, known: torch.Tensor,
                     idx: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights of the neighbours ``idx`` (B, n, k) of
    ``unknown`` (B, n, 3) among ``known`` (B, m, 3), normalised to sum to
    one, float32 and bit for bit those of ``geot_tpu``'s compiled step
    (``geot_tpu/ops/interpolate.py:51-54`` under XLA):

    - the squared distance as XLA contracts it, ``fma(dz, dz, fma(dy, dy,
      dx * dx))`` (each product exact in float64, each sum rounded once to
      float32); the search sums the squares unfused, as the kernels do;
    - a correctly rounded square root (through float64: torch's float32
      ``sqrt`` on the CPU is not, in a few entries);
    - ``1 / ((d + eps) * sum_j 1 / (d_j + eps))``: XLA folds the two
      divisions of ``1 / (d + eps) / norm`` into one, and sums in order.

    Every step is an elementwise IEEE operation (no reduction, whose order
    the device would choose), so the card's weights are the CPU's bit for
    bit, and a float64 step's card-vs-CPU check is not left to a near-tie
    at a max over neighbours either."""
    diff = (unknown.float()[:, :, None, :]
            - grouping_operation(known.float(), idx)).double()
    d2 = (diff[..., 0] * diff[..., 0]).float()
    for c in range(1, diff.shape[-1]):
        d2 = (diff[..., c] * diff[..., c] + d2.double()).float()
    shifted = d2.double().sqrt().float() + eps
    recip = 1.0 / shifted
    norm = recip[..., :1]
    for j in range(1, recip.shape[-1]):
        norm = norm + recip[..., j:j + 1]
    return 1.0 / (shifted * norm)


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_features: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """3-NN + inverse-distance weights + interpolate. The search and the
    weights run in float32, as in ``geot_tpu``.

    Features wider than float32 (a float64 step, held against
    ``geot_tpu``'s) take ``three_nn_weights``: there the weights' last bit
    is the largest difference left between the two packages, and where a
    max over neighbours downstream has two entries closer than it, it
    decides which one takes the gradient. In float32 it is one of many
    roundings that differ anyway (the GEMMs'), and the search's distances
    serve."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    if torch.finfo(known_features.dtype).bits > 32:
        weight = three_nn_weights(unknown_xyz, known_xyz, idx, eps)
    else:
        dist_recip = 1.0 / (dist + eps)
        weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
    return three_interpolate(known_features, idx, weight)
