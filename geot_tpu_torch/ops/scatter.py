"""Segment reductions (``geot_tpu/ops/scatter.py``): the ``torch_scatter``
calls of the reference as ``segment_sum``, ``segment_mean`` and
``segment_max`` over a fixed ``num_segments``, in plain PyTorch on both
devices (``geot_tpu`` runs ``jax.ops.segment_*``, XLA operations).

An empty segment holds the reduction's identity, as in ``jax.ops``: 0 for
the sum and the mean, -inf (the dtype's least value for integers) for the
max. A segment id outside ``[0, num_segments)`` is dropped, as
``jax.ops.segment_*`` drops it."""
from __future__ import annotations

import torch


def _prepared(data: torch.Tensor, segment_ids: torch.Tensor,
              num_segments: int):
    """The rows whose id is in range and their ids as int64."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    if bool(keep.all()):
        return data, ids
    return data[keep], ids[keep]


def _index(ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """data (N, ...), segment_ids (N,) -> (num_segments, ...) sums."""
    data_k, ids = _prepared(data, segment_ids, num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data_k)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Sums over the segments' counts (at least 1: an empty segment is 0)."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(data.new_ones((data.shape[0],)), segment_ids,
                         num_segments).clamp_min(1.0)
    return totals / counts.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """data (N, ...), segment_ids (N,) -> (num_segments, ...) maxima; an
    empty segment is -inf (integers: the dtype's least value).
    ``scatter_reduce(include_self=False)`` leaves an empty segment's
    output as it was, so the output starts at that identity."""
    data_k, ids = _prepared(data, segment_ids, num_segments)
    low = (float("-inf") if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), low)
    return out.scatter_reduce(0, _index(ids, data_k), data_k, "amax",
                              include_self=False)
