"""Exact brute-force k-nearest-neighbour search, query-tiled.

Counterpart of ``geot_tpu/ops/knn.py``. Selection is always exact, with
ties to the smaller index (``lax.top_k``'s rule): ``geot_tpu``'s default
``approx_min_k`` is an XLA operation, and exact selection is what it
computes under ``GEOT_EXACT_KNN=1``.

``knn_small_k`` is the wrapper of the CUDA kernel ``csrc/knn_small_k.cu``
(the port of ``geot_tpu/ops/pallas_knn.py:knn_small_k_pallas``);
``knn_small_k_ref`` is its plain version.
"""
from __future__ import annotations

import torch

from . import _build

_TILE = 2048


def pairwise_dist2(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, shape (..., Q, N).

    Low-dim geometry (C <= 4) uses per-dimension differences summed in
    order, so coincident points give exactly 0; features use the
    |q|^2 - 2 q.s + |s|^2 expansion."""
    C = query.shape[-1]
    if C <= 4:
        diff = query[..., :, None, :] - support[..., None, :, :]
        sq = diff * diff
        d2 = sq[..., 0]
        for c in range(1, C):
            d2 = d2 + sq[..., c]
        return d2
    q2 = (query * query).sum(-1, keepdim=True)
    s2 = (support * support).sum(-1, keepdim=True)
    cross = query @ support.transpose(-1, -2)
    return (q2 - 2.0 * cross + s2.transpose(-1, -2)).clamp_min(0.0)


def _knn_tiled(query: torch.Tensor, support: torch.Tensor, k: int,
               tile: int = _TILE):
    """Exact kNN over query tiles of ``tile`` rows, so no (Q, N) block
    larger than (tile, N) exists. Returns squared d2 (B, Q, k) and int32
    idx (B, Q, k). A stable sort keeps equal distances in index order."""
    ds, ids = [], []
    for q0 in range(0, query.shape[1], tile):
        d2 = pairwise_dist2(query[:, q0:q0 + tile], support)
        d, i = torch.sort(d2, dim=-1, stable=True)
        ds.append(d[..., :k])
        ids.append(i[..., :k].to(torch.int32))
    return torch.cat(ds, dim=1), torch.cat(ids, dim=1)


def knn_small_k_ref(query: torch.Tensor, support: torch.Tensor, k: int):
    """Plain version of the small-k kernel: (B, Q, 3), (B, N, 3) ->
    squared d2 (B, Q, k) f32, idx (B, Q, k) int32."""
    return _knn_tiled(query.float(), support.float(), k)


def knn_small_k(query: torch.Tensor, support: torch.Tensor, k: int):
    """Exact kNN for 1 <= k <= 4 on xyz: squared d2 and int32 idx, each
    (B, Q, k), ascending, ties to the smaller index.

    A CUDA tensor goes to the kernel, a CPU tensor to ``knn_small_k_ref``."""
    if query.device.type == "cpu" and support.device.type == "cpu":
        return knn_small_k_ref(query, support, k)
    if query.device.type != "cuda" or support.device != query.device:
        raise ValueError(f"knn_small_k: query on {query.device} and support "
                         f"on {support.device}; both must be on one CUDA "
                         f"device (or both on the CPU)")
    for name, t in (("query", query), ("support", support)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"knn_small_k: {name} must be (B, n, 3) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"knn_small_k: {name} must be contiguous")
    B, Q, _ = query.shape
    N = support.shape[1]
    if support.shape[0] != B:
        raise ValueError(f"knn_small_k: batch {B} vs {support.shape[0]}")
    if not 1 <= k <= 4 or N < k:
        raise ValueError(f"knn_small_k: need 1 <= k <= 4 and N >= k, got "
                         f"k={k}, N={N}")
    lib = _build.library()
    d2 = torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.geot_knn_small_k(query.data_ptr(), support.data_ptr(),
                              d2.data_ptr(), idx.data_ptr(), B, Q, N, k,
                              stream)
    _build.check_launch("knn_small_k", rc)
    return d2, idx


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        tile: int = _TILE, squared: bool = False):
    """Batched exact kNN: (B, Q, C), (B, N, C) -> (dist, idx), each
    (B, Q, k), ascending; idx int32. ``squared`` returns squared distances.

    k <= 4 on xyz with Q >= 128 on a CUDA tensor runs the small-k kernel
    (``geot_tpu/ops/knn.py:113-120``); everything else the tiled path."""
    query = query.float().contiguous()
    support = support.float().contiguous()
    if k <= 4 and query.shape[-1] == 3 and query.shape[1] >= 128 \
            and query.is_cuda:
        d2, idx = knn_small_k(query, support, k)
    else:
        d2, idx = _knn_tiled(query, support, k, tile)
    d2 = d2.clamp_min(0.0)
    return (d2 if squared else d2.sqrt()), idx
