"""Exact brute-force k-nearest-neighbour search, query-tiled.

Counterpart of ``geot_tpu/ops/knn.py``. Selection is always exact, with
ties to the smaller index (``lax.top_k``'s rule): ``geot_tpu``'s default
``approx_min_k`` is an XLA operation, and exact selection is what it
computes under ``GEOT_EXACT_KNN=1``.

``knn_small_k`` is the path's small-k search. For CUDA tensors it runs,
by ``knn_route``, the CUDA kernel ``csrc/knn_split.cu`` (``knn_split``),
which splits the support range over blocks (``knn_split_plan``) and merges
their lists, or, for the largest searches (the upsample of a whole scan),
the pruned kernel; ``knn_small_k_unsplit`` runs the first version
``csrc/knn_small_k.cu`` (one thread per query). The split and unsplit
kernels port ``geot_tpu/ops/pallas_knn.py:knn_small_k_pallas``, and
``knn_small_k_ref`` is their plain version. ``knn_small_k_pruned`` is the
wrapper of ``csrc/knn_small_k_pruned.cu`` (the port of
``geot_tpu/ops/pallas_knn_pruned.py:knn_small_k_pruned``): the same
contract, bit for bit, over Morton-sorted 32-query tiles that visit
128-support chunks nearest first and stop at the first one farther than
the tile's k-th best; ``knn_small_k_pruned_ref`` is its plain version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .morton import morton_codes_kernel, morton_launch

_TILE = 2048
# knn_split: queries per block (one per thread), fewest supports per
# split, and the blocks per SM the splits aim at
SPLIT_QTILE = 128
SPLIT_MIN = 64
SPLIT_WAVES = 4
# knn_small_k_pruned: sorted queries per tile (a warp), sorted supports per
# chunk, and the most chunks whose keys a block's 4 warps keep in shared
# memory (csrc/knn_small_k_pruned.cu)
PRUNED_TILE = 32
PRUNED_CHUNK = 128
PRUNED_MAX_CHUNKS = 7000
# knn_small_k's route: the pruned kernel, its plan included, from this many
# (query, support) pairs a cloud; knn_split below. chip_smoke.py phase 3
# times both at the two upsamples of whole scans, (40960, 16000) and
# (155648, 16000), and at (24576 | 32768, 16000) and the (2, 16000)^2
# self-search, kernel-only and as wrapper calls (PERF.md, section 6): the
# pruned kernel with its plan is faster at each shape taken here.
PRUNED_MIN_PAIRS = 400_000_000


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


def _smallest_k(d2: torch.Tensor, k: int):
    """The k entries of each row smallest in (value, index) order, i.e.
    ascending with exact ties to the smaller index, as a stable sort would
    give them. d2 must be >= 0: a non-negative float orders like its bits,
    so ``bits << 32 | index`` is one int64 key and ``topk`` selects in
    O(N) per row instead of sorting."""
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)     # -0.0 -> +0.0
    index = torch.arange(d2.shape[-1], device=d2.device)
    top = torch.topk((bits << 32) | index, k, dim=-1, largest=False,
                     sorted=True).values
    d = (top >> 32).to(torch.int32).view(torch.float32)
    return d, (top & 0xFFFFFFFF).to(torch.int32)


def _knn_tiled(query: torch.Tensor, support: torch.Tensor, k: int,
               tile: int = _TILE):
    """Exact kNN over query tiles of ``tile`` rows, so no (Q, N) block
    larger than (tile, N) exists. Returns squared d2 (B, Q, k) and int32
    idx (B, Q, k), equal distances in index order."""
    ds, ids = [], []
    for q0 in range(0, query.shape[1], tile):
        d, i = _smallest_k(pairwise_dist2(query[:, q0:q0 + tile], support),
                           k)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds, dim=1), torch.cat(ids, dim=1)


def knn_small_k_ref(query: torch.Tensor, support: torch.Tensor, k: int):
    """Plain version of the small-k kernel: (B, Q, 3), (B, N, 3) ->
    squared d2 (B, Q, k) f32, idx (B, Q, k) int32."""
    return _knn_tiled(query.float(), support.float(), k)


def _check_small_k(name: str, query: torch.Tensor, support: torch.Tensor,
                   k: int) -> None:
    """Raise on what the small-k kernels do not take."""
    if query.device.type != "cuda" or support.device != query.device:
        raise ValueError(f"{name}: query on {query.device} and support "
                         f"on {support.device}; both must be on one CUDA "
                         f"device (or both on the CPU)")
    for arg, t in (("query", query), ("support", support)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name}: {arg} must be (B, n, 3) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if support.shape[0] != query.shape[0]:
        raise ValueError(f"{name}: batch {query.shape[0]} vs "
                         f"{support.shape[0]}")
    if not 1 <= k <= 4 or support.shape[1] < k:
        raise ValueError(f"{name}: need 1 <= k <= 4 and N >= k, got "
                         f"k={k}, N={support.shape[1]}")


def knn_split_plan(B: int, Q: int, N: int, num_sms: int = 132):
    """How ``knn_small_k``'s kernel splits the N supports: ``(S,
    split_len)``, split s owning indices [s * split_len, (s + 1) *
    split_len). S is the fewest splits that give ``SPLIT_WAVES`` blocks per
    SM over B clouds of ceil(Q / ``SPLIT_QTILE``) query tiles, with at least
    ``SPLIT_MIN`` supports per split; every split is non-empty."""
    tiles = B * -(-Q // SPLIT_QTILE)
    S = max(1, min(-(-SPLIT_WAVES * num_sms // tiles), N // SPLIT_MIN))
    split_len = -(-N // S)
    return -(-N // split_len), split_len


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def knn_small_k(query: torch.Tensor, support: torch.Tensor, k: int):
    """Exact kNN for 1 <= k <= 4 on xyz: squared d2 and int32 idx, each
    (B, Q, k), ascending, ties to the smaller index.

    The custom op ``geot::knn_small_k``: a CUDA tensor goes to
    ``knn_route``'s kernel (chosen inside the op at run time), a CPU
    tensor to ``knn_small_k_ref``; another device raises.
    ``torch.export`` keeps the op in the exported graph."""
    for t in (query, support):
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"knn_small_k: unsupported device {t.device}")
    return torch.ops.geot.knn_small_k(query, support, k)


@torch.library.custom_op("geot::knn_small_k", mutates_args=())
def _knn_small_k_op(query: torch.Tensor, support: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    return knn_small_k_direct(query, support, k)


def knn_route(Q: int, N: int) -> str:
    """Which kernel ``knn_small_k`` runs for (B, Q, 3) x (B, N, 3):
    "knn_small_k_pruned" (with its plan) at ``PRUNED_MIN_PAIRS`` pairs a
    cloud or more, where it holds the supports' keys, else
    "knn_split"."""
    if Q * N >= PRUNED_MIN_PAIRS and N <= PRUNED_MAX_CHUNKS * PRUNED_CHUNK:
        return "knn_small_k_pruned"
    return "knn_split"


def knn_small_k_direct(query: torch.Tensor, support: torch.Tensor, k: int):
    """What ``geot::knn_small_k`` runs, called without the op's dispatch
    (for timing the dispatch): ``knn_route``'s kernel."""
    if query.device.type == "cpu" and support.device.type == "cpu":
        return knn_small_k_ref(query, support, k)
    _check_small_k("knn_small_k", query, support, k)
    if knn_route(query.shape[1], support.shape[1]) == "knn_small_k_pruned":
        return _knn_pruned(query, support, k, None, None)
    return knn_split(query, support, k)


def knn_split(query: torch.Tensor, support: torch.Tensor, k: int):
    """The split kernel ``csrc/knn_split.cu`` (``knn_split_plan`` chosen
    here), whatever ``knn_route`` says; CPU tensors go to
    ``knn_small_k_ref``."""
    if query.device.type == "cpu" and support.device.type == "cpu":
        return knn_small_k_ref(query, support, k)
    _check_small_k("knn_split", query, support, k)
    B, Q, _ = query.shape
    N = support.shape[1]
    S, split_len = knn_split_plan(B, Q, N, _num_sms(query.device.index))
    lib = _build.library()
    d2 = torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=query.device)
    sd = si = None
    if S > 1:       # the splits' lists, d2 and idx, in one allocation
        scratch = torch.empty((2, S, B, Q, k), dtype=torch.int32,
                              device=query.device)
        sd, si = scratch[0].view(torch.float32), scratch[1]
    stream = torch.cuda.current_stream(query.device).cuda_stream
    # the launch goes to the current card: make it the tensors'
    with torch.cuda.device(query.device):
        rc = lib.geot_knn_split(query.data_ptr(), support.data_ptr(),
                                d2.data_ptr(), idx.data_ptr(),
                                sd.data_ptr() if sd is not None else None,
                                si.data_ptr() if si is not None else None,
                                B, Q, N, k, S, split_len, stream)
    _build.check_launch("knn_split", rc)
    return d2, idx


@_knn_small_k_op.register_fake
def _knn_small_k_fake(query: torch.Tensor, support: torch.Tensor, k: int):
    B, Q = query.shape[:2]
    return (query.new_empty((B, Q, k), dtype=torch.float32),
            query.new_empty((B, Q, k), dtype=torch.int32))


def knn_small_k_unsplit(query: torch.Tensor, support: torch.Tensor, k: int):
    """``knn_small_k`` by the first kernel ``csrc/knn_small_k.cu``, one
    thread per query; CPU tensors go to ``knn_small_k_ref``."""
    if query.device.type == "cpu" and support.device.type == "cpu":
        return knn_small_k_ref(query, support, k)
    _check_small_k("knn_small_k_unsplit", query, support, k)
    B, Q, _ = query.shape
    N = support.shape[1]
    lib = _build.library()
    d2 = torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.geot_knn_small_k(query.data_ptr(), support.data_ptr(),
                              d2.data_ptr(), idx.data_ptr(), B, Q, N, k,
                              stream)
    _build.check_launch("knn_small_k", rc)
    return d2, idx


class KnnPrunedPlan(NamedTuple):
    """What ``knn_small_k_pruned``'s kernel reads: ``q_order`` (B, Q)
    int64, the stable sort of the queries' Morton codes (a view of the
    joint order, rows Q + N apart); ``s4`` (B, N, 4) float32, the supports
    in the stable sort of their codes as (x, y, z, original index as the
    float's bits); ``boxes`` (B, NC, 2, 4) float32, the (min, max) xyz of
    each chunk of ``PRUNED_CHUNK`` sorted supports, NaN where a coordinate
    on that axis is NaN (``[..., 3]`` is 0)."""
    q_order: torch.Tensor
    s4: torch.Tensor
    boxes: torch.Tensor


def knn_pruned_order(query: torch.Tensor, support: torch.Tensor
                     ) -> torch.Tensor:
    """Both clouds in Morton order from one sort: (B, Q + N) int64, the
    stable sort of ``morton_codes_kernel(query, support)`` (the supports'
    codes tagged above the queries'), so columns [0, Q) are the stable
    sort of the queries' codes and columns [Q, Q + N) Q plus that of the
    supports' codes."""
    return torch.sort(morton_codes_kernel(query, support), dim=-1,
                      stable=True).indices


def knn_pruned_plan(query: torch.Tensor, support: torch.Tensor
                    ) -> KnnPrunedPlan:
    """The pruned kernel's plan (the part of
    ``pallas_knn_pruned.py:knn_small_k_pruned`` outside its
    ``pallas_call``, with 128-support chunks and no tile-by-chunk sort: the
    kernel orders its own visits): ``knn_pruned_order`` (one Morton launch
    for both clouds and one stable ``torch.sort``), then
    ``knn_pruned_prepare``. On the CPU the same in plain PyTorch."""
    Q = query.shape[1]
    order = knn_pruned_order(query, support)
    return KnnPrunedPlan(order[:, :Q],
                         *knn_pruned_prepare(support, order[:, Q:], base=Q))


def knn_pruned_prepare_ref(support: torch.Tensor, order: torch.Tensor,
                           base: int = 0):
    """Plain version of ``knn_pruned_prepare``, on any device."""
    B, N = support.shape[:2]
    NC = -(-N // PRUNED_CHUNK)
    order = order - base
    ss = torch.gather(support, 1, order[..., None].expand(-1, -1, 3))
    s4 = torch.cat([ss, order.to(torch.int32).view(torch.float32)
                    [..., None]], dim=-1)
    chunks = torch.nn.functional.pad(
        ss, (0, 0, 0, NC * PRUNED_CHUNK - N)).reshape(B, NC, PRUNED_CHUNK, 3)
    valid = (torch.arange(NC * PRUNED_CHUNK, device=support.device)
             < N).reshape(1, NC, PRUNED_CHUNK, 1)
    inf = float("inf")
    lo = torch.where(valid, chunks, inf).amin(dim=2)
    hi = torch.where(valid, chunks, -inf).amax(dim=2)
    return s4, torch.nn.functional.pad(torch.stack([lo, hi], dim=2), (0, 1))


def knn_pruned_prepare(support: torch.Tensor, order: torch.Tensor,
                       base: int = 0):
    """The supports in ``order - base`` ((B, N) int64, rows contiguous) as
    (B, N, 4) float32 rows (x, y, z, original index as the float's bits)
    and the (min, max) xyz of each chunk of ``PRUNED_CHUNK`` of them, (B,
    NC, 2, 4), NaN kept: the kernel ``geot_knn_pruned_prepare`` (one
    launch) for CUDA tensors, ``knn_pruned_prepare_ref`` on the CPU."""
    if support.device.type == "cpu":
        return knn_pruned_prepare_ref(support, order, base)
    B, N = support.shape[:2]
    NC = -(-N // PRUNED_CHUNK)
    if support.device.type != "cuda" or order.device != support.device \
            or order.dtype != torch.int64 or order.shape != (B, N) \
            or not support.is_contiguous() or order.stride(-1) != 1:
        raise ValueError("knn_pruned_prepare: expected a contiguous CUDA "
                         "(B, N, 3) support and (B, N) int64 order with "
                         "contiguous rows on its device")
    lib = _build.library()
    s4 = torch.empty((B, N, 4), dtype=torch.float32, device=support.device)
    boxes = torch.empty((B, NC, 2, 4), dtype=torch.float32,
                        device=support.device)
    stream = torch.cuda.current_stream(support.device).cuda_stream
    with torch.cuda.device(support.device):
        rc = lib.geot_knn_pruned_prepare(
            support.data_ptr(), order.data_ptr(), order.stride(0), base,
            s4.data_ptr(), boxes.data_ptr(), B, N, stream)
    _build.check_launch("knn_pruned_prepare", rc)
    return s4, boxes


def knn_small_k_pruned_ref(query: torch.Tensor, support: torch.Tensor,
                           k: int):
    """Plain version of the pruned kernel: its contract is exact small-k
    kNN, so this is ``knn_small_k_ref``."""
    return knn_small_k_ref(query, support, k)


def knn_small_k_pruned(query: torch.Tensor, support: torch.Tensor, k: int,
                       skipped: "torch.Tensor | None" = None,
                       plan: "KnnPrunedPlan | None" = None):
    """Exact kNN for 1 <= k <= 4 on xyz, equal to ``knn_small_k``: squared
    d2 and int32 idx, each (B, Q, k), ascending, ties to the smaller index.

    A CUDA tensor goes to the kernel, a CPU tensor to
    ``knn_small_k_pruned_ref``. ``skipped``, a one-element int64 CUDA
    tensor, gets the number of (32-query tile, 128-support chunk) pairs the
    kernel did not visit added to it. ``plan`` is ``knn_pruned_plan(query,
    support)`` when the caller has it already."""
    if query.device.type == "cpu" and support.device.type == "cpu":
        return knn_small_k_pruned_ref(query, support, k)
    _check_small_k("knn_small_k_pruned", query, support, k)
    if skipped is not None and (skipped.dtype != torch.int64
                                or skipped.numel() != 1
                                or skipped.device != query.device):
        raise ValueError("knn_small_k_pruned: skipped must be one int64 "
                         "element on the device of query")
    return _knn_pruned(query, support, k, skipped, plan)


def _knn_pruned(query, support, k, skipped, plan):
    """``knn_small_k_pruned`` on checked CUDA tensors. Without a plan: the
    Morton launch, one sort, and the prepare and search kernels from one
    call, with the device made current once."""
    B, Q, _ = query.shape
    N = support.shape[1]
    if Q < 1:
        raise ValueError("knn_small_k_pruned: need Q >= 1")
    if N > PRUNED_MAX_CHUNKS * PRUNED_CHUNK:
        raise ValueError(f"knn_small_k_pruned: N = {N} supports is more "
                         f"than {PRUNED_MAX_CHUNKS * PRUNED_CHUNK}")
    dev = query.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    d2 = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=dev)
    skip_ptr = skipped.data_ptr() if skipped is not None else None
    with torch.cuda.device(dev):
        if plan is None:
            order = torch.sort(morton_launch(query, support, stream), dim=-1,
                               stable=True).indices
            # s4 (B, N) and the boxes (B, NC, 2) float4 in one allocation
            NC = -(-N // PRUNED_CHUNK)
            scratch = torch.empty(B * (N + 2 * NC) * 4, dtype=torch.float32,
                                  device=dev)
            s4 = scratch.data_ptr()
            o = order.data_ptr()
            rc = lib.geot_knn_small_k_pruned(
                query.data_ptr(), o, Q + N, support.data_ptr(), o + 8 * Q,
                Q + N, Q, s4, s4 + 16 * B * N, d2.data_ptr(), idx.data_ptr(),
                skip_ptr, B, Q, N, k, stream)
        else:
            rc = lib.geot_knn_small_k_pruned(
                query.data_ptr(), plan.q_order.data_ptr(),
                plan.q_order.stride(0), None, None, 0, 0,
                plan.s4.data_ptr(), plan.boxes.data_ptr(), d2.data_ptr(),
                idx.data_ptr(), skip_ptr, B, Q, N, k, stream)
    _build.check_launch("knn_small_k_pruned", rc)
    if plan is None:
        _build.check_launch("knn_pruned_prepare", rc)
    return d2, idx


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        tile: int = _TILE, squared: bool = False):
    """Batched exact kNN: (B, Q, C), (B, N, C) -> (dist, idx), each
    (B, Q, k), ascending; idx int32. ``squared`` returns squared distances.

    k <= 4 on xyz with Q >= 128 goes through ``knn_small_k`` (the small-k
    kernel on a CUDA tensor, ``geot_tpu/ops/knn.py:113-120``; its plain
    version, the same tiled search, on the CPU); everything else the tiled
    path."""
    query = query.float().contiguous()
    support = support.float().contiguous()
    if k <= 4 and query.shape[-1] == 3 and query.shape[1] >= 128 \
            and support.shape[1] >= k:
        d2, idx = knn_small_k(query, support, k)
    else:
        d2, idx = _knn_tiled(query, support, k, tile)
    d2 = d2.clamp_min(0.0)
    return (d2 if squared else d2.sqrt()), idx


def knn_point(k: int, query: torch.Tensor,
              support: torch.Tensor | None = None, tile: int = _TILE,
              squared: bool = False, exact: bool = True,
              recall_target: float = 0.99, chunk_size=None):
    """``knn_point`` (``geot_tpu/ops/knn.py:132``): euclidean (dist, idx),
    ascending, self included when ``support`` is None (the query). The
    search is always exact: ``exact``, ``recall_target`` and
    ``chunk_size`` are taken for the signature and change nothing."""
    return knn(query, query if support is None else support, k, tile=tile,
               squared=squared)
