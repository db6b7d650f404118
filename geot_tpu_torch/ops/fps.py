"""Farthest point sampling.

``fps`` is the path's FPS: for a CUDA tensor it runs the cluster kernel
``csrc/fps_cluster.cu`` (one thread-block cluster per cloud, the winner of
each step exchanged through distributed shared memory), or, for a cloud
larger than a cluster's registers hold, the one-block kernel ``csrc/fps.cu``
(``fps_block``). ``fps_plan`` is that shape rule. Both kernels port
``geot_tpu/ops/pallas_fps.py:fps_pallas``. ``fps_ref`` is their plain
PyTorch version with the semantics of ``geot_tpu/ops/fps.py:_fps_impl``:
idx[0] = 0, the running min-distance starts at 1e10, and each step takes the
first maximum.

``fps_stratified`` is the serving pyramid's order
(``geot_tpu/ops/fps.py:95-167``): true FPS (``fps``, so the cluster kernel
on the card) for a prefix, then the rest of the cloud in a fixed order, in
plain PyTorch around the kernel as in ``geot_tpu``.

``fps_bucket`` is the wrapper of ``csrc/fps_bucket.cu`` (the port of
``geot_tpu/ops/pallas_fps.py:fps_bucket_pallas``): the same contract, bit
for bit, computed over Morton-sorted 1024-point buckets that are skipped
when their box proves no min-distance in them can change.
``fps_bucket_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build
from .group import gather_points
from .morton import morton_codes, spatial_sort

# fps_block: points per cloud whose xyz the kernel keeps in registers (512
# threads x 32, their min-distance in shared memory); the min-distance of
# the rest lives in a scratch buffer
_REG_POINTS = 512 * 32
# fps_cluster: threads per block, the slot counts (points per thread) it is
# built for, and the cluster sizes it tries
CLUSTER_THREADS = 256
CLUSTER_SLOTS = (2, 4, 8, 16)
CLUSTER_SIZES = (16, 8, 4, 2)
# fps_bucket: points per bucket and the most buckets a cloud may have
BUCKET = 1024
MAX_BUCKETS = 30
_SENT = 1 << 30          # original index of a padded bucket slot


def fps_ref(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices, plain PyTorch."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    idx = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        diff = xyz - xyz[rows, last][:, None, :]
        sq = diff * diff
        mind = torch.minimum(mind, sq[..., 0] + sq[..., 1] + sq[..., 2])
        last = torch.argmax(mind, dim=-1)       # first maximum on ties
        idx[:, j] = last.to(torch.int32)
    return idx


class FpsPlan(NamedTuple):
    """How ``fps`` runs a cloud of N points: ``route`` "fps_cluster" (C
    blocks, block r owning indices [r * per_cta, (r + 1) * per_cta) with
    ``slots`` points per thread) or "fps" (the one-block kernel)."""
    route: str
    C: int = 0
    per_cta: int = 0
    slots: int = 0

    def ranges(self, N: int):
        """Each block's contiguous index range, in rank order."""
        return [(min(N, r * self.per_cta), min(N, (r + 1) * self.per_cta))
                for r in range(self.C)]


def fps_cluster_size(max_active: Dict[int, int], batch: int) -> int:
    """The largest cluster size C of ``CLUSTER_SIZES`` whose ``batch``
    clusters (one per cloud) the card runs at once (``max_active[C]``, from
    ``cudaOccupancyMaxActiveClusters``); the smallest size if none does, and
    the batch then runs in waves."""
    for C in CLUSTER_SIZES:
        if max_active.get(C, 0) >= batch:
            return C
    return CLUSTER_SIZES[-1]


def fps_plan(N: int, C: int) -> FpsPlan:
    """The shape rule: a cloud of N points runs on C blocks when each
    block's ceil(N / C) points fit ``CLUSTER_SLOTS[-1]`` per thread, else on
    the one-block kernel."""
    per_cta = -(-N // C)
    need = -(-per_cta // CLUSTER_THREADS)
    for slots in CLUSTER_SLOTS:
        if slots >= need:
            return FpsPlan("fps_cluster", C, per_cta, slots)
    return FpsPlan("fps")


_max_active: Dict[int, Dict[int, int]] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def card_max_active(device: torch.device) -> Dict[int, int]:
    """Per cluster size of ``CLUSTER_SIZES``, how many clusters of the
    cluster kernel the card runs at once (``cudaOccupancyMaxActiveClusters``
    at 16 slots), queried once per device."""
    index = _index(device)
    if index not in _max_active:
        lib = _build.library()
        counts = {}
        with torch.cuda.device(index):
            for C in CLUSTER_SIZES:
                count = ctypes.c_int(0)
                rc = lib.geot_fps_cluster_max_active(C, ctypes.byref(count))
                if rc != 0:
                    raise RuntimeError(f"cudaOccupancyMaxActiveClusters at "
                                       f"C={C} failed with CUDA error {rc}")
                counts[C] = count.value
        _max_active[index] = counts
    return _max_active[index]


def card_cluster_size(device: torch.device, batch: int) -> int:
    """``fps_cluster_size`` of the card for ``batch`` clouds."""
    return fps_cluster_size(card_max_active(device), batch)


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 indices; idx[:, 0] == 0.

    A CUDA tensor goes to the cluster kernel or, by ``fps_plan``, to the
    one-block kernel; a CPU tensor to ``fps_ref``."""
    if xyz.device.type == "cpu":
        return fps_ref(xyz, npoint)
    _check_fps_args("fps", xyz, npoint)
    B, N, _ = xyz.shape
    plan = fps_plan(N, card_cluster_size(xyz.device, B))
    if plan.route == "fps":
        return fps_block(xyz, npoint)
    return fps_cluster(xyz, npoint, plan)


def fps_cluster(xyz: torch.Tensor, npoint: int, plan: FpsPlan
                ) -> torch.Tensor:
    """The cluster kernel with the given plan; a CPU tensor goes to
    ``fps_ref``."""
    if xyz.device.type == "cpu":
        return fps_ref(xyz, npoint)
    _check_fps_args("fps_cluster", xyz, npoint)
    if plan.route != "fps_cluster":
        raise ValueError(f"fps_cluster: bad plan {plan}")
    B, N, _ = xyz.shape
    lib = _build.library()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    rc = lib.geot_fps_cluster(xyz.data_ptr(), out.data_ptr(), B, N, npoint,
                              plan.C, plan.per_cta, plan.slots, stream)
    _build.check_launch("fps_cluster", rc)
    return out


def cluster_exchange(B: int, npoint: int, C: int,
                     device: torch.device) -> torch.Tensor:
    """The cluster kernel's exchange alone, for timing: B clusters of C
    blocks run npoint - 1 steps of writing an entry to every peer, the
    step's synchronisation and the reduction of the C entries, with no
    distance work. Returns each step's winning rank (B, npoint); a probe,
    on no path, so it counts no launch."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"cluster_exchange: needs a CUDA device, got "
                         f"{device}")
    lib = _build.library()
    out = torch.zeros((B, npoint), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.geot_cluster_exchange(out.data_ptr(), B, npoint, C, stream)
    if rc != 0:
        raise RuntimeError(f"cluster_exchange kernel launch failed with "
                           f"CUDA error {rc}")
    return out


def fps_block(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The one-block kernel ``csrc/fps.cu``, for any N; a CPU tensor goes
    to ``fps_ref``."""
    if xyz.device.type == "cpu":
        return fps_ref(xyz, npoint)
    _check_fps_args("fps_block", xyz, npoint)
    B, N, _ = xyz.shape
    lib = _build.library()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    tail = (torch.empty((B, N - _REG_POINTS), dtype=torch.float32,
                        device=xyz.device) if N > _REG_POINTS else None)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    rc = lib.geot_fps(xyz.data_ptr(),
                      tail.data_ptr() if tail is not None else None,
                      out.data_ptr(), B, N, npoint, stream)
    _build.check_launch("fps", rc)
    return out


def fps_gather(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS returning the sampled coordinates (B, npoint, 3)."""
    return gather_points(xyz, fps(xyz, npoint))


def _bitrev_schedule(n: int) -> np.ndarray:
    """The bit-reversed visit order of 0..n-1 (van der Corput): every prefix
    of it is spread evenly over [0, n)."""
    bits = max(1, (n - 1).bit_length())
    idx = np.arange(1 << bits)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev[rev < n]


@functools.lru_cache(maxsize=16)
def _bitrev_on(n: int, device: torch.device) -> torch.Tensor:
    """``_bitrev_schedule(n)`` on ``device``, uploaded once: a copy from
    pageable host memory would wait for the device's queue on every call."""
    return torch.from_numpy(_bitrev_schedule(n)).to(device)


def fps_stratified(xyz: torch.Tensor, npoint: int, fps_prefix: int,
                   perm_seed: int = 0, fill: str = "morton") -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices without repeats: true FPS for
    the first ``fps_prefix`` (``fps``), then the points not yet taken in a
    fixed order. ``fill="morton"`` visits the cloud's Morton curve in
    bit-reversed order, so every prefix of the fill covers the cloud
    evenly; ``fill="perm"`` takes ``np.random.default_rng(perm_seed)
    .permutation(N)``. With ``npoint == N`` the result is a permutation.

    A cloud with fewer distinct points than ``fps_prefix`` makes FPS repeat
    indices once its min-distances reach 0; only the first occurrence of
    each head index is kept, and the kept entries of [head | fill] are
    packed in order by a stable partition (two cumulative sums and one
    scatter), as ``geot_tpu`` does, so the result is bit-equal to its."""
    B, N, _ = xyz.shape
    fps_prefix = min(fps_prefix, npoint)
    xyz = xyz.float().contiguous()
    head = fps(xyz, fps_prefix)
    if fps_prefix == npoint:
        return head
    dev = xyz.device
    if fill == "morton":
        # stable, as jnp.argsort: equal codes are common at 10 bits an axis
        curve = torch.sort(morton_codes(xyz), dim=-1, stable=True).indices
        cand = curve[:, _bitrev_on(N, dev)]
    elif fill == "perm":
        perm = np.random.default_rng(perm_seed).permutation(N)
        cand = torch.from_numpy(perm).to(dev)[None].expand(B, N)
    else:
        raise ValueError(f"fps_stratified: fill must be 'morton' or "
                         f"'perm', got {fill!r}")
    head = head.long()
    L = head.shape[1]
    taken = torch.zeros((B, N), dtype=torch.bool, device=dev).scatter_(
        1, head, True)
    untaken = ~taken.gather(1, cand)
    jot = torch.arange(L, device=dev).expand(B, L)
    first = torch.full((B, N), L, device=dev).scatter_reduce(
        1, head, jot, reduce="amin")
    occ = first.gather(1, head) == jot
    # kept: the k distinct head indices and the N - k untaken candidates,
    # exactly N, so ``pos`` is a bijection onto [0, L + N)
    seqv = torch.cat([head, cand], dim=1)
    keep = torch.cat([occ, untaken], dim=1)
    pos = torch.where(keep, keep.cumsum(1) - 1, N + (~keep).cumsum(1) - 1)
    part = torch.empty_like(seqv).scatter_(1, pos, seqv)
    return part[:, :npoint].to(torch.int32)


def _check_fps_args(name: str, xyz: torch.Tensor, npoint: int) -> None:
    if xyz.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xyz.device}")
    _check_xyz(name, xyz)
    if xyz.shape[1] < 1 or npoint < 1:
        raise ValueError(f"{name}: need N >= 1 and npoint >= 1, got "
                         f"N={xyz.shape[1]}, npoint={npoint}")


def _check_xyz(name: str, xyz: torch.Tensor) -> None:
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"{name}: expected (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError(f"{name}: xyz must be contiguous")


def fps_bucket_plan(xyz: torch.Tensor):
    """What ``fps_bucket``'s kernel reads, in plain PyTorch (the part of
    ``fps_bucket_pallas`` outside its ``pallas_call``): the cloud
    Morton-sorted and padded to whole buckets (padding at 1e9), each sorted
    slot's original index (``1 << 30`` for padding) and each bucket's box
    (min xyz, max xyz) over its real points.

    Returns ``(sorted_xyz (B, nb*1024, 3), order (B, nb*1024) int32,
    boxes (B, nb, 6))``."""
    B, N, _ = xyz.shape
    nb = -(-N // BUCKET)
    pad = nb * BUCKET - N
    sx, order = spatial_sort(xyz)
    sx = torch.nn.functional.pad(sx, (0, 0, 0, pad), value=1e9)
    order = torch.nn.functional.pad(order, (0, pad), value=_SENT)
    pts = sx.reshape(B, nb, BUCKET, 3)
    valid = (order < _SENT).reshape(B, nb, BUCKET, 1)
    bmin = torch.where(valid, pts, 4e9).amin(dim=2)
    bmax = torch.where(valid, pts, -4e9).amax(dim=2)
    return (sx.contiguous(), order.contiguous(),
            torch.cat([bmin, bmax], dim=-1).contiguous())


def fps_bucket_ref(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version of the bucket kernel: its contract is exact FPS, so
    this is ``fps_ref``."""
    return fps_ref(xyz, npoint)


def fps_bucket(xyz: torch.Tensor, npoint: int,
               skipped: "torch.Tensor | None" = None,
               plan=None) -> torch.Tensor:
    """(B, N, 3) float32, N <= 30 * 1024 -> (B, npoint) int32 original
    indices, equal to ``fps``.

    A CUDA tensor goes to the kernel, a CPU tensor to ``fps_bucket_ref``.
    ``skipped``, a one-element int64 CUDA tensor, gets the number of
    (step, bucket) distance updates the kernel skipped added to it.
    ``plan`` is ``fps_bucket_plan(xyz)`` when the caller has it already."""
    if xyz.device.type == "cpu":
        return fps_bucket_ref(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps_bucket: unsupported device {xyz.device}")
    _check_xyz("fps_bucket", xyz)
    B, N, _ = xyz.shape
    if N < 1 or npoint < 1 or -(-N // BUCKET) > MAX_BUCKETS:
        raise ValueError(f"fps_bucket: need 1 <= N <= {MAX_BUCKETS * BUCKET} "
                         f"and npoint >= 1, got N={N}, npoint={npoint}")
    if skipped is not None and (skipped.dtype != torch.int64
                                or skipped.numel() != 1
                                or skipped.device != xyz.device):
        raise ValueError("fps_bucket: skipped must be one int64 element on "
                         "the device of xyz")
    lib = _build.library()
    sx, order, boxes = fps_bucket_plan(xyz) if plan is None else plan
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    rc = lib.geot_fps_bucket(xyz.data_ptr(), sx.data_ptr(), order.data_ptr(),
                             boxes.data_ptr(), out.data_ptr(),
                             skipped.data_ptr() if skipped is not None
                             else None, B, N, boxes.shape[1], npoint, stream)
    _build.check_launch("fps_bucket", rc)
    return out
