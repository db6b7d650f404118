"""Farthest point sampling.

``fps`` is the path's FPS: for a CUDA tensor it runs the cluster kernel
``csrc/fps_cluster.cu`` (one thread-block cluster per cloud, the winner of
each step exchanged through distributed shared memory); a cloud larger than
a cluster's registers hold (``fps_plan``'s route "fps") goes to the
bucket-pruned cluster kernel ``csrc/fps_bucket.cu`` (``fps_bucket``) up to
what its clusters' shared memory holds, and above that to the one-block
kernel ``csrc/fps.cu`` (``fps_block``). The cluster and block kernels port
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
for bit, computed by a cluster over Morton-sorted 256-point buckets that
are skipped when their box proves no min-distance in them can change.
``fps_bucket_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build
from .group import gather_points
from .morton import morton_codes, morton_codes_kernel

# fps_block: points per cloud whose xyz the kernel keeps in registers (512
# threads x 32, their min-distance in shared memory); the min-distance of
# the rest lives in a scratch buffer
_REG_POINTS = 512 * 32
# fps_cluster: threads per block, the slot counts (points per thread) it is
# built for, and the cluster sizes it tries
CLUSTER_THREADS = 256
CLUSTER_SLOTS = (2, 4, 8, 16)
CLUSTER_SIZES = (16, 8, 4, 2)
# fps_bucket: points per bucket and the most buckets a block holds in its
# shared memory (csrc/fps_bucket.cu)
BUCKET = 256
BUCKET_BLOCK = 44


def fps_ref(xyz: torch.Tensor, npoint: int,
            weights: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices, plain PyTorch. With
    ``weights`` (B, N), each point's squared distance is scaled by its
    weight before the running minimum (``fps_weighted``)."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    idx = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        diff = xyz - xyz[rows, last][:, None, :]
        sq = diff * diff
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        mind = torch.minimum(mind, d2 if weights is None else d2 * weights)
        last = torch.argmax(mind, dim=-1)       # first maximum on ties
        idx[:, j] = last.to(torch.int32)
    return idx


def fps_weighted(xyz: torch.Tensor, weights: torch.Tensor,
                 npoint: int) -> torch.Tensor:
    """Weighted FPS (``geot_tpu/ops/fps.py:55``, the reference's
    ``pointops.fps_weight``): (B, N, 3), (B, N) -> (B, npoint) int32.
    Each step takes the point whose ``min over the chosen of d2 *
    max(w, 1e-12)`` is largest, first maximum on ties; idx[0] = 0 and the
    running minimum starts at 1e10, as ``fps_ref``.

    Plain PyTorch on both devices, as ``geot_tpu`` runs it as an XLA loop
    (no Pallas kernel exists for it): on the card it is ``npoint`` steps of
    a few launches each."""
    return fps_ref(xyz, npoint, weights.float().clamp_min(1e-12))


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
_bucket_max_active: Dict[int, Dict[int, int]] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _card_max_active(device: torch.device, cache: Dict[int, Dict[int, int]],
                     query: str) -> Dict[int, int]:
    """Per cluster size of ``CLUSTER_SIZES``, how many clusters the card
    runs at once by the launcher ``query`` (``cudaOccupancyMaxActiveClusters``
    at the kernel's largest shared memory), asked once per device."""
    index = _index(device)
    if index not in cache:
        fn = getattr(_build.library(), query)
        counts = {}
        with torch.cuda.device(index):
            for C in CLUSTER_SIZES:
                count = ctypes.c_int(0)
                rc = fn(C, ctypes.byref(count))
                if rc != 0:
                    raise RuntimeError(f"cudaOccupancyMaxActiveClusters at "
                                       f"C={C} failed with CUDA error {rc}")
                counts[C] = count.value
        cache[index] = counts
    return cache[index]


def card_max_active(device: torch.device) -> Dict[int, int]:
    """``_card_max_active`` of the cluster kernel at 16 slots."""
    return _card_max_active(device, _max_active,
                            "geot_fps_cluster_max_active")


def card_bucket_max_active(device: torch.device) -> Dict[int, int]:
    """``_card_max_active`` of the bucket kernel at 44 buckets a block."""
    return _card_max_active(device, _bucket_max_active,
                            "geot_fps_bucket_max_active")


def card_cluster_size(device: torch.device, batch: int) -> int:
    """``fps_cluster_size`` of the card for ``batch`` clouds."""
    return fps_cluster_size(card_max_active(device), batch)


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 indices; idx[:, 0] == 0.

    The custom op ``geot::fps``: a CUDA tensor goes to the cluster kernel
    or, by ``fps_plan`` and ``bucket_capacity`` (chosen inside the op at
    run time), to the bucket kernel or the one-block kernel; a CPU tensor
    to ``fps_ref``; another device
    raises. ``torch.export`` keeps the op in the exported graph."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fps: unsupported device {xyz.device}")
    return torch.ops.geot.fps(xyz, npoint)


@torch.library.custom_op("geot::fps", mutates_args=())
def _fps_op(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return fps_direct(xyz, npoint)


def fps_direct(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """What ``geot::fps`` runs, called without the op's dispatch (for
    timing the dispatch)."""
    if xyz.device.type == "cpu":
        return fps_ref(xyz, npoint)
    _check_fps_args("fps", xyz, npoint)
    B, N, _ = xyz.shape
    plan = fps_plan(N, card_cluster_size(xyz.device, B))
    # the launch goes to the current card: make it the tensor's
    with torch.cuda.device(xyz.device):
        if plan.route == "fps_cluster":
            return fps_cluster(xyz, npoint, plan)
        if N <= bucket_capacity(CLUSTER_SIZES[0]):
            return fps_bucket(xyz, npoint)
        return fps_block(xyz, npoint)


@_fps_op.register_fake
def _fps_fake(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


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


_BITREV: Dict[tuple, torch.Tensor] = {}


def _bitrev_on(n: int, device: torch.device) -> torch.Tensor:
    """``_bitrev_schedule(n)`` on ``device``, uploaded once: a copy from
    pageable host memory would wait for the device's queue on every call.
    Under ``torch.export`` a cached schedule is a real tensor on the
    device, which the exported program keeps as a constant there (so
    ``export_forward`` runs the model once before tracing); one made
    during the trace is not cached."""
    key = (n, torch.device(device))
    sched = _BITREV.get(key)
    if sched is None:
        sched = torch.from_numpy(_bitrev_schedule(n)).to(device)
        if not torch.compiler.is_compiling():
            _BITREV[key] = sched
    return sched


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


def fps_bucket_plan(xyz: torch.Tensor) -> torch.Tensor:
    """What ``fps_bucket``'s kernel reads besides the cloud: the stable sort
    of its Morton codes, (B, N) int64 (the part of ``fps_bucket_pallas``
    outside its ``pallas_call`` that orders the points). On the card the
    codes come from the Morton kernel (one launch, counted in
    ``LAUNCHES``); on the CPU from ``morton_codes``."""
    return torch.sort(morton_codes_kernel(xyz), dim=-1, stable=True).indices


def fps_bucket_ref(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version of the bucket kernel: its contract is exact FPS, so
    this is ``fps_ref``."""
    return fps_ref(xyz, npoint)


def bucket_capacity(C: int) -> int:
    """The most points a cluster of C blocks of the bucket kernel holds."""
    return C * BUCKET_BLOCK * BUCKET


def fps_bucket_size(max_active: Dict[int, int], batch: int, N: int) -> int:
    """The bucket kernel's cluster size for ``batch`` clouds of N points:
    of the sizes in ``CLUSTER_SIZES`` whose blocks hold N, the largest
    whose ``batch`` clusters the card runs at once (``max_active[C]``), else
    the smallest, and the batch runs in waves. Raises if no size holds
    N."""
    holds = [C for C in CLUSTER_SIZES if bucket_capacity(C) >= N]
    if not holds:
        raise ValueError(f"fps_bucket: N = {N} is more than a cluster holds "
                         f"({bucket_capacity(CLUSTER_SIZES[0])} points)")
    for C in holds:
        if max_active.get(C, 0) >= batch:
            return C
    return holds[-1]


def fps_bucket(xyz: torch.Tensor, npoint: int,
               skipped: "torch.Tensor | None" = None,
               plan: "torch.Tensor | None" = None) -> torch.Tensor:
    """(B, N, 3) float32, N <= ``bucket_capacity(16)`` (180,224) -> (B,
    npoint) int32 original indices, equal to ``fps``.

    A CUDA tensor goes to the kernel, a CPU tensor to ``fps_bucket_ref``.
    ``skipped``, a one-element int64 CUDA tensor, gets the number of
    (step, bucket) distance updates the kernel skipped added to it.
    ``plan`` is ``fps_bucket_plan(xyz)`` when the caller has it already.
    The cluster size is ``fps_bucket_size`` of the card."""
    if xyz.device.type == "cpu":
        return fps_bucket_ref(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps_bucket: unsupported device {xyz.device}")
    _check_xyz("fps_bucket", xyz)
    B, N, _ = xyz.shape
    if N < 1 or npoint < 1 or N > bucket_capacity(CLUSTER_SIZES[0]):
        raise ValueError(f"fps_bucket: need 1 <= N <= "
                         f"{bucket_capacity(CLUSTER_SIZES[0])} and npoint >= "
                         f"1, got N={N}, npoint={npoint}")
    C = fps_bucket_size(card_bucket_max_active(xyz.device), B, N)
    if skipped is not None and (skipped.dtype != torch.int64
                                or skipped.numel() != 1
                                or skipped.device != xyz.device):
        raise ValueError("fps_bucket: skipped must be one int64 element on "
                         "the device of xyz")
    if plan is None:
        plan = fps_bucket_plan(xyz)
    lib = _build.library()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    with torch.cuda.device(xyz.device):
        rc = lib.geot_fps_bucket(xyz.data_ptr(), plan.data_ptr(),
                                 out.data_ptr(),
                                 skipped.data_ptr() if skipped is not None
                                 else None, B, N, npoint, C, -(-N // C),
                                 stream)
    _build.check_launch("fps_bucket", rc)
    return out
