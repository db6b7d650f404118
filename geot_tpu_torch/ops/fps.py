"""Farthest point sampling.

``fps`` is the wrapper of the CUDA kernel ``csrc/fps.cu`` (the port of
``geot_tpu/ops/pallas_fps.py:fps_pallas``); ``fps_ref`` is its plain PyTorch
version with the semantics of ``geot_tpu/ops/fps.py:_fps_impl``: idx[0] = 0,
the running min-distance starts at 1e10, and each step takes the first
maximum.

``fps_bucket`` is the wrapper of ``csrc/fps_bucket.cu`` (the port of
``geot_tpu/ops/pallas_fps.py:fps_bucket_pallas``): the same contract, bit
for bit, computed over Morton-sorted 1024-point buckets that are skipped
when their box proves no min-distance in them can change.
``fps_bucket_ref`` is its plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .group import gather_points
from .morton import spatial_sort

# points per cloud whose xyz the kernel keeps in registers (512 threads x
# 32, their min-distance in shared memory); the min-distance of the rest
# lives in a scratch buffer
_REG_POINTS = 512 * 32
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


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 indices; idx[:, 0] == 0.

    A CUDA tensor goes to the kernel, a CPU tensor to ``fps_ref``."""
    if xyz.device.type == "cpu":
        return fps_ref(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    _check_xyz("fps", xyz)
    B, N, _ = xyz.shape
    if N < 1 or npoint < 1:
        raise ValueError(f"fps: need N >= 1 and npoint >= 1, got N={N}, "
                         f"npoint={npoint}")
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
