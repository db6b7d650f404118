"""Farthest point sampling.

``fps`` is the wrapper of the CUDA kernel ``csrc/fps.cu`` (the port of
``geot_tpu/ops/pallas_fps.py:fps_pallas``); ``fps_ref`` is its plain PyTorch
version with the semantics of ``geot_tpu/ops/fps.py:_fps_impl``: idx[0] = 0,
the running min-distance starts at 1e10, and each step takes the first
maximum.
"""
from __future__ import annotations

import torch

from . import _build
from .group import gather_points

# points per cloud whose xyz the kernel keeps in registers (512 threads x
# 32, their min-distance in shared memory); the min-distance of the rest
# lives in a scratch buffer
_REG_POINTS = 512 * 32


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
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: expected (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("fps: xyz must be contiguous")
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
