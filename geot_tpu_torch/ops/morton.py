"""Morton (Z-order) spatial sorting (``geot_tpu/ops/morton.py``).

The bucket-pruned kernels (``fps_bucket``, ``knn_small_k_pruned``) sort a
cloud by Morton code so that contiguous runs of points are spatially
coherent: a fixed-size bucket then has a tight bounding box, and a box
distance bound can prove that a whole bucket needs no work.
``morton_codes`` is plain PyTorch, as ``geot_tpu`` computes the codes
outside its kernels; ``morton_codes_kernel`` is the same function by the
CUDA kernel ``csrc/morton.cu``, the first launch of those kernels' plans on
the card, and ``morton_codes`` is its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each int32 out to every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(xyz: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3) -> (B, N) int32 Morton codes, 10 bits per axis, over each
    cloud's bounding box of valid points; invalid points get the largest
    code so they sort last."""
    xyz = xyz.float()
    if valid is not None:
        big = 3e38
        v = valid[..., None]
        mn = torch.where(v, xyz, big).amin(dim=1, keepdim=True)
        mx = torch.where(v, xyz, -big).amax(dim=1, keepdim=True)
    else:
        mn = xyz.amin(dim=1, keepdim=True)
        mx = xyz.amax(dim=1, keepdim=True)
    # tensor / tensor: torch computes ``scalar / tensor`` as a reciprocal
    # times the scalar, which rounds differently from JAX's division (and
    # ``full_like``, not a tensor made from a Python number, which on the
    # card would be a copy that waits for the device's queue)
    extent = (mx - mn).clamp_min(1e-9)
    scale = torch.full_like(extent, 1023.0) / extent
    q = ((xyz - mn) * scale).clamp(0.0, 1023.0).to(torch.int32)
    code = (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
            | (_spread3(q[..., 2]) << 2))
    if valid is not None:
        code = torch.where(valid, code, torch.full_like(code, 0x7FFFFFFF))
    return code


# set on the second cloud's codes in a joint row (above a code's 30 bits),
# so that one stable sort of the row orders both clouds, the first before
# the second
MORTON_TAG = 1 << 30


def morton_codes_joint(xyz: torch.Tensor, other: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of ``morton_codes_kernel(xyz, other)``: (B, N, 3) and
    (B, M, 3) -> (B, N + M) int32, ``morton_codes(xyz)`` then
    ``morton_codes(other) | MORTON_TAG``."""
    return torch.cat([morton_codes(xyz), morton_codes(other) | MORTON_TAG],
                     dim=1)


def morton_codes_kernel(xyz: torch.Tensor,
                        other: Optional[torch.Tensor] = None):
    """``morton_codes(xyz)`` by the kernel ``csrc/morton.cu``, bit-equal;
    with ``other`` ((B, M, 3), the batch of ``xyz``), the joint row of
    ``morton_codes_joint`` from the same single launch. A CPU tensor goes
    to the plain version."""
    clouds = (xyz,) if other is None else (xyz, other)
    if all(t.device.type == "cpu" for t in clouds):
        return morton_codes(xyz) if other is None else \
            morton_codes_joint(xyz, other)
    for t in clouds:
        if t.device.type != "cuda" or t.device != xyz.device:
            raise ValueError(f"morton_codes_kernel: clouds on {xyz.device} "
                             f"and {t.device}; both must be on one CUDA "
                             f"device (or both on the CPU)")
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3 \
                or not t.is_contiguous() or t.shape[1] < 1:
            raise ValueError(f"morton_codes_kernel: expected contiguous "
                             f"(B, N >= 1, 3) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape[0] != xyz.shape[0]:
            raise ValueError(f"morton_codes_kernel: batch {xyz.shape[0]} "
                             f"vs {t.shape[0]}")
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    with torch.cuda.device(xyz.device):
        return morton_launch(xyz, other, stream)


def morton_launch(xyz: torch.Tensor, other: Optional[torch.Tensor],
                  stream: int) -> torch.Tensor:
    """``morton_codes_kernel``'s launch on ``stream``, the tensors checked
    and their device current."""
    B, N = xyz.shape[:2]
    M = 0 if other is None else other.shape[1]
    codes = torch.empty((B, N + M), dtype=torch.int32, device=xyz.device)
    ptr = codes.data_ptr()
    rc = _build.library().geot_morton_codes(
        xyz.data_ptr(), ptr, N, None if other is None else other.data_ptr(),
        ptr + 4 * N, M, B, N + M, N + M, MORTON_TAG, stream)
    _build.check_launch("morton", rc)
    return codes
