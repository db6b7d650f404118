"""Morton (Z-order) spatial sorting (``geot_tpu/ops/morton.py``).

The bucket-pruned kernels (``fps_bucket``, ``knn_small_k_pruned``) sort a
cloud by Morton code so that contiguous runs of points are spatially
coherent: a fixed-size bucket then has a tight bounding box, and a box
distance bound can prove that a whole bucket needs no work. Plain PyTorch,
outside the kernels, as in ``geot_tpu``.
"""
from __future__ import annotations

from typing import Optional

import torch


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


def spatial_sort(xyz: torch.Tensor):
    """(B, N, 3) -> (sorted_xyz, order), order (B, N) int32 with
    ``sorted_xyz[b, i] = xyz[b, order[b, i]]``. The sort is stable, as
    ``jnp.argsort`` is, so equal codes keep their index order."""
    code = morton_codes(xyz)
    order = torch.sort(code, dim=-1, stable=True).indices
    sorted_xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    return sorted_xyz, order.to(torch.int32)
