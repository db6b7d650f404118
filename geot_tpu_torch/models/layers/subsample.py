"""Subsampling layer API (``geot_tpu/models/layers/subsample.py``):
``furthest_point_sample`` (the port's ``ops.fps``: the FPS kernel on a
CUDA tensor) and ``random_sample``, which draws each cloud's indices from
``generator`` (``geot_tpu`` splits a ``jax.random`` key) or takes them as
``perms``."""
from __future__ import annotations

from typing import Optional

import torch

from ...ops import fps as _fps


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices."""
    return _fps(xyz.float().contiguous(), npoint)


def random_sample(xyz: torch.Tensor, npoint: int,
                  generator: Optional[torch.Generator] = None,
                  perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, ...) -> (B, npoint) distinct indices a cloud: the first
    ``npoint`` of a permutation of N per cloud (``perms`` (B, N), or drawn
    from ``generator``), as ``jax.random.choice`` without replacement."""
    B, N = xyz.shape[0], xyz.shape[1]
    if perms is None:
        perms = torch.stack([torch.randperm(N, generator=generator)
                             for _ in range(B)])
    return torch.as_tensor(perms)[:, :npoint].to(torch.int32).to(xyz.device)
