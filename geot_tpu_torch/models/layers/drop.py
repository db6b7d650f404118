"""Stochastic regularisation (``geot_tpu/models/layers/drop.py``):
``drop_path`` (per-sample stochastic depth) and DropBlock on channels-last
(B, H, W, C) maps (``drop_block_2d``, ``drop_block_fast_2d`` and the
module ``DropBlock2d``).

Masks come from ``generator`` (torch's default generator when it is None),
where ``geot_tpu`` takes a ``jax.random`` key. The draws can be given
instead: ``draw`` (U[0, 1), kept where below the keep rate) for
``drop_path``; ``uniform`` (U[0, 1), the seeds) and ``normal`` (N(0, 1),
the noise) for DropBlock; with ``geot_tpu``'s draws the results are its.
``DropPath`` (the module) lives in ``common``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from .common import DropPath  # noqa: F401  (re-exported as in geot_tpu)


def drop_path(x: torch.Tensor, drop_prob: float = 0.0,
              training: bool = False, scale_by_keep: bool = True,
              generator: Optional[torch.Generator] = None,
              draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero whole samples with probability ``drop_prob`` and scale the
    kept ones by 1 / keep (``scale_by_keep``); identity at eval."""
    if drop_prob == 0.0 or not training:
        return x
    keep = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    if draw is None:
        draw = torch.rand(shape, generator=generator, device=x.device)
    mask = draw.reshape(shape).to(x.device) < keep
    return torch.where(mask, x / keep if scale_by_keep else x,
                       torch.zeros_like(x))


def _block_gamma(drop_prob, block_size, H, W):
    clipped = min(block_size, min(W, H))
    gamma = drop_prob * W * H / clipped ** 2 / (
        (W - block_size + 1) * (H - block_size + 1))
    return clipped, gamma


def _max_pool_same(m: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 max pool of (B, H, W, C) with padding k // 2, cut back to
    (H, W) (an even k drops the last row and column)."""
    H, W = m.shape[1], m.shape[2]
    out = F.max_pool2d(m.permute(0, 3, 1, 2), k, stride=1, padding=k // 2)
    return out[:, :, :H, :W].permute(0, 2, 3, 1)


def _draws(shape, x, generator, uniform, normal, with_noise):
    if uniform is None:
        uniform = torch.rand(shape, generator=generator, device=x.device,
                             dtype=x.dtype)
    if with_noise and normal is None:
        normal = torch.randn(shape, generator=generator, device=x.device,
                             dtype=x.dtype)
    return (uniform.to(x.device, x.dtype),
            None if normal is None else normal.to(x.device, x.dtype))


def drop_block_2d(x: torch.Tensor, drop_prob: float = 0.1,
                  block_size: int = 7, gamma_scale: float = 1.0,
                  with_noise: bool = False, batchwise: bool = False,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None,
                  normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DropBlock: seeds at rate ``gamma`` inside the valid region, grown to
    ``block_size`` squares, then the kept share renormalised (or the
    dropped blocks filled with noise). ``batchwise`` draws one (1, H, W, C)
    mask for the batch."""
    B, H, W, C = x.shape
    clipped, gamma = _block_gamma(drop_prob, block_size, H, W)
    gamma = gamma * gamma_scale
    h_i = torch.arange(H, device=x.device)[:, None]
    w_i = torch.arange(W, device=x.device)[None, :]
    valid = ((w_i >= clipped // 2) & (w_i < W - (clipped - 1) // 2)
             & (h_i >= clipped // 2) & (h_i < H - (clipped - 1) // 2))
    valid = valid.to(x.dtype)[None, :, :, None]
    shape = (1, H, W, C) if batchwise else tuple(x.shape)
    uniform, normal = _draws(shape, x, generator, uniform, normal, with_noise)
    block_mask = ((2 - gamma - valid + uniform) >= 1).to(x.dtype)
    block_mask = -_max_pool_same(-block_mask, clipped)
    if with_noise:
        return x * block_mask + normal * (1 - block_mask)
    scale = block_mask.numel() / (block_mask.float().sum() + 1e-7)
    return x * block_mask * scale.to(x.dtype)


def drop_block_fast_2d(x: torch.Tensor, drop_prob: float = 0.1,
                       block_size: int = 7, gamma_scale: float = 1.0,
                       with_noise: bool = False,
                       generator: Optional[torch.Generator] = None,
                       uniform: Optional[torch.Tensor] = None,
                       normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DropBlock without the valid-region mask: seeds where ``uniform <
    gamma``, grown to blocks."""
    B, H, W, C = x.shape
    clipped, gamma = _block_gamma(drop_prob, block_size, H, W)
    gamma = gamma * gamma_scale
    uniform, normal = _draws(tuple(x.shape), x, generator, uniform, normal,
                             with_noise)
    block_mask = _max_pool_same((uniform < gamma).to(x.dtype), clipped)
    if with_noise:
        return x * (1.0 - block_mask) + normal * block_mask
    block_mask = 1 - block_mask
    scale = block_mask.numel() / (block_mask.float().sum() + 1e-6)
    return x * block_mask * scale.to(x.dtype)


class DropBlock2d(nn.Module):
    """DropBlock as a module: identity at eval or at rate 0; the fast
    variant unless ``fast=False``."""

    def __init__(self, drop_prob: float = 0.1, block_size: int = 7,
                 gamma_scale: float = 1.0, with_noise: bool = False,
                 batchwise: bool = False, fast: bool = True):
        super().__init__()
        self.drop_prob = drop_prob
        self.block_size = block_size
        self.gamma_scale = gamma_scale
        self.with_noise = with_noise
        self.batchwise = batchwise
        self.fast = fast

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None,
                normal: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or not self.drop_prob:
            return x
        if self.fast:
            return drop_block_fast_2d(x, self.drop_prob, self.block_size,
                                      self.gamma_scale, self.with_noise,
                                      generator, uniform, normal)
        return drop_block_2d(x, self.drop_prob, self.block_size,
                             self.gamma_scale, self.with_noise,
                             self.batchwise, generator, uniform, normal)
