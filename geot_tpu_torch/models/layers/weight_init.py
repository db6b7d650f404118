"""Weight initialisers (``geot_tpu/models/layers/weight_init.py``): the
truncated normal by the inverse CDF, fan-scaled variance scaling and
LeCun's normal.

Each takes a tensor, which it fills in place and returns (the torch
reference's call), or a shape, for which it returns a new tensor. Draws
come from ``generator`` (torch's default generator when it is None), where
``geot_tpu`` takes a ``jax.random`` key; ``draw`` gives the base sample
instead: U[0, 1) for the truncated normal and the uniform, N(0, 1) for the
normal. Given the same base sample, the results are ``geot_tpu``'s: the
uniform is mapped onto [lo, hi) in float32 as ``jax.random.uniform``
maps its [0, 1) floats.

Fans follow the torch convention (``fan_in = shape[1] * prod(shape[2:])``)
unless ``fan_axes="flax"`` (``fan_in = prod(shape[:-1])``, ``fan_out =
shape[-1]``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _target(shape_or_tensor, dtype):
    if torch.is_tensor(shape_or_tensor):
        return shape_or_tensor, tuple(shape_or_tensor.shape), \
            dtype or shape_or_tensor.dtype
    return None, tuple(shape_or_tensor), dtype or torch.float32


def _finish(out, values, dtype):
    values = values.to(dtype)
    if out is None:
        return values
    with torch.no_grad():
        out.copy_(values)
    return out


def _uniform(shape, lo, hi, generator, draw):
    """U[lo, hi) in float32 from a U[0, 1) sample, as ``jax.random.uniform``
    computes it: ``max(lo, u * (hi - lo) + lo)`` with lo and hi rounded to
    float32 first."""
    u = draw if draw is not None else torch.rand(shape, generator=generator)
    u = torch.as_tensor(u, dtype=torch.float32)
    lo32 = torch.tensor(lo, dtype=torch.float32)
    hi32 = torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo32, u * (hi32 - lo32) + lo32)


def trunc_normal_(tensor, mean: float = 0.0, std: float = 1.0,
                  a: float = -2.0, b: float = 2.0, dtype=None,
                  generator: Optional[torch.Generator] = None, draw=None):
    """N(mean, std^2) truncated to [a, b] (absolute bounds): a uniform in
    [2 cdf(a) - 1, 2 cdf(b) - 1] (1e-7 inside each end), ``erfinv``, scale
    and shift, clamp."""
    out, shape, dtype = _target(tensor, dtype)

    def norm_cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    lo = norm_cdf((a - mean) / std)
    up = norm_cdf((b - mean) / std)
    u = _uniform(shape, 2 * lo - 1 + 1e-7, 2 * up - 1 - 1e-7, generator, draw)
    x = torch.erfinv(u) * (std * math.sqrt(2.0)) + mean
    return _finish(out, x.clamp(a, b), dtype)


def _fans(shape, fan_axes: str):
    if fan_axes == "flax":
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
        return fan_in, shape[-1]
    if len(shape) == 1:
        return shape[0], shape[0]
    rest = math.prod(shape[2:])
    return shape[1] * rest, shape[0] * rest


def variance_scaling_(tensor, scale: float = 1.0, mode: str = "fan_in",
                      distribution: str = "normal", dtype=None,
                      fan_axes: str = "torch",
                      generator: Optional[torch.Generator] = None,
                      draw=None):
    """Variance ``scale / fan`` (``mode``: fan_in, fan_out, fan_avg) as a
    normal, a truncated normal (std over 0.8796..., the std of N(0, 1)
    truncated at +-2) or a uniform."""
    out, shape, dtype = _target(tensor, dtype)
    fan_in, fan_out = _fans(shape, fan_axes)
    denom = {"fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2}[mode]
    variance = scale / denom
    if distribution == "truncated_normal":
        std = math.sqrt(variance) / 0.87962566103423978
        return _finish(out, trunc_normal_(shape, std=std, generator=generator,
                                          draw=draw), dtype)
    if distribution == "normal":
        z = draw if draw is not None else torch.randn(shape,
                                                      generator=generator)
        z = torch.as_tensor(z, dtype=torch.float32)
        return _finish(out, z * math.sqrt(variance), dtype)
    if distribution == "uniform":
        bound = math.sqrt(3 * variance)
        return _finish(out, _uniform(shape, -bound, bound, generator, draw),
                       dtype)
    raise ValueError(f"invalid distribution {distribution}")


def lecun_normal_(tensor, dtype=None, fan_axes: str = "torch",
                  generator: Optional[torch.Generator] = None, draw=None):
    """The fan-in truncated normal."""
    return variance_scaling_(tensor, mode="fan_in",
                             distribution="truncated_normal", dtype=dtype,
                             fan_axes=fan_axes, generator=generator,
                             draw=draw)
