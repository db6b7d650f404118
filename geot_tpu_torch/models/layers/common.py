"""Building blocks of the flagship model, channels-last
(``geot_tpu/models/layers/common.py``).

Pointwise ``Conv1d``/``Conv2d`` of the reference are ``Dense`` (an
``nn.Linear``) on the last axis. Normalisations take channels-last input
too. Dropout and DropPath are identity at eval and take their masks from an
explicit ``torch.Generator`` in training.

Compute dtype (``dtype``, e.g. bfloat16) follows flax's ``dtype`` argument
with ``promote_dtype``, by explicit casts in each layer rather than
``torch.autocast``: autocast would run the normalisations in float32 and
return float32, where flax returns the layer's ``dtype``, and it would
leave alone the layers that flax runs in ``dtype``. So parameters and
BatchNorm statistics stay float32; a ``Dense`` with a ``dtype`` casts its
input, kernel and bias to it, rounds the product to it and then adds the
bias in it (flax's ``dot_general`` then ``+ bias``); one without a
``dtype`` computes in the promotion of its input's and kernel's types; a
normalisation computes its statistics and output in at least float32 (flax's
``force_float32_reductions``) and rounds the output to its ``dtype`` if it
has one. In a 16-bit dtype GELU, softmax and LeakyReLU run jax's sequence of
operations with its weakly typed constants (``gelu``, ``softmax``,
``LeakyReLU``, ``rounded``). The products accumulate in float32 on both
sides (XLA's bf16 dot on the CPU, oneDNN or cuBLAS here), so the two
frameworks round at the same places, if not always to the same bit: alone,
attention and the MLP block are bit-equal to flax's; a whole bfloat16
forward of the small test config is as far from ``geot_tpu``'s (argmax
agreement 0.984-0.986) as ``geot_tpu`` under ``jit`` is from its own eager
forward (0.963-0.990), and its bfloat16-vs-float32 error is 0.80-0.87 x
``geot_tpu``'s (``tests/test_torch_fast.py``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch
from torch import nn
import torch.nn.functional as F

from ...parallel import dist

DtypeArg = Union[None, str, torch.dtype]


def as_dtype(dtype: DtypeArg) -> Optional[torch.dtype]:
    """A config's ``dtype`` (None, "float32", "bfloat16", or a torch dtype)
    as a torch dtype, None for "the input's"."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype in ("float32", "bfloat16"):
        return getattr(torch, dtype)
    raise ValueError(f"unsupported dtype {dtype!r}; expected None, "
                     f"'float32' or 'bfloat16'")


def _promoted(x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, param.dtype))


_HALF = (torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def rounded(c: float, dtype: torch.dtype) -> float:
    """The constant ``c`` rounded to ``dtype``, on the host: JAX rounds a
    weakly typed constant to the array's dtype before an operation, while
    torch computes a tensor-scalar product with the scalar in float32."""
    return float(torch.tensor(c, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. In a 16-bit dtype it is computed as
    ``jax.nn.gelu(approximate=False)`` computes it, ``0.5 * x * erfc(-x *
    sqrt(1/2))`` with each operation rounded (bit-equal to it, where
    torch's fused GELU is not); in float32 and wider by torch's fused
    kernel, which agrees with that to the last bits."""
    if x.dtype not in _HALF:
        return F.gelu(x, approximate="none")
    return 0.5 * x * torch.erfc(-x * rounded(0.5 ** 0.5, x.dtype))


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class LeakyReLU(nn.Module):
    """``jax.nn.leaky_relu``: in a 16-bit dtype the slope is rounded to it
    before the product, as JAX's weak typing does (0.2 becomes 0.2001953125
    in bfloat16); torch's fused kernel otherwise."""

    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype not in _HALF:
            return F.leaky_relu(x, self.negative_slope)
        return torch.where(x >= 0, x,
                           x * rounded(self.negative_slope, x.dtype))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax. In a 16-bit dtype it is ``jax.nn.softmax``'s sequence,
    ``exp(x - max) / sum``, each operation rounded (bit-equal to it, where
    torch's fused softmax rounds only its output); torch's fused kernel
    otherwise."""
    if x.dtype not in _HALF:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


class Dense(nn.Linear):
    """``nn.Linear`` that computes as flax ``nn.Dense(dtype=dtype)``."""

    # ``weight.permute(flax_kernel_axes)`` is the flax kernel (in, out)
    flax_kernel_axes = (1, 0)

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: DtypeArg = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = as_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        if dt == self.weight.dtype:
            return F.linear(x.to(dt), self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that computes as flax ``nn.LayerNorm(dtype=...)``."""

    flax_name = "LayerNorm"      # the name flax gives an unnamed one

    def __init__(self, dim: int, eps: float = 1e-5, dtype: DtypeArg = None):
        super().__init__(dim, eps=eps)
        self.compute_dtype = as_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(_promoted(x, self.weight))
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor; eps 1e-5; output
    in ``dtype`` if given.

    Training mode normalises with the batch's biased variance and updates
    the running statistics as flax ``nn.BatchNorm(momentum=0.9)`` does
    (``geot_tpu/models/layers/common.py:59-69``): ``running = 0.9 * running
    + 0.1 * batch`` with the BIASED batch variance, where torch's own
    ``BatchNorm1d`` would take the unbiased one. Under data parallelism
    (``parallel.dist``, world size > 1) the batch is the global one: the
    statistics are those of every rank's rows, as BatchNorm over a
    dp-sharded batch is in ``geot_tpu`` (``parallel/mesh.py:6-10``), and
    the running statistics update alike on every rank. Eval mode is
    torch's. ``momentum`` is flax's (the share of the old statistics kept)
    and ``eps`` its ``epsilon``."""

    def __init__(self, num_features: int, dtype: DtypeArg = None,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.compute_dtype = as_dtype(dtype)
        self.keep = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = _promoted(x, self.weight).reshape(-1, shape[-1])
        if not self.training:
            y = super().forward(x2)
        else:
            if dist.world() > 1:
                # the global batch's statistics (SyncBN): count, sum and
                # sum of squares all-reduced, with the gradient
                stats = dist.all_reduce_sum(torch.cat([
                    x2.sum(dim=0), (x2 * x2).sum(dim=0),
                    x2.new_full((1,), x2.shape[0])]))
                C = x2.shape[1]
                n = stats[2 * C]
                mean = stats[:C] / n
                var = (stats[C:2 * C] / n - mean * mean).clamp_min(0.0)
            else:
                mean = x2.mean(dim=0)
                var = ((x2 * x2).mean(dim=0) - mean * mean).clamp_min(0.0)
            y = (x2 - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
                + self.bias
            with torch.no_grad():
                self.running_mean.mul_(self.keep).add_(
                    (1.0 - self.keep) * mean)
                self.running_var.mul_(self.keep).add_((1.0 - self.keep) * var)
                self.num_batches_tracked += 1
        y = y.reshape(shape)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over a channels-last (B, ..., C) tensor: statistics per
    sample and group over every non-batch axis, like flax ``GroupNorm``;
    output in ``dtype`` if given. ``affine=False`` has no scale and bias
    (flax's ``use_scale=use_bias=False``, the InstanceNorm of
    ``create_norm``)."""

    flax_name = "GroupNorm"

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: DtypeArg = None, affine: bool = True):
        super().__init__(num_groups, num_channels, eps=eps, affine=affine)
        self.compute_dtype = as_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.affine:
            x = _promoted(x, self.weight)
        B, C = x.shape[0], x.shape[-1]
        xg = x.reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        if self.affine:
            y = y * self.weight + self.bias
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (``common.py:DropPath``); identity at
    eval. Masks come from ``generator`` (torch's default generator when it
    is None)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return _keep_mask(x, (x.shape[0],) + (1,) * (x.dim() - 1),
                          1.0 - self.rate, generator)


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``); identity at eval. Masks
    come from ``generator`` (torch's default generator when it is None)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return _keep_mask(x, x.shape, 1.0 - self.rate, generator)


def _keep_mask(x, shape, keep, generator):
    """Keep with probability ``keep`` and scale by 1 / keep, as flax does.
    Under data parallelism every rank draws the masks of all ranks' blocks
    and keeps its own, so the ranks' generators stay in step (their later
    draws, on the global batch, are the same) and their masks differ."""
    draws = [torch.rand(shape, dtype=x.dtype, device=x.device,
                        generator=generator) for _ in range(dist.world())]
    mask = draws[dist.rank()] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MlpBlock(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> dropout -> fc2 -> dropout (the
    flagship's dropout rate is 0)."""

    def __init__(self, dim: int, hidden: int, dtype: DtypeArg = None,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop(gelu(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


def make_divisible(v, divisor=8, min_value=None, round_limit=0.9):
    """``v`` rounded to a multiple of ``divisor``, not below ``round_limit
    * v`` (``geot_tpu/models/layers/common.py:23``)."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def drop_path_rates(drop_path_rate: float, depth: int):
    """The linear stochastic-depth schedule, ``linspace(0, rate, depth)``."""
    if depth == 1:
        return [float(drop_path_rate)]
    return [float(drop_path_rate) * i / (depth - 1) for i in range(depth)]


class PointBatchNorm(nn.Module):
    """``BatchNorm`` held as ``bn`` (``geot_tpu``'s ``PointBatchNorm``:
    flax momentum 0.9, epsilon 1e-5 by default), so its weights sit at
    ``<name>.bn`` as in the flax tree."""

    flax_name = "PointBatchNorm"

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: DtypeArg = None):
        super().__init__()
        self.bn = BatchNorm(channels, dtype=dtype, momentum=momentum, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class _BN(nn.Module):
    """Holds ``bn`` so parameter names read ``layer{i}.bn.bn.*`` as in the
    reference SharedMLP state_dict."""

    def __init__(self, c: int, dtype: DtypeArg = None):
        super().__init__()
        self.bn = BatchNorm(c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class _SharedMLPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: DtypeArg = None):
        super().__init__()
        self.conv = Dense(cin, cout, bias=False, dtype=dtype)
        self.bn = _BN(cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Module):
    """Pointwise Linear (no bias) + BN + ReLU per layer; ``channels`` are
    [in, out_0, out_1, ...]."""

    def __init__(self, channels: Sequence[int], dtype: DtypeArg = None):
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", _SharedMLPLayer(
                channels[i], channels[i + 1], dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
        return x
