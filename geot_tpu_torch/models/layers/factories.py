"""Config-driven layer factories (``geot_tpu/models/layers/factories.py``):
``create_act``, ``create_norm``, the pointwise block factories
``create_convblock1d``/``create_convblock2d``/``create_linearblock``,
``CreateResConvBlock2D`` and the bare ``Conv1d``/``Conv2d``.

``norm_args``/``act_args`` are a name or a ``{"norm"/"act": name,
**kwargs}`` dict; None (or no name) means no layer, and a norm drops the
conv's bias. Channels-last, as in ``geot_tpu``: every conv on points is a
``Dense`` over the last axis, so the three block factories build one
module; ``dimension`` only resolves the reference's name aliases. The
BatchNorm names are ``PointBatchNorm`` (``syncbn`` too: the port's
BatchNorm takes the global batch under data parallelism), the LayerNorm
names ``LayerNorm``, ``gn`` ``GroupNorm`` and the InstanceNorm names a
``GroupNorm`` with a group per channel and no affine.

flax infers each layer's input width at its first call; here the widths
are arguments (``channels`` of ``create_norm``; the block factories' and
convs' ``in_channels``). Module names follow the flax tree: a block holds
``conv``, ``norm`` and a ``prelu`` activation as ``act``, except inside
``CreateResConvBlock2D``, where flax binds the norms and ``PReLU``s to the
stack itself (``PointBatchNorm_{i}``, ...) beside its ``_DenseBlock_{i}``.
"""
from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Optional

import torch
from torch import nn
import torch.nn.functional as F

from .common import (Dense, DtypeArg, GroupNorm, LayerNorm, PointBatchNorm,
                     gelu)

__all__ = ["create_act", "create_norm", "create_convblock1d",
           "create_convblock2d", "create_linearblock",
           "CreateResConvBlock2D", "Conv1d", "Conv2d"]


def _hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def _hard_swish(x):
    return x * _hard_sigmoid(x)


_ACT_FNS: dict = {
    "silu": F.silu,
    "swish": F.silu,
    "mish": F.mish,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,
    "leakyrelu": F.leaky_relu,
    "elu": F.elu,
    "celu": F.celu,
    "selu": F.selu,
    "gelu": gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "hard_sigmoid": _hard_sigmoid,
    "hard_swish": _hard_swish,
}


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one scalar slope ``negative_slope`` (initially
    ``negative_slope_init``) for negative inputs."""

    flax_name = "PReLU"

    def __init__(self, negative_slope_init: float = 0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(
            float(negative_slope_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def create_act(act_args) -> Optional[Callable]:
    """An activation from a name or ``{"act": name, **kwargs}``: a function
    (``PReLU``, a module, for ``prelu``), or None. ``inplace`` is taken and
    ignored."""
    if act_args is None:
        return None
    if isinstance(act_args, str):
        act_args = {"act": act_args}
    act_args = dict(act_args)
    act = act_args.pop("act", None)
    if act is None:
        return None
    act = act.lower()
    act_args.pop("inplace", None)
    if act == "prelu":
        return PReLU(**act_args)
    if act not in _ACT_FNS:
        raise ValueError(f"activation '{act}' is not supported "
                         f"(known: {sorted(_ACT_FNS)} + prelu)")
    fn = _ACT_FNS[act]
    return functools.partial(fn, **act_args) if act_args else fn


_BN_NAMES = {"bn", "bn1d", "bn2d", "syncbn", "fastbn", "fastbn1d", "fastbn2d"}
_LN_NAMES = {"ln", "ln1d", "ln2d"}
_IN_NAMES = {"in1d", "in2d"}


def create_norm(norm_args, channels: Optional[int] = None,
                dimension=None, dtype: DtypeArg = None
                ) -> Optional[nn.Module]:
    """A normalisation of ``channels`` from a name or ``{"norm": name,
    **kwargs}`` (``eps``, ``momentum`` in torch's sense, ``num_groups``),
    or None; ``dimension`` appends the reference's "1d"/"2d" to the name."""
    if norm_args is None:
        return None
    if isinstance(norm_args, dict):
        norm_args = copy.deepcopy(dict(norm_args))
        norm = norm_args.pop("norm", None)
    else:
        norm, norm_args = norm_args, {}
    if norm is None:
        return None
    norm = norm.lower()
    if dimension is not None and str(dimension).lower() not in norm:
        norm += str(dimension).lower()
    eps = norm_args.pop("eps", 1e-5)
    known = sorted(_BN_NAMES | _LN_NAMES | _IN_NAMES)
    if norm not in _BN_NAMES | _LN_NAMES | _IN_NAMES | {"gn"}:
        raise ValueError(f"norm '{norm}' is not supported "
                         f"(known: {known} + gn)")
    if channels is None:
        raise ValueError(f"norm '{norm}' needs `channels` (flax infers "
                         f"them at the first call; the port builds with "
                         f"them)")
    if norm in _BN_NAMES:
        # torch momentum m keeps (1 - m) of the running statistics
        torch_momentum = norm_args.pop("momentum", 0.1)
        made = PointBatchNorm(channels, momentum=1.0 - torch_momentum,
                              eps=eps, dtype=dtype)
    elif norm in _LN_NAMES:
        made = LayerNorm(channels, eps=eps, dtype=dtype)
    elif norm == "gn":
        made = GroupNorm(norm_args.pop("num_groups", 32), channels, eps=eps,
                          dtype=dtype)
    else:
        made = GroupNorm(channels, channels, eps=eps, dtype=dtype,
                          affine=False)
    if norm_args:
        raise TypeError(f"unsupported norm arguments {sorted(norm_args)}")
    return made


class _DenseBlock(nn.Module):
    """Dense + norm + act in ``order``. With ``owner`` the norm and a
    module activation are bound to the owner (its flax scope), else held
    here as ``norm`` and ``act``."""

    def __init__(self, in_channels: int, out_channels: int, norm=None,
                 act=None, order: str = "conv-norm-act",
                 use_bias: bool = True, dtype: DtypeArg = None,
                 owner: Optional[Callable[[nn.Module], None]] = None):
        super().__init__()
        if order not in ("conv-norm-act", "norm-act-conv", "conv-act-norm"):
            raise NotImplementedError(f"{order} is not supported")
        self.order = order
        self.conv = Dense(in_channels, out_channels, bias=use_bias,
                          dtype=dtype)
        self.fns = {}
        for role, fn in (("norm", norm), ("act", act)):
            if isinstance(fn, nn.Module):
                if owner is None:
                    self.add_module(role, fn)
                    fn = role
                else:
                    owner(fn)
            self.fns[role] = fn

    def _run(self, role, y):
        fn = self.fns[role]
        if fn is None:
            return y
        return (getattr(self, fn) if isinstance(fn, str) else fn)(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for step in self.order.split("-"):
            x = self.conv(x) if step == "conv" else self._run(step, x)
        return x


def _make_block(in_channels, out_channels, *extra, norm_args=None,
                act_args=None, order="conv-norm-act", dimension=None,
                owner=None, **kwargs) -> nn.Module:
    ks = kwargs.pop("kernel_size", extra[0] if extra else 1)
    if ks not in (1, (1,), (1, 1)):
        raise NotImplementedError(
            f"kernel_size={ks}: the point-cloud conv blocks are pointwise "
            f"(k=1); spatial convs have no (B, N, C) meaning")
    bias = kwargs.pop("bias", True)
    dtype = kwargs.pop("dtype", None)
    if kwargs:
        raise TypeError(f"unsupported conv-block kwargs: {sorted(kwargs)}")
    # the norm's width: the output for conv-first orders, else the input
    norm_ch = in_channels if order == "norm-act-conv" else out_channels
    norm = create_norm(norm_args, norm_ch, dimension=dimension)
    act = create_act(act_args)
    if norm is not None:
        bias = False
    return _DenseBlock(in_channels, out_channels, norm=norm, act=act,
                       order=order, use_bias=bias, dtype=dtype, owner=owner)


def create_convblock1d(*args, norm_args=None, act_args=None,
                       order="conv-norm-act", **kwargs) -> nn.Module:
    """A pointwise Conv1d block on (B, N, C): (in_channels, out_channels
    [, kernel_size 1])."""
    return _make_block(*args, norm_args=norm_args, act_args=act_args,
                       order=order, dimension="1d", **kwargs)


def create_convblock2d(*args, norm_args=None, act_args=None,
                       order="conv-norm-act", **kwargs) -> nn.Module:
    """A pointwise Conv2d block on (B, G, K, C)."""
    return _make_block(*args, norm_args=norm_args, act_args=act_args,
                       order=order, dimension="2d", **kwargs)


def create_linearblock(*args, norm_args=None, act_args=None,
                       order="conv-norm-act", **kwargs) -> nn.Module:
    """A Linear block, the 1d conv block in channels-last form."""
    return _make_block(*args, norm_args=norm_args, act_args=act_args,
                       order=order, dimension="1d", **kwargs)


class _PointwiseConv(nn.Module):
    """A bare pointwise conv: ``conv``, a Dense over the last axis."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True, dtype: DtypeArg = None):
        super().__init__()
        self.conv = Dense(in_channels, out_channels, bias=use_bias,
                          dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _pointwise_conv(in_channels, out_channels=None, kernel_size=1, *,
                    bias=True, dtype=None, **kwargs):
    if out_channels is None:
        out_channels = in_channels
    if kernel_size not in (1, (1,), (1, 1)):
        raise NotImplementedError(
            "spatial kernels have no (B, N, C) meaning")
    if kwargs:
        raise TypeError(f"unsupported conv kwargs: {sorted(kwargs)}")
    return _PointwiseConv(in_channels, out_channels, use_bias=bias,
                          dtype=dtype)


# the reference's Conv2d/Conv1d(in, out) with kernel size 1 by default
Conv1d = _pointwise_conv
Conv2d = _pointwise_conv


class CreateResConvBlock2D(nn.Module):
    """Residual stack of 2d conv blocks: ``mlps[i] -> mlps[i + 1]`` with
    the activation for i < len - 2, a last block without it, then
    ``act(convs(x) + (res or x))``."""

    def __init__(self, mlps, norm_args=None, act_args=None,
                 order: str = "conv-norm-act", dtype: DtypeArg = None):
        super().__init__()
        mlps = list(mlps)
        counts: dict = {}

        def owner(module):
            name = module.flax_name
            self.add_module(f"{name}_{counts.get(name, 0)}", module)
            counts[name] = counts.get(name, 0) + 1

        self.n = len(mlps) - 1
        for i in range(self.n):
            last = i == self.n - 1
            self.add_module(f"_DenseBlock_{i}", create_convblock2d(
                mlps[i], mlps[i + 1], norm_args=norm_args,
                act_args=None if last else act_args,
                order="conv-norm-act" if last else order, dtype=dtype,
                owner=owner))
        act = create_act(act_args)
        if isinstance(act, nn.Module):
            owner(act)
        # a module activation is registered by its flax name above
        self.fns = {"act": act}

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None):
        y = x
        for i in range(self.n):
            y = getattr(self, f"_DenseBlock_{i}")(y)
        out = y + (x if res is None else res)
        act = self.fns["act"]
        return act(out) if act is not None else out
