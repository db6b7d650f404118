"""PointMLP: the part segmentor, the classification encoders and the
pretraining encoder, channels-last
(``geot_tpu/models/backbone/pointmlp.py:27-367``).

Encoder: per stage FPS to ``N // reducer`` anchors, their k nearest
points (exact kNN), a geometric-affine normalisation of the groups (by the
population std of the whole cloud's offsets, then a learned per-channel
``affine_alpha``/``affine_beta`` of shape (1, 1, 1, C), so the AdamW
decay filter sees them as rank 4, as ``geot_tpu``'s does), a residual MLP
per group max-pooled, then per-point residual MLPs. Decoder: 3-NN
interpolation back up the pyramid with skip concats. Head: a global
max-pooled token and the jaw token (one-hot ``cls``) beside every point.
Module names follow the flax tree; every layer's input width follows from
the config and ``in_channels``, the width of the data's ``x``.
``PointMLPEncoder`` (and its ``PointMLP`` alias, ``pointMLP`` and
``pointMLPElite``) gives classification the max over the last stage's
groups; ``PointMLPEncoderV2`` maps each group's features and center
through an MLP (fc1, exact GELU, fc2) first.
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ...core.config import register_model
from ...ops import fps, gather_points, grouping_operation, knn, \
    three_interpolation
from ..layers import BatchNorm, Dense, Dropout, gelu


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, channels: int, bias: bool = True):
        super().__init__()
        self.conv = Dense(in_channels, channels, bias=bias)
        self.bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    """Bottleneck MLP with a residual, hidden width ``channels *
    res_expansion``."""

    def __init__(self, channels: int, res_expansion: float = 1.0,
                 bias: bool = True):
        super().__init__()
        hidden = int(channels * res_expansion)
        self.net1_conv = Dense(channels, hidden, bias=bias)
        self.net1_bn = BatchNorm(hidden)
        self.net2_conv = Dense(hidden, channels, bias=bias)
        self.net2_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.net1_bn(self.net1_conv(x)))
        return F.relu(self.net2_bn(self.net2_conv(h)) + x)


class LocalGrouper(nn.Module):
    """FPS anchors, kNN groups and the geometric-affine normalisation;
    returns the anchors and (B, S, k, 2C [+ 3]) group features, the
    anchor's own features concatenated to every neighbour's."""

    def __init__(self, channels: int, reduce: int, k: int,
                 use_xyz: bool = False, normalize: str = "anchor"):
        super().__init__()
        self.reduce = reduce
        self.k = k
        self.use_xyz = use_xyz
        self.normalize = normalize
        if normalize:
            dim = channels + 3 if use_xyz else channels
            self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, dim))
            self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor):
        B, N, _ = xyz.shape
        idx = fps(xyz.float().contiguous(), N // self.reduce)
        new_xyz = gather_points(xyz, idx)
        new_feats = gather_points(feats, idx)
        _, nidx = knn(new_xyz, xyz, self.k)
        g_feats = grouping_operation(feats, nidx)           # (B, S, k, C)
        if self.use_xyz:
            g_feats = torch.cat([g_feats, grouping_operation(xyz, nidx)], -1)
        if self.normalize:
            if self.normalize == "center":
                mean = g_feats.mean(dim=2, keepdim=True)
            else:                                           # anchor
                anchor = (torch.cat([new_feats, new_xyz], -1)
                          if self.use_xyz else new_feats)
                mean = anchor[:, :, None, :]
            # the population std over each cloud's offsets (jnp.std)
            std = (g_feats - mean).reshape(B, -1).std(dim=-1, correction=0)
            g_feats = (g_feats - mean) / (std[:, None, None, None] + 1e-5)
            g_feats = self.affine_alpha * g_feats + self.affine_beta
        anchor_full = new_feats[:, :, None, :].expand(
            *new_feats.shape[:2], self.k, new_feats.shape[-1])
        return new_xyz, torch.cat([g_feats, anchor_full], dim=-1)


class PreExtraction(nn.Module):
    """Per-group residual MLP, max-pooled over the group."""

    def __init__(self, in_channels: int, out_channels: int, blocks: int = 1,
                 res_expansion: float = 1.0, bias: bool = True):
        super().__init__()
        self.transfer = ConvBNReLU(in_channels, out_channels, bias)
        self.n = blocks
        for i in range(blocks):
            self.add_module(f"op_{i}", ResBlock(out_channels, res_expansion,
                                                bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transfer(x)
        for i in range(self.n):
            x = getattr(self, f"op_{i}")(x)
        return x.amax(dim=2)


class PosExtraction(nn.Module):
    """Per-point residual MLPs."""

    def __init__(self, channels: int, blocks: int = 1,
                 res_expansion: float = 1.0, bias: bool = True):
        super().__init__()
        self.n = blocks
        for i in range(blocks):
            self.add_module(f"op_{i}", ResBlock(channels, res_expansion,
                                                bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"op_{i}")(x)
        return x


@register_model("PointMLPGenEncoder")
class PointMLPGenEncoder(nn.Module):
    """PointMLP's encoder keeping its per-group tokens, for the
    pretraining stage's generator (``geot_tpu/models/backbone/pointmlp.py:
    276-350``): ``forward`` (and ``forward_cls_feat``) takes a batch dict
    (``pos``, ``x``) or arrays and returns (tokens (B, G, C), centers (B,
    G, 3)) of the last stage. ``in_channels`` is the width of ``x``."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 64,
                 res_expansion: float = 1.0, bias: bool = False,
                 use_xyz: bool = False, normalize: str = "anchor",
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.in_channels = in_channels
        self.n_stages = len(pre_blocks)
        self.embedding = ConvBNReLU(in_channels, embed_dim, bias)
        last = embed_dim
        for i in range(self.n_stages):
            out = last * dim_expansion[i]
            self.add_module(f"grouper_{i}", LocalGrouper(
                last, reducers[i], k_neighbors[i], use_xyz, normalize))
            self.add_module(f"pre_{i}", PreExtraction(
                2 * last + (3 if use_xyz else 0), out, pre_blocks[i],
                res_expansion, bias))
            self.add_module(f"pos_{i}", PosExtraction(
                out, pos_blocks[i], res_expansion, bias))
            last = out
        self.out_channels = last

    def forward(self, xyz, features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if isinstance(xyz, dict):
            xyz, features = xyz["pos"], xyz.get("x")
        if features is None:
            features = xyz
        if features.shape[-1] != self.in_channels:
            raise ValueError(f"PointMLPGenEncoder: features have "
                             f"{features.shape[-1]} channels, in_channels "
                             f"is {self.in_channels}")
        x = self.embedding(features)
        for i in range(self.n_stages):
            xyz, grouped = getattr(self, f"grouper_{i}")(xyz, x)
            x = getattr(self, f"pos_{i}")(getattr(self, f"pre_{i}")(grouped))
        return x, xyz

    def forward_cls_feat(self, xyz, features: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        return self(xyz, features)


@register_model("PointMLPEncoder")
class PointMLPEncoder(PointMLPGenEncoder):
    """The classification encoder (``geot_tpu/models/backbone/pointmlp.py:
    137-172``): the stages of ``PointMLPGenEncoder``; ``forward`` returns
    (centers, tokens) of the last stage and ``forward_cls_feat`` the max
    over its groups, (B, ``out_channels``)."""

    def forward(self, xyz, features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x, xyz = super().forward(xyz, features)
        return xyz, x

    def forward_cls_feat(self, xyz, features: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        return self(xyz, features)[1].amax(dim=1)


def pointMLP(**kwargs) -> PointMLPEncoder:
    """The original PointMLP encoder (``geot_tpu/models/backbone/pointmlp.py:
    175-184``); ``num_classes`` is taken and dropped."""
    kwargs.pop("num_classes", None)
    return PointMLPEncoder(embed_dim=64, res_expansion=1.0, bias=False,
                           use_xyz=False, normalize="anchor",
                           dim_expansion=(2, 2, 2, 2), pre_blocks=(2, 2, 2, 2),
                           pos_blocks=(2, 2, 2, 2),
                           k_neighbors=(24, 24, 24, 24),
                           reducers=(2, 2, 2, 2), **kwargs)


def pointMLPElite(**kwargs) -> PointMLPEncoder:
    """The slim PointMLP encoder (``geot_tpu/models/backbone/pointmlp.py:
    187-195``)."""
    kwargs.pop("num_classes", None)
    return PointMLPEncoder(embed_dim=32, res_expansion=0.25, bias=False,
                           use_xyz=False, normalize="anchor",
                           dim_expansion=(2, 2, 2, 1), pre_blocks=(1, 1, 2, 1),
                           pos_blocks=(1, 1, 2, 1),
                           k_neighbors=(24, 24, 24, 24),
                           reducers=(2, 2, 2, 2), **kwargs)


@register_model("PointMLP")
def PointMLP(**kwargs) -> PointMLPEncoder:
    """The registry's ``PointMLP``: a ``PointMLPEncoder`` of the arguments
    it takes, the others dropped (``geot_tpu/models/backbone/pointmlp.py:
    362-367``)."""
    fields = inspect.signature(PointMLPEncoder.__init__).parameters
    return PointMLPEncoder(**{k: v for k, v in kwargs.items()
                              if k in fields and k != "self"})


@register_model("PointMLPEncoderV2")
class PointMLPEncoderV2(nn.Module):
    """``enc``, a ``PointMLPGenEncoder``; each last-stage group's features
    and center concatenated go through ``feat_mlp_fc1``, exact GELU and
    ``feat_mlp_fc2`` to ``feat_channels`` (0: the last stage's width),
    then the max over the groups (``geot_tpu/models/backbone/pointmlp.py:
    322-359``). ``forward`` and ``forward_cls_feat`` take a batch dict or
    arrays and return (B, ``out_channels``)."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 64,
                 res_expansion: float = 1.0, bias: bool = False,
                 use_xyz: bool = False, normalize: str = "anchor",
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2),
                 feat_channels: int = 0):
        super().__init__()
        self.enc = PointMLPGenEncoder(
            in_channels, embed_dim, res_expansion, bias, use_xyz, normalize,
            dim_expansion, pre_blocks, pos_blocks, k_neighbors, reducers)
        last = self.enc.out_channels
        out = feat_channels or last
        self.feat_mlp_fc1 = Dense(last + 3, out)
        self.feat_mlp_fc2 = Dense(out, out)
        self.out_channels = out

    def forward(self, xyz, features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x, xyz = self.enc(xyz, features)
        h = self.feat_mlp_fc1(torch.cat([x, xyz.to(x.dtype)], dim=-1))
        return self.feat_mlp_fc2(gelu(h)).amax(dim=1)

    def forward_cls_feat(self, xyz, features: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        return self(xyz, features)


@register_model("PointMLPPartSegmentor")
class PointMLPPartSegmentor(nn.Module):
    """``forward`` takes a batch dict (``pos``, ``x``, ``cls``) or arrays
    and returns (B, N, ``num_classes``) logits. The head's dropout (0.5)
    draws its mask from ``generator``."""

    def __init__(self, num_classes: int = 17, shape_classes: int = 2,
                 embed_dim: int = 64, res_expansion: float = 1.0,
                 bias: bool = True, use_xyz: bool = True,
                 normalize: str = "anchor",
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 k_neighbors: Sequence[int] = (32, 32, 32, 32),
                 reducers: Sequence[int] = (4, 4, 4, 4),
                 de_dims: Sequence[int] = (512, 256, 128, 128),
                 de_blocks: Sequence[int] = (2, 2, 2, 2),
                 gmp_dim: int = 64, cls_dim: int = 64,
                 in_channels: int = 3):
        super().__init__()
        self.shape_classes = shape_classes
        self.in_channels = in_channels
        self.n_stages = len(pre_blocks)
        self.de_blocks = list(de_blocks)[:len(de_dims)]
        self.embedding = ConvBNReLU(in_channels, embed_dim, bias)
        widths = [embed_dim]
        for i in range(self.n_stages):
            last, out = widths[-1], widths[-1] * dim_expansion[i]
            self.add_module(f"grouper_{i}", LocalGrouper(
                last, reducers[i], k_neighbors[i], use_xyz, normalize))
            self.add_module(f"pre_{i}", PreExtraction(
                2 * last + (3 if use_xyz else 0), out, pre_blocks[i],
                res_expansion, bias))
            self.add_module(f"pos_{i}", PosExtraction(
                out, pos_blocks[i], res_expansion, bias))
            widths.append(out)
        f = widths[-1]
        for i, dim in enumerate(de_dims):
            for j in range(de_blocks[i]):
                cin = f + widths[-(i + 2)] if j == 0 else dim
                self.add_module(f"de_{i}_{j}", ConvBNReLU(cin, dim, bias))
            f = dim
        self.gmp = ConvBNReLU(f, gmp_dim, bias)
        self.cls_map = ConvBNReLU(shape_classes, cls_dim, bias)
        self.head0 = ConvBNReLU(gmp_dim + cls_dim + f, 128, bias)
        self.dropout = Dropout(0.5)
        self.head1 = Dense(128, num_classes)

    def forward(self, pts, features: Optional[torch.Tensor] = None,
                cls_label: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if isinstance(pts, dict):
            pts, features, cls_label = (pts["pos"], pts.get("x"),
                                        pts.get("cls"))
        if features is None:
            features = pts
        if features.shape[-1] != self.in_channels:
            raise ValueError(f"PointMLPPartSegmentor: features have "
                             f"{features.shape[-1]} channels, in_channels "
                             f"is {self.in_channels}")
        l_xyz, l_feats = [pts], [self.embedding(features)]
        for i in range(self.n_stages):
            xyz, grouped = getattr(self, f"grouper_{i}")(l_xyz[-1],
                                                         l_feats[-1])
            h = getattr(self, f"pre_{i}")(grouped)
            l_xyz.append(xyz)
            l_feats.append(getattr(self, f"pos_{i}")(h))

        f = l_feats[-1]
        for i, n in enumerate(self.de_blocks):
            up = three_interpolation(l_xyz[-(i + 2)], l_xyz[-(i + 1)], f)
            f = torch.cat([up, l_feats[-(i + 2)]], dim=-1)
            for j in range(n):
                f = getattr(self, f"de_{i}_{j}")(f)

        B, N = f.shape[:2]
        gmp = self.gmp(f).amax(dim=1, keepdim=True)
        if cls_label is None:
            cls_label = torch.zeros(B, dtype=torch.long, device=f.device)
        onehot = F.one_hot(cls_label.reshape(-1).long(),
                           self.shape_classes).to(f.dtype)
        cls_tok = self.cls_map(onehot[:, None, :])
        cond = torch.cat([gmp.expand(B, N, -1), cls_tok.expand(B, N, -1), f],
                         dim=-1)
        return self.head1(self.dropout(self.head0(cond), generator))
