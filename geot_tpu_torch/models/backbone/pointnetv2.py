"""PointNet++ encoder and decoders, channels-last
(``geot_tpu/models/backbone/pointnetv2.py:23-270``).

Set-abstraction stages (FPS down by ``stride``, then one ball-query local
aggregation per scale, concatenated) and feature-propagation stages
(3-NN inverse-distance interpolation, skip concat, shared MLP). The
config surface is ``geot_tpu``'s: ``mlps`` given, or derived from
``width``/``layers``/``strides``. flax infers each layer's input width;
here every width follows from the config (``in_channels`` is the width of
the data's ``x``), and ``channel_list`` is what the decoder is built
from. Module names follow the flax tree (``sa_{k}.la_{i}.convs``,
``fp_{j}.convs``), so ``engine.convert.params_from_jax`` maps them.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from ...core.config import MODELS
from ...ops import fps, gather_points, three_interpolation
from ..layers import LocalAggregation, SharedMLP


def _to_full_list(param, blocks, strides, param_scaling=1,
                  block_param_scaling=1):
    """A scalar or partial radius/nsample spec as per-stage, per-block
    lists (reference ``pointnetv2.py:289-307``)."""
    param_list = []
    if isinstance(param, (list, tuple)):
        for i, value in enumerate(param):
            value = (list(value) if isinstance(value, (list, tuple))
                     else [value])
            if len(value) != blocks[i]:
                value += [value[-1]] * (blocks[i] - len(value))
            param_list.append(value)
    else:
        for i, stride in enumerate(strides):
            if stride == 1:
                param_list.append([param] * blocks[i])
            else:
                param_list.append([param] + [param * block_param_scaling]
                                  * (blocks[i] - 1))
                param *= param_scaling
    return param_list


class PointNetSAModuleMSG(nn.Module):
    """One stage: FPS to ``N // stride`` queries (none for stride 1), then
    a local aggregation ``la_{i}`` per (radius, nsample, channels) scale,
    concatenated. ``channel_list[i]`` includes the input width."""

    def __init__(self, stride: int, radii: Sequence[float],
                 nsamples: Sequence[int],
                 channel_list: Sequence[Sequence[int]],
                 feature_type: str = "dp_fj", reduction: str = "max"):
        super().__init__()
        self.stride = stride
        self.n = len(channel_list)
        for i, (radius, nsample, channels) in enumerate(
                zip(radii, nsamples, channel_list)):
            self.add_module(f"la_{i}", LocalAggregation(
                channels[0], list(channels)[1:],
                {"NAME": "ballquery", "radius": radius, "nsample": nsample},
                feature_type, reduction))

    def forward(self, support_xyz, support_features):
        if self.stride > 1:
            idx = fps(support_xyz.float().contiguous(),
                      support_xyz.shape[1] // self.stride)
            query_xyz = gather_points(support_xyz, idx)
        else:
            query_xyz = support_xyz
        outs = [getattr(self, f"la_{i}")(query_xyz, support_xyz,
                                         support_features)
                for i in range(self.n)]
        return query_xyz, torch.cat(outs, dim=-1)


class PointNetFPModule(nn.Module):
    """three_interpolation of the coarse features onto the fine points,
    concatenated after the fine level's own, then ``convs``; ``mlp`` are
    the output widths of its layers."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.convs = SharedMLP([in_channels] + list(mlp))

    def forward(self, unknown, known, unknown_feats, known_feats):
        interp = three_interpolation(unknown, known, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([unknown_feats, interp], dim=-1)
        return self.convs(interp)


# the reference's names (pointnet2_modules.py:24, 582) and the pointnet2
# package's FP name
PointnetSAModuleMSG = PointNetSAModuleMSG
PointnetFPModule = PointNetFPModule
PointNetFeaturePropagation = PointNetFPModule


def PointnetSAModule(mlp, npoint=None, radius=None, nsample=None,
                     stride: Optional[int] = None, **kwargs):
    """The single-scale SA module: ``PointNetSAModuleMSG`` with one
    (radius, nsample, mlp) scale; ``mlp[0]`` is the input width. The
    reference's absolute ``npoint`` is given as ``stride`` (``N //
    npoint``), as in ``geot_tpu``."""
    if stride is None:
        if npoint is not None:
            raise ValueError(
                "npoint is an absolute output size; the module takes the "
                "ratio: pass stride=N // npoint instead")
        stride = 1
    return PointNetSAModuleMSG(stride=stride, radii=[radius],
                               nsamples=[nsample], channel_list=[list(mlp)],
                               **kwargs)


@MODELS.register_module(name="PointNet2Encoder")
class PointNet2Encoder(nn.Module):
    """Hierarchical encoder; ``forward`` returns the per-level points and
    features ``([xyz, ...], [x, ...])``. ``geot_tpu``'s fields that its
    encoder never reads (``group_args``, ``conv_args``, ``sampler``, ...)
    are not taken."""

    def __init__(self, in_channels: int = 3, radius: Any = 0.1,
                 num_samples: Any = 32, aggr_args: Any = None,
                 blocks: Optional[Sequence[int]] = None, mlps: Any = None,
                 width: Optional[int] = None,
                 strides: Sequence[int] = (4, 4, 4, 4), layers: int = 3,
                 width_scaling: int = 2, radius_scaling: int = 2,
                 block_radius_scaling: int = 1, nsample_scaling: int = 1,
                 double_last_channel: bool = True):
        super().__init__()
        stages = len(strides)
        blocks = blocks if mlps is None else [len(m) for m in mlps]
        blocks = blocks or [1] * stages
        radii = _to_full_list(radius, blocks, strides, radius_scaling,
                              block_radius_scaling)
        nsamples = _to_full_list(num_samples, blocks, strides,
                                 nsample_scaling)
        if mlps is None:
            mlps = []
            for i in range(stages):
                if not double_last_channel:
                    mlps.append([[width] * layers] * blocks[i])
                    width = width * width_scaling if strides[i] > 1 else width
                else:
                    tmp = [width] * (layers - 1)
                    width = width * width_scaling if strides[i] > 1 else width
                    tmp += [width]
                    mlps.append([tmp] + [[width] * layers] * (blocks[i] - 1))
        aggr = dict(aggr_args or {})
        self.in_channels = in_channels
        self.channel_list: List[int] = [in_channels]
        self.n = stages
        in_ch = in_channels
        for k, stride in enumerate(strides):
            self.add_module(f"sa_{k}", PointNetSAModuleMSG(
                stride, radii[k], nsamples[k],
                [[in_ch] + list(m) for m in mlps[k]],
                aggr.get("feature_type", "dp_fj"),
                aggr.get("reduction", "max")))
            in_ch = sum(m[-1] for m in mlps[k])
            self.channel_list.append(in_ch)
        self.out_channels = in_ch

    def forward(self, xyz, features=None):
        return self.forward_seg_feat(xyz, features)

    def forward_cls_feat(self, xyz, features=None):
        """The max over the last level's points: (B, ``out_channels``)."""
        return self.forward_seg_feat(xyz, features)[1][-1].amax(dim=1)

    def forward_seg_feat(self, xyz, features=None):
        if features is None:
            features = xyz
        if features.shape[-1] != self.in_channels:
            raise ValueError(f"PointNet2Encoder: features have "
                             f"{features.shape[-1]} channels, in_channels "
                             f"is {self.in_channels}")
        l_xyz, l_feats = [xyz], [features]
        for k in range(self.n):
            new_xyz, new_f = getattr(self, f"sa_{k}")(l_xyz[-1], l_feats[-1])
            l_xyz.append(new_xyz)
            l_feats.append(new_f)
        return l_xyz, l_feats


@MODELS.register_module(name="PointNet2GenEncoder")
class PointNet2GenEncoder(PointNet2Encoder):
    """The encoder for the pretraining stage's generator
    (``geot_tpu/models/backbone/pointnetv2.py:273``): ``forward_cls_feat``
    returns the coarsest level's features and points. It also takes the
    batch dict (``pos``, ``x``) that ``ViewGenBase`` passes."""

    def forward_cls_feat(self, xyz, features: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        if isinstance(xyz, dict):
            xyz, features = xyz["pos"], xyz.get("x")
        l_xyz, l_feats = self.forward_seg_feat(xyz, features)
        return l_feats[-1], l_xyz[-1]


@MODELS.register_module(name="PointNet2Decoder")
class PointNet2Decoder(nn.Module):
    """Feature propagation back up the pyramid, coarsest first. Returns
    level 0's features, ``out_channels`` wide."""

    def __init__(self, encoder_channel_list: Sequence[int],
                 fp_mlps: Any = None, decoder_layers: int = 1,
                 _level0_extra: int = 0):
        super().__init__()
        skip = list(encoder_channel_list)
        if fp_mlps is None:
            fp_mlps = [[skip[1]] * (decoder_layers + 1)]
            fp_mlps += [[c] * (decoder_layers + 1) for c in skip[1:-1]]
        self.n = len(fp_mlps)
        # fp_{j} writes level L - n + j from the one above it: the
        # encoder's last level, else what fp_{j+1} wrote; level 0 may
        # carry _level0_extra more channels (the part decoder's one-hot)
        L = len(skip) - 1
        above = skip[L]
        for j in reversed(range(self.n)):
            level = L - self.n + j
            self.add_module(f"fp_{j}", PointNetFPModule(
                skip[level] + (_level0_extra if level == 0 else 0) + above,
                fp_mlps[j]))
            above = fp_mlps[j][-1]
        self.out_channels = above if self.n == L else skip[0]

    def forward(self, l_xyz, l_features):
        l_features = list(l_features)
        n = self.n
        for i in range(-1, -(n + 1), -1):
            l_features[i - 1] = getattr(self, f"fp_{n + i}")(
                l_xyz[i - 1], l_xyz[i], l_features[i - 1], l_features[i])
        return l_features[0]


@MODELS.register_module(name="PointNet2PartDecoder")
class PointNet2PartDecoder(PointNet2Decoder):
    """``PointNet2Decoder`` whose finest level's features are concatenated
    with the one-hot of each cloud's shape category ``cls_label`` (B,) or
    (B, 1) before its FP stage (``geot_tpu/models/backbone/pointnetv2.py:
    238-270``)."""

    def __init__(self, encoder_channel_list: Sequence[int],
                 shape_classes: int = 16, fp_mlps: Any = None,
                 decoder_layers: int = 1):
        skip = list(encoder_channel_list)
        n = len(fp_mlps) if fp_mlps is not None else len(skip) - 1
        # the one-hot joins level 0 only when the decoder reaches it
        super().__init__(encoder_channel_list, fp_mlps, decoder_layers,
                         _level0_extra=(shape_classes if n == len(skip) - 1
                                        else 0))
        self.shape_classes = shape_classes
        self.reaches_level0 = n == len(skip) - 1

    def forward(self, l_xyz, l_features, cls_label=None):
        l_features = list(l_features)
        if self.reaches_level0:
            if cls_label is None:
                raise ValueError("PointNet2PartDecoder needs the shape "
                                 "category (cls)")
            B, N0 = l_xyz[0].shape[:2]
            onehot = torch.nn.functional.one_hot(
                cls_label.reshape(-1).long(), self.shape_classes).to(
                l_features[0].dtype)
            l_features[0] = torch.cat(
                [l_features[0], onehot[:, None, :].expand(
                    B, N0, self.shape_classes)], dim=-1)
        return super().forward(l_xyz, l_features)
