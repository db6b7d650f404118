"""The segmentation wrappers and heads
(``geot_tpu/models/segmentation/base_seg.py``): ``WholePartSeg`` and
``WholePartSeg_ntm``, the GeoT segmentation wrappers; ``Ins_T`` and
``Ins_T_mean``, the transition-matrix predictor wrappers; ``BaseSeg``, the
encoder/decoder/head composition of the supervised zoo, with
``DistillBaseSeg`` and ``VariableSeg`` around it; ``BasePartSeg``, that
composition with the shape category given to the decoder; and the heads
``SegHead``, ``VariableSegHead`` and ``MultiSegHead``.

A composition builds its head with the width of what reaches it, under
the head's ``INPUT_WIDTH_ARG`` (``in_channels`` unless the head names
another argument)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ...core.config import MODELS, build_model_from_cfg, register_model
from ..backbone.transformer import SigT, SigTMean, _ClsTokenEncoder
from ..generation.view_gen import Conv, ConvTranspose
from ..layers import BatchNorm, Dense, Dropout


@register_model("WholePartSeg")
class WholePartSeg(nn.Module):
    """Batches go in as dicts, as in ``geot_tpu``:

    - labelled only: ``p0 = {"pos", "x", "cls"}``;
    - fixmatch: also ``u0 = {"pos_s", "x_s", "cls_s", "pos_w", "x_w",
      "cls_w", "T"?}``: the labelled, strong and weak batches are stacked
      along the batch axis and go through ONE segmentor forward;
    - teacher: ``if_teacher=True`` reads the weak view from ``p0``.

    Returns ``(logit, correction, sigma, feats)``."""

    def __init__(self, segmentor_args: Dict[str, Any]):
        super().__init__()
        self.segmentor = build_model_from_cfg(segmentor_args)

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                cls0: Optional[torch.Tensor] = None,
                u0: Optional[Dict[str, torch.Tensor]] = None,
                if_teacher: bool = False, fixmatch: bool = False,
                generator: Optional[torch.Generator] = None):
        T = None
        if if_teacher:
            p0, f0, cls0 = p0["pos_w"], p0["x_w"], p0["cls_w"]
        elif isinstance(p0, dict):
            if u0 is not None:
                if fixmatch:
                    pos = torch.cat([p0["pos"], u0["pos_s"], u0["pos_w"]])
                    f0 = torch.cat([p0["x"], u0["x_s"], u0["x_w"]])
                    cls0 = torch.cat([p0["cls"].reshape(-1),
                                      u0["cls_s"].reshape(-1),
                                      u0["cls_w"].reshape(-1)])
                else:
                    pos = torch.cat([p0["pos"], u0["pos_s"]])
                    f0 = torch.cat([p0["x"], u0["x_s"]])
                    cls0 = torch.cat([p0["cls"].reshape(-1),
                                      u0["cls_s"].reshape(-1)])
                p0 = pos
                T = u0.get("T")
            else:
                p0, f0, cls0 = p0["pos"], p0.get("x"), p0["cls"]
        return self.segmentor(p0, f0, cls0, T, generator=generator)


@register_model("WholePartSeg_ntm")
class WholePartSegNTM(nn.Module):
    """``WholePartSeg`` without the T thread (``base_seg.py:66-91``): the
    segmentor is called with ``T=None``, so its correction is None; with
    ``u0`` and ``fixmatch`` the three batches are stacked as there, with
    ``u0`` alone the labelled batch goes through by itself."""

    def __init__(self, segmentor_args: Dict[str, Any]):
        super().__init__()
        self.segmentor = build_model_from_cfg(segmentor_args)

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                cls0: Optional[torch.Tensor] = None,
                u0: Optional[Dict[str, torch.Tensor]] = None,
                if_teacher: bool = False, fixmatch: bool = False,
                generator: Optional[torch.Generator] = None):
        if if_teacher:
            p0, f0, cls0 = p0["pos_w"], p0["x_w"], p0["cls_w"]
        elif isinstance(p0, dict):
            if u0 is not None and fixmatch:
                f0 = torch.cat([p0["x"], u0["x_s"], u0["x_w"]])
                cls0 = torch.cat([p0["cls"].reshape(-1),
                                  u0["cls_s"].reshape(-1),
                                  u0["cls_w"].reshape(-1)])
                p0 = torch.cat([p0["pos"], u0["pos_s"], u0["pos_w"]])
            else:
                p0, f0, cls0 = p0["pos"], p0.get("x"), p0["cls"]
        return self.segmentor(p0, f0, cls0, None, generator=generator)


@register_model("Ins_T")
class InsT(nn.Module):
    """Instance-T predictor wrapper (``base_seg.py:94``):
    ``T_predictor(clean)``."""

    def __init__(self, T_args: Dict[str, Any]):
        super().__init__()
        self.T_predictor = build_model_from_cfg(T_args)

    def forward(self, clean: torch.Tensor) -> torch.Tensor:
        return self.T_predictor(clean)


@register_model("Ins_T_mean")
class InsTMean(nn.Module):
    """Instance-T predictor with class-mean conditioning
    (``base_seg.py:108``): ``T_predictor(clean, cm)``."""

    def __init__(self, T_args: Dict[str, Any]):
        super().__init__()
        self.T_predictor = build_model_from_cfg(T_args)

    def forward(self, clean: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
        return self.T_predictor(clean, cm)


def build_head(cls_args: Dict[str, Any], width: int) -> nn.Module:
    """The head of ``cls_args`` for features of ``width`` channels: the
    width goes to the head's ``INPUT_WIDTH_ARG`` (``in_channels`` by
    default)."""
    head = MODELS.get(cls_args.get("NAME"))
    key = getattr(head, "INPUT_WIDTH_ARG", "in_channels")
    return build_model_from_cfg(dict(cls_args, **{key: width}))


@register_model("BaseSeg")
class BaseSeg(nn.Module):
    """Encoder, optional decoder, optional head. The decoder is built with
    ``encoder_channel_list`` = the encoder's ``channel_list`` unless the
    config gives one, and the head with ``in_channels`` = the width of
    what reaches it (the decoder's or the encoder's ``out_channels``).
    ``forward`` takes a batch dict (``pos``, ``x``) or arrays and returns
    bare (B, N, C) logits."""

    def __init__(self, encoder_args: Dict[str, Any],
                 decoder_args: Optional[Dict[str, Any]] = None,
                 cls_args: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.encoder = build_model_from_cfg(encoder_args)
        width = self.encoder.out_channels
        self.decoder = None
        if decoder_args is not None:
            dec_args = dict(decoder_args)
            dec_args.setdefault("encoder_channel_list",
                                self.encoder.channel_list)
            self.decoder = build_model_from_cfg(dec_args)
            width = self.decoder.out_channels
        self.head = (build_head(cls_args, width) if cls_args is not None
                     else None)

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if isinstance(p0, dict):
            p0, f0 = p0["pos"], p0.get("x")
        l_xyz, l_feats = self.encoder.forward_seg_feat(p0, f0)
        if self.decoder is not None:
            f = self.decoder(l_xyz, l_feats)
        else:
            # a one-level encoder (DGCNN) returns its (B, N, C) features
            f = l_feats[-1] if isinstance(l_feats, (list, tuple)) else l_feats
        return self.head(f, generator) if self.head is not None else f


@register_model("BasePartSeg")
class BasePartSeg(BaseSeg):
    """``BaseSeg`` for part segmentation: the decoder also takes each
    cloud's shape category (``cls``). ``forward`` takes a batch dict
    (``pos``, ``x``, ``cls``) or arrays ``(p0, f0, cls0)`` and returns
    bare (B, N, C) logits."""

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                cls0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if isinstance(p0, dict):
            p0, f0, cls0 = p0["pos"], p0.get("x"), p0.get("cls")
        l_xyz, l_feats = self.encoder.forward_seg_feat(p0, f0)
        if self.decoder is not None:
            f = self.decoder(l_xyz, l_feats, cls0)
        else:
            f = l_feats[-1] if isinstance(l_feats, (list, tuple)) else l_feats
        return self.head(f, generator) if self.head is not None else f


@register_model("SegHead")
class SegHead(nn.Module):
    """Per-point head (``GenericSegHead``): optional global max/avg features
    (``global_feat``, a comma list) concatenated to every point, then
    ``mlp_{i}`` + ``bn_{i}`` + ReLU per width of ``mlps`` (one layer of the
    input width when None), dropout, and ``out`` to ``num_classes``.
    ``in_channels`` is the width of the features that reach it."""

    def __init__(self, num_classes: int = 17,
                 in_channels: Optional[int] = None,
                 mlps: Optional[Sequence[int]] = None,
                 dropout_ratio: float = 0.5,
                 global_feat: Optional[str] = None):
        super().__init__()
        if in_channels is None:
            raise ValueError("SegHead needs in_channels")
        self.global_feat = ([t for t in global_feat.split(",")
                             if "max" in t or t in ("avg", "mean")]
                            if global_feat else [])
        width = in_channels * (1 + len(self.global_feat))
        mlps = list(mlps) if mlps is not None else [width]
        self.n = len(mlps)
        for i, c in enumerate(mlps):
            self.add_module(f"mlp_{i}", Dense(width, c))
            self.add_module(f"bn_{i}", BatchNorm(c))
            width = c
        self.dropout = Dropout(dropout_ratio)
        self.out = Dense(width, num_classes)

    def forward(self, f: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.global_feat:
            g = torch.cat([f.amax(dim=1, keepdim=True) if "max" in t
                           else f.mean(dim=1, keepdim=True)
                           for t in self.global_feat], dim=-1)
            f = torch.cat([f, g.expand(*f.shape[:2], g.shape[-1])], dim=-1)
        for i in range(self.n):
            f = torch.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"mlp_{i}")(f)))
        return self.out(self.dropout(f, generator))


@register_model("DistillBaseSeg")
class DistillBaseSeg(nn.Module):
    """``BaseSeg`` as ``inner`` (``base_seg.py:189``; the reference class
    is commented out): ``distill_args`` and ``criterion_args`` are taken
    and not read."""

    def __init__(self, encoder_args: Dict[str, Any],
                 decoder_args: Optional[Dict[str, Any]] = None,
                 cls_args: Optional[Dict[str, Any]] = None,
                 distill_args: Any = None, criterion_args: Any = None):
        super().__init__()
        self.inner = BaseSeg(encoder_args, decoder_args, cls_args)

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self.inner(p0, f0, generator)


@register_model("VariableSeg")
class VariableSeg(DistillBaseSeg):
    """``BaseSeg`` as ``inner`` for variable-length scenes, in the dense
    layout (``base_seg.py:299``)."""

    def __init__(self, encoder_args: Dict[str, Any],
                 decoder_args: Optional[Dict[str, Any]] = None,
                 cls_args: Optional[Dict[str, Any]] = None):
        super().__init__(encoder_args, decoder_args, cls_args)


@register_model("VariableSegHead")
class VariableSegHead(nn.Module):
    """``fc0`` (to ``in_channels``, or the input's width when None) +
    ``bn0`` + ReLU, dropout, and ``out`` to ``num_classes``
    (``base_seg.py:245``). ``feat_channels`` is the input's width, which a
    composition gives."""

    INPUT_WIDTH_ARG = "feat_channels"

    def __init__(self, num_classes: int = 17,
                 in_channels: Optional[int] = None,
                 dropout_ratio: float = 0.5,
                 feat_channels: Optional[int] = None):
        super().__init__()
        if feat_channels is None:
            raise ValueError("VariableSegHead needs feat_channels")
        c = in_channels or feat_channels
        self.fc0 = Dense(feat_channels, c)
        self.bn0 = BatchNorm(c)
        self.dropout = Dropout(dropout_ratio)
        self.out = Dense(c, num_classes)

    def forward(self, f: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.out(self.dropout(torch.relu(self.bn0(self.fc0(f))),
                                     generator))


@register_model("MultiSegHead")
class MultiSegHead(nn.Module):
    """Per-category part heads (``base_seg.py:267``): for category i,
    ``head{i}_fc`` (the input's width) + ``head{i}_bn`` + ReLU, dropout and
    ``head{i}_out`` to ``num_parts[i]``, padded with -1e9 to the largest
    part count; stacked to (S, B, N, P) for ``MultiShapeCrossEntropy``.
    ``in_channels`` is the input's width; ``num_classes`` is taken and not
    read."""

    # logits stacked per category: geot_tpu's trainer cannot train them,
    # so the port's refuses (``engine.train._misplaced``)
    STACKED = True

    def __init__(self, num_classes: int = 50,
                 in_channels: Optional[int] = None, shape_classes: int = 16,
                 num_parts: Sequence[int] = (4, 2, 2, 4, 4, 3, 3, 2, 4, 2,
                                             6, 2, 3, 3, 3, 3),
                 dropout_ratio: float = 0.0):
        super().__init__()
        if in_channels is None:
            raise ValueError("MultiSegHead needs in_channels")
        self.shape_classes = shape_classes
        self.num_parts = tuple(num_parts)
        self.dropout = Dropout(dropout_ratio)
        for i in range(shape_classes):
            self.add_module(f"head{i}_fc", Dense(in_channels, in_channels))
            self.add_module(f"head{i}_bn", BatchNorm(in_channels))
            self.add_module(f"head{i}_out", Dense(in_channels,
                                                  self.num_parts[i]))

    def forward(self, f: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        most = max(self.num_parts)
        outs = []
        for i in range(self.shape_classes):
            h = torch.relu(getattr(self, f"head{i}_bn")(
                getattr(self, f"head{i}_fc")(f)))
            h = getattr(self, f"head{i}_out")(self.dropout(h, generator))
            outs.append(F.pad(h, (0, most - self.num_parts[i]),
                              value=-1e9))
        return torch.stack(outs)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation: xavier-uniform weights and zero biases for
    every Linear (the reference ``_init_weights``), unit/zero norms, the
    per-class xavier of ``SigTMean``, ``sig_t``'s constant, the cls-token
    encoders' ``cls_pos`` N(0, 1), xavier-uniform kernels and zero
    biases for the generation stack's convolutions. The zero-initialised
    ``T_linear``/``T_revision`` and ``sigma`` = 0.4 keep their values."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Linear):
                if name.endswith(("T_linear", "T_revision")):
                    continue
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.BatchNorm1d, nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (SigTMean, SigT, _ClsTokenEncoder)):
                m.reset_parameters(generator)
            elif isinstance(m, (Conv, ConvTranspose)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
    return model
