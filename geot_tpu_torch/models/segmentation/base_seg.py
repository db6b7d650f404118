"""``WholePartSeg``, the GeoT segmentation wrapper, ``InsTMean``, the
instance transition-matrix predictor wrapper, ``BaseSeg`` with its
``SegHead``, the encoder/decoder/head composition of the supervised zoo,
and ``BasePartSeg``, that composition with the shape category given to the
decoder (``geot_tpu/models/segmentation/base_seg.py:19-63, 108, 121-186,
223-243``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...core.config import build_model_from_cfg, register_model
from ..backbone.transformer import SigTMean
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


@register_model("Ins_T_mean")
class InsTMean(nn.Module):
    """Instance-T predictor with class-mean conditioning
    (``base_seg.py:108``): ``T_predictor(clean, cm)``."""

    def __init__(self, T_args: Dict[str, Any]):
        super().__init__()
        self.T_predictor = build_model_from_cfg(T_args)

    def forward(self, clean: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
        return self.T_predictor(clean, cm)


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
        self.head = (build_model_from_cfg(dict(cls_args, in_channels=width))
                     if cls_args is not None else None)

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


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation: xavier-uniform weights and zero biases for
    every Linear (the reference ``_init_weights``), unit/zero norms, the
    per-class xavier of ``SigTMean``, xavier-uniform kernels and zero
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
            elif isinstance(m, SigTMean):
                m.reset_parameters(generator)
            elif isinstance(m, (Conv, ConvTranspose)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
    return model
