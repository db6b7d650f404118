"""Classification wrappers, channels-last
(``geot_tpu/models/classification/cls_base.py:11-70``): ``ClsHead``, a
head on a global feature; ``BaseCls``, an encoder's ``forward_cls_feat``
and the head; ``DistillCls``, the same returning the global feature too.

The head is built with ``in_channels`` = the width of the encoder's
global feature (``cls_channels`` where the encoder has one, else its
``out_channels``). Module names follow the flax tree (``encoder``,
``head.mlp_{i}``, ``head.bn_{i}``, ``head.out``), so
``engine.convert.params_from_jax`` maps them.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...core.config import MODELS, build_model_from_cfg
from ..layers import BatchNorm, Dense, Dropout


@MODELS.register_module(name="ClsHead")
class ClsHead(nn.Module):
    """``mlp_{i}`` + ``bn_{i}`` + ReLU + dropout per width of ``mlps``,
    then ``out`` to ``num_classes``; the dropout masks come from
    ``generator``."""

    def __init__(self, num_classes: int, in_channels: Optional[int] = None,
                 mlps: Sequence[int] = (512, 256),
                 dropout_ratio: float = 0.5):
        super().__init__()
        if in_channels is None:
            raise ValueError("ClsHead needs in_channels")
        self.n = len(mlps)
        width = in_channels
        for i, c in enumerate(mlps):
            self.add_module(f"mlp_{i}", Dense(width, c))
            self.add_module(f"bn_{i}", BatchNorm(c))
            width = c
        self.dropout = Dropout(dropout_ratio)
        self.out = Dense(width, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"mlp_{i}")(x)))
            x = self.dropout(x, generator)
        return self.out(x)


class _ClsBase(nn.Module):
    def __init__(self, encoder_args: Dict[str, Any],
                 cls_args: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.encoder = build_model_from_cfg(encoder_args)
        width = getattr(self.encoder, "cls_channels",
                        self.encoder.out_channels)
        self.head = (build_model_from_cfg(dict(cls_args, in_channels=width))
                     if cls_args is not None else None)
        # an encoder with stochastic depth (the cls-token encoders) takes
        # the masks' generator
        self._gen = "generator" in inspect.signature(
            self.encoder.forward_cls_feat).parameters

    def _feat_and_logits(self, p0, f0, generator):
        if isinstance(p0, dict):
            p0, f0 = p0["pos"], p0.get("x")
        g = (self.encoder.forward_cls_feat(p0, f0, generator=generator)
             if self._gen else self.encoder.forward_cls_feat(p0, f0))
        return g, (self.head(g, generator) if self.head is not None else g)


@MODELS.register_module(name="BaseCls")
class BaseCls(_ClsBase):
    """Encoder + head: a batch dict (``pos``, ``x``) or arrays in, (B,
    num_classes) logits out (the global feature without a head)."""

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self._feat_and_logits(p0, f0, generator)[1]


@MODELS.register_module(name="DistillCls")
class DistillCls(_ClsBase):
    """``BaseCls`` returning ``(logits, global feature)``, for a
    distillation term on the feature; ``distill_args`` is taken and not
    read, as in ``geot_tpu``."""

    def __init__(self, encoder_args: Dict[str, Any],
                 cls_args: Optional[Dict[str, Any]] = None,
                 distill_args: Any = None):
        super().__init__(encoder_args, cls_args)

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        g, logits = self._feat_and_logits(p0, f0, generator)
        return logits, g
