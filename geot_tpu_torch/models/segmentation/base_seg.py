"""``WholePartSeg``, the GeoT segmentation wrapper, and ``InsTMean``, the
instance transition-matrix predictor wrapper
(``geot_tpu/models/segmentation/base_seg.py:19-63, 108``)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ...core.config import build_model_from_cfg, register_model
from ..backbone.transformer import SigTMean


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


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation: xavier-uniform weights and zero biases for
    every Linear (the reference ``_init_weights``), unit/zero norms, the
    per-class xavier of ``SigTMean``. The zero-initialised
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
    return model
