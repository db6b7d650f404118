"""``WholePartSeg``: the GeoT segmentation wrapper, labelled-only eval
branch (``geot_tpu/models/segmentation/base_seg.py:38-64``). The fixmatch
concat of labelled, strong and weak batches belongs to training."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ...core.config import build_model_from_cfg, register_model


@register_model("WholePartSeg")
class WholePartSeg(nn.Module):
    def __init__(self, segmentor_args: Dict[str, Any]):
        super().__init__()
        self.segmentor = build_model_from_cfg(segmentor_args)

    def forward(self, p0, f0: Optional[torch.Tensor] = None,
                cls0: Optional[torch.Tensor] = None):
        """``p0`` is a (B, N, 3) tensor or a batch dict
        ``{"pos", "x", "cls"}``. Returns ``(logit, correction, sigma,
        feats)``."""
        if isinstance(p0, dict):
            p0, f0, cls0 = p0["pos"], p0.get("x"), p0["cls"]
        return self.segmentor(p0, f0, cls0, None)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation: xavier-uniform weights and zero biases for
    every Linear (the reference ``_init_weights``), unit/zero norms. The
    zero-initialised ``T_linear``/``T_revision`` and ``sigma`` = 0.4 keep
    their values."""
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
    return model
