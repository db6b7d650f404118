"""Scan-level inference, the serving path
(``geot_tpu/engine/predict.py:29-201``).

    model = load_model()                      # flagship, seeded weights, CUDA
    labels, logits = predict_scan(model, points, jaw=0)

Pipeline: unit-sphere normalise -> sample ``num_points`` with numpy's
``default_rng(seed).choice`` (the same draw as ``geot_tpu``) -> forward ->
softmax -> 3-NN upsample to the full scan -> uint8 class ids.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.config import FLAGSHIP_SEG_ARGS, build_model_from_cfg, \
    resolve_device
from ..data.tooth_semi import FDI_LABEL_MAP, pc_norm
from ..models.segmentation.base_seg import init_weights
from .eval import get_pred_whole

# contiguous class id -> FDI code of the lower/upper jaw
_ID2FDI_LOWER = {0: 0, **{v: k for k, v in FDI_LABEL_MAP.items() if 30 < k < 50}}
_ID2FDI_UPPER = {0: 0, **{v: k for k, v in FDI_LABEL_MAP.items() if 10 < k < 30}}
_FDI_LUT_LOWER = np.array([_ID2FDI_LOWER[i]
                           for i in range(max(_ID2FDI_LOWER) + 1)], np.int32)
_FDI_LUT_UPPER = np.array([_ID2FDI_UPPER[i]
                           for i in range(max(_ID2FDI_UPPER) + 1)], np.int32)


def map_pred_to_fdi(pred, jaw: int):
    """Contiguous class-id predictions -> python list of FDI codes."""
    lut = _FDI_LUT_LOWER if jaw == 0 else _FDI_LUT_UPPER
    return np.take(lut, np.asarray(pred, dtype=np.int64)).tolist()


def load_model(seg_args: Optional[Dict[str, Any]] = None,
               ckpt: Optional[str] = None, seed: int = 0,
               device: "str | torch.device" = "cuda") -> torch.nn.Module:
    """``WholePartSeg`` in eval mode on ``device``.

    ``seg_args`` defaults to the flagship; weights come from ``ckpt`` (a
    ``state_dict`` written by ``torch.save``, e.g. of
    ``engine.convert.params_from_jax``) or, without one, from a
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": seg_args or
                                  FLAGSHIP_SEG_ARGS})
    if ckpt:
        model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                         weights_only=True))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


@torch.no_grad()
def predict_scan(model: torch.nn.Module, points: np.ndarray, jaw: int = 0,
                 num_points: int = 16000, seed: int = 0):
    """points (P, 3) raw scan -> (full-res predictions (P,) np.uint8,
    sampled logits (N, C) on the model's device)."""
    device = next(model.parameters()).device
    points_norm, center, scale = pc_norm(points.astype(np.float32))
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(points_norm), num_points,
                     replace=len(points_norm) < num_points)
    pos = torch.from_numpy(np.ascontiguousarray(points_norm[sel][None]))
    pos = pos.to(device)
    cls = torch.full((1, 1), jaw, dtype=torch.long, device=device)
    logits = model({"pos": pos, "x": pos, "cls": cls})[0]
    preds = get_pred_whole(logits, pos, [points], [center], [scale])
    return preds[0], logits[0]
