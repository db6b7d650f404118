"""Sigmoid poly-1 focal losses (``geot_tpu/losses/build.py:158-221``): the
supervised ``Poly1FocalLoss`` and the unsupervised, confidence-masked
``Poly1FocalLoss_U_corr`` that the flagship feeds T-corrected logits."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F


def _poly1_focal_elem(logits: torch.Tensor, labels: torch.Tensor,
                      epsilon: float, alpha: float,
                      gamma: float) -> torch.Tensor:
    """(B, N, C) per-element sigmoid focal + poly-1 terms; labels (B, N)."""
    C = logits.shape[-1]
    p = torch.sigmoid(logits)
    onehot = F.one_hot(labels.long(), C).to(logits.dtype)
    # optax.sigmoid_binary_cross_entropy computes the same function
    ce = F.binary_cross_entropy_with_logits(logits, onehot, reduction="none")
    pt = onehot * p + (1 - onehot) * (1 - p)
    fl = ce * ((1 - pt) ** gamma)
    if alpha >= 0:
        fl = (alpha * onehot + (1 - alpha) * (1 - onehot)) * fl
    return fl + epsilon * torch.pow(1 - pt, gamma + 1)


class Poly1FocalLoss:
    """``geot_tpu/losses/build.py:175``, mean reduction."""

    def __init__(self, epsilon: float = 1.0, alpha: float = 0.25,
                 gamma: float = 2.0, **kwargs):
        self.epsilon, self.alpha, self.gamma = epsilon, alpha, gamma

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor):
        return _poly1_focal_elem(logits, labels, self.epsilon, self.alpha,
                                 self.gamma).mean()


class Poly1FocalLossUCorr:
    """Confidence-thresholded masked mean of the poly-1 focal terms
    (``build.py:194-221``, ``_Poly1FocalMasked``)."""

    def __init__(self, epsilon: float = 1.0, alpha: float = 0.25,
                 gamma: float = 2.0, **kwargs):
        self.epsilon, self.alpha, self.gamma = epsilon, alpha, gamma

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor,
                 logits_pred: torch.Tensor, thresh: float = 0.95):
        poly1 = _poly1_focal_elem(logits, labels, self.epsilon, self.alpha,
                                  self.gamma)
        mask = (logits_pred >= thresh)[..., None].to(poly1.dtype)
        return (poly1 * mask).sum() / (mask.sum() * poly1.shape[-1] + 0.001)


LOSSES = {"Poly1FocalLoss": Poly1FocalLoss,
          "Poly1FocalLoss_U_corr": Poly1FocalLossUCorr}


def build_criterion_from_cfg(cfg: Dict[str, Any]):
    """``{"NAME": ..., **kwargs}`` -> the loss; only the flagship's two
    are ported."""
    cfg = dict(cfg)
    name = cfg.pop("NAME")
    if name not in LOSSES:
        raise KeyError(f"loss {name!r} is not ported; ported: "
                       f"{sorted(LOSSES)}")
    return LOSSES[name](**cfg)
