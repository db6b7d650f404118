"""Noise-transition-matrix (NTM) estimation and the FixMatch bookkeeping
(``geot_tpu/engine/semi.py``), in PyTorch.

Row normalisation divides each row by its own sum, and ``filter_outlier``
zeroes scores for the anchors' selection only: ``geot_tpu``'s fixes of two
reference bugs (``geot_tpu/engine/semi.py:9-30``). ``reference_bugs=True``
reproduces both, as there: the (C,) row sums broadcast over the last axis,
and the anchor row gathered for class c carries zeros at every class c' <=
c where that point's probability cleared c''s quantile.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# FDI adjacency projection: physical neighbourhood order of the 17 classes
LABEL_PROJ = np.array([0, 8, 7, 6, 5, 4, 3, 2, 1, 9, 10, 11, 12, 13, 14, 15,
                       16])
# (C, C) squared distances in projected label space
_PROJ_D2 = (LABEL_PROJ[:, None].astype(np.float32)
            - LABEL_PROJ[None, :].astype(np.float32)) ** 2


def estimate_class_T(probs_u: torch.Tensor, filter_outlier: bool = False,
                     quantile: float = 0.97,
                     reference_bugs: bool = False) -> torch.Tensor:
    """Row c = the softmax row of the most confident point for class c
    (``semi.py:49``). probs_u (B, N, C), already detached."""
    C = probs_u.shape[-1]
    flat = probs_u.reshape(-1, C)
    scores = flat
    if filter_outlier:
        thresh = torch.quantile(flat, quantile, dim=0, keepdim=True)
        zero_mask = flat >= thresh
        scores = torch.where(zero_mask, 0.0, flat)
    idx_best = torch.argmax(scores, dim=0)            # first max, as jnp
    rows = flat[idx_best]
    if filter_outlier and reference_bugs:
        ar = torch.arange(C, device=flat.device)
        rows = torch.where(zero_mask[idx_best] & (ar[None, :] <= ar[:, None]),
                           0.0, rows)
    return rows


def _row_normalize(x: torch.Tensor,
                   reference_bugs: bool = False) -> torch.Tensor:
    """``semi.py:81``: each row divided by its own sum, or with
    ``reference_bugs`` entry [i, j] by row j's sum."""
    if reference_bugs:
        return x / x.sum(dim=1)[None, :]
    return x / x.sum(dim=1, keepdim=True)


def gaussian_prior_T(sigma: torch.Tensor,
                     reference_bugs: bool = False) -> torch.Tensor:
    """Row c: a gaussian over projected-label distance with the model's
    per-class sigma (``semi.py:93``). Row 0 (gum) is the delta at [0, 0];
    column 0 is zero for the tooth rows."""
    C = sigma.shape[0]
    d2 = torch.from_numpy(_PROJ_D2[:C, :C]).to(sigma.device)
    s = sigma[:, None]
    prior = torch.exp(-d2 / (2.0 * s * s)) / (s * math.sqrt(2.0 * math.pi))
    keep = torch.ones((C, C), dtype=prior.dtype, device=prior.device)
    keep[:, 0] = 0.0
    keep[0, :] = 0.0
    delta = torch.zeros_like(keep)
    delta[0, 0] = 1.0
    return _row_normalize(prior * keep + delta, reference_bugs)


class NTMUpdate(NamedTuple):
    ema_t: torch.Tensor        # persistent state (class_T EMA), detached
    ema_t_corr: torch.Tensor   # geometry-corrected EMA used for the step
    class_T: torch.Tensor


def ntm_update(ema_t: torch.Tensor, probs_u: torch.Tensor,
               sigma: torch.Tensor, geo_lambda: float = 0.999,
               ema_t_decay: float = 0.999, filter_outlier: bool = False,
               reference_bugs: bool = False) -> NTMUpdate:
    """One step of the NTM state machine (``semi.py:114``): ``class_T``
    from the batch anchors; ``new_T = geo_lambda * class_T + (1 -
    geo_lambda) * prior`` with row 0 from ``class_T``; ``ema_t_corr`` =
    EMA(ema_t, new_T), differentiable through sigma; the persistent
    ``ema_t`` = EMA(ema_t, class_T), detached. ``reference_bugs``: the
    reference's two bugs, see the module's docstring."""
    rb = reference_bugs
    class_T = estimate_class_T(probs_u.detach(), filter_outlier,
                               reference_bugs=rb).detach()
    prior_T = gaussian_prior_T(sigma, rb)
    new_T = geo_lambda * class_T + (1.0 - geo_lambda) * prior_T
    new_T = _row_normalize(torch.cat([class_T[:1], new_T[1:]]), rb)
    ema_t_corr = _row_normalize(ema_t * ema_t_decay
                                + new_T * (1.0 - ema_t_decay), rb)
    new_ema_t = _row_normalize(ema_t * ema_t_decay
                               + class_T * (1.0 - ema_t_decay), rb)
    return NTMUpdate(ema_t=new_ema_t.detach(), ema_t_corr=ema_t_corr,
                     class_T=class_T)


def combine_T(ema_t_corr: torch.Tensor, ins_T: torch.Tensor,
              lambda_: float = 0.9) -> torch.Tensor:
    """``lambda * ema_t_corr + (1 - lambda) * ins_T``, rows L1-normalised
    (``semi.py:148``). ins_T (M, C, C)."""
    new_t = lambda_ * ema_t_corr[None] + (1.0 - lambda_) * ins_T
    return new_t / new_t.abs().sum(dim=2, keepdim=True)


def apply_T(logits: torch.Tensor, new_t: torch.Tensor) -> torch.Tensor:
    """Per-point row vector times matrix (``semi.py:156``): logits (B, N, C),
    new_t (B*N, C, C) -> (B, N, C), in at least float32."""
    B, N, C = logits.shape
    dt = torch.promote_types(torch.promote_types(logits.dtype, new_t.dtype),
                             torch.float32)
    out = torch.bmm(logits.reshape(B * N, 1, C).to(dt), new_t.to(dt))
    return out.reshape(B, N, C)


def pseudo_stats(pseudo_label: torch.Tensor, target_u: torch.Tensor,
                 conf: torch.Tensor, thresh: float, num_classes: int):
    """Pseudo-label accuracy, coverage and recall diagnostics
    (``semi.py:165``), vectorised over classes."""
    maskf = (conf >= thresh).float()
    total = pseudo_label.numel()
    correct = (pseudo_label == target_u).float()
    denom = maskf.sum()
    zero = torch.zeros((), device=conf.device)

    def ratio(num, den):
        return torch.where(den > 0, num / den.clamp_min(1) * 100.0, zero)

    onehot_p = F.one_hot(pseudo_label.reshape(-1).long(), num_classes).float()
    onehot_g = F.one_hot(target_u.reshape(-1).long(), num_classes).float()
    mflat = maskf.reshape(-1, 1)
    hit = onehot_p * onehot_g
    fg_p = (pseudo_label > 0).float()
    return {
        "over_th": maskf.sum() / total * 100.0,
        "pseudo_acc": ratio((correct * maskf).sum(), denom),
        "pseudo_acc_classwise": ratio((hit * mflat).sum(0),
                                      (onehot_p * mflat).sum(0)),
        "over_th_classwise": ratio((onehot_p * mflat).sum(0),
                                   onehot_p.sum(0)),
        "over_th_recall_classwise": ratio((hit * mflat).sum(0),
                                          onehot_g.sum(0)),
        "over_th_wobg": (maskf * fg_p).sum() / fg_p.sum().clamp_min(1) * 100,
        "over_acc_wobg": ratio((correct * fg_p * maskf).sum(),
                               (fg_p * maskf).sum()),
    }
