"""The loss registry (``geot_tpu/losses/build.py``): every criterion a
config can name in ``criterion_args`` or ``criterion_u_args``, with
``geot_tpu``'s aliases. Losses are callables over channels-last tensors:
logits (B, N, C), integer labels (B, N).

Tie rules are jnp's: ``argmax`` and the top-2 of ``Poly1FocalLoss_U_top2``
take the first maximum.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.registry import Registry
from ..ops import knn

LOSS = Registry("loss")
LOSSES = LOSS       # the port's earlier name


def _flatten_logits(logits: torch.Tensor, labels: torch.Tensor):
    return logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-logp[i, labels[i]] per row."""
    return -logp.gather(1, labels[:, None])[:, 0]


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


@LOSS.register_module(name="CrossEntropy")
@LOSS.register_module(name="CrossEntropyLoss")
class CrossEntropy:
    """``build.py:28``: mean cross entropy, optionally label-smoothed over
    the C - 1 other classes."""

    def __init__(self, label_smoothing: float = 0.0, **kwargs):
        self.label_smoothing = label_smoothing

    def __call__(self, logits, labels):
        logits, labels = _flatten_logits(logits, labels)
        logp = F.log_softmax(logits, -1)
        if self.label_smoothing > 0:
            C = logits.shape[-1]
            onehot = F.one_hot(labels, C).to(logits.dtype)
            smooth = onehot * (1 - self.label_smoothing) + \
                (1 - onehot) * self.label_smoothing / (C - 1)
            return (-(smooth * logp).sum(-1)).mean()
        return _nll(logp, labels).mean()


@LOSS.register_module(name="SmoothCrossEntropy")
class SmoothCrossEntropy:
    """``build.py:45``: label-smoothed cross entropy with an optional
    ``ignore_index`` and per-class ``weight``, averaged over kept points."""

    def __init__(self, label_smoothing: float = 0.2, ignore_index=None,
                 num_classes=None, weight=None, **kwargs):
        self.label_smoothing = label_smoothing
        self.ignore_index = ignore_index
        self.weight = weight

    def __call__(self, logits, labels):
        logits, labels = _flatten_logits(logits, labels)
        C = logits.shape[-1]
        valid = torch.ones_like(labels, dtype=logits.dtype)
        if self.ignore_index is not None:
            valid = (labels != self.ignore_index).to(logits.dtype)
            labels = torch.where(labels == self.ignore_index, 0, labels)
        onehot = F.one_hot(labels, C).to(logits.dtype)
        if self.label_smoothing > 0:
            onehot = onehot * (1 - self.label_smoothing) + \
                (1 - onehot) * self.label_smoothing / (C - 1)
        logp = F.log_softmax(logits, -1)
        if self.weight is not None:
            w = _as_tensor(self.weight, logits).reshape(-1)
            per = -(onehot * logp * w).sum(-1)
        else:
            per = -(onehot * logp).sum(-1)
        return (per * valid).sum() / valid.sum().clamp_min(1.0)


@LOSS.register_module(name="MaskedCrossEntropy")
class MaskedCrossEntropy:
    """``build.py:74``: cross entropy over the points where mask is 1 (the
    smoothing argument is accepted and, as there, not applied)."""

    def __init__(self, label_smoothing: float = 0.2, **kwargs):
        pass

    def __call__(self, logits, labels, mask):
        logits, labels = _flatten_logits(logits, labels)
        mask = mask.reshape(-1).to(logits.dtype)
        loss = _nll(F.log_softmax(logits, -1), labels)
        return (loss * mask).sum() / mask.sum().clamp_min(1.0)


@LOSS.register_module(name="BCELogits")
@LOSS.register_module(name="BCEWithLogitsLoss")
class BCELogits:
    """``build.py:88``: sigmoid binary cross entropy against the one-hot
    labels, mean over every (point, class)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, logits, labels):
        logits, labels = _flatten_logits(logits, labels)
        onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
        return F.binary_cross_entropy_with_logits(logits, onehot)


@LOSS.register_module(name="FocalLoss")
class FocalLoss:
    """``build.py:110``: softmax focal loss, ``pt`` detached."""

    def __init__(self, gamma: float = 0.0, alpha=None,
                 size_average: bool = True, **kwargs):
        self.gamma = gamma
        if isinstance(alpha, (int, float)):
            alpha = [alpha, 1 - alpha]
        self.alpha = alpha
        self.size_average = size_average

    def __call__(self, logits, labels):
        logits, labels = _flatten_logits(logits, labels)
        logpt = -_nll(F.log_softmax(logits, -1), labels)
        pt = torch.exp(logpt.detach())
        if self.alpha is not None:
            logpt = logpt * _as_tensor(self.alpha, logits)[labels]
        loss = -((1 - pt) ** self.gamma) * logpt
        return loss.mean() if self.size_average else loss.sum()


@LOSS.register_module(name="Poly1CrossEntropyLoss")
class Poly1CrossEntropy:
    """``build.py:133``: cross entropy + epsilon * (1 - pt)."""

    def __init__(self, num_classes: int = 50, epsilon: float = 1.0,
                 reduction: str = "mean", weight=None, **kwargs):
        self.epsilon = epsilon
        self.reduction = reduction
        self.weight = weight

    def __call__(self, logits, labels):
        logits, labels = _flatten_logits(logits, labels)
        C = logits.shape[-1]
        onehot = F.one_hot(labels, C).to(logits.dtype)
        pt = (onehot * torch.softmax(logits, -1)).sum(-1)
        ce = _nll(F.log_softmax(logits, -1), labels)
        if self.weight is not None:
            ce = ce * _as_tensor(self.weight, logits)[labels]
        return _reduce(ce + self.epsilon * (1 - pt), self.reduction)


def _poly1_focal_elem(logits: torch.Tensor, labels: torch.Tensor,
                      epsilon: float, alpha: float,
                      gamma: float) -> torch.Tensor:
    """(B, N, C) per-element sigmoid focal + poly-1 terms; labels (B, N)
    (``build.py:158``)."""
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


def _masked_mean(poly1: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of the (B, N, C) terms where the (B, N) mask holds, over the
    masked element count + 0.001 (``_Poly1FocalMasked``)."""
    mask = mask[..., None].to(poly1.dtype)
    return (poly1 * mask).sum() / (mask.sum() * poly1.shape[-1] + 0.001)


@LOSS.register_module(name="Poly1FocalLoss")
class Poly1FocalLoss:
    """``build.py:175``: the GeoT supervised criterion."""

    def __init__(self, epsilon: float = 1.0, alpha: float = 0.25,
                 gamma: float = 2.0, reduction: str = "mean", **kwargs):
        self.epsilon, self.alpha, self.gamma = epsilon, alpha, gamma
        self.reduction = reduction

    def __call__(self, logits, labels):
        return _reduce(_poly1_focal_elem(logits, labels, self.epsilon,
                                         self.alpha, self.gamma),
                       self.reduction)


class _Poly1FocalMasked:
    """Confidence-thresholded masked mean of the poly-1 focal terms
    (``build.py:194``); ``mask`` replaces the threshold mask when given."""

    def __init__(self, epsilon: float = 1.0, alpha: float = 0.25,
                 gamma: float = 2.0, **kwargs):
        self.epsilon, self.alpha, self.gamma = epsilon, alpha, gamma

    def _elem(self, logits, labels):
        return _poly1_focal_elem(logits, labels, self.epsilon, self.alpha,
                                 self.gamma)

    def __call__(self, logits, labels, logits_pred, thresh: float = 0.95,
                 mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = logits_pred >= thresh
        return _masked_mean(self._elem(logits, labels), mask)


@LOSS.register_module(name="Poly1FocalLoss_U")
class Poly1FocalLossU(_Poly1FocalMasked):
    """``build.py:214``."""


@LOSS.register_module(name="Poly1FocalLoss_U_corr")
class Poly1FocalLossUCorr(_Poly1FocalMasked):
    """``build.py:220``: the same forward, fed T-corrected logits."""


@LOSS.register_module(name="Poly1FocalLoss_U_T")
class Poly1FocalLossUT(_Poly1FocalMasked):
    """``build.py:225``: the terms reweighted by ``beta = p_before_T /
    p_after_T`` at the pseudo-label's class."""

    def __call__(self, logits, labels, logits_pred, T, pred_u_t,
                 thresh: float = 0.95, mask: Optional[torch.Tensor] = None):
        after = pred_u_t.gather(-1, labels.long()[..., None])[..., 0]
        poly1 = self._elem(logits, labels) * (logits_pred / after)[..., None]
        if mask is None:
            mask = logits_pred >= thresh
        return _masked_mean(poly1, mask)


@LOSS.register_module(name="Poly1FocalLoss_U_Cur")
class Poly1FocalLossUCur(_Poly1FocalMasked):
    """``build.py:243``: masked by the batch's per-point curvature score
    ``cur`` where given, else by the confidence."""

    def __call__(self, logits, labels, logits_pred, thresh: float = 0.95,
                 cur: Optional[torch.Tensor] = None):
        mask = (cur if cur is not None else logits_pred) >= thresh
        return _masked_mean(self._elem(logits, labels), mask)


def _top2(x: torch.Tensor):
    """``lax.top_k(x, 2)`` over the last axis: values and indices, each
    (..., 2); of equal values the first index comes first."""
    i1 = x.argmax(dim=-1)
    rest = x.scatter(-1, i1[..., None], float("-inf"))
    i2 = rest.argmax(dim=-1)
    idx = torch.stack([i1, i2], dim=-1)
    return x.gather(-1, idx), idx


@LOSS.register_module(name="Poly1FocalLoss_U_top2")
class Poly1FocalLossUTop2(_Poly1FocalMasked):
    """``build.py:257``: the threshold mask widened by ambiguous points
    (top-1 + top-2 >= 0.9) whose top-2 labels are swapped with their
    nearest neighbour's in xyz. Returns ``(loss, widened mask, topk
    mask)``. The neighbour comes from a k = 2 self-search of each cloud;
    ``idx[..., 1]`` is the nearest other index, ties to the smaller."""

    def __call__(self, logits, labels, logits_pred, pred_u, pos,
                 thresh: float = 0.95, mask=None):
        poly1 = self._elem(logits, labels)
        thresh_mask = mask if mask is not None else logits_pred >= thresh
        vals, lab = _top2(pred_u.detach())
        top2_mask = (vals[..., 0] + vals[..., 1] >= 0.9) & ~thresh_mask
        label1, label2 = lab[..., 0], lab[..., 1]
        _, nn_idx = knn(pos, pos, 2)
        nn1 = nn_idx[..., 1].long()
        l1n = label1.gather(1, nn1)
        l2n = label2.gather(1, nn1)
        topk_mask = (label1 == l2n) & (label2 == l1n) & top2_mask
        full = thresh_mask | topk_mask
        return _masked_mean(poly1, full), full, topk_mask


@LOSS.register_module(name="Poly1FocalLoss_U_T_v1")
class Poly1FocalLossUTV1(_Poly1FocalMasked):
    """``build.py:284``: ``_U_T`` with the after-T confidence of the weak
    probabilities corrected by ``T + delta_T`` (the model's T-revision
    output). Returns ``(loss, delta_T)``."""

    def __call__(self, logits, labels, logits_pred, T, pred_u, delta_T,
                 thresh: float = 0.95, mask=None):
        corrected = torch.einsum("bnc,cd->bnd", pred_u, T + delta_T)
        after = corrected.gather(-1, labels.long()[..., None])[..., 0]
        poly1 = self._elem(logits, labels) * (logits_pred / after)[..., None]
        if mask is None:
            mask = logits_pred >= thresh
        return _masked_mean(poly1, mask), delta_T


@LOSS.register_module(name="Weight_CELoss")
class WeightCELoss:
    """``build.py:307``: NLL weighted per class by the batch's mean class
    histogram ``class_weights`` (B, C)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, logits, labels, class_weights):
        w = class_weights.mean(dim=0).to(logits.dtype)
        logits, labels = _flatten_logits(logits, labels)
        return (_nll(F.log_softmax(logits, -1), labels) * w[labels]).mean()


@LOSS.register_module(name="Weight_CELoss_U")
class WeightCELossU:
    """``build.py:323``: the weighted NLL over the points whose confidence
    clears the threshold and whose pseudo-label is not 0."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, logits, labels, class_weights, logits_pred,
                 thresh: float = 0.95):
        w = class_weights.mean(dim=0).to(logits.dtype)
        keep = (logits_pred >= thresh) & (labels != 0)
        logits_f, labels_f = _flatten_logits(logits, labels)
        keep = keep.reshape(-1).to(logits_f.dtype)
        nll = _nll(F.log_softmax(logits_f, -1), labels_f) * w[labels_f]
        return (nll * keep).sum() / keep.sum().clamp_min(1.0)


@LOSS.register_module(name="MSE_Loss_U")
class MSELossU:
    """``build.py:345``: self-thresholded softmax MSE, with the reference's
    broadcast: per (n, c) the numerator is (sum_b mask) x (sum_b loss)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, logits, target, thresh: float = 0.95):
        probs = torch.softmax(logits, -1)
        mask = (probs >= thresh).to(probs.dtype)
        loss = (probs - target) ** 2
        return (mask.sum(0) * loss.sum(0)).sum() / (mask.sum() + 0.001)


@LOSS.register_module(name="MultiShapeCrossEntropy")
class MultiShapeCrossEntropy:
    """``build.py:364``: per sample, the inner criterion on the logits of
    its shape category; ``logits_all_shapes`` (S, B, N, C)."""

    def __init__(self, criterion_args, **kwargs):
        self.criterion = build_criterion_from_cfg(criterion_args)

    def __call__(self, logits_all_shapes, points_labels, shape_labels):
        B = shape_labels.shape[0]
        losses = 0.0
        for i in range(B):
            sl = int(shape_labels[i])
            losses = losses + self.criterion(
                logits_all_shapes[sl][i][None], points_labels[i][None])
        return losses / B


@LOSS.register_module(name="LabelSmoothingCrossEntropy")
class LabelSmoothingCrossEntropy:
    """``build.py:382``."""

    def __init__(self, smoothing: float = 0.1, **kwargs):
        self.smoothing = smoothing

    def __call__(self, logits, labels):
        logits, labels = _flatten_logits(logits, labels)
        logp = F.log_softmax(logits, -1)
        smooth = -logp.mean(dim=-1)
        return ((1 - self.smoothing) * _nll(logp, labels)
                + self.smoothing * smooth).mean()


@LOSS.register_module(name="SoftTargetCrossEntropy")
class SoftTargetCrossEntropy:
    """``build.py:397``: targets are probability distributions."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, logits, target):
        C = logits.shape[-1]
        return (-target.reshape(-1, C)
                * F.log_softmax(logits.reshape(-1, C), -1)).sum(-1).mean()


@LOSS.register_module(name="DistillLoss")
class DistillLoss:
    """``build.py:412``: CE on the labels + KL(teacher || student) at
    temperature tau, times tau^2."""

    def __init__(self, alpha: float = 0.5, tau: float = 1.0, **kwargs):
        self.alpha = alpha
        self.tau = tau

    def __call__(self, student_logits, teacher_logits, labels):
        ce = CrossEntropy()(student_logits, labels)
        C = student_logits.shape[-1]
        s = F.log_softmax(student_logits.reshape(-1, C) / self.tau, -1)
        t = torch.softmax(teacher_logits.reshape(-1, C) / self.tau, -1)
        kd = (t * (torch.log(t + 1e-12) - s)).sum(-1).mean() * self.tau ** 2
        return (1 - self.alpha) * ce + self.alpha * kd


def build_criterion_from_cfg(cfg: Dict[str, Any], **default_args: Any):
    """``{"NAME": ..., **kwargs}`` -> the loss (``build.py:429``); an
    unknown name raises ``KeyError``."""
    return LOSS.build(cfg, **default_args)
