"""The train and eval steps (``geot_tpu/engine/steps.py``), flagship
branches: the FixMatch + NTM semi step (``:147-423``), the supervised
warm-up step (``:83``), the eval and confusion steps (``:426, 435``) and
the class-mean bootstrap step (``:451``).

One step: the frozen teacher's softmax on the weak view gives the pseudo
labels (or the student's own weak view, after ``switch_ep``); the student
runs ONE forward over the labelled, strong and weak batches stacked; the
NTM state machine and the T-predictor correct the strong logits; the loss
is ``Poly1FocalLoss`` on the labelled part + the masked
``Poly1FocalLoss_U_corr`` on the corrected strong part + the 3D manifold
loss on the instance matrices; AdamW updates the student (gradients
clipped to a global norm) and the T-predictor with one learning rate.

The eval, confusion and bootstrap steps run the model in eval mode (running
BatchNorm statistics, no dropout) under ``no_grad``; the two train steps
put the student back in train mode.

The other ``criterion_u`` branches, ``pseudo_refine``, the feature-space,
identity and contrastive losses, ``threed_anchors``,
``skip_nonfinite_updates`` and the EMA evaluation shadow are not ported;
a config that turns one on is refused.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from ..losses import build_criterion_from_cfg, threed_space_loss
from ..optim import set_learning_rate
from .semi import apply_T, combine_T, ntm_update, pseudo_stats
from .state import SemiTrainState

# config switches of geot_tpu's step whose branches the port lacks
_UNPORTED = ("use_feat_loss", "use_identity_loss", "use_contrastive",
             "pseudo_refine", "threed_anchors", "skip_nonfinite_updates",
             "ema_eval", "reference_bugs")


def _refuse_unported(cfg: Dict[str, Any]) -> None:
    on = [k for k in _UNPORTED if cfg.get(k)]
    if on:
        raise NotImplementedError(f"not ported: {on}")
    if cfg["criterion_args"]["NAME"] != "Poly1FocalLoss":
        raise NotImplementedError("only the flagship supervised loss is "
                                  "ported: Poly1FocalLoss")


def _zero_missing_grads(modules) -> None:
    """A parameter the loss does not reach (T_linear, T_revision) gets a
    zero gradient, as under ``jax.grad``, so weight decay still applies."""
    for m in modules:
        for p in m.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_supervised_step(cfg: Dict[str, Any]) -> Callable:
    """``step(state, batch_l, lr) -> metrics``: one supervised update of
    the student and its AdamW (``steps.py:83``, the phase
    ``epoch <= supervised_epochs``; ``geot_tpu/engine/train.py:539-553``
    trains the state's student, batch statistics and optimizer with it).
    ``batch_l`` holds ``pos, x, cls, y``; the loss is the supervised
    criterion on the labelled forward; gradients are clipped to a global
    norm as in the semi step."""
    _refuse_unported(cfg)
    criterion = build_criterion_from_cfg(cfg["criterion_args"])
    clip = cfg.get("grad_norm_clip")

    def step(state: SemiTrainState, batch_l: Dict[str, torch.Tensor],
             lr: float) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        logits = model(batch_l, generator=state.generator)[0]
        loss = criterion(logits, batch_l["y"])
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        _zero_missing_grads([model])
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(clip))
        set_learning_rate(state.opt, lr)
        state.opt.step()
        state.step += 1
        loss = loss.detach()
        return {"loss": loss, "sup_loss": loss,
                "unsup_loss": torch.zeros_like(loss)}

    return step


def make_semi_step(cfg: Dict[str, Any]) -> Callable:
    """``step(state, batch_l, batch_u, lr, use_teacher) -> metrics``:
    one update of ``state`` in place. ``batch_l`` holds ``pos, x, cls, y``
    and ``batch_u`` ``pos_w, x_w, cls_w, pos_s, x_s, cls_s, raw_pos, y``,
    tensors on the state's device; metrics are 0-d (or per-class) tensors
    on that device."""
    _refuse_unported(cfg)
    if cfg["criterion_u_args"]["NAME"] != "Poly1FocalLoss_U_corr":
        raise NotImplementedError(
            "only the flagship losses are ported: Poly1FocalLoss and "
            "Poly1FocalLoss_U_corr")
    criterion = build_criterion_from_cfg(cfg["criterion_args"])
    criterion_u = build_criterion_from_cfg(cfg["criterion_u_args"])
    num_classes = int(cfg["num_classes"])
    clip = cfg.get("grad_norm_clip")
    threshold = float(cfg.get("threshold", 0.0))
    unsup_w = float(cfg.get("unsupervised_loss_weight", 1.0))
    lambda_ = float(cfg.get("lambma", 0.9))
    geo_lambda = float(cfg.get("geo_lambma", 0.999))
    ema_t_decay = float(cfg.get("ema_t_decay", 0.999))
    filter_outlier = bool(cfg.get("filter_outlier", False))
    use_3d = bool(cfg.get("use_3d_loss", True))
    td_loss = threed_space_loss(int(cfg.get("threed_k", 32)),
                                float(cfg.get("threed_sigma", 1.0)))
    td_w = float(cfg.get("threed_loss_weight", 0.1))
    b_l = int(cfg["batch_size_l"])
    b_u = int(cfg["batch_size_u"])

    def step(state: SemiTrainState, batch_l: Dict[str, torch.Tensor],
             batch_u: Dict[str, torch.Tensor], lr: float,
             use_teacher: bool) -> Dict[str, torch.Tensor]:
        model, t_pred = state.model, state.t_predictor
        teacher_probs = None
        if use_teacher:
            with torch.no_grad():
                t_logits = state.teacher(batch_u, if_teacher=True)[0]
                teacher_probs = torch.softmax(t_logits, dim=-1)

        model.train()
        t_pred.train()
        u0 = dict(batch_u)
        u0["T"] = state.ema_t
        logits, _corr, sigma, _feats = model(batch_l, u0=u0, fixmatch=True,
                                             generator=state.generator)
        pred_l = logits[:b_l]
        pred_u_strong = logits[b_l:b_l + b_u]
        pred_u_weak = logits[b_l + b_u:]
        probs_w = (teacher_probs if use_teacher else
                   torch.softmax(pred_u_weak, dim=-1).detach())
        conf = probs_w.amax(dim=-1)
        pseudo = probs_w.argmax(dim=-1)        # first maximum, as jnp

        ntm = ntm_update(state.ema_t, probs_w, sigma, geo_lambda=geo_lambda,
                         ema_t_decay=ema_t_decay,
                         filter_outlier=filter_outlier)
        probs_s = torch.softmax(pred_u_strong, dim=-1)
        ins_T = t_pred(probs_s.detach(), state.cm)
        pred_u_corr = apply_T(pred_u_strong,
                              combine_T(ntm.ema_t_corr, ins_T, lambda_))

        sup_loss = criterion(pred_l, batch_l["y"])
        unsup = criterion_u(pred_u_corr, pseudo, conf, thresh=threshold)
        n_conf = (conf >= threshold).float().sum().clamp_min(1.0)
        unsup = unsup * unsup_w * (n_conf.new_tensor(b_u * conf.shape[-1])
                                   / n_conf)
        loss = sup_loss + unsup
        metrics = {}
        if use_3d:
            l3 = td_loss(batch_u["raw_pos"], pseudo, ins_T) * td_w
            loss = loss + l3
            metrics["threed_loss"] = l3.detach()

        state.opt.zero_grad(set_to_none=True)
        state.t_opt.zero_grad(set_to_none=True)
        loss.backward()
        _zero_missing_grads([model, t_pred])
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(clip))
        set_learning_rate(state.opt, lr)
        set_learning_rate(state.t_opt, lr)
        state.opt.step()
        state.t_opt.step()
        state.ema_t = ntm.ema_t
        state.step += 1

        with torch.no_grad():
            target_u = batch_u["y"].reshape(pseudo.shape)
            stats = pseudo_stats(pseudo, target_u, conf, threshold,
                                 num_classes)
            student = pred_u_strong.detach().argmax(dim=-1)
            stats["teacher_acc"] = (pseudo == target_u).float().mean()
            stats["student_acc"] = (student == target_u).float().mean()
        return {"loss": loss.detach(), "sup_loss": sup_loss.detach(),
                "unsup_loss": unsup.detach(), **metrics, **stats}

    return step


def make_eval_step() -> Callable:
    """``step(model, batch) -> logits (B, N, C)``: the eval-mode forward of
    ``batch``'s ``pos, x, cls`` (``steps.py:426``)."""

    @torch.no_grad()
    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        return model(batch)[0]

    return step


def make_confusion_step(num_classes: int) -> Callable:
    """``step(model, batch) -> (C, C)`` hard-label confusion counts, rows
    the label and columns the prediction (``steps.py:435``), float32 as
    there; ``engine.train.cal_confusion`` sums and row-normalises them."""

    @torch.no_grad()
    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        pred = model(batch)[0].argmax(dim=-1).reshape(-1)
        onehot_t = F.one_hot(batch["y"].reshape(-1).long(), num_classes)
        onehot_p = F.one_hot(pred, num_classes)
        return onehot_t.float().T @ onehot_p.float()

    return step


def make_cm_step() -> Callable:
    """``step(model, batch) -> (sums (C, C), counts (C,))``: one batch of
    the class-mean softmax bootstrap (``steps.py:451``), eval mode."""

    @torch.no_grad()
    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        probs = torch.softmax(model(batch)[0].float(), dim=-1)
        C = probs.shape[-1]
        onehot = F.one_hot(batch["y"].reshape(-1).long(), C).float()
        return onehot.T @ probs.reshape(-1, C), onehot.sum(dim=0)

    return step
