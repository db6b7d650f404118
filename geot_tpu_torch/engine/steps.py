"""The train and eval steps (``geot_tpu/engine/steps.py``): the FixMatch +
NTM semi step with every branch (``:147-423``), the supervised step
(``:83``: a supervised run's, and a semi run's warm-up), the eval and
confusion steps (``:426, 435``) and the class-mean bootstrap step
(``:451``). Each takes the logits through ``_logits_of``: the seg_T
family returns a tuple, ``BaseSeg`` and ``PointMLPPartSegmentor`` bare
logits.

One semi step: the frozen teacher's softmax on the weak view gives the
pseudo labels (or the student's own weak view, after ``switch_ep``),
optionally refined with the xyz neighbours' (``pseudo_refine``); the
student runs ONE forward over the labelled, strong and weak batches
stacked; the NTM state machine and the T-predictor correct the strong
logits; the loss is the supervised criterion on the labelled part + the
``criterion_u`` branch on the strong part, scaled by the masked share +
the feature-space, identity, 3D manifold and teacher-contrast terms that
the config turns on; ``cfg.optimizer`` updates the student (gradients
clipped to a global norm) and the T-predictor with one learning rate
(``step_per_update`` gradients an update of the student), and the EMA
shadow follows the student (``ema_eval``).

``optimizer.NAME: adahessian`` (alone or under lookahead): the step also
takes the Hutchinson estimate of the Hessian's diagonal, ``z * (H z)`` with
Rademacher ``z`` drawn from the state's generator after the forward, by a
second backward through the first one's graph (``optim.adahessian``); the
semi step takes one joint pass over the student's and the T-predictor's
parameters (``geot_tpu/engine/steps.py:352-364``). ``grad_norm_clip``
scales the gradients, not the diagonal.

``skip_nonfinite_updates``: when the loss or a gradient (unclipped) is not
finite, the step leaves the weights, both optimizers' states, the BatchNorm
statistics, ``ema_t``, the bank and the EMA shadow as they were; ``step``
advances and the reported loss is 0. Its decision is the step's one host
synchronisation, and there is none without the switch.

Data parallelism (``parallel.dist``, world size > 1): each rank holds
``batch_size / world`` rows of every global batch and runs the forward on
them (BatchNorm takes the global batch's statistics); the logits and the
batch are then gathered into the global batch on every rank, and each rank
computes the whole loss, the NTM update, the pseudo-label statistics and
the random draws on it, as ``geot_tpu``'s step does over its dp-sharded
batch. A rank back-propagates its share of the loss (``dist``'s
convention), and ``sum_gradients`` adds the ranks' parts up to the global
batch's gradient (and Hessian diagonal). ``ema_t`` and the bank are
broadcast from rank 0, so the ranks stay bit-equal.

The eval, confusion and bootstrap steps run the model in eval mode (running
BatchNorm statistics, no dropout) under ``no_grad``; the two train steps
put the student back in train mode.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..losses import (build_criterion_from_cfg, contrast_loss_t,
                      feature_space_loss, identity_loss, threed_space_loss)
from ..optim import hutchinson_diag, rademacher, set_learning_rate
from ..parallel import dist
from .pseudo_mask import pseudo_label_refine
from .semi import apply_T, combine_T, ntm_update, pseudo_stats
from .state import SemiTrainState, TrainState


def _logits_of(out):
    """A segmentation model's logits: the seg_T family returns ``(logit,
    correction, sigma, feats)``, ``BaseSeg`` and ``PointMLPPartSegmentor``
    bare logits (``geot_tpu/engine/steps.py:30``)."""
    return out[0] if isinstance(out, (tuple, list)) else out


def _sup_loss_fn(criterion, criterion_name: str, logits: torch.Tensor,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The supervised criterion as the reference dispatches it
    (``steps.py:39``)."""
    if criterion_name == "Weight_CELoss":
        return criterion(logits, batch["y"], batch["class_weights"])
    if criterion_name == "MultiShapeCrossEntropy":
        return criterion(logits, batch["y"], batch["cls"])
    return criterion(logits, batch["y"])


def _backward(loss: torch.Tensor, opts: List[torch.optim.Optimizer],
              generator: torch.Generator,
              zs: Optional[Dict[str, torch.Tensor]] = None
              ) -> Optional[List[List[torch.Tensor]]]:
    """Back-propagate this rank's share of ``loss`` into the ``.grad`` of
    the parameters of ``opts``, summed over the ranks (a zero gradient
    where the loss does not reach a parameter, as under ``jax.grad``).
    When an optimizer takes the Hessian diagonal (AdaHessian, the
    optimizers' ``needs_hessian``), one joint pass over all of them gives the
    Hutchinson diagonal, per optimizer in its ``params()`` order: ``z``
    from ``generator`` in that order, or ``zs`` by parameter name."""
    params = [p for o in opts for p in o.params()]
    hessian = any(o.needs_hessian for o in opts)
    share = dist.backward_share(loss)
    if not hessian:
        share.backward()
        grads = [p.grad for p in params]
    else:
        grads = torch.autograd.grad(share, params, create_graph=True,
                                    allow_unused=True)
        if zs is None:
            z = rademacher(params, generator)
        else:
            names = [n for o in opts for g in o.param_groups
                     for n in g["names"]]
            z = [zs[n].to(p) for n, p in zip(names, params)]
        diag = hutchinson_diag(grads, params, z)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g.detach()
    dist.sum_gradients(params)
    if not hessian:
        return None
    dist.sum_(diag)
    out, at = [], 0
    for o in opts:
        n = len(o.params())
        out.append(diag[at:at + n])
        at += n
    return out


def _finite(loss: torch.Tensor, modules) -> torch.Tensor:
    """True when the loss and every module's gradient norm are finite
    (``steps.py:73``, ``_finite_guard``); on the device."""
    ok = torch.isfinite(loss)
    for m in modules:
        ok = ok & torch.isfinite(torch.nn.utils.get_total_norm(
            [p.grad for p in m.parameters()]))
    return ok


def _gathered(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every entry of a rank's batch gathered into the global batch."""
    return {k: dist.gather(v) for k, v in batch.items()}


def _buffers(module: torch.nn.Module) -> List[torch.Tensor]:
    return [b for _, b in module.named_buffers()]


def _restore(buffers: List[torch.Tensor], saved: List[torch.Tensor]):
    with torch.no_grad():
        for b, s in zip(buffers, saved):
            b.copy_(s)


def _ema_update(state: SemiTrainState, decay: float) -> None:
    """The shadow's Polyak step, ``e * decay + p * (1 - decay)`` as in
    ``steps.py:62`` (two roundings, no fused multiply-add); a no-op when
    the decay is 0 or the state keeps no shadow."""
    if not decay or not state.ema_params:
        return
    params = dict(state.model.named_parameters())
    shadow = list(state.ema_params.values())
    live = [params[k].detach() for k in state.ema_params]
    with torch.no_grad():
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, torch._foreach_mul(live, 1.0 - decay))


def make_supervised_step(cfg: Dict[str, Any]) -> Callable:
    """``step(state, batch_l, lr) -> metrics``: one supervised update of
    the model and its optimizer (``steps.py:83``): every step of a supervised
    run (a ``TrainState``), and the warm-up phase ``epoch <=
    supervised_epochs`` of a semi one (a ``SemiTrainState``, whose student
    it trains). ``batch_l`` holds ``pos, x, cls, y``
    (and ``class_weights`` for ``Weight_CELoss``); the loss is the
    supervised criterion on the labelled forward; gradients are clipped to
    a global norm as in the semi step; the EMA shadow follows
    (``ema_eval``) and ``skip_nonfinite_updates`` guards the update.
    ``draws = {"hessian": {name: z}}`` feeds AdaHessian's ``z``."""
    criterion = build_criterion_from_cfg(cfg["criterion_args"])
    criterion_name = cfg["criterion_args"]["NAME"]
    clip = cfg.get("grad_norm_clip")
    skip_nonfinite = bool(cfg.get("skip_nonfinite_updates", False))
    ema_decay = float(cfg.get("ema_eval") or 0.0)

    def step(state: "TrainState | SemiTrainState",
             batch_l: Dict[str, torch.Tensor], lr: float,
             draws: Optional[Dict[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        saved = ([b.clone() for b in _buffers(model)] if skip_nonfinite
                 else None)
        logits = dist.gather(_logits_of(model(batch_l,
                                              generator=state.generator)))
        loss = _sup_loss_fn(criterion, criterion_name, logits,
                            _gathered(batch_l))
        state.opt.zero_grad(set_to_none=True)
        diag = _backward(loss, [state.opt], state.generator,
                         (draws or {}).get("hessian"))
        loss = loss.detach()
        metrics = {"loss": loss, "sup_loss": loss,
                   "unsup_loss": torch.zeros_like(loss)}
        if skip_nonfinite:
            ok = _finite(loss, [model])
            metrics["skipped"] = (~ok).float()
            if not bool(ok):                 # the step's one host sync
                _restore(_buffers(model), saved)
                state.step += 1
                metrics["loss"] = metrics["sup_loss"] = torch.zeros_like(
                    loss)
                return metrics
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(clip))
        set_learning_rate(state.opt, lr)
        state.opt.step(hessian=diag[0] if diag else None)
        _ema_update(state, ema_decay)
        state.step += 1
        return metrics

    return step


def make_semi_step(cfg: Dict[str, Any]) -> Callable:
    """``step(state, batch_l, batch_u, lr, use_teacher, draws=None) ->
    metrics``: one update of ``state`` in place. ``batch_l`` holds ``pos,
    x, cls, y`` (and ``class_weights``) and ``batch_u`` ``pos_w, x_w,
    cls_w, pos_s, x_s, cls_s, raw_pos, y`` (and ``cur`` where the dataset
    has it), tensors on the state's device; metrics are 0-d (or per-class)
    tensors on that device.

    The contrast keys and permutation and the 3D-loss anchors come from
    the state's generator; ``draws = {"contrast": (keys (B_u, N), perm),
    "anchors": (B_u, M), "hessian": {name: z}}`` feeds given ones (a test
    seam: ``geot_tpu``'s draws, or the same draws on two devices)."""
    criterion = build_criterion_from_cfg(cfg["criterion_args"])
    criterion_name = cfg["criterion_args"]["NAME"]
    criterion_u = build_criterion_from_cfg(cfg["criterion_u_args"])
    criterion_u_name = cfg["criterion_u_args"]["NAME"]
    num_classes = int(cfg["num_classes"])
    clip = cfg.get("grad_norm_clip")
    ema_decay = float(cfg.get("ema_eval") or 0.0)
    threshold = float(cfg.get("threshold", 0.0))
    unsup_w = float(cfg.get("unsupervised_loss_weight", 1.0))
    lambda_ = float(cfg.get("lambma", 0.9))
    geo_lambda = float(cfg.get("geo_lambma", 0.999))
    ema_t_decay = float(cfg.get("ema_t_decay", 0.999))
    filter_outlier = bool(cfg.get("filter_outlier", False))
    reference_bugs = bool(cfg.get("reference_bugs", False))

    use_feat = bool(cfg.get("use_feat_loss", False))
    feat_loss = feature_space_loss(int(cfg.get("feat_k", 16)),
                                   float(cfg.get("feat_sigma", 1.0)),
                                   num_classes)
    feat_w = float(cfg.get("feat_loss_weight", 10.0))
    use_id = bool(cfg.get("use_identity_loss", False))
    id_loss = identity_loss()
    id_w = float(cfg.get("identity_loss_weight", 1.0))
    use_3d = bool(cfg.get("use_3d_loss", True))
    td_loss = threed_space_loss(int(cfg.get("threed_k", 32)),
                                float(cfg.get("threed_sigma", 1.0)),
                                num_classes,
                                anchors=int(cfg.get("threed_anchors", 0)
                                            or 0))
    td_w = float(cfg.get("threed_loss_weight", 0.1))
    use_contrast = bool(cfg.get("use_contrastive", False))
    contrast_w = float(cfg.get("contrastive_loss_weight", 1.0))
    # the reference hard-codes 0.9; geot_tpu makes it configurable
    # (steps.py:190-196)
    contrast_th = float(cfg.get("contrast_threshold", 0.9))
    pseudo_refine = bool(cfg.get("pseudo_refine", False))
    skip_nonfinite = bool(cfg.get("skip_nonfinite_updates", False))
    b_l = int(cfg["batch_size_l"])
    b_u = int(cfg["batch_size_u"])

    def unsup_loss(pred_u_strong, pred_u_corr, pseudo, conf, probs_w, ntm,
                   corr, refine_mask, batch_l, batch_u):
        """The ``criterion_u`` dispatch (``steps.py:259-300``): the loss
        and the mask that replaces the threshold mask in the scale (top2's
        widened one), or None."""
        name = criterion_u_name
        if name == "Weight_CELoss_U":
            return criterion_u(pred_u_strong, pseudo,
                               batch_l["class_weights"], conf,
                               thresh=threshold), None
        if name == "Poly1FocalLoss_U":
            return criterion_u(pred_u_strong, pseudo, conf, thresh=threshold,
                               mask=refine_mask), None
        if name == "Poly1FocalLoss_U_T":
            return criterion_u(pred_u_strong, pseudo, conf, ntm.ema_t,
                               torch.softmax(pred_u_corr, -1),
                               thresh=threshold, mask=refine_mask), None
        if name == "Poly1FocalLoss_U_T_v1":
            # delta_T: the model's T-revision output, zeros without one
            delta = corr if corr is not None else torch.zeros_like(ntm.ema_t)
            return criterion_u(pred_u_strong, pseudo, conf, ntm.ema_t,
                               probs_w, delta, thresh=threshold,
                               mask=refine_mask)[0], None
        if name == "Poly1FocalLoss_U_Cur":
            return criterion_u(pred_u_strong, pseudo, conf, thresh=threshold,
                               cur=batch_u.get("cur", conf)), None
        if name == "Poly1FocalLoss_U_top2":
            loss, full_mask, _ = criterion_u(
                pred_u_strong, pseudo, conf, probs_w, batch_u["raw_pos"],
                thresh=threshold, mask=refine_mask)
            return loss, full_mask
        if name == "MSE_Loss_U":
            return criterion_u(pred_u_strong, probs_w,
                               thresh=threshold), None
        # Poly1FocalLoss_U_corr, the config default
        return criterion_u(pred_u_corr, pseudo, conf, thresh=threshold,
                           mask=refine_mask), None

    def step(state: SemiTrainState, batch_l: Dict[str, torch.Tensor],
             batch_u: Dict[str, torch.Tensor], lr: float, use_teacher: bool,
             draws: Optional[Dict[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        model, t_pred = state.model, state.t_predictor
        saved = ([b.clone() for b in _buffers(model)] if skip_nonfinite
                 else None)
        teacher_probs = teacher_feats = None
        if use_teacher:
            with torch.no_grad():
                t_out = state.teacher(batch_u, if_teacher=True)
                teacher_probs = dist.gather(torch.softmax(t_out[0], dim=-1))
                if use_contrast:
                    teacher_feats = dist.gather(t_out[-1])

        model.train()
        t_pred.train()
        u0 = dict(batch_u)
        u0["T"] = state.ema_t
        logits, corr, sigma, feats = model(batch_l, u0=u0, fixmatch=True,
                                           generator=state.generator)
        # this rank's rows of the stacked batch, then the global batch
        bl, bu = b_l // dist.world(), b_u // dist.world()
        pred_l = dist.gather(logits[:bl])
        pred_u_strong = dist.gather(logits[bl:bl + bu])
        pred_u_weak = dist.gather(logits[bl + bu:])
        batch_l, batch_u = _gathered(batch_l), _gathered(batch_u)
        probs_w = (teacher_probs if use_teacher else
                   torch.softmax(pred_u_weak, dim=-1).detach())
        conf = probs_w.amax(dim=-1)
        pseudo = probs_w.argmax(dim=-1)        # first maximum, as jnp
        refine_mask = (pseudo_label_refine(probs_w, threshold,
                                           batch_u["raw_pos"])
                       if pseudo_refine else None)

        ntm = ntm_update(state.ema_t, probs_w, sigma, geo_lambda=geo_lambda,
                         ema_t_decay=ema_t_decay,
                         filter_outlier=filter_outlier,
                         reference_bugs=reference_bugs)
        probs_s = torch.softmax(pred_u_strong, dim=-1)
        ins_T = t_pred(probs_s.detach(), state.cm)
        pred_u_corr = apply_T(pred_u_strong,
                              combine_T(ntm.ema_t_corr, ins_T, lambda_))

        sup_loss = _sup_loss_fn(criterion, criterion_name, pred_l, batch_l)
        unsup, mask_override = unsup_loss(
            pred_u_strong, pred_u_corr, pseudo, conf, probs_w, ntm, corr,
            refine_mask, batch_l, batch_u)
        if mask_override is not None:
            thresh_mask = mask_override
        elif refine_mask is not None:
            thresh_mask = refine_mask
        else:
            thresh_mask = conf >= threshold
        n_mask = thresh_mask.float().sum().clamp_min(1.0)
        unsup = unsup * unsup_w * (n_mask.new_tensor(b_u * conf.shape[-1])
                                   / n_mask)
        loss = sup_loss + unsup
        aux = {}
        if use_feat:
            aux["feat_loss"] = feat_loss(probs_s, pseudo, ins_T) * feat_w
        if use_id:
            aux["identity_loss"] = id_loss(ins_T) * id_w
        if use_3d:
            aux["threed_loss"] = td_loss(
                batch_u["raw_pos"], pseudo, ins_T,
                generator=state.generator,
                anchor_idx=draws.get("anchors")) * td_w
        new_contrast = state.contrast
        if use_contrast and use_teacher:
            lc, new_contrast = contrast_loss_t(
                state.contrast, dist.gather(feats[bl:bl + bu]), conf,
                teacher_feats,
                threshold=contrast_th, generator=state.generator,
                draws=draws.get("contrast"))
            aux["contrast_loss"] = lc * contrast_w
        for v in aux.values():
            loss = loss + v

        state.opt.zero_grad(set_to_none=True)
        state.t_opt.zero_grad(set_to_none=True)
        diags = _backward(loss, [state.opt, state.t_opt], state.generator,
                          draws.get("hessian"))
        loss = loss.detach()

        with torch.no_grad():
            target_u = batch_u["y"].reshape(pseudo.shape)
            stats = pseudo_stats(pseudo, target_u, conf, threshold,
                                 num_classes)
            student = pred_u_strong.detach().argmax(dim=-1)
            stats["teacher_acc"] = (pseudo == target_u).float().mean()
            stats["student_acc"] = (student == target_u).float().mean()
        metrics = {"loss": loss, "sup_loss": sup_loss.detach(),
                   "unsup_loss": unsup.detach(), **stats,
                   **{k: v.detach() for k, v in aux.items()}}
        if skip_nonfinite:
            ok = _finite(loss, [model, t_pred])
            metrics["skipped"] = (~ok).float()
            if not bool(ok):                 # the step's one host sync
                _restore(_buffers(model), saved)
                state.step += 1
                metrics["loss"] = torch.zeros_like(loss)
                return metrics

        if clip is not None:
            torch.nn.utils.clip_grad_norm_(model.parameters(), float(clip))
        set_learning_rate(state.opt, lr)
        set_learning_rate(state.t_opt, lr)
        state.opt.step(hessian=diags[0] if diags else None)
        state.t_opt.step(hessian=diags[1] if diags else None)
        _ema_update(state, ema_decay)
        # every rank computed them from the same global tensors; rank 0's
        # bits make them equal whatever the kernels' summation order
        state.ema_t = dist.broadcast_(ntm.ema_t)
        dist.broadcast_(new_contrast.queue)
        dist.broadcast_(new_contrast.ptr)
        state.contrast = new_contrast
        state.step += 1
        return metrics

    return step


def make_eval_step() -> Callable:
    """``step(model, batch) -> logits (B, N, C)``: the eval-mode forward of
    ``batch``'s ``pos, x, cls`` (``steps.py:426``)."""

    @torch.no_grad()
    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        return _logits_of(model(batch))

    return step


def make_confusion_step(num_classes: int) -> Callable:
    """``step(model, batch) -> (C, C)`` hard-label confusion counts, rows
    the label and columns the prediction (``steps.py:435``), float32 as
    there; ``engine.train.cal_confusion`` sums and row-normalises them."""

    @torch.no_grad()
    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        pred = _logits_of(model(batch)).argmax(dim=-1).reshape(-1)
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
        probs = torch.softmax(_logits_of(model(batch)).float(), dim=-1)
        C = probs.shape[-1]
        onehot = F.one_hot(batch["y"].reshape(-1).long(), C).float()
        return onehot.T @ probs.reshape(-1, C), onehot.sum(dim=0)

    return step
