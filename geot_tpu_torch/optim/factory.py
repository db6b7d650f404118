"""AdamW with the reference's weight-decay filter, and the epoch-indexed
learning-rate schedules (``geot_tpu/optim/factory.py:22, 86, 228-398``).

``torch.optim.AdamW`` decays ``p`` by ``lr * wd * p`` before the Adam step;
optax's ``adamw`` adds ``wd * p`` to the Adam update before the learning
rate scales it. Both move ``p`` by ``-lr * (adam + wd * p)``.
"""
from __future__ import annotations

import bisect
import math
from typing import Any, Callable, Dict, Iterable

import torch


def _decay_groups(named_params: Iterable, weight_decay: float):
    """Two param groups: rank >= 2 tensors decay, the rest (biases, norm
    scales, sigma) do not (``_decay_mask``, ``factory.py:22``)."""
    decay, no_decay = [], []
    for _, p in named_params:
        if p.requires_grad:
            (decay if p.dim() >= 2 else no_decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def build_optimizer_from_cfg(module: torch.nn.Module, lr: float,
                             NAME: str = "adamw", weight_decay: float = 1e-4,
                             betas=(0.9, 0.999), eps: float = 1e-8,
                             **kwargs) -> torch.optim.Optimizer:
    """``cfg.optimizer`` -> AdamW over ``module``'s parameters with the
    reference's decay filter. Only ``adamw`` with the filter is ported."""
    if NAME.lower() != "adamw" or not kwargs.get("filter_bias_and_bn", True):
        raise NotImplementedError(f"optimizer {NAME!r} {kwargs} is not "
                                  f"ported; ported: adamw")
    groups = _decay_groups(module.named_parameters(), weight_decay)
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps)


class PlateauSchedule:
    """ReduceLROnPlateau (``factory.py:228-298``): the lr drops by
    ``decay_rate`` (not below ``min_lr``) when the metric that the trainer
    feeds after each validation (``note_metric``) has not improved by the
    relative ``threshold`` for more than ``patience_t`` validations in a
    row, then waits ``cooldown_t`` validations; linear warmup first.
    ``schedule(epoch)`` returns the lr, as the other schedules do, and
    ``state_dict`` / ``load_state_dict`` carry what it has learned."""

    def __init__(self, lr: float, decay_rate: float = 0.1,
                 patience_t: int = 10, threshold: float = 1e-4,
                 cooldown_t: int = 0, warmup_epochs: int = 0,
                 warmup_lr: float = 1e-6, min_lr: float = 0.0,
                 mode: str = "max"):
        self.base_lr = float(lr)
        self.decay_rate = float(decay_rate)
        self.patience = int(patience_t)
        self.threshold = float(threshold)
        self.cooldown_t = int(cooldown_t)
        self.warmup_epochs = int(warmup_epochs)
        self.warmup_lr = float(warmup_lr)
        self.min_lr = float(min_lr)
        self.mode = mode
        self.cur = float(lr)
        self.best = None
        self.bad = 0
        self.cooldown = 0

    def _is_better(self, metric: float) -> bool:
        # torch ReduceLROnPlateau's relative threshold
        if self.mode == "max":
            return (metric > self.best * (1.0 + self.threshold)
                    if self.best > 0 else metric > self.best + self.threshold)
        return (metric < self.best * (1.0 - self.threshold)
                if self.best > 0 else metric < self.best - self.threshold)

    def note_metric(self, metric: float) -> None:
        metric = float(metric)
        if self.best is None or self._is_better(metric):
            self.best = metric
            self.bad = 0
            return
        if self.cooldown > 0:
            self.cooldown -= 1
            return
        self.bad += 1
        if self.bad > self.patience:
            self.cur = max(self.cur * self.decay_rate, self.min_lr)
            self.bad = 0
            self.cooldown = self.cooldown_t

    def __call__(self, epoch: int) -> float:
        t = max(int(epoch) - 1, 0)
        if self.warmup_epochs > 0 and t < self.warmup_epochs:
            return self.warmup_lr + (self.base_lr - self.warmup_lr) \
                * t / self.warmup_epochs
        return self.cur

    def state_dict(self) -> Dict[str, Any]:
        return {"cur": self.cur, "best": self.best, "bad": self.bad,
                "cooldown": self.cooldown}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.cur, self.best = sd["cur"], sd["best"]
        self.bad, self.cooldown = sd["bad"], sd["cooldown"]


def build_scheduler_from_cfg(cfg: Dict[str, Any]
                             ) -> "Callable[[int], float] | PlateauSchedule":
    """Epoch (1-based) -> lr (``factory.py:301-396``) for ``cfg["sched"]``
    in ``multistep``, ``step``, ``cosine``, ``tanh``, ``poly``,
    ``plateau`` (a ``PlateauSchedule``) and ``none``, with
    ``warmup_epochs`` / ``warmup_lr``. Unset ``min_lr`` is ``lr / 1000``,
    unset ``decay_rate`` ``0.01 ** (1 / epochs)`` (``step``), ``t_max``
    defaults to ``epochs``. The lr of epoch e is the timm schedule's at
    ``t = e - 1``: the reference steps its scheduler with the 0-based
    epoch after the previous one."""
    sched = cfg.get("sched", "multistep")
    lr = float(cfg.get("lr", 1e-3))
    epochs = int(cfg.get("epochs", 300))
    min_lr = float(cfg["min_lr"]) if cfg.get("min_lr") else lr / 1000.0
    default_rate = 0.01 ** (1.0 / max(epochs, 1))
    t_max = int(cfg.get("t_max") or epochs)
    warmup_epochs = int(cfg.get("warmup_epochs", 0) or 0)
    warmup_lr = cfg.get("warmup_lr", 1e-6)
    warmup_lr = 1e-6 if warmup_lr is None else float(warmup_lr)

    def with_warmup(base: Callable[[int], float]) -> Callable[[int], float]:
        def schedule(epoch: int) -> float:
            t = max(int(epoch) - 1, 0)
            if warmup_epochs > 0 and t < warmup_epochs:
                return warmup_lr + t * (lr - warmup_lr) / warmup_epochs
            return base(t)
        return schedule

    if sched == "multistep":
        decay_epochs = sorted(cfg.get("decay_epochs", [220]))
        rate = float(cfg.get("decay_rate") or 0.1)

        def base(t):
            # timm multistep_lr.py:46: bisect_right(decay_t, t + 1)
            return lr * rate ** bisect.bisect_right(decay_epochs, t + 1)
    elif sched == "step":
        every = cfg.get("decay_epochs", 30)
        every = int(every[0] if isinstance(every, (list, tuple)) else every)
        rate = float(cfg.get("decay_rate") or default_rate)

        def base(t):
            return lr * rate ** (t // max(every, 1))
    elif sched == "cosine":
        def base(t):
            if t >= t_max:                  # past the one cycle
                return min_lr
            return min_lr + 0.5 * (lr - min_lr) * (
                1 + math.cos(math.pi * t / t_max))
    elif sched == "tanh":
        lb, ub = -7.0, 3.0                  # timm tanh_lr.py:27-28

        def base(t):
            if t >= epochs:
                return min_lr
            tr = t / epochs
            return min_lr + 0.5 * (lr - min_lr) * (
                1 - math.tanh(lb * (1.0 - tr) + ub * tr))
    elif sched == "poly":
        power = float(cfg.get("decay_rate") or 0.9)

        def base(t):
            if t >= epochs:
                return min_lr
            return min_lr + (lr - min_lr) * (1 - t / epochs) ** power
    elif sched == "plateau":
        return PlateauSchedule(
            lr, decay_rate=float(cfg.get("decay_rate", 0.1)),
            patience_t=int(cfg.get("patience_epochs", 10)),
            threshold=float(cfg.get("plateau_threshold", 1e-4)),
            cooldown_t=int(cfg.get("cooldown_epochs", 0) or 0),
            warmup_epochs=warmup_epochs, warmup_lr=warmup_lr, min_lr=min_lr,
            mode=cfg.get("plateau_mode", "max"))
    elif sched in ("none", None):
        return lambda epoch: lr
    else:
        raise ValueError(f"unknown scheduler {sched}")
    return with_warmup(base)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the scheduled lr into every param group (``factory.py:398``)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
