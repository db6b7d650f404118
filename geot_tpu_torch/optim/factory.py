"""AdamW with the reference's weight-decay filter and the epoch-indexed
multistep schedule (``geot_tpu/optim/factory.py:22, 86, 338-350, 398``).

``torch.optim.AdamW`` decays ``p`` by ``lr * wd * p`` before the Adam step;
optax's ``adamw`` adds ``wd * p`` to the Adam update before the learning
rate scales it. Both move ``p`` by ``-lr * (adam + wd * p)``.
"""
from __future__ import annotations

import bisect
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


def build_scheduler_from_cfg(cfg: Dict[str, Any]) -> Callable[[int], float]:
    """Epoch (1-based) -> lr for ``sched: multistep``
    (``factory.py:338-350``): the lr of epoch e is
    ``lr * rate ** bisect_right(decay_epochs, e)``. Warmup is not ported
    (the flagship has none)."""
    sched = cfg.get("sched", "multistep")
    if sched != "multistep" or int(cfg.get("warmup_epochs", 0) or 0):
        raise NotImplementedError(f"scheduler {sched!r} with warmup "
                                  f"{cfg.get('warmup_epochs')} is not "
                                  f"ported; ported: multistep")
    lr = float(cfg.get("lr", 1e-3))
    decay_epochs = sorted(cfg.get("decay_epochs", [220]))
    rate = float(cfg.get("decay_rate") or 0.1)

    def schedule(epoch: int) -> float:
        t = max(int(epoch) - 1, 0)
        return lr * rate ** bisect.bisect_right(decay_epochs, t + 1)

    return schedule


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the scheduled lr into every param group (``factory.py:398``)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
