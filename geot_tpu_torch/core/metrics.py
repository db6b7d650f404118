"""The metric helpers the training loop uses
(``geot_tpu/core/metrics.py:9, 193``)."""
from __future__ import annotations

import torch


class AverageMeter:
    """Running average (``geot_tpu/core/metrics.py:9``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def cal_model_parm_nums(module: torch.nn.Module) -> int:
    """Number of parameter elements of a module
    (``geot_tpu/core/metrics.py:193``)."""
    return sum(p.numel() for p in module.parameters())
