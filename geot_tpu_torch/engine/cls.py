"""Point-cloud classification (``task: cls``; ``geot_tpu/engine/cls.py``):
any ``BaseCls`` / ``DistillCls`` composition on ScanObjectNN through the
supervised loop of ``engine.taskloop``.

The protocol: overall accuracy (OA) and mean per-class accuracy (mAcc) in
percent over the validation split; the best checkpoint by OA.

    python -m geot_tpu_torch.engine.train --cfg cfgs/scanobjectnn/pointnet2cls.yaml
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..data.build import to_device

KEYS = ("pos", "x", "y")


def _batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The step's tensors of a collated batch: ``pos``, ``x``, ``y``."""
    return to_device(batch, [k for k in KEYS if k in batch], device)


def evaluate(eval_step, model, loader, cfg, device="cuda"
             ) -> Dict[str, float]:
    """OA and mAcc (percent) of ``model`` over ``loader``: every batch's
    forward and argmax are issued before the first fetch, so the card
    never waits for the host's counting."""
    num_classes = int(cfg.get("num_classes", 15))
    pending = []
    for batch in loader:
        logits = eval_step(model, _batch(batch, device))
        pending.append((logits.argmax(dim=-1), np.asarray(batch["y"])))
    correct = np.zeros(num_classes, np.int64)
    seen = np.zeros(num_classes, np.int64)
    for pred, y in pending:
        p = pred.cpu().numpy().reshape(-1)
        y = y.reshape(-1)
        np.add.at(seen, y, 1)
        np.add.at(correct, y[p == y], 1)
    oa = float(correct.sum()) / max(int(seen.sum()), 1)
    present = seen > 0
    macc = (float(np.mean(correct[present] / seen[present]))
            if present.any() else 0.0)
    return {"oa": 100.0 * oa, "macc": 100.0 * macc}


def main(cfg, device: "str | torch.device" = "cuda"):
    from .taskloop import run
    return run(cfg, task="cls", batch_fn=_batch, evaluate_fn=evaluate,
               primary="oa", metric_names=("oa", "macc"), device=device)
