"""Part segmentation (``task: partseg``; ``geot_tpu/engine/partseg.py``):
any ``BasePartSeg`` or ``PointMLPPartSegmentor`` on ShapeNetPart through
the supervised loop of ``engine.taskloop``, trained on ``trainval`` by
default.

The protocol: each shape's mean part IoU (``get_ins_mious``), averaged
over the split (``ins_miou``) and per category, then over the categories
(``cls_miou``); the best checkpoint by ``ins_miou``.
``eval_category_mask: True`` restricts the argmax to the parts of the
shape's category; ``eval_refine: True`` revotes badly labelled points
(``part_seg_refinement``). A ``multihead`` dataset (labels numbered within
the category) turns both off.

    python -m geot_tpu_torch.engine.train --cfg cfgs/shapenetpart/pointnet2part.yaml
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..data.build import to_device
from ..data.shapenetpart import SHAPENETPART_CLS2PARTS
from .partseg_eval import get_ins_mious, part_seg_refinement

KEYS = ("pos", "x", "cls", "y")


def _part_mask(num_parts: int = 50) -> np.ndarray:
    """(16, num_parts) float32: 0 at each category's parts, -inf
    elsewhere."""
    m = np.full((len(SHAPENETPART_CLS2PARTS), num_parts), -np.inf,
                np.float32)
    for c, parts in enumerate(SHAPENETPART_CLS2PARTS):
        m[c, parts] = 0.0
    return m


def _batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The step's tensors of a collated batch (``pos``, ``x``, ``cls``,
    ``y`` where present); a ragged batch (clouds shorter than
    ``num_points``) raises ``ValueError``."""
    if isinstance(batch.get("pos"), list):
        raise ValueError(
            "ragged part-seg batch (clouds shorter than num_points): set "
            "dataset presample: True or lower num_points for fixed shapes")
    return to_device(batch, [k for k in KEYS if k in batch], device)


def _cls_of(batch: Dict[str, Any]) -> np.ndarray:
    """The shape categories (B,): ``cls``, else the argmax of the h5
    variant's per-point category one-hot features."""
    if "cls" in batch:
        return np.asarray(batch["cls"]).reshape(-1)
    return np.asarray(batch["x"])[:, 0, :16].argmax(-1)


def _multihead(cfg) -> bool:
    """``multihead`` of the validation split's dataset config (``common``
    merged with the split's own keys, as the loader merges them)."""
    ds = cfg.get("dataset") or {}
    if not ds:
        return False
    merged = dict(ds.get("common", {}))
    merged.update(dict(ds.get(ds.get("val_split", "test"), {}) or {}))
    return bool(merged.get("multihead", False))


def evaluate(eval_step, model, loader, cfg, device="cuda"
             ) -> Dict[str, Any]:
    """``ins_miou``, ``cls_miou`` and ``per_category`` ({category: mean
    shape IoU}) of ``model`` over ``loader``, in percent. Every batch's
    forward, mask and argmax are issued before the first fetch."""
    multihead = _multihead(cfg)
    category_mask = bool(cfg.get("eval_category_mask", False))
    refine = bool(cfg.get("eval_refine", False))
    if multihead:
        # labels numbered within the category: the global part ids of the
        # mask and the refinement do not apply
        category_mask = refine = False
    mask = torch.from_numpy(_part_mask(int(cfg.get("num_classes",
                                                   50)))).to(device)
    pending = []
    for batch in loader:
        dev = _batch(batch, device)
        cls_h = _cls_of(batch)
        logits = eval_step(model, dev)
        if category_mask:
            logits = logits + mask[torch.from_numpy(cls_h).to(
                device)][:, None, :].to(logits.dtype)
        pending.append((logits.argmax(dim=-1).to(torch.int32), cls_h,
                        np.asarray(batch["y"]), dev["pos"]))
    ins_mious, cats = [], []
    for pred, cls_h, y_h, pos in pending:
        p = pred.cpu().numpy()
        if refine:
            p = part_seg_refinement(p, pos, cls_h, SHAPENETPART_CLS2PARTS)
        ins_mious.extend(get_ins_mious(p, y_h, cls_h, SHAPENETPART_CLS2PARTS,
                                       multihead=multihead))
        cats.extend(cls_h.tolist())
    cats = np.asarray(cats)
    per_cat = {int(c): float(np.mean([m for m, cc in zip(ins_mious, cats)
                                      if cc == c]))
               for c in sorted(set(cats.tolist()))}
    return {"ins_miou": float(np.mean(ins_mious)),
            "cls_miou": float(np.mean(list(per_cat.values()))),
            "per_category": per_cat}


def main(cfg, device: "str | torch.device" = "cuda"):
    from .taskloop import run
    return run(cfg, task="partseg", batch_fn=_batch, evaluate_fn=evaluate,
               primary="ins_miou", metric_names=("ins_miou", "cls_miou"),
               default_train_split="trainval", device=device)
