"""ShapeNetPart's evaluation helpers (``geot_tpu/engine/partseg_eval.py:
15-72``): ``batched_bincount``, ``part_seg_refinement`` (a vote of each
badly labelled point's 11 nearest neighbours) and ``get_ins_mious`` (each
shape's mean part IoU). The votes and the IoUs are counted on the host,
as there; the neighbour search is ``ops.knn`` on the device of ``pos``."""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from ..ops import knn


def batched_bincount(x: np.ndarray, max_value: int) -> np.ndarray:
    """(B, K) int -> (B, max_value) counts."""
    out = np.zeros((x.shape[0], max_value), dtype=np.int64)
    for i, row in enumerate(np.asarray(x)):
        out[i] = np.bincount(row, minlength=max_value)[:max_value]
    return out


def part_seg_refinement(pred: np.ndarray, pos, cls: np.ndarray,
                        cls2parts: Sequence[Sequence[int]], n: int = 10
                        ) -> np.ndarray:
    """Relabel the points of every part that is not one of the shape's
    category or has fewer than ``n`` points by the majority of their
    ``n + 1`` nearest points' labels, that part left out (a shape with one
    label keeps it). ``pred`` (B, N) and ``cls`` on the host; ``pos`` (B,
    N, 3), an array (searched on the CPU) or a tensor (searched on its
    device). Returns the refined (B, N) labels."""
    pred = np.asarray(pred).copy()
    pos = (pos if isinstance(pos, torch.Tensor)
           else torch.from_numpy(np.ascontiguousarray(pos)))
    max_part = cls2parts[-1][-1] + 1
    for b in range(pred.shape[0]):
        parts = set(cls2parts[int(np.asarray(cls[b]).reshape(-1)[0])])
        counts = Counter(pred[b].tolist())
        if len(counts) <= 1:
            continue
        for part_id, cnt in list(counts.items()):
            if cnt < n or part_id not in parts:
                bad = np.where(pred[b] == part_id)[0]
                rows = torch.from_numpy(bad).to(pos.device)
                _, idx = knn(pos[b][rows][None], pos[b][None], n + 1)
                neigh = pred[b][idx[0].cpu().numpy()]         # (bad, n+1)
                hist = batched_bincount(neigh, max_part)
                hist[:, part_id] = 0
                pred[b][bad] = hist.argmax(axis=1)
    return pred


def get_ins_mious(pred, target, cls, cls2parts,
                  multihead: bool = False) -> List[float]:
    """Each shape's mean IoU over its category's parts, in percent (100
    for a part in neither prediction nor label); with ``multihead`` the
    parts are numbered 0.. within the category."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    ins_mious = []
    for b in range(pred.shape[0]):
        parts = cls2parts[int(np.asarray(cls[b]).reshape(-1)[0])]
        if multihead:
            parts = list(range(len(parts)))
        part_ious = []
        for part in parts:
            p = pred[b] == part
            t = target[b] == part
            union = np.logical_or(p, t).sum()
            if union == 0:
                part_ious.append(100.0)
            else:
                part_ious.append(np.logical_and(p, t).sum() * 100.0 / union)
        ins_mious.append(float(np.mean(part_ious)))
    return ins_mious
