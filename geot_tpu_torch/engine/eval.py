"""Full-resolution prediction (``geot_tpu/engine/eval.py:26-71``): softmax
the logits of the sample, then 3-NN + inverse-distance interpolate them to
every point of the raw scan and take the argmax."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import three_nn


def pad_to_bucket(points: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad (P, 3) points to the next multiple of ``bucket``."""
    P = len(points)
    padded = np.zeros((-(-P // bucket) * bucket, 3), dtype=np.float32)
    padded[:P] = points
    return padded


def _upsample_pred(probs: torch.Tensor, pos: torch.Tensor,
                   full_points: torch.Tensor, center: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """probs (N, C) softmax; pos (N, 3) normalised sample; full (P, 3) raw.
    Returns argmax predictions (P,) on the full scan."""
    pos_world = pos * scale + center
    dist, idx = three_nn(full_points[None], pos_world[None])
    dist, idx = dist[0], idx[0].long()
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=1, keepdim=True)
    logit_whole = (probs[idx] * weight[..., None]).sum(dim=1)
    return logit_whole.argmax(dim=-1)


# full scans are zero-padded to a multiple of this many points
BUCKET = 8192


@torch.no_grad()
def get_pred_whole(logits: torch.Tensor, pos: torch.Tensor, full_points_list,
                   centers, scales) -> List[np.ndarray]:
    """Per-sample full-resolution class ids (uint8: 17 classes fit a byte,
    and the copy to the host is 8x smaller than int64), computed on the
    device of ``logits``.

    logits (B, N, C) raw; pos (B, N, 3); full_points_list: list of (P_i, 3)
    numpy arrays."""
    device = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    preds = []
    for i, full in enumerate(full_points_list):
        full = np.asarray(full, dtype=np.float32)
        padded = torch.from_numpy(pad_to_bucket(full, BUCKET)).to(device)
        center = torch.from_numpy(
            np.asarray(centers[i], dtype=np.float32)).to(device)
        scale = torch.tensor(np.float32(scales[i]), device=device)
        pred = _upsample_pred(probs[i], pos[i], padded, center, scale)
        preds.append(pred.to(torch.uint8).cpu().numpy()[:len(full)])
    return preds
