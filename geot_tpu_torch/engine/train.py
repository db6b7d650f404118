"""Pieces of the training entry point (``geot_tpu/engine/train.py``).

``cal_mean_feature`` is the bootstrap of the class-mean softmax matrix
``cm`` that runs before the first semi step (``train.py:114``). The epoch
loop, validation and checkpoints are not ported yet; a caller drives the
step as ``geot_tpu/engine/train.py:334-522`` does:

    state = SemiTrainState.create(cfg, device="cuda")
    loader_l, loader_u = build_semi_loaders(cfg)
    state.cm = cal_mean_feature(make_cm_step(), state.model, loader_l,
                                cfg["num_classes"], "cuda")
    step = make_semi_step(cfg)
    for batch_l, batch_u in semi_pairs(loader_l, loader_u):
        metrics = step(state, to_device(batch_l, MODEL_KEYS, "cuda"),
                       to_device(batch_u, SEMI_KEYS, "cuda"), lr,
                       use_teacher)
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..data.build import MODEL_KEYS, to_device


def cal_mean_feature(cm_step: Callable, model: torch.nn.Module,
                     loader: Iterable, num_classes: int,
                     device: "str | torch.device") -> torch.Tensor:
    """Class-conditional mean of the model's softmax over ``loader``: row c
    is the mean softmax of the points labelled c (``geot_tpu``'s fix of the
    reference's row-indexing bug). Sums accumulate in float64 on the host;
    returns (C, C) float32 on ``device``."""
    total = np.zeros((num_classes, num_classes), dtype=np.float64)
    counts = np.zeros((num_classes,), dtype=np.float64)
    for batch in loader:
        sums, cnts = cm_step(model, to_device(batch, MODEL_KEYS, device))
        total += sums.double().cpu().numpy()
        counts += cnts.double().cpu().numpy()
    cm = total / np.maximum(counts[:, None], 1.0)
    return torch.from_numpy(cm.astype(np.float32)).to(device)
