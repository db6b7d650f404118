"""Seeding (``geot_tpu/core/random.py:11``): Python's, numpy's and torch's
global generators. The port's own randomness (weights, dropout masks, data)
comes from explicit generators; this covers whatever draws from the
globals."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int = 0) -> int:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
