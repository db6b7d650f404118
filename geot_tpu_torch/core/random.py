"""Seeding (``geot_tpu/core/random.py:11``): Python's, numpy's and torch's
global generators. The port's own randomness (weights, dropout masks, data)
comes from explicit generators; this covers whatever draws from the
globals. ``str2bool`` is argparse's boolean coercion (``:23``)."""
from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def set_random_seed(seed: int = 0, deterministic: bool = False) -> int:
    """Seed the global generators. ``deterministic`` also makes torch pick
    deterministic algorithms where it has them
    (``torch.use_deterministic_algorithms``, warning on an operation that
    has none) and cuDNN deterministic, unbenchmarked kernels; it sets
    ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) unless it is set, without
    which cuBLAS refuses deterministic mode. ``geot_tpu`` takes the flag
    and has nothing to set."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return seed


def str2bool(v):
    """``v`` as a bool: a bool as it is; ``yes/true/t/y/1`` and
    ``no/false/f/n/0`` in any case; anything else raises
    ``argparse.ArgumentTypeError``."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")
