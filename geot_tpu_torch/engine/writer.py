"""Scalar logging (``geot_tpu/engine/writer.py:35``): one
``{"tag", "value", "step", "ts"}`` JSON line per scalar in
``<run_dir>/scalars.jsonl``, and TensorBoard event files under
``<run_dir>/tb`` when ``torch.utils.tensorboard`` imports."""
from __future__ import annotations

import json
import os
import time


def _make_tb(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter as TBWriter
    except ImportError:
        return None
    return TBWriter(log_dir=os.path.join(log_dir, "tb"))


class SummaryWriter:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                       buffering=1)
        self._tb = _make_tb(log_dir) if tensorboard else None

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()})
                      + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
