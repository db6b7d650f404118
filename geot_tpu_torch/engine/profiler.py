"""Host-side step latencies (``geot_tpu/engine/profiler.py:33``): one
``{"step", "dt", "ts", ...}`` JSON line per step after the first in
``step_times.jsonl``. ``dt`` is the host time between two ticks; the loop
does not synchronise with the device per step, so it measures dispatch
unless the host waits on the card."""
from __future__ import annotations

import json
import time
from typing import List, Optional


class StepTimer:
    """``tick`` per step; ``mean`` is the mean of the last ``window``
    intervals (0 before the second tick)."""

    def __init__(self, log_path: Optional[str] = None, window: int = 50):
        self.log_path = log_path
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None
        self._f = open(log_path, "a", buffering=1) if log_path else None

    def tick(self, step: int, **extra):
        now = time.time()
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
            if self._f:
                self._f.write(json.dumps({"step": step, "dt": dt,
                                          "ts": now, **extra}) + "\n")
        self._last = now

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def close(self):
        if self._f:
            self._f.close()
