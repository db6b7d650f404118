"""Host-side step latencies (``geot_tpu/engine/profiler.py:33``): one
``{"step", "dt", "ts", ...}`` JSON line per step after the first in
``step_times.jsonl``. ``dt`` is the host time between two ticks; the loop
does not synchronise with the device per step, so it measures dispatch
unless the host waits on the card."""
from __future__ import annotations

import json
import time
from typing import Optional


class StepTimer:
    def __init__(self, log_path: Optional[str] = None):
        self._last: Optional[float] = None
        self._f = open(log_path, "a", buffering=1) if log_path else None

    def tick(self, step: int, **extra):
        now = time.time()
        if self._last is not None and self._f:
            self._f.write(json.dumps({"step": step, "dt": now - self._last,
                                      "ts": now, **extra}) + "\n")
        self._last = now

    def close(self):
        if self._f:
            self._f.close()
