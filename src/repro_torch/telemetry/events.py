"""Step timing (port of ``RingTimer`` from ``repro/telemetry/events.py``).

The event log, metric registry and in-graph probes of the reference come
with the telemetry slice (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np


class RingTimer:
    """Ring-buffered wall-clock step timer (``perf_counter`` based).

    Keeps the last ``capacity`` durations; ``summary()`` reports count /
    mean / percentiles over the window, so a long run's statistics track
    recent behaviour instead of averaging over warmup."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf = collections.deque(maxlen=capacity)
        self._t0: Optional[float] = None
        self.total = 0       # durations ever recorded (not just in window)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("RingTimer.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.record(dt)
        return dt

    def record(self, seconds: float) -> None:
        self._buf.append(float(seconds))
        self.total += 1

    def __enter__(self) -> "RingTimer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __len__(self) -> int:
        return len(self._buf)

    def summary(self) -> Dict[str, float]:
        if not self._buf:
            return {"count": 0}
        arr = np.asarray(self._buf, dtype=np.float64)
        return {
            "count": int(arr.size),
            "total": int(self.total),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "max_s": float(arr.max()),
        }
