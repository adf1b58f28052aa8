"""Latency and throughput instrumentation — port of the JAX package's
``utils/timing.py``.

Every micro-batch is timed: a bounded reservoir keeps the recent window,
and percentiles come from the exact sorted sample.
"""

from __future__ import annotations

import datetime as _dt
import time
from typing import Dict

import numpy as np


def date_to_epoch_s(date: str) -> int:
    """ISO date string → seconds since the unix epoch (UTC midnight)."""
    d = _dt.date.fromisoformat(date)
    return int((d - _dt.date(1970, 1, 1)).days) * 86400


class LatencyTracker:
    """Sliding-window latency stats (p50/p90/p99/max) + counters."""

    def __init__(self, window: int = 4096):
        self._buf = np.zeros(window, dtype=np.float64)
        self._n = 0
        self._rows = 0
        self._t_start = time.perf_counter()

    def record(self, seconds: float, rows: int = 0) -> None:
        self._buf[self._n % len(self._buf)] = seconds
        self._n += 1
        self._rows += rows

    def snapshot(self) -> Dict[str, float]:
        k = min(self._n, len(self._buf))
        wall = time.perf_counter() - self._t_start
        if k == 0:
            return {"count": 0, "rows": 0, "wall_s": wall}
        window = np.sort(self._buf[:k])
        return {
            "count": self._n,
            "rows": self._rows,
            "wall_s": wall,
            "rows_per_s": self._rows / wall if wall > 0 else 0.0,
            "p50_ms": float(np.percentile(window, 50) * 1e3),
            "p90_ms": float(np.percentile(window, 90) * 1e3),
            "p99_ms": float(np.percentile(window, 99) * 1e3),
            "max_ms": float(window[-1] * 1e3),
        }
