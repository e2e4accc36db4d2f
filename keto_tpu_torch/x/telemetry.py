"""Sliding-window duration statistics: a copy of ``DurationStats``
(keto_tpu/x/telemetry.py:18-86). The streaming check pipeline records every
slice's service time here (and the BFS steps of every slice that ran the
fixpoint), and every reader — the slice controller, admission control
(``tail``, keto_tpu_torch/driver/admission.py), ``chip_smoke.py``'s stream
report, an operator — reads the same numbers. The reference's ``/metrics``
histogram mirror comes with the metrics (ROADMAP A6)."""

from __future__ import annotations

import collections
import threading


class DurationStats:
    """Thread-safe sliding-window duration recorder (milliseconds)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()  # guards: _window, _count
        self._window: collections.deque = collections.deque(maxlen=capacity)
        self._count = 0

    def observe(self, ms: float) -> None:
        with self._lock:
            self._window.append(float(ms))
            self._count += 1

    def reset(self) -> None:
        with self._lock:
            self._window.clear()
            self._count = 0

    def tail(self, n: int) -> tuple[list[float], int]:
        """``(last ≤n observations, total observation count)``: admission
        control reads the slice service times recorded since its previous
        tick (by count delta) without resetting the window other readers
        share."""
        with self._lock:
            count = self._count
            if n <= 0:
                return [], count
            vals = list(self._window)
            return (vals[-n:] if n < len(vals) else vals), count

    def snapshot(self) -> dict:
        """``{count, p50_ms, p99_ms, mean_ms, max_ms}`` over the window
        (zeros when nothing was observed)."""
        with self._lock:
            vals = sorted(self._window)
            count = self._count
        if not vals:
            return {"count": count, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0, "max_ms": 0.0}
        n = len(vals)
        return {
            "count": count,
            "p50_ms": round(vals[n // 2], 3),
            "p99_ms": round(vals[min(n - 1, int(n * 0.99))], 3),
            "mean_ms": round(sum(vals) / n, 3),
            "max_ms": round(vals[-1], 3),
        }
