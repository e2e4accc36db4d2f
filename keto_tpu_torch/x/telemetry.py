"""Stat sinks: copies of ``DurationStats``, ``MaintenanceStats`` and the
per-route ``Telemetry`` counter (keto_tpu/x/telemetry.py).

The streaming check pipeline records every slice's service time in a
``DurationStats`` (and the BFS steps of every slice that ran the fixpoint),
and every reader — the slice controller, admission control (``tail``,
keto_tpu_torch/driver/admission.py), ``chip_smoke.py``'s stream report, the
``/metrics`` histogram it mirrors into — reads the same numbers. The check
engine counts every snapshot-lifecycle event into its ``MaintenanceStats``
(counters, gauges and durations, read by ``/metrics`` and ``counters()``).
Both REST ports count every non-health request into the registry's
``Telemetry`` by ``"<role> <method> <route>"`` when ``telemetry.enabled``
is on; ``Registry.telemetry().snapshot()`` reads it."""

from __future__ import annotations

import collections
import threading


class DurationStats:
    """Thread-safe sliding-window duration recorder (milliseconds)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()  # guards: _window, _count
        self._window: collections.deque = collections.deque(maxlen=capacity)
        self._count = 0
        # the /metrics bridge: a histogram (keto_tpu_torch/x/metrics.py)
        # mirroring every observation in seconds
        self._mirror = None

    def attach_histogram(self, histogram) -> None:
        """Mirror observations into ``histogram`` (anything with
        ``observe(labels, seconds)``) from now on."""
        self._mirror = histogram

    def observe(self, ms: float) -> None:
        with self._lock:
            self._window.append(float(ms))
            self._count += 1
        mirror = self._mirror
        if mirror is not None:
            mirror.observe((), ms / 1e3)

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


class MaintenanceStats:
    """Counters + gauges for incremental snapshot maintenance.

    The check engine records every snapshot-lifecycle event here
    (keto_tpu_torch/check/gpu_engine.py): delta applies, overlay occupancy
    against the configured budget, compactions vs full rebuilds and their
    durations, and snapshot-cache saves/reloads — so operators can see
    overlay budget pressure BEFORE it forces an expensive rebuild."""

    def __init__(self):
        self._lock = threading.Lock()  # guards: _counters, _gauges, _durations
        self._counters: collections.Counter = collections.Counter()
        self._gauges: dict[str, float] = {}
        self._durations: dict[str, dict] = {}

    def incr(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] += by

    def set_gauge(self, key: str, value) -> None:
        with self._lock:
            self._gauges[key] = value

    def observe_ms(self, key: str, ms: float) -> None:
        with self._lock:
            d = self._durations.setdefault(key, {"count": 0, "total_ms": 0.0, "last_ms": 0.0})
            d["count"] += 1
            d["total_ms"] += float(ms)
            d["last_ms"] = float(ms)

    def snapshot(self) -> dict:
        """One flat dict: counters, gauges, and per-key duration stats
        (``<key>_count/_total_ms/_last_ms``)."""
        with self._lock:
            out: dict = dict(self._counters)
            out.update(self._gauges)
            for key, d in self._durations.items():
                out[f"{key}_count"] = d["count"]
                out[f"{key}_total_ms"] = round(d["total_ms"], 3)
                out[f"{key}_last_ms"] = round(d["last_ms"], 3)
            return out

    def raw(self) -> tuple[dict, dict, dict]:
        """``(counters, gauges, durations)`` as separate copies — the
        /metrics bridge needs them typed (counter vs gauge vs duration
        pair), which the flat ``snapshot`` view erases."""
        with self._lock:
            return (
                dict(self._counters),
                dict(self._gauges),
                {k: dict(v) for k, v in self._durations.items()},
            )


class Telemetry:
    """Per-route request counters.

    ``max_routes`` bounds label cardinality at the sink itself: the
    serving layers already normalize unknown paths to ``other``
    (keto_tpu_torch/x/metrics.normalize_route), but ANY caller recording
    unbounded strings here (a future surface, a bug) folds into
    ``other`` past the cap instead of growing the counter map without
    bound under a path-scanning client."""

    OVERFLOW_ROUTE = "other"

    def __init__(self, enabled: bool = False, max_routes: int = 256):
        self.enabled = enabled
        self._max_routes = max_routes
        self._lock = threading.Lock()  # guards: _counts
        self._counts: collections.Counter = collections.Counter()

    def record(self, route: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            if route not in self._counts and len(self._counts) >= self._max_routes:
                route = self.OVERFLOW_ROUTE
            self._counts[route] += 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)
