"""SLO engine: availability and latency burn rates over the live metrics: a copy of
keto_tpu/x/slo.py.

Dashboards built on raw counters answer "what is the error rate right
now"; an on-call rotation needs "how fast are we spending this month's
error budget, and over which horizon" — the multi-window burn-rate
framing (the SRE-workbook alerting policy). This module computes it
in-process, from the SAME instrument families the Prometheus exposition
renders, so ``GET /slo`` and an external Prometheus agree by
construction:

- **availability**: the fraction of REST + gRPC requests that did not
  fail server-side (REST 5xx; gRPC INTERNAL / UNAVAILABLE /
  DEADLINE_EXCEEDED / UNKNOWN), judged against
  ``serve.slo_availability_objective``;
- **latency**: the fraction of REST requests answered within
  ``serve.slo_latency_objective_ms`` (quantized UP to the histogram
  bucket edge at or above it — the report states the edge actually
  used), judged against ``serve.slo_latency_objective_ratio``.

A **burn rate** of 1.0 means the service is spending error budget
exactly at the rate that exhausts it at the objective horizon; 10 means
ten times too fast. Rates are computed over multiple trailing windows
(default 5m and 1h) from periodic counter samples, so a short spike and
a slow leak are distinguishable — the standard fast-burn/slow-burn
alert pair.

Sampling is lazy and cheap: the engine keeps a bounded ring of counter
snapshots, refreshed at most once per ``min_sample_interval_s`` when a
report (or ``keto_slo_*`` scrape callback) asks. Counters are read
through ``MetricsRegistry.family(...)`` — the live family objects — so
the scrape-time callbacks can never recurse into ``render``.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Optional

#: trailing windows the burn rates are computed over (seconds → label)
DEFAULT_WINDOWS = ((300.0, "5m"), (3600.0, "1h"))

#: gRPC status codes that count against availability (server-side
#: failure classes; client errors and policy sheds do not spend budget)
_GRPC_ERROR_CODES = frozenset(
    {"INTERNAL", "UNAVAILABLE", "DEADLINE_EXCEEDED", "UNKNOWN", "DATA_LOSS"}
)


def _is_http_error(code: str) -> bool:
    return code.startswith("5")


class SloEngine:
    def __init__(
        self,
        metrics,
        *,
        availability_objective: float = 0.999,
        latency_objective_ms: float = 250.0,
        latency_objective_ratio: float = 0.99,
        windows=DEFAULT_WINDOWS,
        min_sample_interval_s: float = 1.0,
    ):
        self._metrics = metrics
        self.availability_objective = min(
            0.999999, max(0.0, float(availability_objective))
        )
        self.latency_objective_ratio = min(
            0.999999, max(0.0, float(latency_objective_ratio))
        )
        self.latency_objective_ms = float(latency_objective_ms)
        self.windows = tuple(windows)
        self._interval = max(0.0, float(min_sample_interval_s))
        self._lock = threading.Lock()  # guards: _samples, _last_report
        horizon = max(w for w, _ in self.windows)
        # ring depth: one sample per interval across the longest window,
        # plus slack so the oldest in-window sample is always present
        # (sub-second test intervals share the 1 Hz ring bound)
        self._samples: deque[dict] = deque(
            maxlen=int(horizon / max(self._interval, 1.0)) + 8
        )
        self._last_report: Optional[dict] = None
        self._threshold_le: Optional[float] = None
        # zero baseline: until a window's worth of samples exists, the
        # window covers boot→now (counters start at zero at boot, so
        # the deltas are exact, just over a shorter horizon — reported
        # as covered_s)
        self._samples.append(
            {"t": time.monotonic(), "total": 0.0, "errors": 0.0,
             "lat_total": 0.0, "lat_good": 0.0}
        )

    # -- counter reads ---------------------------------------------------------

    def _latency_threshold_le(self, buckets) -> float:
        """The histogram bucket edge the latency objective quantizes UP
        to (reported, so the stated objective is the one enforced)."""
        if self._threshold_le is None:
            want = self.latency_objective_ms / 1e3
            i = bisect.bisect_left(list(buckets), want)
            self._threshold_le = (
                float(buckets[i]) if i < len(buckets) else float("inf")
            )
        return self._threshold_le

    def _read_counters(self) -> dict:
        """One cumulative snapshot of the SLI numerators/denominators."""
        total = errors = 0.0
        fam = self._metrics.family("keto_http_requests_total")
        if fam is not None:
            for _name, labelnames, labels, value, _ex in fam.samples():
                code = dict(zip(labelnames, labels)).get("code", "")
                total += value
                if _is_http_error(str(code)):
                    errors += value
        fam = self._metrics.family("keto_grpc_requests_total")
        if fam is not None:
            for _name, labelnames, labels, value, _ex in fam.samples():
                code = dict(zip(labelnames, labels)).get("code", "")
                total += value
                if str(code) in _GRPC_ERROR_CODES:
                    errors += value
        lat_total = lat_good = 0.0
        fam = self._metrics.family("keto_http_request_duration_seconds")
        if fam is not None:
            le_thr = self._latency_threshold_le(fam.buckets)
            for name, labelnames, labels, value, _ex in fam.samples():
                if not name.endswith("_bucket"):
                    continue
                le = dict(zip(labelnames, labels)).get("le", "")
                le_f = float("inf") if le == "+Inf" else float(le)
                if le_f == le_thr:
                    lat_good += value
            for name, labelnames, labels, value, _ex in fam.samples():
                if name.endswith("_count"):
                    lat_total += value
        return {
            "t": time.monotonic(),
            "total": total,
            "errors": errors,
            "lat_total": lat_total,
            "lat_good": lat_good,
        }

    def sample(self) -> None:
        """Record one counter snapshot if the sampling interval elapsed
        (lazy: driven by /slo queries and /metrics scrapes)."""
        now = time.monotonic()
        with self._lock:
            if self._samples and now - self._samples[-1]["t"] < self._interval:
                return
        snap = self._read_counters()
        with self._lock:
            if self._samples and snap["t"] - self._samples[-1]["t"] < self._interval:
                return
            self._samples.append(snap)

    # -- burn-rate math --------------------------------------------------------

    @staticmethod
    def _ratio(good: float, total: float) -> float:
        """Success ratio with the no-traffic convention: an idle window
        spends no budget, so it reports 1.0."""
        return 1.0 if total <= 0 else max(0.0, min(1.0, good / total))

    def _window_report(self, newest: dict, window_s: float, label: str) -> dict:
        with self._lock:
            samples = list(self._samples)
        cutoff = newest["t"] - window_s
        oldest = samples[0] if samples else newest
        for s in samples:
            if s["t"] >= cutoff:
                oldest = s
                break
        total = newest["total"] - oldest["total"]
        errors = newest["errors"] - oldest["errors"]
        lat_total = newest["lat_total"] - oldest["lat_total"]
        lat_good = newest["lat_good"] - oldest["lat_good"]
        avail_ratio = self._ratio(total - errors, total)
        lat_ratio = self._ratio(lat_good, lat_total)
        avail_budget = 1.0 - self.availability_objective
        lat_budget = 1.0 - self.latency_objective_ratio
        return {
            "window": label,
            "window_s": window_s,
            "covered_s": round(max(0.0, newest["t"] - oldest["t"]), 3),
            "requests": total,
            "errors": errors,
            "availability_ratio": round(avail_ratio, 6),
            "availability_burn_rate": round((1.0 - avail_ratio) / avail_budget, 4),
            "latency_requests": lat_total,
            "latency_ratio": round(lat_ratio, 6),
            "latency_burn_rate": round((1.0 - lat_ratio) / lat_budget, 4),
        }

    def report(self) -> dict:
        """The ``GET /slo`` body (also the per-scrape callback source,
        cached for one sampling interval)."""
        self.sample()
        with self._lock:
            cached = self._last_report
            newest = self._samples[-1] if self._samples else None
        if newest is None:
            newest = self._read_counters()
        if cached is not None and cached["_t"] == newest["t"]:
            return cached
        out = {
            "_t": newest["t"],
            "objectives": {
                "availability": self.availability_objective,
                "latency_ratio": self.latency_objective_ratio,
                "latency_threshold_ms": self.latency_objective_ms,
                "latency_threshold_le_s": self._threshold_le,
            },
            "windows": [
                self._window_report(newest, w, label)
                for w, label in self.windows
            ],
        }
        with self._lock:
            self._last_report = out
        return out

    def to_json(self) -> dict:
        out = dict(self.report())
        out.pop("_t", None)
        return out

    # -- /metrics bridge -------------------------------------------------------

    def metric_rows(self, field: str):
        """``[((window,), value), ...]`` for one per-window field — what
        the ``keto_slo_*`` callback families yield at scrape time."""
        rep = self.report()
        return [
            ((w["window"],), float(w[field])) for w in rep["windows"]
        ]

    def objective_rows(self):
        return [
            (("availability",), self.availability_objective),
            (("latency_ratio",), self.latency_objective_ratio),
            (("latency_threshold_seconds",), self.latency_objective_ms / 1e3),
        ]


__all__ = ["SloEngine", "DEFAULT_WINDOWS"]
