"""The port's SLO engine (keto_tpu_torch/x/slo.py) against the reference's
(keto_tpu/x/slo.py) on the CPU: the same request counters, observed in the
same order under the same fake clock, give equal reports, scrape rows and
objective rows. Every comparison is exact (tolerance 0)."""

from __future__ import annotations

import types

import pytest

from keto_tpu.x import metrics as ref_metrics
from keto_tpu.x import slo as ref_slo
from keto_tpu_torch.x import metrics as port_metrics
from keto_tpu_torch.x import slo as port_slo


class Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


#: (seconds to advance, [(code, latency_s) ...], grpc codes) per step
STEPS = [
    (0.0, [("200", 0.01), ("403", 0.02)], ["OK"]),
    (2.0, [("200", 0.3), ("500", 0.05)], []),
    (30.0, [("429", 0.001)] * 5, ["INTERNAL", "OK"]),
    (400.0, [("200", 0.2), ("503", 1.5), ("504", 0.26)], ["UNAVAILABLE"]),
    (0.5, [("200", 0.01)], []),  # inside the sampling interval: cached
    (3500.0, [("200", 0.1)] * 3, ["DEADLINE_EXCEEDED"]),
]


def _run(metrics_mod, slo_mod, monkeypatch, objectives):
    clock = Clock()
    monkeypatch.setattr(slo_mod, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    m = metrics_mod.MetricsRegistry()
    req = m.counter("keto_http_requests_total", "r", ("role", "method", "route", "code"))
    lat = m.histogram("keto_http_request_duration_seconds", "l", ("role", "method", "route"))
    grpc = m.counter("keto_grpc_requests_total", "g", ("method", "code"))
    engine = slo_mod.SloEngine(m, **objectives)
    out = []
    for dt, reqs, codes in STEPS:
        clock.t += dt
        for code, s in reqs:
            req.inc(("read", "GET", "/check", code))
            lat.observe(("read", "GET", "/check"), s)
        for code in codes:
            grpc.inc(("CheckService/Check", code))
        out.append((engine.to_json(), engine.metric_rows("availability_burn_rate"),
                    engine.metric_rows("latency_ratio"), engine.objective_rows()))
    return out


@pytest.mark.parametrize("objectives", [
    {},
    {"availability_objective": 0.99, "latency_objective_ms": 100.0,
     "latency_objective_ratio": 0.9},
    {"latency_objective_ms": 10_000.0},
], ids=["defaults", "tight", "past-the-buckets"])
def test_reports_equal_the_reference_under_a_fake_clock(monkeypatch, objectives):
    want = _run(ref_metrics, ref_slo, monkeypatch, objectives)
    got = _run(port_metrics, port_slo, monkeypatch, objectives)
    assert got == want
    # the last report's windows start at their oldest in-window sample
    assert [w["covered_s"] for w in got[-1][0]["windows"]] == [0.0, 3500.5]


def test_an_idle_window_spends_no_budget():
    engine = port_slo.SloEngine(port_metrics.MetricsRegistry())
    rep = engine.to_json()
    for w in rep["windows"]:
        assert (w["requests"], w["availability_ratio"], w["availability_burn_rate"]) == (0, 1.0, 0.0)
    assert [r[0][0] for r in engine.objective_rows()] == [
        "availability", "latency_ratio", "latency_threshold_seconds"]
