"""The port's metrics registry (keto_tpu_torch/x/metrics.py) against the
reference's (keto_tpu/x/metrics.py) on the CPU.

The same observations, in the same order, go into both registries, and
``render()`` and ``render(openmetrics=True)`` must be byte-equal: labels
that need escaping, callback families, a broken callback, exemplars and the
null registry. ``parse_exposition`` must accept and reject the same texts
with the same message (the cases of tests/test_metrics.py:24-153). Every
comparison is exact (tolerance 0)."""

from __future__ import annotations

import types

import pytest

from keto_tpu.x import metrics as ref
from keto_tpu_torch.x import metrics as port

# -- the same observations into both registries ---------------------------------


def _basic(mod, m):
    c = m.counter("t_requests_total", "requests", ("route", "code"))
    c.inc(("/check", "200"))
    c.inc(("/check", "200"), by=2)
    c.inc(("/check", "403"))
    m.gauge("t_depth", "queue depth").set((), 7)
    h = m.histogram("t_latency_seconds", "latency", ("route",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(("/check",), v)


def _escaping(mod, m):
    c = m.counter("t_esc_total", 'help with \\ and\nnewline', ("v",))
    c.inc(('quote " backslash \\ newline \n end',))
    c.inc(("plain",), by=3)
    m.gauge("t_g", "g", ("a", "b")).set(('x"y', "z\\w"), -1.5)


def _exemplars(mod, m):
    h = m.histogram("t_lat_seconds", "lat", ("route",), buckets=(0.1, 1.0, 10.0))
    h.observe(("/a",), 0.05, trace_id="fast")
    h.observe(("/a",), 3.0, trace_id="slowest")
    h.observe(("/a",), 0.5, trace_id="mid")
    h.observe(("/b",), 0.01)
    h.observe(("/b",), 20.0, trace_id="b" * 32)
    d = m.histogram("t_default_seconds", "default buckets")
    for i in range(50):
        d.observe((), i * 0.013, trace_id=f"{i:032x}")


def _callbacks(mod, m):
    state = {"n": 41}
    m.register_callback("t_live_total", "counter", "live", lambda: [((), float(state["n"]))])
    m.register_callback("t_lanes", "gauge", "per lane",
                        lambda: [(("interactive",), 2.0), (("batch",), 1e9)], ("lane",))

    def boom():
        raise RuntimeError("stat source died")

    m.register_callback("t_broken_total", "counter", "broken", boom)
    m.counter("t_ok_total", "fine").inc(())


def _values(mod, m):
    g = m.gauge("t_values", "formatting", ("k",))
    for k, v in (("int", 3), ("float", 0.1), ("neg", -2.25), ("big", 1.5e12),
                 ("tiny", 1e-9), ("inf", float("inf")), ("ninf", float("-inf"))):
        g.set((k,), v)


SCENARIOS = {"basic": _basic, "escaping": _escaping, "exemplars": _exemplars,
             "callbacks": _callbacks, "values": _values}


@pytest.mark.parametrize("openmetrics", [False, True], ids=["prometheus", "openmetrics"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_render_is_byte_equal_to_the_reference(name, openmetrics, monkeypatch):
    out = []
    for mod in (ref, port):
        # an exemplar carries the wall clock of its observation: one fixed
        # clock for both registries
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.125))
        m = mod.MetricsRegistry()
        SCENARIOS[name](mod, m)
        out.append(m.render(openmetrics=openmetrics))
    assert out[1] == out[0]
    # and the port's own strict parser takes it
    port.parse_exposition(out[1])


def test_the_broken_callback_is_contained_as_the_reference():
    m = port.MetricsRegistry()
    _callbacks(port, m)
    families = port.parse_exposition(m.render())
    assert families["t_broken_total"]["samples"] == []
    assert families["t_ok_total"]["samples"][0][2] == 1
    assert families["t_live_total"]["samples"][0][2] == 41


def test_null_registry_is_inert_as_the_reference():
    for mod in (ref, port):
        m = mod.NullMetricsRegistry()
        m.counter("x_total", "x").inc(())
        m.histogram("h_seconds", "h").observe((), 1.0, trace_id="t")
        m.gauge("g", "g").set((), 5)
        m.register_callback("c_total", "counter", "c", lambda: [((), 1.0)])
        assert m.render() == "" and m.render(openmetrics=True) == ""
        assert not m.enabled and m.family_names() == [] and m.family("x_total") is None


def test_constants_equal_the_reference():
    assert port.DEFAULT_LATENCY_BUCKETS == ref.DEFAULT_LATENCY_BUCKETS
    assert port.KNOWN_ROUTES == ref.KNOWN_ROUTES


@pytest.mark.parametrize("path", ["/check", "/relation-tuples", "/metrics", "/slo", "/admin",
                                  "/check/../etc", "/relation-tuples/123", "/%2e%2e", ""])
def test_normalize_route_as_the_reference(path):
    assert port.normalize_route(path) == ref.normalize_route(path)


def test_declaration_errors_as_the_reference():
    for bad in (lambda m: m.counter("t_requests", "bad name"),
                lambda m: m.histogram("t_h_seconds", "h", buckets=(1.0, 0.5)),
                lambda m: m.gauge("0bad", "bad"),
                lambda m: m.gauge("t_g", "g", ("0bad",)),
                lambda m: m.register_callback("t_c", "summary", "x", lambda: [])):
        msgs = []
        for mod in (ref, port):
            with pytest.raises(ValueError) as e:
                bad(mod.MetricsRegistry())
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    m = port.MetricsRegistry()
    c = m.counter("t_x_total", "x", ("a",))
    assert m.counter("t_x_total", "x", ("a",)) is c  # idempotent by name
    with pytest.raises(ValueError, match="different shape"):
        m.counter("t_x_total", "x", ("a", "b"))


#: the exposition texts of tests/test_metrics.py:116-141 and more
TEXTS = {
    "good": "# HELP a_total ok\n# TYPE a_total counter\na_total 1\n",
    "counter-without-total": "# HELP a ok\n# TYPE a counter\na 1\n",
    "duplicate-sample": "# HELP a_total ok\n# TYPE a_total counter\na_total 1\na_total 2\n",
    "type-without-help": "# TYPE a_total counter\na_total 1\n",
    "not-cumulative": ("# HELP h ok\n# TYPE h histogram\n"
                       'h_bucket{le="0.1"} 5\nh_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n'),
    "missing-inf": ("# HELP h ok\n# TYPE h histogram\n"
                    'h_bucket{le="0.1"} 1\nh_sum 1\nh_count 1\n'),
    "good-histogram": ("# HELP h ok\n# TYPE h histogram\n"
                       'h_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 2\nh_sum 1.5\nh_count 2\n'),
    "count-mismatch": ("# HELP h ok\n# TYPE h histogram\n"
                       'h_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 2\nh_sum 1.5\nh_count 3\n'),
    "bad-value": "# HELP a_total ok\n# TYPE a_total counter\na_total one\n",
    "bad-label": '# HELP g ok\n# TYPE g gauge\ng{0x="1"} 1\n',
    "unknown-type": "# HELP s ok\n# TYPE s summary\ns 1\n",
    "labelled": '# HELP g ok\n# TYPE g gauge\ng{a="x\\"y",b="z"} -1.5\n',
    "empty": "",
    "eof": "# HELP a_total ok\n# TYPE a_total counter\na_total 1\n# EOF\n",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_exposition_agrees_with_the_reference(name):
    text = TEXTS[name]
    got = []
    for mod in (ref, port):
        try:
            got.append(("ok", mod.parse_exposition(text)))
        except ValueError as e:
            got.append(("error", str(e)))
    assert got[1] == got[0]


def test_parse_exposition_round_trips_every_family_kind():
    m = port.MetricsRegistry()
    _basic(port, m)
    families = port.parse_exposition(m.render())
    samples = {tuple(sorted(lbl.items())): v for _, lbl, v in families["t_requests_total"]["samples"]}
    assert samples[(("code", "200"), ("route", "/check"))] == 3
    hist = {(n, lbl.get("le")): v for n, lbl, v in families["t_latency_seconds"]["samples"]}
    assert hist[("t_latency_seconds_bucket", "+Inf")] == 3
    assert hist[("t_latency_seconds_sum", None)] == pytest.approx(5.55, abs=1e-12)
