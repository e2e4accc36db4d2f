"""The port's observability wiring (keto_tpu_torch/driver/observability.py,
the REST middleware and the daemon) against the reference's on the CPU.

- **The live scrape.** The port's ``Daemon(device="cpu")`` and the
  reference's ``Daemon(Registry(Config(...)))`` (tests/test_metrics.py:
  166-190) get the same namespaces, tuples and REST requests. Every line of
  the port's ``/metrics`` passes the strict parser on both ports; its family
  set is the reference's minus ``PENDING_FAMILIES`` (pinned here: each later
  ROADMAP item shrinks it), and the table of docs/concepts/observability.md
  minus the same list. The families the requests fix are equal series by
  series (``SERIES``): the request, replay, expand, list, explain, shed,
  deadline, health-state, timeline, SLO-objective and build-phase families,
  and the latency histograms' counts. Not compared: latency sums and
  buckets and every duration (clocks), the governor's bytes and the
  maintenance events (the two engines' layouts and native paths differ;
  tests/test_torch_maintenance_stats.py holds those), the slice and route
  counts (slicing follows each engine's own controller), group-commit
  groups (thread timing), the tracer's span counts (the reference's gRPC
  server adds spans) and the health transitions (derived on read, so they
  follow probe timing).
- **The hooks.** A real ``torch.OutOfMemoryError`` at the engine's guard
  leaves one valid ``oom`` bundle whose ``hbm`` section shows the event; a
  DEGRADED flip leaves a ``health-degraded`` bundle; the drain leaves a
  ``drain`` bundle and flushes the ``otlp-file`` spans; a traced
  ``GET /check`` gives a request span with its stage spans as children, the
  ``device`` stage among them.

Every comparison is exact (tolerance 0)."""

from __future__ import annotations

import json
import logging
import re
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.driver import observability as obs
from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.flightrec import list_bundles, validate_bundle
from keto_tpu_torch.x.metrics import parse_exposition

from test_torch_hbm import _OomAt

ROOT = Path(__file__).resolve().parent.parent
NAMESPACES = [{"id": 0, "name": "files"}, {"id": 1, "name": "groups"}]
TID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TID}-00f067aa0ba902b7-01"

#: the reference's families the port leaves out, by the ROADMAP item that
#: brings each; every later item must shrink this
PENDING = {
    "A7": {"keto_grpc_requests_total", "keto_grpc_request_duration_seconds"},
    "A9": {"keto_tenant_known", "keto_tenant_resident", "keto_tenant_evictions_total",
           "keto_tenant_faultins_total", "keto_tenant_shed_spikes_total",
           "keto_tenant_checks_total", "keto_tenant_shed_total", "keto_tenant_resident_bytes",
           "keto_tenant_degraded"},
    "A10": {"keto_replication_apply_delay_seconds", "keto_replica_lag_seconds",
            "keto_replica_applied_commits_total", "keto_replica_bootstraps_total",
            "keto_checkcache_hits_total", "keto_checkcache_misses_total",
            "keto_checkcache_invalidations_total", "keto_fleet_epoch",
            "keto_fleet_promotions_total", "keto_fleet_replicas"},
    "A11": {"keto_reshard_state", "keto_route_weight"},
}
PENDING_ALL = set().union(*PENDING.values())

TUPLES = [
    {"namespace": "files", "object": "doc", "relation": "view",
     "subject_set": {"namespace": "groups", "object": "eng", "relation": "member"}},
    {"namespace": "groups", "object": "eng", "relation": "member",
     "subject_set": {"namespace": "groups", "object": "core", "relation": "member"}},
    {"namespace": "groups", "object": "core", "relation": "member", "subject_id": "alice"},
    {"namespace": "groups", "object": "eng", "relation": "member", "subject_id": "bob"},
    {"namespace": "files", "object": "memo", "relation": "view", "subject_id": "carol"},
]
CHECK = "/check?namespace=files&object=doc&relation=view&latest=true&subject_id="
#: (port role, method, path, body, headers, settle first): the same sequence
#: on both daemons
REQUESTS = [
    ("write", "PATCH", "/relation-tuples",
     [{"action": "insert", "relation_tuple": t} for t in TUPLES[:4]], {}, False),
    ("write", "PUT", "/relation-tuples", TUPLES[4], {"X-Idempotency-Key": "k-1"}, False),
    ("write", "PUT", "/relation-tuples", TUPLES[4], {"X-Idempotency-Key": "k-1"}, False),
    ("read", "GET", CHECK + "alice", None, {}, True),
    ("read", "GET", CHECK + "alice", None, {"traceparent": TRACEPARENT}, False),
    ("read", "GET", CHECK + "mallory", None, {}, False),
    ("read", "POST", "/check?latest=true",
     {"namespace": "files", "object": "doc", "relation": "view", "subject_id": "bob"}, {}, False),
    ("read", "POST", "/check/batch?latest=true", {"tuples": [
        {"namespace": "files", "object": "memo", "relation": "view", "subject_id": "carol"},
        {"namespace": "files", "object": "memo", "relation": "view", "subject_id": "alice"}]},
     {}, False),
    ("read", "POST", "/check/batch", {"tuples": [TUPLES[4]] * 50000}, {}, False),
    ("read", "GET", CHECK + "alice&timeout_ms=0.001", None, {}, False),
    ("read", "GET", "/check?namespace=files&object=doc&relation=view", None, {}, False),
    ("read", "GET", "/expand?namespace=files&object=doc&relation=view&max-depth=3", None, {},
     False),
    ("read", "GET", "/relation-tuples?namespace=groups", None, {}, False),
    ("read", "GET", "/relation-tuples/list-objects?namespace=files&relation=view"
                    "&subject_id=alice&latest=true", None, {}, False),
    ("read", "GET", "/relation-tuples/list-subjects?namespace=files&object=doc&relation=view"
                    "&latest=true", None, {}, False),
    ("read", "GET", "/check/explain?namespace=files&object=doc&relation=view&subject_id=alice",
     None, {}, True),
    ("read", "GET", "/check/explain?namespace=files&object=doc&relation=view&subject_id=eve",
     None, {}, False),
    ("read", "GET", "/version", None, {}, False),
    ("read", "GET", "/health/ready", None, {}, False),
    ("read", "GET", "/scan-1/../../etc/passwd", None, {}, False),
    ("read", "GET", "/debug/requests?n=2", None, {}, False),
    ("read", "GET", "/slo", None, {}, False),
    ("write", "DELETE", "/relation-tuples?namespace=files&object=memo&relation=view"
                        "&subject_id=carol", None, {}, False),
    ("write", "GET", "/metrics", None, {}, False),
]

#: the families the requests fix, compared series by series
SERIES = [
    "keto_http_requests_total", "keto_idempotent_replays_total", "keto_expand_requests_total",
    "keto_list_requests_total", "keto_explain_requests_total", "keto_health_state",
    "keto_check_shed_total", "keto_check_deadline_drops_total", "keto_lane_shed_total",
    "keto_admission_shed_total", "keto_timeline_finished_total", "keto_slo_objective",
    "keto_build_phase", "keto_witness_verify_failures_total", "keto_decision_log_records_total",
    "keto_flightrec_bundles_total", "keto_persistence_reconnect_retries_total",
    "keto_http_request_duration_seconds_count", "keto_expand_duration_seconds_count",
]


def http(port, method, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


class _Ref:
    def __init__(self):
        from keto_tpu.config.provider import Config
        from keto_tpu.driver.daemon import Daemon as RefDaemon
        from keto_tpu.driver.registry import Registry

        cfg = Config(overrides={"namespaces": NAMESPACES, "dsn": "memory",
                                "serve.read.port": 0, "serve.write.port": 0,
                                "tracing.provider": "memory"})
        self.d = RefDaemon(Registry(cfg))
        self.d.serve_all(block=False)
        self.ports = {"read": self.d.read_port, "write": self.d.write_port}

    def settle(self):
        eng = self.d.registry.permission_engine()
        eng.snapshot()
        eng.labels_settled()

    def close(self):
        self.d.shutdown()


class _Port:
    def __init__(self):
        self.d = Daemon([tns.Namespace(id=n["id"], name=n["name"]) for n in NAMESPACES],
                        device="cpu", tracing_provider="memory")
        self.d.start()
        self.ports = {"read": self.d.read.port, "write": self.d.write.port}

    def settle(self):
        self.d.engine.labels_settled()

    def close(self):
        self.d.stop()


def _drive(side):
    out = []
    for role, method, path, body, headers, settle in REQUESTS:
        if settle:
            side.settle()
        out.append(http(side.ports[role], method, path, body, headers)[0])
    return out


@pytest.fixture(scope="module")
def live():
    ref, port = _Ref(), _Port()
    try:
        codes = (_drive(ref), _drive(port))
        fams = {name: parse_exposition(http(side.ports["read"], "GET", "/metrics")[1])
                for name, side in (("ref", ref), ("port", port))}
        yield {"ref": ref, "port": port, "codes": codes, "fams": fams}
    finally:
        ref.close()
        port.close()


def _series(families, name):
    fam = name[: -len("_count")] if name.endswith("_count") else name
    return sorted((n, tuple(sorted(lbl.items())), v) for n, lbl, v in families[fam]["samples"]
                  if n == name or (not name.endswith("_count") and fam == name))


def test_the_requests_answer_as_the_reference(live):
    ref_codes, port_codes = live["codes"]
    assert port_codes == ref_codes
    assert port_codes[3:12] == [200, 200, 403, 200, 200, 429, 504, 400, 200]


@pytest.mark.parametrize("role", ["read", "write"])
def test_every_scrape_line_parses_on_both_ports(live, role):
    status, text, headers = http(live["port"].ports[role], "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    assert len(parse_exposition(text)) == len(live["fams"]["port"])
    status, text, headers = http(live["port"].ports[role], "GET", "/metrics",
                                 headers={"Accept": "application/openmetrics-text"})
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    assert text.rstrip().endswith("# EOF")
    parse_exposition(text)


def test_the_pending_list_is_pinned():
    assert obs.PENDING_FAMILIES == {f: item for item, fams in PENDING.items() for f in fams}


def test_family_set_is_the_reference_minus_the_pending_list(live):
    port, ref = live["fams"]["port"], live["fams"]["ref"]
    assert set(port) == set(ref) - PENDING_ALL
    assert PENDING_ALL <= set(ref)


def test_family_set_is_the_documented_table_minus_the_pending_list(live):
    from keto_tpu.x.analysis.surface import documented_families

    doc = documented_families(ROOT / "docs" / "concepts" / "observability.md")
    assert set(live["fams"]["port"]) == set(doc) - PENDING_ALL
    for name, fam in live["fams"]["port"].items():
        assert fam["type"] == doc[name], name


@pytest.mark.parametrize("name", SERIES)
def test_series_equal_the_reference(live, name):
    got, want = _series(live["fams"]["port"], name), _series(live["fams"]["ref"], name)
    assert got == want
    assert got, f"{name} has no series"


def test_build_info_has_the_reference_shape(live):
    (p,), (r,) = live["fams"]["port"]["keto_build_info"]["samples"], live["fams"]["ref"]["keto_build_info"]["samples"]
    assert (p[0], set(p[1]), p[2]) == (r[0], set(r[1]), r[2]) == ("keto_build_info", {"version"}, 1)


def test_the_requests_moved_their_families(live):
    fams = live["fams"]["port"]

    def value(sample, **labels):
        fam = sample if sample in fams else sample.rsplit("_", 1)[0]
        return sum(v for n, lbl, v in fams[fam]["samples"]
                   if n == sample and all(lbl.get(k) == x for k, x in labels.items()))

    assert value("keto_http_requests_total", role="read", route="/check", code="200") == 3
    assert value("keto_http_requests_total", route="other", code="404") == 1
    assert not [1 for _, lbl, _ in fams["keto_http_requests_total"]["samples"]
                if lbl["route"].startswith("/health/")]
    assert value("keto_idempotent_replays_total") == 1
    b = live["port"].d.batcher
    assert value("keto_check_shed_total") == b.shed_count == 1
    assert value("keto_check_deadline_drops_total") == b.deadline_drop_count
    assert value("keto_health_state", state="serving") == 1
    assert value("keto_group_commit_batch_size_count") == value("keto_group_commit_flush_total")
    assert value("keto_group_commit_wait_seconds_count") == 4
    eng = live["port"].d.engine
    assert value("keto_engine_stream_slice_duration_seconds_count") == \
        eng.stream_slice_stats.snapshot()["count"] > 0
    assert value("keto_timeline_stage_duration_seconds_count", stage="device") > 0
    assert value("keto_build_rows_ingested_total") >= 5
    assert value("keto_hbm_resident_bytes") == eng.hbm.resident_bytes()
    assert value("keto_tracer_spans_exported_total") > 0


def test_the_slowest_check_exemplar_names_a_finished_span(live):
    text = http(live["port"].ports["read"], "GET", "/metrics",
                headers={"Accept": "application/openmetrics-text"})[1]
    lines = [ln for ln in text.splitlines()
             if ln.startswith("keto_http_request_duration_seconds_bucket")
             and 'route="/check"' in ln and " # {" in ln]
    assert lines
    trace_id = re.search(r'trace_id="([0-9a-f]{32})"', lines[0]).group(1)
    assert trace_id in {s.trace_id for s in live["port"].d.tracer.finished}


def test_slo_totals_equal_the_scrape(live):
    port = live["port"]
    time.sleep(1.05)  # past the engine's sampling interval: a fresh sample
    status, body, _ = http(port.ports["read"], "GET", "/slo")
    assert status == 200
    rep = json.loads(body)
    fams = parse_exposition(http(port.ports["read"], "GET", "/metrics")[1])
    total = sum(v for _, _, v in fams["keto_http_requests_total"]["samples"])
    errors = sum(v for _, lbl, v in fams["keto_http_requests_total"]["samples"]
                 if lbl["code"].startswith("5"))
    # /slo's own request counts after its report; the scrape's after its render
    assert rep["windows"][0]["requests"] == total - 1 and rep["windows"][0]["errors"] == errors
    assert rep["objectives"]["availability"] == 0.999
    assert set(rep) == {"objectives", "windows"}


def test_traced_check_has_its_stage_spans_as_children(live):
    spans = list(live["port"].d.tracer.finished)
    (req,) = [s for s in spans if s.trace_id == TID and s.name == "http.GET /check"]
    assert req.parent_id == "00f067aa0ba902b7" and req.remote
    kids = {s.name: s for s in spans if s.parent_id == req.span_id}
    assert {"timeline.admit", "timeline.device", "timeline.deliver"} <= set(kids)
    assert all(s.trace_id == TID for s in kids.values())
    assert kids["timeline.device"].tags["request_id"] == req.tags["request_id"]


# -- the hooks --------------------------------------------------------------------


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


#: a ring of groups (interior rows, as tests/test_torch_health.py's), alice
#: in g0, and the document over g1
ROWS = [T("groups", f"g{i}", "member", SubjectSet("groups", f"g{(i + d) % 6}", "member"))
        for i in range(6) for d in (1, 2)] + [
    T("groups", "g0", "member", SubjectID("alice")),
    T("files", "doc", "view", SubjectSet("groups", "g1", "member"))]


def _daemon(tmp_path, **kw):
    d = Daemon([tns.Namespace(id=n["id"], name=n["name"]) for n in NAMESPACES], device="cpu",
               tuples=ROWS, debug_bundle_dir=str(tmp_path / "bundles"), **kw)
    d.flightrec.min_interval_s = 0.0  # every trigger of a test writes its bundle
    return d


def _bundles(tmp_path, reason, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        got = [json.loads(p.read_text()) for p in list_bundles(tmp_path / "bundles")]
        got = [b for b in got if b["reason"] == reason]
        if got or time.monotonic() > deadline:
            return got
        time.sleep(0.02)


def test_a_real_oom_at_the_guard_leaves_an_oom_bundle(tmp_path):
    d = _daemon(tmp_path)
    d.start()
    try:
        inject = _OomAt(d.engine, "check-dispatch")
        status = http(d.read.port, "GET", CHECK + "alice")[0]
        assert status == 200 and inject.fired == 1
        (bundle,) = _bundles(tmp_path, "oom")
        assert validate_bundle(bundle) == [] and bundle["detail"] == "check-dispatch"
        hbm = bundle["sections"]["hbm"]
        assert (hbm["oom_events"], hbm["oom_recoveries"]) == (1, 1)
        # the deferred dump caught the request's own finished timeline
        kinds = [t["kind"] for t in bundle["sections"]["timelines"]["recent"]]
        assert "GET /check" in kinds
        assert {"health", "batcher", "metrics", "slo", "config"} <= set(bundle["sections"])
        fams = parse_exposition(http(d.read.port, "GET", "/metrics")[1])
        assert fams["keto_oom_events_total"]["samples"][0][2] == 1
        assert fams["keto_oom_recoveries_total"]["samples"][0][2] == 1
        assert ("keto_flightrec_bundles_total", {"reason": "oom"}, 1.0) in \
            fams["keto_flightrec_bundles_total"]["samples"]
    finally:
        d.stop()


def test_a_degraded_flip_leaves_a_health_degraded_bundle(tmp_path):
    d = _daemon(tmp_path)
    d.start()
    try:
        assert http(d.read.port, "GET", "/health/ready")[0] == 200
        d.engine.hbm.set_budget_bytes(1)
        d.store.write_relation_tuples(T("groups", "g1", "member",
                                        SubjectSet("groups", "g4", "member")))
        d.engine.snapshot_serving()
        status, body, _ = http(d.read.port, "GET", "/health/ready")
        assert status == 200 and json.loads(body)["status"] == "degraded"
        (bundle,) = _bundles(tmp_path, "health-degraded")
        assert validate_bundle(bundle) == [] and "memory_pressure" in bundle["detail"]
        assert bundle["sections"]["health"]["state"] == "degraded"
        raw = d.engine.maintenance.raw()
        assert raw[1]["health_state"] == "degraded" and raw[1]["memory_pressure"] == 1
        assert raw[0]["health_transitions"] == d.monitor.transitions
    finally:
        d.stop()


def test_the_drain_leaves_a_bundle_and_flushes_the_span_file(tmp_path):
    spans = tmp_path / "spans.otlp.jsonl"
    d = _daemon(tmp_path, tracing_provider="otlp-file", tracing_otlp_file=str(spans))
    d.start()
    assert http(d.read.port, "GET", CHECK + "alice", headers={"traceparent": TRACEPARENT})[0] == 200
    out = d.drain_and_shutdown(5.0)
    assert out["batcher_idle"] and out["servers_idle"]
    (bundle,) = _bundles(tmp_path, "drain", timeout=0.0)
    assert validate_bundle(bundle) == []
    got = [s for line in spans.read_text().splitlines()
           for s in json.loads(line)["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    (req,) = [s for s in got if s["traceId"] == TID and s["name"] == "http.GET /check"]
    kids = {s["name"] for s in got if s["parentSpanId"] == req["spanId"]}
    assert "timeline.device" in kids


def test_health_transitions_count_into_the_sink_the_monitor_is_given():
    from keto_tpu_torch.driver.health import HealthMonitor, HealthState
    from keto_tpu_torch.x.telemetry import MaintenanceStats

    sink = MaintenanceStats()
    mon = HealthMonitor(None, stats=sink)
    assert mon.status()[0] is HealthState.SERVING
    mon.set_override(HealthState.NOT_SERVING, "draining")
    assert mon.status()[0] is HealthState.NOT_SERVING
    counters, gauges, _ = sink.raw()
    assert counters == {"health_transitions": mon.transitions} and mon.transitions == 2
    assert gauges == {"health_state": "not_serving"}


def test_metrics_disabled_answers_404_and_checks_still_work(tmp_path):
    d = _daemon(tmp_path, metrics_enabled=False)
    d.start()
    try:
        assert http(d.read.port, "GET", "/metrics")[0] == 404
        assert http(d.write.port, "GET", "/metrics")[0] == 404
        assert http(d.read.port, "GET", CHECK + "alice")[0] == 200
        assert http(d.read.port, "GET", "/slo")[0] == 200
    finally:
        d.stop()


def test_serve_flags_name_their_config_keys(tmp_path):
    """The observability keys of a ``serve -c`` config (which replaced the
    flags named after them) reach the registry's metrics, tracer, flight
    recorder and logger."""
    from test_torch_rest import write_config

    from keto_tpu_torch.cmd import build_parser
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.driver.registry import Registry, schema_default

    nss = [{"id": 0, "name": "acl"}]
    path = write_config(tmp_path / "a.json", nss, **{
        "metrics.enabled": False, "tracing.provider": "otlp-file",
        "tracing.otlp.file": str(tmp_path / "s.jsonl"),
        "tracing.otlp.endpoint": "http://127.0.0.1:1/v1/traces",
        "serve.debug_bundle_dir": str(tmp_path / "b"), "log.level": "debug",
        "log.format": "json"})
    args = build_parser().parse_args(["serve", "-c", str(path)])
    cfg = Config(config_file=args.config, env={})
    assert (cfg.get("metrics.enabled"), cfg.get("tracing.provider"), cfg.get("tracing.otlp.file"),
            cfg.get("tracing.otlp.endpoint"), cfg.get("serve.debug_bundle_dir"),
            cfg.get("log.level"), cfg.get("log.format")) == \
        (False, "otlp-file", str(tmp_path / "s.jsonl"), "http://127.0.0.1:1/v1/traces",
         str(tmp_path / "b"), "debug", "json")
    reg = Registry(cfg, device="cpu")
    try:
        assert not reg.metrics().enabled and reg.tracer().provider == "otlp-file"
        assert reg.flight_recorder() is not None and reg.logger().level == logging.DEBUG
    finally:
        reg.close()
    d = Config(config_file=str(write_config(tmp_path / "d.json", nss)), env={})
    keys = ("metrics.enabled", "tracing.provider", "tracing.otlp.file", "serve.debug_bundle_dir",
            "log.level", "log.format")
    assert tuple(d.get(k, schema_default(k)) for k in keys) == (True, "", "", "", "info", "text")


def test_no_bridge_reads_a_component_that_is_not_there():
    m = obs.build_metrics()
    fams = parse_exposition(m.render())
    assert set(fams) == set(parse_exposition(
        obs.build_metrics(engine=lambda: None).render()))
    assert fams["keto_health_state"]["samples"] and fams["keto_build_phase"]["samples"]


def test_the_rest_layer_declares_its_families_without_the_wiring():
    """servers/rest.py declares the HTTP and expand families itself, as the
    reference's RestApp does; it never imports the module that composes it."""
    import subprocess
    import sys

    code = ("import sys, keto_tpu_torch.servers.rest; "
            "print('keto_tpu_torch.driver.observability' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parents[1]).stdout
    assert out.strip() == "False"
    fams = parse_exposition(obs.build_metrics().render())
    assert {"keto_http_requests_total", "keto_http_request_duration_seconds",
            "keto_expand_requests_total", "keto_expand_duration_seconds"} <= set(fams)
