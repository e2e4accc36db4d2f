"""The port's tracing (keto_tpu_torch/x/tracing.py) and structured logging
(keto_tpu_torch/x/logging.py) against the reference's copies on the CPU.

Spans with fixed ids and times give byte-equal ``spans_to_otlp_request``
JSON; ``parse_traceparent`` accepts and rejects the same headers; the
``otlp-file`` provider writes one valid request a line; the ``otlp-http``
exporter reaches a collector thread on loopback; a log record made inside
``request_context`` carries the same fields as the reference formatter's.
Every comparison is exact (tolerance 0)."""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from keto_tpu.x import logging as ref_logging
from keto_tpu.x import tracing as ref
from keto_tpu_torch.x import logging as port_logging
from keto_tpu_torch.x import tracing as port

TID, PID = "ab" * 16, "cd" * 8


def _spans(mod):
    """Three spans with fixed ids, times and tags: a root, its child and a
    remote-parented entry span."""
    return [
        mod.Span(name="http.GET /check", trace_id=TID, span_id="1" * 16, parent_id=None,
                 start=10.0, start_unix_ns=1_700_000_000_000_000_000, end=10.0123,
                 tags={"role": "read", "status": 200}),
        mod.Span(name="timeline.device", trace_id=TID, span_id="2" * 16, parent_id="1" * 16,
                 start=10.001, start_unix_ns=1_700_000_000_001_000_000, end=10.004,
                 tags={"route": "bfs", "width": 1024, "request_id": "r-1"}),
        mod.Span(name="http.POST /check/batch", trace_id="ef" * 16, span_id="3" * 16,
                 parent_id=PID, start=1.0, start_unix_ns=5, end=None, tags={}, remote=True),
    ]


@pytest.mark.parametrize("service", ["keto-tpu", "another service"])
def test_otlp_request_json_is_byte_equal(service):
    got = [json.dumps(mod.spans_to_otlp_request(_spans(mod), service=service))
           for mod in (ref, port)]
    assert got[1] == got[0]


@pytest.mark.parametrize("i", range(3))
def test_span_to_otlp_is_equal(i):
    assert _spans(port)[i].to_otlp() == _spans(ref)[i].to_otlp()


HEADERS = [
    f"00-{TID}-{PID}-01",
    f"00-{TID.upper()}-{PID}-00",
    f" 00-{TID}-{PID}-01 ",
    f"01-{TID}-{PID}-01-extra",
    "",
    "garbage",
    f"00-{TID}-{PID}",
    f"ff-{TID}-{PID}-01",
    f"00-{'0' * 32}-{PID}-01",
    f"00-{TID}-{'0' * 16}-01",
    f"00-{TID[:-1]}-{PID}-01",
    f"00-{TID[:-1]}g-{PID}-01",
    f"0-{TID}-{PID}-01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_as_the_reference(header):
    assert port.parse_traceparent(header) == ref.parse_traceparent(header)


def test_format_traceparent_round_trips():
    assert port.format_traceparent(TID, PID) == ref.format_traceparent(TID, PID)
    assert port.parse_traceparent(port.format_traceparent(TID, PID)) == (TID, PID)


def test_span_context_joins_the_remote_parent():
    t = port.Tracer("memory")
    assert port.current_traceparent() == "" and port.current_span_ids() is None
    with t.span("server", remote_parent=(TID, PID)) as s:
        assert (s.trace_id, s.parent_id, s.remote) == (TID, PID, True)
        assert port.current_span_ids() == (TID, s.span_id)
        assert port.current_traceparent() == f"00-{TID}-{s.span_id}-01"
        with t.span("child") as c:
            assert c.trace_id == TID and c.parent_id == s.span_id
    kinds = {x.name: x.to_otlp()["kind"] for x in t.finished}
    assert kinds == {"server": 2, "child": 1}
    assert t.spans_exported == 2 and t.spans_dropped == 0


def test_disabled_tracer_is_a_noop():
    assert not port.NOOP.enabled
    with port.NOOP.span("x") as s:
        assert s is None
    assert port.current_span_ids() is None


def test_otlp_file_provider_writes_one_request_a_line(tmp_path):
    out = tmp_path / "spans.otlp.jsonl"
    t = port.Tracer("otlp-file", otlp_file=str(out))
    for i in range(3):
        with t.span("http.GET /check", role="read", i=i):
            with t.span("engine.batch"):
                pass
    t.emit("timeline.device", trace_id=TID, parent_id=PID, start_unix_ns=7, duration_s=0.5,
           route="bfs")
    t.close()
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 7
    for line in lines:
        req = json.loads(line)
        spans = req["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert len(spans) == 1
        assert len(spans[0]["traceId"]) == 32 and len(spans[0]["spanId"]) == 16
        assert int(spans[0]["endTimeUnixNano"]) >= int(spans[0]["startTimeUnixNano"])
    assert t.spans_exported == 7 and t.spans_dropped == 0
    with pytest.raises(ValueError, match="requires tracing.otlp.file"):
        port.Tracer("otlp-file")


def test_otlp_file_unwritable_path_never_breaks_serving():
    t = port.Tracer("otlp-file", otlp_file="/nonexistent-dir/spans.jsonl")
    for _ in range(2):
        with t.span("http.GET /check"):
            pass
    assert t.spans_dropped >= 1
    t.close()


def test_otlp_http_exporter_reaches_a_collector_on_loopback():
    received = []

    class Collector(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Collector)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t = port.Tracer("otlp-http",
                        otlp_endpoint=f"http://127.0.0.1:{httpd.server_address[1]}/v1/traces")
        with t.span("http.GET /check", role="read"):
            with t.span("engine.batch"):
                pass
        t.flush()
        deadline = time.monotonic() + 10
        while not received and time.monotonic() < deadline:
            time.sleep(0.05)
        spans = [s for r in received for s in r["resourceSpans"][0]["scopeSpans"][0]["spans"]]
        names = {s["name"]: s for s in spans}
        assert set(names) == {"http.GET /check", "engine.batch"}
        assert names["engine.batch"]["parentSpanId"] == names["http.GET /check"]["spanId"]
        t.close()
        assert t.spans_exported == 2 and t.spans_dropped == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


class _Capture(logging.Handler):
    def __init__(self, formatter):
        super().__init__()
        self.setFormatter(formatter)
        self.lines = []

    def emit(self, record):
        self.lines.append(self.format(record))


def _log_one(mod, fmt):
    logger = mod.new_logger("debug", fmt, name=f"t-{mod.__name__}-{fmt}")
    cap = _Capture(logger.handlers[0].formatter)
    logger.handlers = [cap]
    with mod.request_context(request_id="req-1", trace_id=TID):
        assert (mod.current_request_id(), mod.current_trace_id()) == ("req-1", TID)
        mod.with_fields(logger, tenant="default", n=3).info("served %s", "/check")
    assert (mod.current_request_id(), mod.current_trace_id()) == ("", "")
    logger.info("outside")
    return cap.lines


def test_json_log_record_carries_the_reference_fields():
    got = [_log_one(mod, "json") for mod in (ref_logging, port_logging)]
    for r, p in zip(*got):
        r, p = json.loads(r), json.loads(p)
        assert set(p) == set(r)
        for k in r:
            if k not in ("logger", "time"):
                assert p[k] == r[k], k
    inside = json.loads(got[1][0])
    assert inside["request_id"] == "req-1" and inside["trace_id"] == TID
    assert "request_id" not in json.loads(got[1][1])


def test_text_log_line_carries_the_reference_fields():
    got = [_log_one(mod, "text") for mod in (ref_logging, port_logging)]
    for r, p in zip(*got):
        # "HH:MM:SS LEVEL logger: msg fields": equal past the time and name
        assert p.split(": ", 1)[1] == r.split(": ", 1)[1]
    assert got[1][0].endswith("request_id=req-1 trace_id=" + TID + " tenant=default n=3")


def test_default_logger_name_is_the_port_s():
    assert port_logging.new_logger().name == "keto_tpu_torch"
