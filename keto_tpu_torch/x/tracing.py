"""Request tracing: a copy of
keto_tpu/x/tracing.py.

The analog of the reference's opentracing wiring (reference
internal/driver/config/provider.go:145-155 for config,
registry_default.go:288-290 HTTP middleware, :331-333/:344-346 gRPC
interceptors, pop_connection.go:17-23 SQL-level spans): spans carry a trace
id, name, duration, and tags, propagate via a context variable, and export
through a pluggable provider (the reference selects jaeger/zipkin/etc. from
config the same way). Providers:

- ``""`` (default): tracing disabled, spans are no-ops;
- ``log``: finished spans go to the structured logger at debug level;
- ``memory``: spans collect in a ring buffer (tests, /debug introspection);
- ``otlp-file``: spans append to ``tracing.otlp.file`` as OTLP/JSON lines
  (one ExportTraceServiceRequest per line) — a local OpenTelemetry
  collector tails it with the filelog receiver; suits zero-egress hosts;
- ``otlp-http``: spans POST (batched, background thread, drop-on-overflow
  — telemetry never blocks serving) to an OTLP/HTTP collector at
  ``tracing.otlp.endpoint`` (default the collector's standard local
  listener, http://127.0.0.1:4318/v1/traces).
"""

from __future__ import annotations

import collections
import contextvars
import json
import queue
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "keto_tpu_torch_span", default=None
)

DEFAULT_OTLP_ENDPOINT = "http://127.0.0.1:4318/v1/traces"

_HEX = set("0123456789abcdef")


def parse_traceparent(value: str) -> Optional[tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header
    (``00-<32 hex>-<16 hex>-<2 hex>``), or None when malformed — a bad
    header starts a fresh trace instead of failing the request."""
    parts = (value or "").strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if version == "ff" or len(version) != 2 or not set(version) <= _HEX:
        return None
    if len(trace_id) != 32 or not set(trace_id) <= _HEX or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not set(span_id) <= _HEX or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """A W3C ``traceparent`` value continuing ``trace_id`` under
    ``span_id`` (sampled flag set — this process exported the span)."""
    return f"00-{trace_id}-{span_id}-01"


def current_traceparent() -> str:
    """The ``traceparent`` an outbound request should carry to join the
    current trace, or "" outside any span (the httpclient SDK's
    injection seam)."""
    s = _current_span.get()
    if s is None:
        return ""
    return format_traceparent(s.trace_id, s.span_id)


def current_span_ids() -> Optional[tuple[str, str]]:
    """``(trace_id, span_id)`` of the active span, or None — the
    timeline recorder captures these at request arrival so the child
    spans it emits at finish parent under the request's server span."""
    s = _current_span.get()
    if s is None:
        return None
    return s.trace_id, s.span_id


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float
    #: wall-clock epoch nanoseconds at span start (OTLP export needs
    #: absolute time; ``start`` stays monotonic for exact durations)
    start_unix_ns: int = 0
    end: Optional[float] = None
    tags: dict[str, Any] = field(default_factory=dict)
    #: the parent span lives in ANOTHER process (joined via traceparent):
    #: this span is still the local entry point (SERVER kind)
    remote: bool = False

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.end is None else (self.end - self.start) * 1e3

    def to_otlp(self) -> dict:
        """This span as an OTLP/JSON span object."""
        dur_ns = 0 if self.end is None else int((self.end - self.start) * 1e9)
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id or "",
            "name": self.name,
            # root spans are the request entry points (SERVER); nested
            # spans are INTERNAL — backends derive per-service request
            # rates from server spans, so children must not double-count.
            # A remote-parented span (joined via traceparent) is still
            # this process's entry point.
            "kind": 2 if (self.parent_id is None or self.remote) else 1,
            "startTimeUnixNano": str(self.start_unix_ns),
            "endTimeUnixNano": str(self.start_unix_ns + dur_ns),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in self.tags.items()
            ],
        }


def spans_to_otlp_request(spans: list[Span], service: str = "keto-tpu") -> dict:
    """An OTLP/JSON ExportTraceServiceRequest wrapping ``spans``."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {"key": "service.name", "value": {"stringValue": service}}
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "keto_tpu"},
                        "spans": [s.to_otlp() for s in spans],
                    }
                ],
            }
        ]
    }


class _OtlpHttpExporter:
    """Background batcher POSTing OTLP/JSON to a local collector. Spans
    enqueue without blocking; a full queue drops (and counts) instead of
    stalling the serving path."""

    def __init__(self, endpoint: str, flush_interval_s: float = 1.0, batch: int = 64):
        self.endpoint = endpoint
        self._q: queue.Queue = queue.Queue(maxsize=4096)
        self._interval = flush_interval_s
        self._batch = batch
        self.dropped = 0
        self.exported = 0
        # spans accepted but not yet export-attempted: queued OR held in
        # the worker's current batch. Incremented atomically with the
        # enqueue and decremented only after the POST attempt, so flush()
        # can never observe "empty queue" while a drained batch is still
        # un-POSTed (the drain race a queue-emptiness check had).
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="keto-tpu-torch-otlp", daemon=True
        )
        self._thread.start()

    def submit(self, span: Span) -> None:
        with self._pending_lock:
            try:
                self._q.put_nowait(span)
            except queue.Full:
                self.dropped += 1
            else:
                self._pending += 1

    def _loop(self) -> None:
        import urllib.request

        while True:
            spans: list[Span] = []
            try:
                spans.append(self._q.get(timeout=self._interval))
            except queue.Empty:
                if self._stop.is_set():
                    return  # drained: queue empty after stop
                continue
            while len(spans) < self._batch:
                try:
                    spans.append(self._q.get_nowait())
                except queue.Empty:
                    break
            body = json.dumps(spans_to_otlp_request(spans)).encode()
            req = urllib.request.Request(
                self.endpoint, data=body, method="POST",
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=5):
                    self.exported += len(spans)
            except Exception:
                self.dropped += len(spans)  # collector down: drop, never block
            with self._pending_lock:
                self._pending -= len(spans)

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until every span accepted so far has been export-attempted
        — the queue AND the worker's in-flight batch (tests, shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._pending_lock:
                if self._pending == 0:
                    return
            time.sleep(0.02)

    def stop(self) -> None:
        """Flush, then stop and join the worker — spans accepted before
        stop() are exported, not dropped."""
        self.flush()
        self._stop.set()
        self._thread.join(timeout=10)


class Tracer:
    def __init__(
        self,
        provider: str = "",
        logger=None,
        capacity: int = 1024,
        otlp_file: str = "",
        otlp_endpoint: str = DEFAULT_OTLP_ENDPOINT,
    ):
        self.provider = provider
        self._logger = logger
        self._lock = threading.Lock()
        self.finished: collections.deque[Span] = collections.deque(maxlen=capacity)
        self._otlp_file = otlp_file
        self._file_handle = None
        self._file_failed = False
        # export accounting for /metrics (the otlp-http provider counts in
        # its exporter; every other provider counts here)
        self._exported = 0
        self._dropped = 0
        self._http: Optional[_OtlpHttpExporter] = None
        if provider == "otlp-file" and not otlp_file:
            raise ValueError(
                "tracing.provider=otlp-file requires tracing.otlp.file"
            )
        if provider == "otlp-http":
            self._http = _OtlpHttpExporter(otlp_endpoint or DEFAULT_OTLP_ENDPOINT)

    @property
    def enabled(self) -> bool:
        return self.provider != ""

    @property
    def spans_exported(self) -> int:
        """Spans handed to the provider (for otlp-http: POSTed)."""
        return self._http.exported if self._http is not None else self._exported

    @property
    def spans_dropped(self) -> int:
        """Spans lost (full export queue, collector down, dead file)."""
        return self._http.dropped if self._http is not None else self._dropped

    @contextmanager
    def span(
        self,
        name: str,
        remote_parent: Optional[tuple[str, str]] = None,
        **tags,
    ) -> Iterator[Optional[Span]]:
        """``remote_parent`` is a ``(trace_id, span_id)`` extracted from an
        inbound ``traceparent`` header (parse_traceparent above):
        a root span joins the caller's trace instead of starting its own,
        so one trace follows the request across services. Ignored when a
        local parent span is already active."""
        if not self.enabled:
            yield None
            return
        parent = _current_span.get()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif remote_parent is not None:
            trace_id, parent_id = remote_parent
        else:
            trace_id, parent_id = uuid.uuid4().hex, None
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent_id,
            start=time.perf_counter(),
            start_unix_ns=time.time_ns(),
            tags=dict(tags),
            remote=parent is None and remote_parent is not None,
        )
        token = _current_span.set(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            _current_span.reset(token)
            self._export(s)

    def emit(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str] = None,
        start_unix_ns: int = 0,
        duration_s: float = 0.0,
        **tags,
    ) -> None:
        """Export an explicitly-timed, already-finished span (the
        timeline recorder's post-hoc stage spans): no context-variable
        nesting, the caller supplies trace/parent ids and wall-clock
        timing. No-op while disabled."""
        if not self.enabled:
            return
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=uuid.uuid4().hex[:16],
            # "" (not None) when the caller knows no parent: these are
            # always INTERNAL stage spans, never request entry points
            parent_id=parent_id or "",
            start=0.0,
            start_unix_ns=int(start_unix_ns) or time.time_ns(),
            end=max(0.0, float(duration_s)),
            tags=dict(tags),
        )
        self._export(s)

    def _export(self, s: Span) -> None:
        if self.provider == "log" and self._logger is not None:
            self._logger.debug(
                "span %s trace=%s dur=%.2fms %s", s.name, s.trace_id, s.duration_ms, s.tags
            )
            self._exported += 1
        elif self.provider == "memory":
            with self._lock:
                self.finished.append(s)
                self._exported += 1
        elif self.provider == "otlp-file" and self._otlp_file:
            # telemetry never breaks serving: an unwritable path logs once
            # and disables the exporter instead of failing every request;
            # the handle stays open (O_APPEND line writes) so the hot path
            # pays one write syscall, not open/write/close per span
            line = json.dumps(spans_to_otlp_request([s])) + "\n"
            with self._lock:
                if self._file_failed:
                    self._dropped += 1
                    return
                try:
                    if self._file_handle is None:
                        self._file_handle = open(self._otlp_file, "a")
                    self._file_handle.write(line)
                    self._file_handle.flush()
                    self._exported += 1
                except OSError as e:
                    self._file_failed = True
                    self._dropped += 1
                    if self._logger is not None:
                        self._logger.error(
                            "otlp-file exporter disabled: %s (%s)", e, self._otlp_file
                        )
        elif self.provider == "otlp-http" and self._http is not None:
            self._http.submit(s)

    def flush(self) -> None:
        if self._http is not None:
            self._http.flush()

    def close(self) -> None:
        if self._http is not None:
            self._http.stop()
        with self._lock:
            if self._file_handle is not None:
                try:
                    self._file_handle.close()
                except OSError:
                    pass
                self._file_handle = None


#: process-wide no-op tracer used before a registry exists
NOOP = Tracer("")
