"""REST handlers over the stdlib HTTP server: a lean port of
keto_tpu/servers/rest.py with the same routes, status codes and bodies.

Read port:

- ``GET /check`` decodes the tuple from the URL query; a nil subject is a
  400 with "Subject has to be specified." (reference
  internal/check/handler.go:85-107); the *status code mirrors the
  decision*: 200 allowed / 403 denied, body ``{"allowed": bool}``.
- ``POST /check`` takes the tuple as JSON (handler.go:128-146).
- ``POST /check/batch`` takes ``{"tuples": [...]}`` and answers
  ``{"results": [bool, ...]}`` in order. Big payloads ride the batcher's
  batch lane (keto_tpu_torch/driver/batch.py) and dispatch in bounded
  sub-slices that interleave with interactive checks; an
  ``X-Keto-Priority`` header (``interactive`` | ``batch``) pins the lane
  on any check route (anything else is a 400), else size classifies. A
  batch that is not pinned interactive is first held against the
  admission window, before its JSON is decoded (rest.py:801-840).
- Deadlines (rest.py:620-650): ``?timeout_ms=`` or an
  ``X-Request-Timeout-Ms`` header on ``/check``, ``POST /check`` and
  ``/check/batch`` rides into the batcher as an absolute deadline (a
  malformed or non-positive value is a 400); a request that expires
  queued answers **504**. A full lane or the admission window
  (keto_tpu_torch/driver/admission.py) sheds with **429**; every error
  response whose error carries backoff advice has a ``Retry-After``
  header (integer seconds, rest.py:106-120).
- ``?snaptoken=`` asks for a snapshot at or past a write's token (the
  batcher's ``at_least``; a malformed one is a 400) and ``?latest=true``
  for read-your-writes; by default a check is served in the serving mode
  (keto_tpu/servers/rest.py:653-664). Responses carry the deciding
  snapshot's id in ``X-Keto-Snaptoken``.
- ``GET /relation-tuples/list-objects`` (namespace, relation and a subject)
  and ``GET /relation-tuples/list-subjects`` (namespace, object, relation)
  answer the reverse queries through the list engine
  (keto_tpu/servers/rest.py:919-976): ``page_size``, ``page_token`` and
  the same freshness parameters; a missing field is a 400; the body is
  ``{"objects" | "subject_ids", "next_page_token", "snaptoken"}`` and the
  response carries ``X-Keto-Snaptoken``.
- ``GET /check/explain`` (keto_tpu/servers/rest.py:748-790) answers the
  decision with its provenance (keto_tpu_torch/explain): the route that
  decided, a witness verified against the store (grant) or a
  frontier-exhaustion certificate (deny), and the label route's landmark.
  Always 200 (the body carries ``allowed``); a nil subject is a 400; 404
  when explain is disabled; ``?snaptoken=`` as on ``/check``; the response
  carries ``X-Keto-Snaptoken``.
- ``GET /expand`` (keto_tpu/servers/rest.py:843-873) answers the subject
  set's tree (``Tree.to_json``; an empty 200 for no tree) through the
  snapshot-backed expand engine; ``max-depth`` is required (absent or not
  an integer: 400), and a depth of 0 or past ``max_read_depth`` (the
  reference's ``limit.max_read_depth``, default 5) takes the cap
  (keto_tpu/driver/registry.py:768-773).
- ``GET /watch?snaptoken=N`` (keto_tpu/servers/rest.py:977-1016) is the
  changefeed: a chunked ``application/x-ndjson`` stream, one line a
  committed transaction ``{"snaptoken", "changes": [{"action",
  "relation_tuple"}], "committed_at", "emitted_at"}`` (plus the writer's
  ``traceparent`` where it sent one), resumable from any retained token.
  A token below the store's retained horizon answers **410** before any
  byte streams; past ``serve.watch_max_streams`` open streams it answers
  **429**. The hub's ``close()`` (the drain's first step) ends every
  stream. Without a watch hub the route is a 404.
- ``GET /relation-tuples`` (rest.py:875-899) pages the store's tuples
  matching the URL query: ``page_token``, ``page_size`` (malformed: 400);
  the body is ``{"relation_tuples": [...], "next_page_token": ...}``.
- With a decision log, ``/check`` appends a sampled, witness-free record of
  each decision (rest.py:705-746): its ``route`` read off the request
  timeline's last ``device`` stamp ("" when timelines are off), its
  ``trace_id`` the timeline's trace id, else its request id.
- Request timelines (rest.py:197-245, keto_tpu_torch/x/timeline.py):
  every request but the health routes echoes its ``X-Request-Id`` or gets
  a minted one (``uuid4().hex``); every one that ``_TIMELINE_EXCLUDED``
  does not name gets a timeline, bound to the handler's context while it
  is routed and finished with its status and snaptoken, and the response
  carries the ``Server-Timing`` of its stages. A W3C ``traceparent``
  header joins its trace id. ``GET /debug/requests`` (both ports,
  rest.py:355-373) answers the recorder's recent and slowest timelines:
  ``?n=``, ``?slowest=``, ``?trace_id=``, ``?snaptoken=``, ``?tenant=``.
- Observability (rest.py:150-262, :326-343, :375-390): every request but
  the health routes counts into ``keto_http_requests_total`` and
  ``keto_http_request_duration_seconds`` (trace-id exemplars) by role,
  method, normalized route (``other`` past the declared surface) and code;
  runs inside a request span ``http.{method} {route}`` that joins the
  ``traceparent`` (its timeline is born inside it, so the stage spans
  parent under it); and binds its request id and trace id into the log
  context (keto_tpu_torch/x/logging.py) for the handler. ``GET /metrics``
  (both ports) answers the registry's Prometheus text, or OpenMetrics with
  exemplars for ``Accept: application/openmetrics-text``, and 404 when the
  metrics are disabled; ``GET /slo`` (both ports) answers the SLO engine's
  report (404 without one). ``/expand`` records ``keto_expand_*``.

Write port: ``PUT /relation-tuples`` creates from a JSON body → 201 +
Location (reference transact_server.go:130-153); ``DELETE`` by URL query →
204 (transact_server.go:173-187); ``PATCH /relation-tuples`` applies a JSON
array of ``{"action": "insert" | "delete", "relation_tuple": {...}}`` in one
transaction → 204 (rest.py:1088-1112; an unknown action or a missing tuple
is a 400 and applies nothing). Each answers the commit's snaptoken. An
``X-Idempotency-Key`` header on any of the three (rest.py:1019-1112) makes
the write exactly-once per key: a retry of an applied key applies nothing
and answers the original ``X-Keto-Snaptoken`` with
``X-Keto-Idempotent-Replay: true``. Writes go through ``transact`` (the
daemon passes its group-commit coordinator's, keto_tpu_torch/driver/
group_commit.py), else straight to the store's transaction.

Tenants (keto_tpu/servers/rest.py:586-615): the port serves the default
tenant alone (multi-tenant serving is ROADMAP A9). Every route the
reference scopes through ``_scope`` reads ``X-Keto-Tenant``: absent, blank
or ``default`` serves as always; a malformed id answers the reference's
400; any other tenant answers 400 naming A9, so a request addressed to
another tenant is never answered from, or written into, the default
tenant's store. Every write reports its commit to the watch hub with the
request's ``traceparent`` (``_note_commit``, rest.py:1029-1045), which the
commit's watch line carries. With a ``Telemetry`` sink
(``telemetry.enabled``) every non-health request counts into it by
``"<role> <method> <route>"`` (rest.py:196).

Both ports: ``GET /health/alive`` → ``{"status": "ok"}``; ``GET
/health/ready`` reads the health state machine (keto_tpu_torch/driver/
health.py; keto_tpu/servers/rest.py:509-548): 200 ``{"status": "ok"}``
while SERVING; 200 ``{"status": <state>, "reason": ...}`` in the other
ready states (``degraded`` under memory pressure or an audit mismatch;
``starting`` with the first build's phase, percent and rows); 503
``{"status": "unavailable", "reason": ...}`` with ``Retry-After: 1`` when
NOT_SERVING — past the staleness budget, a dead maintenance worker, or a
drain (``"draining: shutdown requested"``, pinned by the daemon);
``/version`` →
``{"version": ...}`` (rest.py:267-268). Errors render the herodot-style
envelope of x/errors.py.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
import uuid
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlsplit

from keto_tpu_torch.driver.health import READY_STATES, HealthMonitor, HealthState
from keto_tpu_torch.relationtuple.model import (
    RelationQuery,
    RelationTuple,
    subject_set_from_url_query,
)
from keto_tpu_torch.version import __version__
from keto_tpu_torch.x.errors import ErrBadRequest, ErrNilSubject, ErrTooManyRequests, KetoError
from keto_tpu_torch.x.logging import new_logger, request_context
from keto_tpu_torch.x.metrics import NullMetricsRegistry, normalize_route
from keto_tpu_torch.x.pagination import with_size, with_token
from keto_tpu_torch.x.timeline import TimelineRecorder, current_timeline
from keto_tpu_torch.x.tracing import NOOP, current_traceparent, parse_traceparent

READ = "read"
WRITE = "write"

#: routes whose handling records no request timeline: scrapes and the debug
#: surfaces would otherwise churn the ring the operator is trying to read
_TIMELINE_EXCLUDED = frozenset({"/metrics", "/debug/requests", "/slo"})


#: the tenant every request without an ``X-Keto-Tenant`` header belongs to
DEFAULT_TENANT = "default"
#: the request header that addresses a tenant
TENANT_HEADER = "X-Keto-Tenant"
#: tenant ids are path- and label-safe (keto_tpu/driver/tenants.py:75-77)
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def validate_tenant_id(raw: str) -> str:
    """The validated tenant id for ``raw`` (absent/blank -> default);
    anything outside the 64-char ``[A-Za-z0-9._-]`` grammar is a 400 (the
    port's copy of keto_tpu/driver/tenants.py:80-93)."""
    tenant = (raw or "").strip()
    if not tenant:
        return DEFAULT_TENANT
    if not _TENANT_RE.match(tenant):
        raise ErrBadRequest(
            f"invalid {TENANT_HEADER} {tenant!r} (expected 1-64 chars of "
            "[A-Za-z0-9._-], starting alphanumeric)"
        )
    return tenant


@dataclass
class RawBody:
    """A non-JSON response payload (the ``/metrics`` exposition): the
    handler writes ``data`` verbatim under ``content_type``."""

    data: bytes
    content_type: str


@dataclass
class StreamBody:
    """A chunked streaming response (``GET /watch``): the backends write
    ``Transfer-Encoding: chunked``, iterate ``chunks`` (bytes a chunk) until
    it ends, then close the connection. Closing the iterator on a client
    disconnect releases its resources (the watch hub's stream slot)."""

    chunks: Any  # iterator of bytes
    content_type: str = "application/x-ndjson"


def _error_headers(err: KetoError) -> dict[str, str]:
    """Overload errors carry the server's backoff advice as a
    ``Retry-After`` header (integer seconds)."""
    ra = getattr(err, "retry_after_s", None)
    return {"Retry-After": str(max(1, math.ceil(ra)))} if ra else {}

#: upper bound on one /check/batch payload
MAX_BATCH_CHECK = 65536
#: the expand depth cap's default (the reference's limit.max_read_depth)
MAX_READ_DEPTH = 5


def http_metrics(m):
    """The REST request counter and latency histogram, declared once per
    registry (as the reference's ``RestApp``, keto_tpu/servers/rest.py:150-165;
    creation is idempotent across the two roles)."""
    return (
        m.counter(
            "keto_http_requests_total",
            "REST requests served, by role/method/route/status code "
            "(health endpoints excluded; undeclared routes count as 'other').",
            ("role", "method", "route", "code"),
        ),
        m.histogram(
            "keto_http_request_duration_seconds",
            "REST request handling latency; the slowest sample per route "
            "carries a trace_id exemplar.",
            ("role", "method", "route"),
        ),
    )


def expand_metrics(m):
    """The expand request counter and build-latency histogram
    (keto_tpu/servers/grpc_api.py:124-140), labeled by surface."""
    return (
        m.counter(
            "keto_expand_requests_total",
            "Expand trees built, by serving surface (http/grpc).",
            ("surface",),
        ),
        m.histogram(
            "keto_expand_duration_seconds",
            "Expand tree construction latency (host-side recursion over "
            "the device snapshot or the Manager).",
            ("surface",),
        ),
    )


class RestApp:
    """Routes requests for one server role against the store (writes and
    tuple reads), the check batcher, the list engine and the expand engine
    (reads)."""

    def __init__(self, role: str, store, batcher, lister=None, explain=None, decision_log=None,
                 expander=None, max_read_depth: int = MAX_READ_DEPTH,
                 recorder: Optional[TimelineRecorder] = None, transact=None,
                 monitor: Optional[HealthMonitor] = None, metrics=None, tracer=None, slo=None,
                 logger=None, watch_hub=None, telemetry=None):
        self.role = role
        self.store = store
        self.batcher = batcher
        #: the write path: ``(insert, delete, idempotency_key=None) ->
        #: TransactResult``, the group-commit coordinator's ``transact`` or
        #: the store's own transaction
        self.transact = transact if transact is not None else store.transact_relation_tuples
        self.lister = lister
        #: the expand engine (keto_tpu_torch/expand), None: no /expand
        self.expander = expander
        #: the cap of an expand's depth (the reference's limit.max_read_depth)
        self.max_read_depth = int(max_read_depth)
        #: the ExplainEngine, None when explain is disabled
        self.explain = explain
        #: the DecisionLog that /check samples into, None when there is none
        self.decision_log = decision_log
        #: the request timelines' recorder (a disabled one records nothing)
        self.recorder = recorder if recorder is not None else TimelineRecorder(enabled=False)
        #: the health state machine /health/ready reads (by default one over
        #: the batcher's engine)
        self.monitor = monitor if monitor is not None else HealthMonitor(batcher.engine)
        #: the metrics registry (bridged by keto_tpu_torch/driver/observability.py);
        #: the null registry records nothing and /metrics answers 404
        self.metrics = metrics if metrics is not None else NullMetricsRegistry()
        #: the request spans' tracer (disabled by default)
        self.tracer = tracer if tracer is not None else NOOP
        #: the SLO engine /slo reports, None: /slo answers 404
        self.slo = slo
        self._log = logger if logger is not None else new_logger()
        #: the Watch changefeed hub (keto_tpu_torch/list/watch.py), None: no
        #: /watch, and writes note no commits
        self.watch_hub = watch_hub
        #: the per-route request counter (x/telemetry.Telemetry), or None
        self.telemetry = telemetry
        self._req_count, self._req_latency = http_metrics(self.metrics)
        self._expand_count, self._expand_latency = expand_metrics(self.metrics)

    @property
    def draining(self) -> Optional[str]:
        """The reason of a pinned NOT_SERVING (a drain), else None."""
        pinned = self.monitor.override()
        if pinned is None or pinned[0] is not HealthState.NOT_SERVING:
            return None
        return pinned[1]

    def handle(self, method: str, path: str, query: dict[str, list[str]], body: bytes,
               headers: Optional[dict[str, str]] = None):
        """Returns (status, payload-dict | None, headers-dict). ``headers``
        are the request headers, lowercase-keyed (request id, trace context,
        deadline, lane)."""
        if path.startswith("/health/"):
            return self._route(method, path, query, body, headers)
        hdrs = headers or {}
        route = normalize_route(path)
        # correlation: echo the caller's request id or mint one; join the
        # caller's trace when a well-formed traceparent came in
        req_id = (hdrs.get("x-request-id") or "").strip() or uuid.uuid4().hex
        remote = parse_traceparent(hdrs.get("traceparent", ""))
        if self.telemetry is not None:
            self.telemetry.record(f"{self.role} {method} {route}")
        recorder = self.recorder
        t0 = time.perf_counter()
        with self.tracer.span(f"http.{method} {route}", remote_parent=remote,
                              role=self.role) as span:
            trace_id = span.trace_id if span is not None else (remote[0] if remote else "")
            # the timeline is born inside the request span, so the stage
            # spans it emits at finish parent under it
            tl = None if path in _TIMELINE_EXCLUDED else recorder.begin(
                f"{method} {route}", trace_id=trace_id, request_id=req_id, surface="http",
                tenant=(hdrs.get("x-keto-tenant") or "").strip() or DEFAULT_TENANT,
            )
            with request_context(request_id=req_id, trace_id=trace_id):
                with recorder.activate(tl):
                    status, payload, resp_headers = self._route(method, path, query, body,
                                                                headers)
                if span is not None:
                    span.tags["status"] = status
                    span.tags["request_id"] = req_id
                # inside the bound context: the record carries the ids
                self._log.debug("%s %s %s -> %d", self.role, method, path, status)
        dur_s = time.perf_counter() - t0
        self._req_count.inc((self.role, method, route, str(status)))
        self._req_latency.observe((self.role, method, route), dur_s, trace_id=trace_id)
        resp_headers = dict(resp_headers)
        resp_headers.setdefault("X-Request-Id", req_id)
        if tl is not None:
            recorder.finish(tl, status=status, snaptoken=resp_headers.get("X-Keto-Snaptoken"))
            # a stream's exchange has no end, so it carries no timing
            if not isinstance(payload, StreamBody):
                resp_headers.setdefault("Server-Timing", recorder.server_timing(tl))
        return status, payload, resp_headers

    def note_listener_shed(self, method: str, path: str) -> None:
        """Count a listener-level 429 (shed on the event loop before any
        handler ran) into the request metrics (async_rest.py)."""
        self._req_count.inc((self.role, method, normalize_route(path), "429"))

    def _route(self, method: str, path: str, query: dict[str, list[str]], body: bytes,
               headers: Optional[dict[str, str]] = None):
        try:
            route = (method, path)
            if path == "/health/alive":
                return 200, {"status": "ok"}, {}
            if path == "/health/ready":
                return self._health_ready()
            if path == "/version":
                return 200, {"version": __version__}, {}
            if route == ("GET", "/metrics"):
                return self._get_metrics(headers)
            if route == ("GET", "/debug/requests"):
                return self._get_debug_requests(query)
            if route == ("GET", "/slo"):
                return self._get_slo()
            if self.role == READ:
                if route == ("GET", "/check"):
                    return self._get_check(query, headers)
                if route == ("POST", "/check"):
                    return self._post_check(body, query, headers)
                if route == ("POST", "/check/batch"):
                    return self._post_check_batch(body, query, headers)
                if route == ("GET", "/check/explain"):
                    return self._get_explain(query, headers)
                if route == ("GET", "/expand") and self.expander is not None:
                    return self._get_expand(query, headers)
                if route == ("GET", "/relation-tuples"):
                    return self._get_relation_tuples(query, headers)
                if route == ("GET", "/relation-tuples/list-objects") and self.lister:
                    return self._get_list_objects(query, headers)
                if route == ("GET", "/relation-tuples/list-subjects") and self.lister:
                    return self._get_list_subjects(query, headers)
                if route == ("GET", "/watch") and self.watch_hub is not None:
                    return self._get_watch(query, headers)
            else:
                if route == ("PUT", "/relation-tuples"):
                    return self._put_relation_tuple(body, headers)
                if route == ("DELETE", "/relation-tuples"):
                    return self._delete_relation_tuple(query, headers)
                if route == ("PATCH", "/relation-tuples"):
                    return self._patch_relation_tuples(body, headers)
            err = KetoError("404 page not found")
            err.status_code = 404
            return 404, err.to_json(), {}
        except KetoError as e:
            return e.status_code, e.to_json(), _error_headers(e)
        except Exception as e:  # unexpected → 500 envelope
            err = KetoError(str(e) or "internal server error")
            return 500, err.to_json(), {}

    def _health_ready(self):
        """Readiness from the health state machine (rest.py:509-548): the
        ready states answer 200 (the state surfaced, so probes can alert on
        ``degraded``); NOT_SERVING answers 503 with the machine's reason and
        backoff advice."""
        state, reason = self.monitor.status()
        if state not in READY_STATES:
            return 503, {"status": "unavailable", "reason": reason or state.value}, \
                {"Retry-After": "1"}
        if state is HealthState.SERVING:
            return 200, {"status": "ok"}, {}
        body = {"status": state.value}
        if reason:
            body["reason"] = reason
        if state is HealthState.STARTING:
            body.update(self.monitor.starting_detail())
        return 200, body, {}

    # -- observability -------------------------------------------------------

    def _get_metrics(self, headers):
        """The registry's Prometheus text exposition; OpenMetrics with
        trace-id exemplars for ``Accept: application/openmetrics-text``;
        404 when the metrics are disabled (rest.py:326-343)."""
        m = self.metrics
        if not m.enabled:
            err = KetoError("metrics disabled by configuration")
            err.status_code = 404
            return 404, err.to_json(), {}
        openmetrics = "application/openmetrics-text" in (headers or {}).get("accept", "")
        content_type = (
            "application/openmetrics-text; version=1.0.0; charset=utf-8"
            if openmetrics
            else "text/plain; version=0.0.4; charset=utf-8"
        )
        return 200, RawBody(m.render(openmetrics=openmetrics).encode(), content_type), {}

    def _get_slo(self):
        """The SLO engine's multi-window availability and latency burn-rate
        report (rest.py:375-384); 404 without an engine."""
        if self.slo is None:
            err = KetoError("no SLO engine configured")
            err.status_code = 404
            return 404, err.to_json(), {}
        return 200, self.slo.to_json(), {}

    @staticmethod
    def _int_param(query, key: str, default: int) -> int:
        raw = (query.get(key) or [""])[0]
        if not raw:
            return default
        try:
            return max(0, int(raw))
        except ValueError:
            raise ErrBadRequest(f"invalid {key} {raw!r}") from None

    def _get_debug_requests(self, query):
        """The recorder's recent and top-K-slowest request timelines,
        filtered by ``?trace_id=``, ``?snaptoken=`` and ``?tenant=``;
        ``?n=`` and ``?slowest=`` bound the two lists."""
        body = self.recorder.snapshot(
            recent=self._int_param(query, "n", 50),
            slowest=self._int_param(query, "slowest", 20),
            trace_id=(query.get("trace_id") or [""])[0] or None,
            snaptoken=(query.get("snaptoken") or [""])[0] or None,
            tenant=(query.get("tenant") or [""])[0] or None,
        )
        return 200, body, {}

    # -- tenancy --------------------------------------------------------------

    @staticmethod
    def _scope(headers) -> None:
        """Admit the tenant a request addresses (rest.py:586-615): the
        default tenant (no header, a blank one or ``default``) is served; a
        malformed id is the reference's 400; any other tenant is a 400
        naming ROADMAP A9, since the port serves one tenant's store."""
        tenant = validate_tenant_id((headers or {}).get("x-keto-tenant", ""))
        if tenant != DEFAULT_TENANT:
            raise ErrBadRequest(
                f"multi-tenant serving is not available: {TENANT_HEADER} {tenant!r} "
                "addresses a tenant other than the default one, and this server "
                "serves only the default tenant (ROADMAP A9)"
            )

    # -- read ----------------------------------------------------------------

    @staticmethod
    def _deadline_from(query, headers) -> Optional[float]:
        """The request's deadline as absolute ``time.monotonic()`` seconds,
        from ``?timeout_ms=`` or ``X-Request-Timeout-Ms``; a malformed or
        non-positive value is a 400."""
        raw = (query.get("timeout_ms") or [""])[0]
        if not raw and headers:
            raw = headers.get("x-request-timeout-ms", "")
        if not raw:
            return None
        try:
            ms = float(raw)
        except ValueError:
            raise ErrBadRequest(f"invalid timeout_ms {raw!r}") from None
        if ms <= 0:
            raise ErrBadRequest(f"timeout_ms must be > 0, got {raw!r}")
        return time.monotonic() + ms / 1e3

    @staticmethod
    def _lane_from(headers) -> Optional[str]:
        """The ``X-Keto-Priority`` lane hint (``interactive`` | ``batch``);
        absent → None (the batcher classifies by size), else a 400."""
        raw = (headers or {}).get("x-keto-priority", "").strip().lower()
        if not raw:
            return None
        if raw in ("interactive", "batch"):
            return raw
        raise ErrBadRequest(f"invalid X-Keto-Priority {raw!r} (expected interactive|batch)")

    @staticmethod
    def _consistency_from(query) -> dict:
        """``{"at_least": ..., "latest": ...}`` from ``?snaptoken=`` and
        ``?latest=``."""
        raw_token = (query.get("snaptoken") or [""])[0]
        at_least = None
        if raw_token:
            try:
                at_least = int(raw_token)
            except ValueError:
                raise ErrBadRequest(f"malformed snaptoken {raw_token!r}") from None
        latest = (query.get("latest") or [""])[0].lower() in ("1", "true")
        return {"at_least": at_least, "latest": latest}

    @staticmethod
    def _token_headers(token) -> dict[str, str]:
        return {} if token is None else {"X-Keto-Snaptoken": str(token)}

    def _check(self, tuple_: RelationTuple, query, headers=None):
        self._scope(headers)
        allowed, token = self.batcher.check_with_token(
            tuple_, **self._consistency_from(query),
            deadline=self._deadline_from(query, headers), lane=self._lane_from(headers),
        )
        # the sampled decision record: one None test when the log is off,
        # one RNG draw when it is on; witness-free (the snaptoken makes the
        # decision re-explainable later)
        dl = self.decision_log
        if dl is not None and dl.sampled():
            self._record_decision(dl, tuple_, allowed, token)
        return (200 if allowed else 403), {"allowed": allowed}, self._token_headers(token)

    @staticmethod
    def _record_decision(dl, tuple_, allowed, token) -> None:
        """Append one check decision to the decision log. The route is read
        off the request timeline's last device stamp; "" with timelines
        off."""
        route = ""
        trace_id = ""
        tl = current_timeline()
        if tl is not None:
            # the trace id when a traceparent joined us, else the request id
            trace_id = tl.trace_id or tl.request_id
            for stage, _t, attrs in reversed(tl.stamps):
                if stage == "device" and attrs and "route" in attrs:
                    route = str(attrs["route"])
                    break
        dl.record("default", {
            "kind": "check",
            "tuple": tuple_.to_json(),
            "decision": bool(allowed),
            "route": route,
            "witness": None,
            "snaptoken": str(token) if token is not None else "",
            "trace_id": trace_id,
        })

    @staticmethod
    def _tuple_from(query) -> RelationTuple:
        try:
            return RelationTuple.from_url_query(query)
        except ErrNilSubject:
            raise ErrBadRequest("Subject has to be specified.") from None

    def _get_check(self, query, headers=None):
        return self._check(self._tuple_from(query), query, headers)

    def _get_explain(self, query, headers=None):
        """The decision plus its provenance (keto_tpu_torch/explain)."""
        self._scope(headers)
        if self.explain is None:
            err = KetoError("explain disabled by configuration")
            err.status_code = 404
            return 404, err.to_json(), {}
        tuple_ = self._tuple_from(query)
        tl = current_timeline()
        resp = self.explain.explain(tuple_, at_least=self._consistency_from(query)["at_least"],
                                    trace_id=tl.trace_id if tl is not None else "")
        if tl is not None:
            tl.stamp("explain", route=resp.get("route", ""), verified=bool(resp.get("verified")))
        headers = {"X-Keto-Snaptoken": resp["snaptoken"]} if resp.get("snaptoken") else {}
        return 200, resp, headers

    def _post_check(self, body: bytes, query, headers=None):
        try:
            obj = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise ErrBadRequest(f"Unable to decode JSON payload: {e}") from None
        return self._check(RelationTuple.from_json(obj), query, headers)

    def _post_check_batch(self, body: bytes, query, headers=None):
        self._scope(headers)
        lane_hint = self._lane_from(headers)
        if lane_hint != "interactive":
            # pre-parse shed: an over-window batch lane refuses BEFORE the
            # JSON decode, or in a brownout the parsing becomes the load
            self.batcher.admission_precheck()
        try:
            obj = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise ErrBadRequest(f"Unable to decode JSON payload: {e}") from None
        raw = obj.get("tuples") if isinstance(obj, dict) else None
        if not isinstance(raw, list) or not raw:
            raise ErrBadRequest('expected a non-empty "tuples" array')
        if len(raw) > MAX_BATCH_CHECK:
            raise ErrBadRequest(
                f"too many tuples in one batch check ({len(raw)} > "
                f"{MAX_BATCH_CHECK}); split the request"
            )
        tuples = [RelationTuple.from_json(t) for t in raw]
        results, token = self.batcher.check_batch_with_token(
            tuples, **self._consistency_from(query),
            deadline=self._deadline_from(query, headers), lane=lane_hint,
        )
        return 200, {"results": [bool(r) for r in results]}, self._token_headers(token)

    def expand_depth(self, requested: int) -> int:
        """A request's max-depth clamped to the cap: 0, or more than the
        cap, takes the cap (keto_tpu/driver/registry.py:768-773)."""
        cap = self.max_read_depth
        return cap if requested <= 0 or requested > cap else requested

    def _get_expand(self, query, headers=None):
        # the reference parses max-depth unconditionally: absent or
        # invalid is a 400; 0 means the cap
        self._scope(headers)
        raw_depth = (query.get("max-depth") or [""])[0]
        try:
            depth = int(raw_depth)
        except ValueError:
            raise ErrBadRequest(f"invalid max-depth {raw_depth!r}") from None
        subject = subject_set_from_url_query(query)
        eff_depth = self.expand_depth(depth)
        t0 = time.perf_counter()
        tree = self.expander.build_tree(subject, eff_depth)
        dur_s = time.perf_counter() - t0
        self._expand_count.inc(("http",))
        self._expand_latency.observe(("http",), dur_s)
        tl = current_timeline()
        if tl is not None:
            tl.stamp("expand", depth=eff_depth)
        if tree is None:
            return 200, None, {}
        return 200, tree.to_json(), {}

    def _get_relation_tuples(self, query, headers=None):
        self._scope(headers)
        rq = RelationQuery.from_url_query(query)
        opts = []
        token = (query.get("page_token") or [""])[0]
        if token:
            opts.append(with_token(token))
        raw_size = (query.get("page_size") or [""])[0]
        if raw_size:
            try:
                opts.append(with_size(int(raw_size)))
            except ValueError:
                raise ErrBadRequest(f"invalid page_size {raw_size!r}") from None
        rels, next_page = self.store.get_relation_tuples(rq, *opts)
        body = {"relation_tuples": [r.to_json() for r in rels], "next_page_token": next_page}
        return 200, body, {}

    # -- reverse queries -------------------------------------------------------

    @staticmethod
    def _page_opts(query) -> tuple[int, str]:
        """(page_size, page_token); a malformed size is a 400."""
        token = (query.get("page_token") or [""])[0]
        raw_size = (query.get("page_size") or [""])[0]
        size = 0
        if raw_size:
            try:
                size = int(raw_size)
            except ValueError:
                raise ErrBadRequest(f"invalid page_size {raw_size!r}") from None
            if size < 0:
                raise ErrBadRequest(f"page_size must be >= 0, got {raw_size!r}")
        return size, token

    def _get_list_objects(self, query, headers=None):
        """Every object the subject can reach under namespace + relation, a
        sorted page with a snaptoken-pinned page token."""
        rq = RelationQuery.from_url_query(query)
        if rq.namespace == "":
            raise ErrBadRequest("namespace has to be specified")
        if rq.relation == "":
            raise ErrBadRequest("relation has to be specified")
        sub = rq.subject
        if sub is None:
            raise ErrBadRequest("Subject has to be specified.")
        self._scope(headers)
        size, token = self._page_opts(query)
        objs, nxt, snaptoken = self.lister.page_objects(
            rq.namespace, rq.relation, sub, page_size=size, page_token=token,
            **self._consistency_from(query),
        )
        body = {"objects": objs, "next_page_token": nxt, "snaptoken": str(snaptoken)}
        return 200, body, self._token_headers(snaptoken)

    def _get_list_subjects(self, query, headers=None):
        """Every subject id allowed on namespace:object#relation."""
        rq = RelationQuery.from_url_query(query)
        if rq.namespace == "":
            raise ErrBadRequest("namespace has to be specified")
        if rq.object == "":
            raise ErrBadRequest("object has to be specified")
        if rq.relation == "":
            raise ErrBadRequest("relation has to be specified")
        self._scope(headers)
        size, token = self._page_opts(query)
        subs, nxt, snaptoken = self.lister.page_subjects(
            rq.namespace, rq.object, rq.relation, page_size=size, page_token=token,
            **self._consistency_from(query),
        )
        body = {"subject_ids": subs, "next_page_token": nxt, "snaptoken": str(snaptoken)}
        return 200, body, self._token_headers(snaptoken)

    # -- watch ---------------------------------------------------------------

    def _get_watch(self, query, headers=None):
        """``GET /watch?snaptoken=N``: the chunked ndjson changefeed, one
        line a committed transaction, resumable from any retained
        snaptoken (410 past the horizon), ended by the drain."""
        self._scope(headers)
        hub = self.watch_hub
        raw = (query.get("snaptoken") or [""])[0] or "0"
        try:
            since = int(raw)
        except ValueError:
            raise ErrBadRequest(f"malformed snaptoken {raw!r}") from None
        # the horizon is checked before a 200 is committed: an expired
        # token answers 410, it does not die mid-stream
        hub.changes_since(since)
        if not hub.try_acquire_stream():
            raise ErrTooManyRequests(
                "too many concurrent watch streams; retry with backoff", retry_after_s=1.0)

        def gen():
            try:
                for token, changes in hub.subscribe(since, own_slot=False):
                    msg = hub.enrich_group(token, {
                        "snaptoken": str(token),
                        "changes": [{"action": action, "relation_tuple": rt.to_json()}
                                    for action, rt in changes],
                    })
                    yield (json.dumps(msg) + "\n").encode()
            finally:
                hub.release_stream()

        return 200, StreamBody(gen()), {}

    # -- write ---------------------------------------------------------------

    def _note_commit(self, result) -> None:
        """Register the committed transaction's trace context with the
        watch hub, so the commit's watch line carries the writer's
        ``traceparent`` (rest.py:1029-1045). An idempotent replay answers an
        old commit and registers nothing."""
        hub = self.watch_hub
        if hub is None or result is None or getattr(result, "replayed", False):
            return
        token = getattr(result, "snaptoken", None)
        if token is None:
            return
        try:
            hub.note_commit_trace(int(token), current_traceparent())
        except Exception:
            # the trace enrichment never fails a write
            self._log.debug("commit-trace registration failed", exc_info=True)

    @staticmethod
    def _idempotency_key_from(headers) -> Optional[str]:
        """``X-Idempotency-Key`` on a write opts into exactly-once
        semantics (rest.py:1019-1026)."""
        return (headers or {}).get("x-idempotency-key") or None

    @staticmethod
    def _write_headers(result) -> dict[str, str]:
        """A write's response headers: the snaptoken it committed at, and
        the replay marker on a deduplicated retry (rest.py:1048-1060)."""
        if result is None:
            return {}
        out = {"X-Keto-Snaptoken": str(result.snaptoken)}
        if result.replayed:
            out["X-Keto-Idempotent-Replay"] = "true"
        return out

    def _put_relation_tuple(self, body: bytes, headers=None):
        try:
            obj = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise ErrBadRequest(str(e)) from None
        rel = RelationTuple.from_json(obj)
        self._scope(headers)
        result = self.transact([rel], (), idempotency_key=self._idempotency_key_from(headers))
        self._note_commit(result)
        resp = {"Location": "/relation-tuples?" + rel.to_url_query()}
        resp.update(self._write_headers(result))
        return 201, rel.to_json(), resp

    def _delete_relation_tuple(self, query, headers=None):
        rel = RelationTuple.from_url_query(query)
        self._scope(headers)
        result = self.transact((), [rel], idempotency_key=self._idempotency_key_from(headers))
        self._note_commit(result)
        return 204, None, self._write_headers(result)

    def _patch_relation_tuples(self, body: bytes, headers=None):
        try:
            deltas = json.loads(body or b"[]")
        except json.JSONDecodeError as e:
            raise ErrBadRequest(str(e)) from None
        if not isinstance(deltas, list):
            raise ErrBadRequest("expected a JSON array of patch deltas")
        insert, delete = [], []
        for d in deltas:
            raw = d.get("relation_tuple") if isinstance(d, dict) else None
            if raw is None:
                raise ErrBadRequest("relation_tuple is missing")
            action = d.get("action")
            if action == "insert":
                insert.append(RelationTuple.from_json(raw))
            elif action == "delete":
                delete.append(RelationTuple.from_json(raw))
            else:
                raise ErrBadRequest(f"unknown action {action}")
        self._scope(headers)
        result = self.transact(insert, delete,
                               idempotency_key=self._idempotency_key_from(headers))
        self._note_commit(result)
        return 204, None, self._write_headers(result)


def _make_handler(app: RestApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "keto-tpu-torch"

        def _serve(self, method: str):
            # in-flight accounting for the drain: the exchange counts until
            # its response bytes are handed to the kernel
            with self.server.active_lock:
                self.server.active_count += 1
            try:
                parts = urlsplit(self.path)
                query = parse_qs(parts.query, keep_blank_values=True)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                req_headers = {k.lower(): v for k, v in self.headers.items()}
                status, payload, headers = app.handle(method, parts.path, query, body,
                                                      req_headers)
                if isinstance(payload, StreamBody):
                    self._serve_stream(status, payload, headers)
                    return
                if isinstance(payload, RawBody):
                    data, content_type = payload.data, payload.content_type
                else:
                    data = b"" if payload is None else json.dumps(payload).encode()
                    content_type = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if data:
                    self.wfile.write(data)
            finally:
                with self.server.active_lock:
                    self.server.active_count -= 1

        def _serve_stream(self, status: int, payload: StreamBody, headers) -> None:
            """Chunked transfer: each chunk framed and flushed as it comes,
            so a subscriber sees a commit live; the connection closes at the
            end. A client disconnect closes the generator, which releases
            its watch slot."""
            self.send_response(status)
            self.send_header("Content-Type", payload.content_type)
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Connection", "close")
            self.end_headers()
            chunks = payload.chunks
            try:
                for chunk in chunks:
                    if not chunk:
                        continue
                    self.wfile.write(b"%x\r\n" % len(chunk) + chunk + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # the subscriber went away; the finally releases the slot
            finally:
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()
                self.close_connection = True

        def log_message(self, fmt, *args):  # quiet: no per-request stderr lines
            pass

        def do_GET(self):
            self._serve("GET")

        def do_POST(self):
            self._serve("POST")

        def do_PUT(self):
            self._serve("PUT")

        def do_DELETE(self):
            self._serve("DELETE")

        def do_PATCH(self):
            self._serve("PATCH")

    return Handler


class _Server(ThreadingHTTPServer):
    """socketserver listens with a backlog of 5: past 5 connects waiting to
    be accepted, the kernel drops SYNs and a client waits out its SYN
    retransmit (≥ 1 s). The reference's fronts listen with ≥ 100
    (``asyncio.start_server``, ``socket.create_server``)."""

    request_queue_size = 128
    daemon_threads = True


class RestServer:
    """One role's REST server on its own port, served from a thread."""

    def __init__(self, role: str, store, batcher, host: str = "127.0.0.1", port: int = 0,
                 lister=None, explain=None, decision_log=None, expander=None,
                 max_read_depth: int = MAX_READ_DEPTH,
                 recorder: Optional[TimelineRecorder] = None, transact=None,
                 monitor: Optional[HealthMonitor] = None, metrics=None, tracer=None, slo=None,
                 logger=None, watch_hub=None, telemetry=None):
        self.app = RestApp(role, store, batcher, lister, explain, decision_log, expander,
                           max_read_depth, recorder, transact, monitor, metrics, tracer, slo,
                           logger, watch_hub, telemetry)
        self.httpd = _Server((host or "0.0.0.0", port), _make_handler(self.app))
        self.httpd.active_count = 0
        self.httpd.active_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def drain(self, timeout_s: float) -> bool:
        """Wait until every accepted request has had its response written
        (rest.py:1214-1224). True when idle within ``timeout_s``."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self.httpd.active_lock:
                if self.httpd.active_count == 0:
                    return True
            time.sleep(0.01)
        with self.httpd.active_lock:
            return self.httpd.active_count == 0

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name=f"rest-{self.app.role}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
