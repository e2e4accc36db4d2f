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
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from keto_tpu_torch.driver.health import READY_STATES, HealthMonitor, HealthState
from keto_tpu_torch.relationtuple.model import (
    RelationQuery,
    RelationTuple,
    subject_set_from_url_query,
)
from keto_tpu_torch.version import __version__
from keto_tpu_torch.x.errors import ErrBadRequest, ErrNilSubject, KetoError
from keto_tpu_torch.x.pagination import with_size, with_token
from keto_tpu_torch.x.timeline import TimelineRecorder, current_timeline

READ = "read"
WRITE = "write"

#: routes whose handling records no request timeline: reading the ring
#: must not churn it
_TIMELINE_EXCLUDED = frozenset({"/debug/requests"})

#: routes the port serves; a timeline of any other path is kind "other",
#: so a path-scanning client cannot grow the kinds without bound
#: (keto_tpu/x/metrics.py:89-93)
_KNOWN_ROUTES = frozenset({
    "/check", "/check/batch", "/check/explain", "/expand", "/relation-tuples",
    "/relation-tuples/list-objects", "/relation-tuples/list-subjects", "/version",
    "/debug/requests", "/health/alive", "/health/ready",
})

_HEX = set("0123456789abcdef")


def parse_traceparent(value: str) -> Optional[tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header
    (``00-<32 hex>-<16 hex>-<2 hex>``), or None when malformed: a copy of
    keto_tpu/x/tracing.py:45-59."""
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


def _error_headers(err: KetoError) -> dict[str, str]:
    """Overload errors carry the server's backoff advice as a
    ``Retry-After`` header (integer seconds)."""
    ra = getattr(err, "retry_after_s", None)
    return {"Retry-After": str(max(1, math.ceil(ra)))} if ra else {}

#: upper bound on one /check/batch payload
MAX_BATCH_CHECK = 65536
#: the expand depth cap's default (the reference's limit.max_read_depth)
MAX_READ_DEPTH = 5


class RestApp:
    """Routes requests for one server role against the store (writes and
    tuple reads), the check batcher, the list engine and the expand engine
    (reads)."""

    def __init__(self, role: str, store, batcher, lister=None, explain=None, decision_log=None,
                 expander=None, max_read_depth: int = MAX_READ_DEPTH,
                 recorder: Optional[TimelineRecorder] = None, transact=None,
                 monitor: Optional[HealthMonitor] = None):
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
        # correlation: echo the caller's request id or mint one; join the
        # caller's trace when a well-formed traceparent came in
        req_id = (hdrs.get("x-request-id") or "").strip() or uuid.uuid4().hex
        remote = parse_traceparent(hdrs.get("traceparent", ""))
        recorder = self.recorder
        tl = None if path in _TIMELINE_EXCLUDED else recorder.begin(
            f"{method} {path if path in _KNOWN_ROUTES else 'other'}",
            trace_id=remote[0] if remote else "", request_id=req_id, surface="http",
            tenant="default", parent_span_id=remote[1] if remote else "",
        )
        with recorder.activate(tl):
            status, payload, resp_headers = self._route(method, path, query, body, headers)
        resp_headers = dict(resp_headers)
        resp_headers.setdefault("X-Request-Id", req_id)
        if tl is not None:
            recorder.finish(tl, status=status, snaptoken=resp_headers.get("X-Keto-Snaptoken"))
            resp_headers.setdefault("Server-Timing", recorder.server_timing(tl))
        return status, payload, resp_headers

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
            if route == ("GET", "/debug/requests"):
                return self._get_debug_requests(query)
            if self.role == READ:
                if route == ("GET", "/check"):
                    return self._get_check(query, headers)
                if route == ("POST", "/check"):
                    return self._post_check(body, query, headers)
                if route == ("POST", "/check/batch"):
                    return self._post_check_batch(body, query, headers)
                if route == ("GET", "/check/explain"):
                    return self._get_explain(query)
                if route == ("GET", "/expand") and self.expander is not None:
                    return self._get_expand(query)
                if route == ("GET", "/relation-tuples"):
                    return self._get_relation_tuples(query)
                if route == ("GET", "/relation-tuples/list-objects") and self.lister:
                    return self._get_list_objects(query)
                if route == ("GET", "/relation-tuples/list-subjects") and self.lister:
                    return self._get_list_subjects(query)
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

    def _get_explain(self, query):
        """The decision plus its provenance (keto_tpu_torch/explain)."""
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

    def _get_expand(self, query):
        # the reference parses max-depth unconditionally: absent or
        # invalid is a 400; 0 means the cap
        raw_depth = (query.get("max-depth") or [""])[0]
        try:
            depth = int(raw_depth)
        except ValueError:
            raise ErrBadRequest(f"invalid max-depth {raw_depth!r}") from None
        subject = subject_set_from_url_query(query)
        eff_depth = self.expand_depth(depth)
        tree = self.expander.build_tree(subject, eff_depth)
        tl = current_timeline()
        if tl is not None:
            tl.stamp("expand", depth=eff_depth)
        if tree is None:
            return 200, None, {}
        return 200, tree.to_json(), {}

    def _get_relation_tuples(self, query):
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

    def _get_list_objects(self, query):
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
        size, token = self._page_opts(query)
        objs, nxt, snaptoken = self.lister.page_objects(
            rq.namespace, rq.relation, sub, page_size=size, page_token=token,
            **self._consistency_from(query),
        )
        body = {"objects": objs, "next_page_token": nxt, "snaptoken": str(snaptoken)}
        return 200, body, self._token_headers(snaptoken)

    def _get_list_subjects(self, query):
        """Every subject id allowed on namespace:object#relation."""
        rq = RelationQuery.from_url_query(query)
        if rq.namespace == "":
            raise ErrBadRequest("namespace has to be specified")
        if rq.object == "":
            raise ErrBadRequest("object has to be specified")
        if rq.relation == "":
            raise ErrBadRequest("relation has to be specified")
        size, token = self._page_opts(query)
        subs, nxt, snaptoken = self.lister.page_subjects(
            rq.namespace, rq.object, rq.relation, page_size=size, page_token=token,
            **self._consistency_from(query),
        )
        body = {"subject_ids": subs, "next_page_token": nxt, "snaptoken": str(snaptoken)}
        return 200, body, self._token_headers(snaptoken)

    # -- write ---------------------------------------------------------------

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
        result = self.transact([rel], (), idempotency_key=self._idempotency_key_from(headers))
        resp = {"Location": "/relation-tuples?" + rel.to_url_query()}
        resp.update(self._write_headers(result))
        return 201, rel.to_json(), resp

    def _delete_relation_tuple(self, query, headers=None):
        rel = RelationTuple.from_url_query(query)
        result = self.transact((), [rel], idempotency_key=self._idempotency_key_from(headers))
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
        result = self.transact(insert, delete,
                               idempotency_key=self._idempotency_key_from(headers))
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
                data = b"" if payload is None else json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if data:
                    self.wfile.write(data)
            finally:
                with self.server.active_lock:
                    self.server.active_count -= 1

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
                 monitor: Optional[HealthMonitor] = None):
        self.app = RestApp(role, store, batcher, lister, explain, decision_log, expander,
                           max_read_depth, recorder, transact, monitor)
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
