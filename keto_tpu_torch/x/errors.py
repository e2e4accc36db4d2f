"""Error taxonomy.

Mirrors the herodot-style errors the reference surfaces over REST/gRPC:
400 bad-request family for malformed input (reference
internal/relationtuple/definitions.go:120-128), 404 for unknown namespaces
(reference internal/persistence/definitions.go:31), and a generic 500.

Every error carries an HTTP status code and renders to the reference's JSON
error envelope ``{"error": {"code", "status", "message", ...}}``. This is the
port's own copy of keto_tpu/x/errors.py, cut to the errors the Check slice
raises.
"""

from __future__ import annotations

import http
from typing import Any, Optional


class KetoError(Exception):
    """Base error with an HTTP status code and a gRPC status code.

    ``retry_after_s`` is the server's backoff advice for retryable
    overload errors (429/503): REST renders it as a ``Retry-After``
    header, gRPC as ``retry-after`` trailing metadata, and the SDK's
    retry policy sleeps it instead of its own backoff draw."""

    status_code: int = 500
    grpc_code: int = 13  # INTERNAL

    def __init__(
        self,
        message: str = "",
        *,
        reason: str = "",
        details: Optional[dict] = None,
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(message or self.__class__.__name__)
        self.message = message or self.default_message()
        self.reason = reason
        self.details = details or {}
        self.retry_after_s = retry_after_s

    @classmethod
    def default_message(cls) -> str:
        return http.HTTPStatus(cls.status_code).phrase

    def with_reason(self, reason: str) -> "KetoError":
        self.reason = reason
        return self

    def to_json(self) -> dict[str, Any]:
        body: dict[str, Any] = {
            "code": self.status_code,
            "status": http.HTTPStatus(self.status_code).phrase,
            "message": self.message,
        }
        if self.reason:
            body["reason"] = self.reason
        if self.details:
            body["details"] = self.details
        return {"error": body}


class ErrBadRequest(KetoError):
    status_code = 400
    grpc_code = 3  # INVALID_ARGUMENT


class ErrNotFound(KetoError):
    status_code = 404
    grpc_code = 5  # NOT_FOUND


class ErrInternalServerError(KetoError):
    status_code = 500
    grpc_code = 13  # INTERNAL


class ErrDeadlineExceeded(KetoError, TimeoutError):
    """A request's deadline expired before (or while) it was served —
    REST 504 / gRPC DEADLINE_EXCEEDED. Subclasses TimeoutError so callers
    treating the batcher as a plain future API keep working."""

    status_code = 504
    grpc_code = 4  # DEADLINE_EXCEEDED

    def __init__(self, message: str = "request deadline exceeded", **kw):
        super().__init__(message, **kw)


class ErrTooManyRequests(KetoError):
    """Load shed: the check queue is at capacity and the server refuses
    new work instead of growing an unbounded backlog — REST 429 / gRPC
    RESOURCE_EXHAUSTED."""

    status_code = 429
    grpc_code = 8  # RESOURCE_EXHAUSTED

    def __init__(self, message: str = "server overloaded, retry later", **kw):
        super().__init__(message, **kw)


class ErrServiceUnavailable(KetoError):
    """The serving core is not ready (snapshot beyond its staleness
    budget, maintenance dead) — REST 503 / gRPC UNAVAILABLE."""

    status_code = 503
    grpc_code = 14  # UNAVAILABLE

    def __init__(self, message: str = "service not ready", **kw):
        super().__init__(message, **kw)


class ErrMalformedInput(ErrBadRequest):
    """Reference internal/relationtuple/definitions.go:123."""

    def __init__(self, message: str = "malformed string input", **kw):
        super().__init__(message, **kw)


class ErrNilSubject(ErrBadRequest):
    """Reference internal/relationtuple/definitions.go:124."""

    def __init__(self, message: str = "subject is not allowed to be nil", **kw):
        super().__init__(message, **kw)


class ErrDuplicateSubject(ErrBadRequest):
    """Reference internal/relationtuple/definitions.go:125."""

    def __init__(self, message: str = "exactly one of subject_set or subject_id has to be provided", **kw):
        super().__init__(message, **kw)


class ErrDroppedSubjectKey(ErrBadRequest):
    """Reference internal/relationtuple/definitions.go:126."""

    def __init__(
        self,
        message: str = 'provide "subject_id" or "subject_set.*"; support for "subject" was dropped',
        **kw,
    ):
        super().__init__(message, **kw)


class ErrIncompleteSubject(ErrBadRequest):
    """Reference internal/relationtuple/definitions.go:127."""

    def __init__(
        self,
        message: str = 'incomplete subject, provide "subject_id" or a complete "subject_set.*"',
        **kw,
    ):
        super().__init__(message, **kw)


class ErrNamespaceUnknown(ErrNotFound):
    """Unknown namespace — the check engine maps this to allowed=false
    (reference internal/check/engine.go:76-77); list/write surface it as 404.
    Reference sentinel: internal/persistence/definitions.go:31."""

    def __init__(self, message: str = "namespace unknown", **kw):
        super().__init__(message, **kw)


class ErrMalformedPageToken(ErrBadRequest):
    """Reference internal/persistence/definitions.go:32."""

    def __init__(self, message: str = "malformed page token", **kw):
        super().__init__(message, **kw)


class ErrWatchExpired(KetoError):
    """A Watch resume snaptoken predates the store's retained change-log
    horizon — REST 410 Gone / gRPC OUT_OF_RANGE. The subscriber re-lists
    and re-subscribes from the current snaptoken (the standard changefeed
    contract)."""

    status_code = 410
    grpc_code = 11  # OUT_OF_RANGE

    def __init__(
        self,
        message: str = "watch snaptoken predates the retained change log; "
        "re-list and resume from a current snaptoken",
        **kw,
    ):
        super().__init__(message, **kw)
