"""Structured logging: a copy of
keto_tpu/x/logging.py.

The analog of the reference's logrusx setup (reference
internal/driver/registry_factory.go:33): level and format come from config
(``log.level``, ``log.format``), per-request logging is attached by the REST
servers excluding health endpoints (reference registry_default.go:275,300),
and ``text``/``json`` formats are supported.

Request correlation: the REST/gRPC layers bind the request's
``X-Request-Id`` and trace id into context variables around handler
execution (``request_context``), and both formatters stamp them onto
every record emitted inside that scope — a log line, the span it was
emitted under, and the response headers all carry the same ids, so one
grep follows a request across logs, traces, and latency exemplars.
"""

from __future__ import annotations

import contextvars
import json
import logging
import sys
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional

_request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "keto_tpu_torch_request_id", default=""
)
_trace_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "keto_tpu_torch_trace_id", default=""
)


def current_request_id() -> str:
    return _request_id.get()


def current_trace_id() -> str:
    return _trace_id.get()


@contextmanager
def request_context(request_id: str = "", trace_id: str = "") -> Iterator[None]:
    """Bind correlation ids for the duration of a request's handling;
    every log record emitted inside carries them (and the httpclient SDK
    propagates them onto outbound requests)."""
    tokens = []
    if request_id:
        tokens.append((_request_id, _request_id.set(request_id)))
    if trace_id:
        tokens.append((_trace_id, _trace_id.set(trace_id)))
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


def _correlation_fields() -> dict[str, str]:
    out = {}
    rid = _request_id.get()
    if rid:
        out["request_id"] = rid
    tid = _trace_id.get()
    if tid:
        out["trace_id"] = tid
    return out


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        body: dict[str, Any] = {
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime(record.created)),
            "logger": record.name,
        }
        body.update(_correlation_fields())
        extra = getattr(record, "fields", None)
        if extra:
            body.update(extra)
        if record.exc_info:
            body["error"] = self.formatException(record.exc_info)
        return json.dumps(body)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = f"{self.formatTime(record, '%H:%M:%S')} {record.levelname:<5} {record.name}: {record.getMessage()}"
        fields = {**_correlation_fields(), **(getattr(record, "fields", None) or {})}
        if fields:
            base += " " + " ".join(f"{k}={v}" for k, v in fields.items())
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def new_logger(level: str = "info", fmt: str = "text", name: str = "keto_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_JsonFormatter() if fmt == "json" else _TextFormatter())
    logger.handlers = [handler]
    return logger


def with_fields(logger: logging.Logger, **fields) -> logging.LoggerAdapter:
    """Attach structured fields to subsequent log calls."""

    class _Adapter(logging.LoggerAdapter):
        def process(self, msg, kwargs):
            kwargs.setdefault("extra", {})["fields"] = {**fields, **kwargs.get("extra", {}).get("fields", {})}
            return msg, kwargs

    return _Adapter(logger, {})
