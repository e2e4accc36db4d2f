"""Event-loop REST backend: one reactor, bounded handler pool. The port's
copy of keto_tpu/servers/async_rest.py.

The stdlib ``ThreadingHTTPServer`` backend (keto_tpu_torch/servers/rest.py)
spends a thread per CONNECTION. This backend serves the
same ``RestApp`` routes from one asyncio reactor: connections cost a
coroutine, HTTP/1.1 keep-alive is honored, and handler execution (which
blocks on engine futures) runs on a BOUNDED thread pool — concurrency
backpressure lands in the pool's queue instead of in an unbounded thread
count. ``make_rest_server`` selects the backend by ``serve.http_backend``
(default ``async``; ``threading`` keeps the stdlib backend).

The handler pool is LANED by endpoint: ``/check/batch`` requests run on
their own smaller pool, so batch POSTs blocked on chunk futures can
never occupy every handler thread and convoy interactive checks at the
HTTP layer — the server-side face of the batcher's priority lanes.

Protocol scope matches the reference surface: Content-Length bodies
(no chunked requests), small JSON responses, no upgrades. A chunked
request or a ``HEAD`` answers 501 and closes, a body past 64 MiB 413, and a
malformed or oversized head drops the connection; a ``GET /watch`` stream
runs on a pool of its own, outside the drain's count (the hub's ``close()``
ends it).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from http import HTTPStatus
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from keto_tpu_torch.servers.rest import RawBody, RestApp, RestServer, StreamBody

_log = logging.getLogger("keto_tpu_torch.rest")

_MAX_HEAD = 64 * 1024
_MAX_BODY = 64 * 1024 * 1024

_REASONS = {s.value: s.phrase for s in HTTPStatus}

#: the listener-level shed envelope (matches the x/errors 429 rendering)
_SHED_BODY = {
    "error": {
        "code": 429,
        "status": "Too Many Requests",
        "message": "batch check backlog full (server overloaded); retry with backoff",
    }
}


class AsyncRestServer:
    """Drop-in for ``RestServer`` (same constructor surface, ``port``,
    ``drain``, ``start``/``stop``) on an asyncio reactor: ``app_kwargs`` are
    ``RestApp``'s components."""

    def __init__(
        self,
        role: str,
        store,
        batcher,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        workers: int = 32,
        **app_kwargs,
    ):
        self.app = RestApp(role, store, batcher, **app_kwargs)
        self._host = host or "0.0.0.0"
        self._want_port = port
        self._port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._conns: set[asyncio.StreamWriter] = set()
        # request exchanges mid-flight (head parsed → response flushed);
        # only the event-loop thread mutates it, other threads poll it in
        # drain() — the SIGTERM path waits for this to hit zero before
        # connections are aborted, so accepted requests get their bytes
        self._active = 0
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"rest-{role}"
        )
        # batch-check requests block their handler thread for the whole
        # chunk's latency AND burn real CPU decoding their payloads; a
        # dedicated small pool keeps them from convoying interactive
        # checks out of handler threads (or out of the GIL). The pool's
        # waiting line is BOUNDED: past _batch_limit pending exchanges
        # the listener sheds 429 + Retry-After straight from the event
        # loop — every queue in the path is bounded and sheds
        # explicitly, none hides unbounded latency
        n_batch = max(4, workers // 8)
        self._batch_pool = ThreadPoolExecutor(
            max_workers=n_batch, thread_name_prefix=f"rest-{role}-batch"
        )
        self._batch_limit = 3 * n_batch
        self._batch_pending = 0  # event-loop thread only
        # watch streams live for the connection's lifetime and block
        # between events — a dedicated pool keeps them from occupying
        # request-handler threads (the hub's max_streams bounds the
        # count, so sizing the pool to it never queues a live stream
        # behind another); list traversals ride the BATCH pool so a
        # 100k-result listing never convoys interactive checks out of
        # handler threads — the server-side face of the batcher's
        # priority lanes, applied to the reverse-query surface
        self._watch_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix=f"rest-{role}-watch"
        )
        #: swallowed-with-a-trace counters (keto-analyze KTA401 seam):
        #: connection teardown races and protocol-level failures
        self.teardown_errors = 0
        self.protocol_errors = 0

    @property
    def port(self) -> int:
        assert self._port is not None, "server not started"
        return self._port

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"rest-async-{self.app.role}", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError("async REST server failed to start (timeout)")
        if self._boot_error is not None:
            raise RuntimeError(
                f"async REST server failed to start: {self._boot_error!r}"
            ) from self._boot_error

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._serve_connection, self._host, self._want_port,
                limit=_MAX_HEAD,
            )
            self._port = self._server.sockets[0].getsockname()[1]

        try:
            try:
                loop.run_until_complete(boot())
            except BaseException as e:  # bind failures etc. → surface in start()
                self._boot_error = e
                return
            finally:
                self._ready.set()
            loop.run_forever()
        finally:
            loop.close()

    def drain(self, timeout_s: float) -> bool:
        """Wait (from any thread) until no request exchange is mid-flight
        — every accepted request has had its response flushed. True when
        idle within ``timeout_s``."""
        import time as _time

        deadline = _time.monotonic() + max(0.0, timeout_s)
        while _time.monotonic() < deadline:
            if self._active == 0:
                return True
            _time.sleep(0.01)
        return self._active == 0

    def stop(self) -> None:
        loop = self._loop
        if loop is None or not loop.is_running():
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._batch_pool.shutdown(wait=False, cancel_futures=True)
            self._watch_pool.shutdown(wait=False, cancel_futures=True)
            return

        async def teardown():
            if self._server is not None:
                self._server.close()
                # idle keep-alive connections would make wait_closed()
                # (which on 3.12+ waits for EVERY connection) hang forever
                # — abort them; in-flight handlers see a reset, matching
                # what a process exit would do anyway
                for w in list(self._conns):
                    try:
                        w.transport.abort()
                    except Exception:
                        # a connection torn down concurrently by its peer;
                        # nothing to abort, but keep the trace visible
                        self.teardown_errors += 1
                        _log.debug("transport abort raced teardown", exc_info=True)
                try:
                    await asyncio.wait_for(self._server.wait_closed(), timeout=3)
                except (TimeoutError, asyncio.TimeoutError):
                    pass
            loop.stop()

        asyncio.run_coroutine_threadsafe(teardown(), loop)
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._batch_pool.shutdown(wait=False, cancel_futures=True)
        self._watch_pool.shutdown(wait=False, cancel_futures=True)

    # -- per-connection ------------------------------------------------------

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conns.add(writer)
        try:
            while True:
                head = await self._read_head(reader)
                if head is None:
                    return  # EOF / oversized / malformed — drop quietly
                method, target, version, headers = head
                if "transfer-encoding" in headers:
                    # out of protocol scope (module doc): REJECT with
                    # correct framing — parsing chunk framing as the next
                    # request head would desync the connection
                    await self._write_response(
                        writer, 501,
                        {"error": {"message": "chunked requests unsupported"}},
                        {}, True,
                    )
                    return
                if method == "HEAD":
                    # RestApp has no HEAD routes and a HEAD response must
                    # not carry a body (a client would misparse the next
                    # response) — cleanly framed 501 + close, matching the
                    # stdlib backend
                    await self._write_response(writer, 501, None, {}, True)
                    return
                length = int(headers.get("content-length") or 0)
                if length < 0 or length > _MAX_BODY:
                    await self._write_response(
                        writer, 413, {"error": {"message": "body too large"}}, {}, True
                    )
                    return
                body = await reader.readexactly(length) if length else b""
                parts = urlsplit(target)
                query = parse_qs(parts.query, keep_blank_values=True)
                close = (
                    version == "HTTP/1.0"
                    or headers.get("connection", "").lower() == "close"
                )
                is_batch = parts.path in (
                    "/check/batch",
                    "/relation-tuples/list-objects",
                    "/relation-tuples/list-subjects",
                )
                if is_batch and self._batch_pending >= self._batch_limit:
                    # listener-level shed: the batch pool's waiting line
                    # is full — refuse for microseconds on the event loop
                    # instead of queueing invisible seconds of latency
                    self.app.note_listener_shed(method, parts.path)
                    await self._write_response(
                        writer, 429, _SHED_BODY, {"Retry-After": "1"}, close
                    )
                    if close:
                        return
                    continue
                self._active += 1
                if is_batch:
                    self._batch_pending += 1
                streamed = False
                try:
                    pool = self._batch_pool if is_batch else self._pool
                    status, payload, extra = await asyncio.get_running_loop().run_in_executor(
                        pool, self.app.handle, method, parts.path, query, body,
                        headers,
                    )
                    if isinstance(payload, StreamBody):
                        streamed = True
                    else:
                        await self._write_response(writer, status, payload, extra, close)
                finally:
                    self._active -= 1
                    if is_batch:
                        self._batch_pending -= 1
                if streamed:
                    # long-lived chunked stream (GET /watch): drive the
                    # blocking generator on the dedicated watch pool so
                    # request-handler threads stay free; stream
                    # responses never keep-alive. Runs OUTSIDE _active —
                    # the SIGTERM drain must not wait on open watches
                    # (the hub's close() ends them instead).
                    await self._write_stream(writer, status, payload, extra)
                    return
                if close:
                    return
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            asyncio.LimitOverrunError,
        ):
            pass
        except Exception:
            # handler exceptions are already mapped to 500 envelopes inside
            # RestApp; anything surfacing here is a protocol-level failure
            # — counted, and traced at debug (malformed client bytes must
            # not let a scanner spam the operator log at warning level)
            self.protocol_errors += 1
            _log.debug("protocol-level connection failure", exc_info=True)
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                self.teardown_errors += 1
                _log.debug("connection close raced teardown", exc_info=True)

    @staticmethod
    async def _read_head(reader: asyncio.StreamReader):
        """(method, target, version, lowercase header dict) or None."""
        try:
            # the stream limit (start_server limit=_MAX_HEAD) bounds the
            # head size: oversized heads raise LimitOverrunError here
            raw = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError:
            return None
        except asyncio.LimitOverrunError:
            return None
        try:
            lines = raw.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split(" ", 2)
            headers: dict[str, str] = {}
            for line in lines[1:]:
                if not line:
                    continue
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            return method.upper(), target, version.strip(), headers
        except ValueError:
            return None

    async def _write_stream(
        self, writer: asyncio.StreamWriter, status: int, payload: StreamBody,
        extra: dict,
    ) -> None:
        """Chunked transfer of a StreamBody: each ``next()`` on the
        (blocking) generator runs on the watch pool; chunks flush as
        they arrive so subscribers see commits live."""
        head = [
            f"HTTP/1.1 {status} {_REASONS.get(status, '')}",
            f"Content-Type: {payload.content_type}",
            "Transfer-Encoding: chunked",
            "Server: keto-tpu-torch",
        ]
        for k, v in extra.items():
            head.append(f"{k}: {v}")
        head.append("Connection: close")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        await writer.drain()
        chunks = payload.chunks
        loop = asyncio.get_running_loop()
        end = object()
        try:
            while True:
                chunk = await loop.run_in_executor(self._watch_pool, next, chunks, end)
                if chunk is end:
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
                if not chunk:
                    continue
                writer.write(b"%x\r\n" % len(chunk) + chunk + b"\r\n")
                await writer.drain()
        finally:
            # client disconnects (ConnectionResetError out of drain) land
            # here: closing the generator releases its watch slot
            close = getattr(chunks, "close", None)
            if close is not None:
                await loop.run_in_executor(self._watch_pool, close)

    async def _write_response(
        self, writer: asyncio.StreamWriter, status: int, payload, extra: dict,
        close: bool,
    ) -> None:
        if isinstance(payload, RawBody):
            data, content_type = payload.data, payload.content_type
        else:
            data = b"" if payload is None else json.dumps(payload).encode()
            content_type = "application/json"
        reason = _REASONS.get(status, "")
        head = [
            f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(data)}",
            "Server: keto-tpu-torch",
        ]
        for k, v in extra.items():
            head.append(f"{k}: {v}")
        head.append("Connection: close" if close else "Connection: keep-alive")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()


def make_rest_server(backend: str, role: str, store, batcher, host: str = "127.0.0.1",
                     port: int = 0, **app_kwargs):
    """The REST backend ``serve.http_backend`` names (keto_tpu/driver/
    daemon.py:33-47): ``async`` (the reference's default) the asyncio
    reactor, ``threading`` the stdlib thread-per-connection server."""
    if backend == "threading":
        return RestServer(role, store, batcher, host, port, **app_kwargs)
    if backend == "async":
        return AsyncRestServer(role, store, batcher, host, port, **app_kwargs)
    raise ValueError(f"unknown serve.http_backend {backend!r} (want async|threading)")
