"""The port's asyncio REST backend (keto_tpu_torch/servers/async_rest.py) on
the CPU: the protocol cases of tests/test_async_rest.py — keep-alive reuse,
an idle keep-alive connection that must not hang ``stop()``, chunked and
HEAD requests refused with correct framing, ``Connection: close`` honored,
an oversized body refused, a malformed head dropped — and the
``serve.http_backend`` selection; then the reference parity scripts of
tests/test_torch_rest.py (the tuple API) through both of the port's
backends, each held against the reference's servers: equal status and
body."""

from __future__ import annotations

import http.client
import json
import socket
import time

import pytest
from test_torch_rest import _SCRIPTS, _req

from keto_tpu_torch.config import Config
from keto_tpu_torch.driver.daemon import Daemon, role_server
from keto_tpu_torch.driver.registry import Registry
from keto_tpu_torch.servers.async_rest import AsyncRestServer, make_rest_server
from keto_tpu_torch.servers.rest import READ, WRITE, RestServer


def _registry(**keys):
    return Registry(Config(overrides={"namespaces": [{"id": 0, "name": "videos"}], **keys},
                           env={}), device="cpu")


@pytest.fixture
def servers():
    reg = _registry()
    read = role_server(reg, READ, backend="async")
    write = role_server(reg, WRITE, backend="async")
    read.start()
    write.start()
    yield read, write
    read.stop()
    write.stop()
    reg.close()


def test_keep_alive_reuses_one_connection(servers):
    read, write = servers
    assert isinstance(read, AsyncRestServer)
    conn = http.client.HTTPConnection("127.0.0.1", write.port)
    try:
        for i in range(5):
            body = json.dumps({"namespace": "videos", "object": f"v{i}", "relation": "view",
                               "subject_id": "alice"})
            conn.request("PUT", "/relation-tuples", body=body)
            resp = conn.getresponse()
            assert resp.status == 201
            resp.read()
            assert resp.headers.get("Connection") == "keep-alive"
        assert conn.sock is not None  # the same socket served all five
    finally:
        conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", read.port)
    try:
        conn.request("GET", "/check?namespace=videos&object=v1&relation=view&subject_id=alice"
                     "&latest=true")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["allowed"] is True
        conn.request("GET", "/check?namespace=videos&object=v1&relation=view&subject_id=bob")
        resp = conn.getresponse()
        assert resp.status == 403
        resp.read()
    finally:
        conn.close()


def test_stop_with_idle_keepalive_connection():
    """``stop()`` does not hang on an idle keep-alive connection."""
    reg = _registry()
    srv = role_server(reg, READ, backend="async")
    srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port)
    try:
        conn.request("GET", "/health/alive")
        conn.getresponse().read()  # keep-alive: the socket stays open and idle
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 4.5, "stop() hung on an idle connection"
    finally:
        conn.close()
        reg.close()


def test_chunked_and_head_rejected_with_framing(servers):
    read, _ = servers
    s = socket.create_connection(("127.0.0.1", read.port), timeout=10)
    try:
        s.sendall(b"POST /check HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n")
        assert b"501" in s.recv(4096).split(b"\r\n", 1)[0]
    finally:
        s.close()
    conn = http.client.HTTPConnection("127.0.0.1", read.port)
    try:
        conn.request("HEAD", "/health/alive")
        resp = conn.getresponse()
        assert resp.status == 501 and resp.read() == b""
    finally:
        conn.close()


def test_connection_close_honored(servers):
    read, _ = servers
    conn = http.client.HTTPConnection("127.0.0.1", read.port)
    try:
        conn.request("GET", "/health/alive", headers={"Connection": "close"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.headers.get("Connection") == "close"
        resp.read()
    finally:
        conn.close()


def test_oversized_body_rejected(servers):
    read, _ = servers
    s = socket.create_connection(("127.0.0.1", read.port), timeout=10)
    try:
        s.sendall(b"POST /check HTTP/1.1\r\nHost: x\r\nContent-Length: 99999999999\r\n\r\n")
        assert b"413" in s.recv(4096).split(b"\r\n", 1)[0]
    finally:
        s.close()


def test_malformed_request_drops_quietly(servers):
    read, _ = servers
    s = socket.create_connection(("127.0.0.1", read.port), timeout=10)
    try:
        s.sendall(b"garbage\r\n\r\n")
        assert s.recv(4096) == b""  # closed, no crash
    finally:
        s.close()
    conn = http.client.HTTPConnection("127.0.0.1", read.port)
    try:
        conn.request("GET", "/health/alive")
        assert conn.getresponse().status == 200
    finally:
        conn.close()


def test_backend_config_selection():
    reg = _registry(**{"serve.http_backend": "threading"})
    try:
        srv = role_server(reg, READ)
        assert isinstance(srv, RestServer)
        srv.httpd.server_close()  # bound in __init__: do not leak the socket
    finally:
        reg.close()
    reg = _registry()
    try:
        srv = role_server(reg, READ)
        assert isinstance(srv, AsyncRestServer)
        srv.stop()  # never started: releases the handler pools
    finally:
        reg.close()
    with pytest.raises(ValueError, match="http_backend"):
        make_rest_server("epoll", READ, None, None)


@pytest.mark.parametrize("backend", ["threading", "async"])
@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_tuple_routes_answer_as_the_reference_on_both_backends(backend, script):
    """The same requests, in the same order, to the port's daemon on
    ``backend`` and to the reference's servers: equal status and body."""
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.registry import Registry as RefRegistry
    from keto_tpu.servers.rest import READ as RREAD
    from keto_tpu.servers.rest import WRITE as RWRITE
    from keto_tpu.servers.rest import RestServer as RefRestServer

    from keto_tpu_torch import namespace as tns

    mine = Daemon([tns.Namespace(id=0, name="videos"), tns.Namespace(id=1, name="groups")],
                  device="cpu", http_backend=backend)
    mine.start()
    reg = RefRegistry(RefConfig(overrides={"namespaces": [{"id": 0, "name": "videos"},
                                                          {"id": 1, "name": "groups"}]}))
    ref = {"read": RefRestServer(reg, RREAD, port=0), "write": RefRestServer(reg, RWRITE, port=0)}
    for s in ref.values():
        s.start()
    try:
        assert type(mine.read).__name__ == ("AsyncRestServer" if backend == "async"
                                            else "RestServer")
        for method, role, path, body in _SCRIPTS[script]:
            got = _req(method, getattr(mine, role).port, path, body)[:2]
            want = _req(method, ref[role].port, path, body)[:2]
            assert got == want, (method, role, path)
    finally:
        for s in ref.values():
            s.stop()
        reg.close()
        mine.stop()
