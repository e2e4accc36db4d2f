"""Minimal RFC 6455 websocket client — stdlib only.

Implements exactly what the namespace watcher needs (the reference
watches namespace definitions over a watcherx websocket source,
reference internal/driver/config/namespace_watcher.go:47-88): the
client handshake, text/binary messages with fragmentation, automatic
pong replies, masked client frames, and clean close. No extensions, no
permessage-deflate.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import ssl
import struct
import urllib.parse
from typing import Optional

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WebSocketError(ConnectionError):
    pass


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a handshake key (shared with the test
    server in tests/ws_test_server.py)."""
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


class WebSocketClient:
    """One client connection. ``recv()`` returns a complete text message,
    or None when the server closes; raises ``socket.timeout`` when a
    read timeout is set (callers poll their own shutdown flag)."""

    def __init__(self, url: str, timeout: float = 10.0):
        u = urllib.parse.urlsplit(url)
        if u.scheme not in ("ws", "wss"):
            raise WebSocketError(f"not a websocket url: {url}")
        secure = u.scheme == "wss"
        port = u.port or (443 if secure else 80)
        sock = socket.create_connection((u.hostname, port), timeout=timeout)
        if secure:
            ctx = ssl.create_default_context()
            sock = ctx.wrap_socket(sock, server_hostname=u.hostname)
        self._sock = sock
        self._buf = b""
        self._partial = b""  # fragmented-message accumulator (see recv)

        key = base64.b64encode(os.urandom(16)).decode()
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        self._sock.sendall(
            (
                f"GET {path} HTTP/1.1\r\n"
                f"Host: {u.hostname}:{port}\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        head = self._read_until(b"\r\n\r\n")
        status = head.split(b"\r\n", 1)[0]
        if b" 101 " not in status + b" ":
            raise WebSocketError(f"handshake rejected: {status.decode(errors='replace')}")
        want = accept_key(key).encode()
        for line in head.split(b"\r\n")[1:]:
            k, _, v = line.partition(b":")
            if k.strip().lower() == b"sec-websocket-accept":
                if v.strip() != want:
                    raise WebSocketError("bad Sec-WebSocket-Accept")
                break
        else:
            raise WebSocketError("missing Sec-WebSocket-Accept")

    # -- plumbing ------------------------------------------------------------

    def settimeout(self, t: Optional[float]) -> None:
        self._sock.settimeout(t)

    def _read_until(self, marker: bytes) -> bytes:
        while marker not in self._buf:
            got = self._sock.recv(4096)
            if not got:
                raise WebSocketError("connection closed during handshake")
            self._buf += got
        head, self._buf = self._buf.split(marker, 1)
        return head

    def _peek_exact(self, n: int) -> None:
        """Buffer at least ``n`` bytes WITHOUT consuming. A read timeout
        raised here leaves ``_buf`` intact, so a later retry resumes at
        the same stream position — frame parsing must never consume bytes
        before the whole frame is available, or a mid-frame timeout
        desynchronizes the stream permanently."""
        while len(self._buf) < n:
            got = self._sock.recv(4096)
            if not got:
                raise WebSocketError("connection closed mid-frame")
            self._buf += got

    def _read_frame(self) -> tuple[int, bool, bytes]:
        self._peek_exact(2)
        b1, b2 = self._buf[0], self._buf[1]
        fin = bool(b1 & 0x80)
        opcode = b1 & 0x0F
        masked = bool(b2 & 0x80)
        length = b2 & 0x7F
        header = 2
        if length == 126:
            self._peek_exact(4)
            (length,) = struct.unpack(">H", self._buf[2:4])
            header = 4
        elif length == 127:
            self._peek_exact(10)
            (length,) = struct.unpack(">Q", self._buf[2:10])
            header = 10
        mask_off = header
        if masked:
            header += 4
        self._peek_exact(header + length)  # the whole frame, atomically
        mask = self._buf[mask_off : mask_off + 4] if masked else b""
        payload = self._buf[header : header + length]
        self._buf = self._buf[header + length :]
        if masked:
            payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        return opcode, fin, payload

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        # client frames MUST be masked (RFC 6455 §5.3)
        mask = os.urandom(4)
        head = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        body = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        self._sock.sendall(head + mask + body)

    # -- public API ----------------------------------------------------------

    def recv(self) -> Optional[str]:
        """Next complete text message; None once the server closes.
        Fragments accumulate on the instance so a read timeout between
        fragment frames resumes mid-message instead of dropping them."""
        while True:
            opcode, fin, payload = self._read_frame()
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                try:
                    self._send_frame(OP_CLOSE, b"")
                except OSError:
                    pass
                return None
            if opcode in (OP_TEXT, OP_BINARY, OP_CONT):
                self._partial += payload
                if fin:
                    message, self._partial = self._partial, b""
                    return message.decode("utf-8", errors="replace")

    def send(self, text: str) -> None:
        self._send_frame(OP_TEXT, text.encode())

    def close(self) -> None:
        try:
            self._send_frame(OP_CLOSE, b"")
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
