"""ctypes binding for the native (C++) tuple→graph interner.

A copy of keto_tpu/graph/native.py over the port's own copy of the C++
(``keto_tpu_torch/native/ingest.cpp``, byte for byte the reference's
``native/ingest.cpp``), built with g++ at first use by
``keto_tpu_torch._build.host_lib`` — never the reference's ``native/*.so``.
It implements the same interning contract as ``interner.intern_rows``
(same node-id assignment order, same wildcard-expansion edges, same
dedup), parsing the rows in one native pass and keeping the string tables
resident so per-query resolution stays in C++.

Unlike the reference, loading is not opportunistic: a failed build or
load raises, and no environment variable turns the native path off. The
only way back to the Python interner is the reference's own: rows whose
strings defeat both native encodings (``native_intern_rows`` returns
None; ``snapshot.intern_snapshot_rows`` then interns in Python and counts
it in ``COUNTERS``). The store's sorted column bundle interns through
``native_intern_columns`` (UCS4 cells decoded in C++ straight out of the
numpy buffers); a bundle with an embedded NUL code point goes back to the
rows, counted as ``columns_refused``. The chunk-fed ``NativeStreamBuilder``
interns scan chunks on a C++ worker pool (graph/stream_build.py); a chunk
whose framing fails kills the stream, and the caller replays its chunks in
Python (``stream_replays``).

Lifetime: a ``NativeInterned`` owns its C++ handle and frees it in
``__del__``. Every native call runs inside one of its methods, which
holds a reference to the object for the call's length, so no call can
outlive ``graph_free`` even though ctypes releases the GIL during it.
"""

from __future__ import annotations

import ctypes
from operator import attrgetter
from typing import Iterable, Optional

import numpy as np

from keto_tpu_torch import _build

_FIELD = b"\x1f"
_RECORD = b"\x1e"

#: interns per path since process start: ``native`` (the C++ interner
#: over rows, ``native_intern_rows``), ``python`` (a snapshot's rows whose
#: strings defeat both native encodings, the reference's fallback, counted
#: by ``snapshot.intern_snapshot_rows``), ``columns`` (the store's column
#: bundle), ``columns_refused`` (a bundle ``native_intern_columns`` would
#: not take: an embedded NUL code point or a non-``U`` column), ``stream``
#: (a chunk-fed ``NativeStreamBuilder`` build) and ``stream_replays`` (a
#: stream killed by a chunk's framing, its chunks replayed in Python)
COUNTERS = {"native": 0, "python": 0, "columns": 0, "columns_refused": 0, "stream": 0,
            "stream_replays": 0}

_PI64 = ctypes.POINTER(ctypes.c_int64)


def encode_row(r) -> bytes:
    """One InternalRow-shaped row in the parser's record format (the
    single Python-side definition of the wire encoding)."""
    if r.subject_id is not None:
        sub = b"1" + _FIELD + r.subject_id.encode() + _FIELD + _FIELD
    else:
        sub = (
            b"0" + _FIELD + str(r.sset_namespace_id).encode() + _FIELD
            + r.sset_object.encode() + _FIELD + r.sset_relation.encode()
        )
    return (
        str(r.namespace_id).encode() + _FIELD + r.object.encode() + _FIELD
        + r.relation.encode() + _FIELD + sub + _RECORD
    )


def pack_rows(rows: list) -> bytes:
    """Serialize rows into the parser's buffer format."""
    return b"".join(encode_row(r) for r in rows)


class NativeInterned:
    """Drop-in for ``InternedGraph``: same arrays and resolution interface,
    backed by the resident C++ intern tables."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._handle = handle
        self.num_sets = int(lib.graph_num_sets(handle))
        self.num_leaves = int(lib.graph_num_leaves(handle))
        n_edges = int(lib.graph_num_edges(handle))
        self.src = np.empty(n_edges, np.int64)
        self.dst = np.empty(n_edges, np.int64)
        if n_edges:
            lib.graph_edges(handle, self.src.ctypes.data_as(_PI64),
                            self.dst.ctypes.data_as(_PI64))
        lib.graph_release_edges(handle)  # numpy owns the copies now
        self.key_ns = np.empty(self.num_sets, np.int64)
        self.key_obj = np.empty(self.num_sets, np.int64)
        self.key_rel = np.empty(self.num_sets, np.int64)
        self.key_wild = np.empty(self.num_sets, np.uint8)
        if self.num_sets:
            lib.graph_keys(
                handle,
                self.key_ns.ctypes.data_as(_PI64),
                self.key_obj.ctypes.data_as(_PI64),
                self.key_rel.ctypes.data_as(_PI64),
                self.key_wild.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        self.key_wild = self.key_wild.astype(bool)

    @property
    def num_nodes(self) -> int:
        return self.num_sets + self.num_leaves

    def num_obj_codes(self) -> int:
        """Size of the object-string code table (``ExtendedInterned``
        assigns fresh codes above it)."""
        return int(self._lib.graph_num_obj_codes(self._handle))

    def num_rel_codes(self) -> int:
        return int(self._lib.graph_num_rel_codes(self._handle))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and self._handle:
            lib.graph_free(self._handle)
            self._handle = None

    def resolve_set(self, ns_id: int, obj: str, rel: str) -> int:
        o, r = obj.encode(), rel.encode()
        return int(self._lib.graph_resolve_set(self._handle, ns_id, o, len(o), r, len(r)))

    def resolve_queries(self, buf: bytes, n: int):
        """Bulk literal-query resolution: ``buf`` packs ``n`` records in the
        row wire format (kind 1: f0 = subject id; kind 0: subject set).
        Returns ``(start_raw, sub_raw)`` int64 arrays (-1 = not present;
        leaf subjects offset by num_sets), or None when the parser rejects
        the buffer's framing."""
        start = np.empty(n, np.int64)
        sub = np.empty(n, np.int64)
        rc = self._lib.graph_resolve_queries(
            self._handle, buf, len(buf), n,
            start.ctypes.data_as(_PI64), sub.ctypes.data_as(_PI64),
        )
        if rc != 0:
            return None
        return start, sub

    def resolve_leaf(self, subject_id: str) -> int:
        s = subject_id.encode()
        return int(self._lib.graph_resolve_leaf(self._handle, s, len(s)))

    def obj_code(self, s: str) -> int:
        b = s.encode()
        return int(self._lib.graph_obj_code(self._handle, b, len(b)))

    def rel_code(self, s: str) -> int:
        b = s.encode()
        return int(self._lib.graph_rel_code(self._handle, b, len(b)))

    # -- reverse lookups (expand-tree reconstruction, compaction) -----------

    def _str_at(self, fn_name: str, idx: int) -> str:
        n = ctypes.c_int64()
        ptr = getattr(self._lib, fn_name)(self._handle, idx, ctypes.byref(n))
        if not ptr:
            raise IndexError(f"{fn_name}({idx}) out of range")
        return ctypes.string_at(ptr, n.value).decode()

    def set_key_of(self, raw_id: int):
        """``(ns_id, object, relation)`` of set node ``raw_id``: field
        codes from the resident key arrays, strings from the C tables."""
        return (
            int(self.key_ns[raw_id]),
            self._str_at("graph_obj_str", int(self.key_obj[raw_id])),
            self._str_at("graph_rel_str", int(self.key_rel[raw_id])),
        )

    def leaf_str(self, idx: int) -> str:
        """Subject-id string of leaf ``idx`` (not offset by num_sets)."""
        return self._str_at("graph_leaf_str", idx)


def _string_column(strs: list) -> Optional[tuple[bytes, np.ndarray, np.ndarray]]:
    """(utf-8 blob, byte starts, byte lens) for a string column, built in
    a handful of vectorized passes (no per-row Python encode). Joins on
    NUL: multi-byte UTF-8 never contains a 0x00 byte, so separator
    positions are exactly the zero bytes of the encoded blob. None when a
    string embeds NUL (the packed-buffer path takes those rows)."""
    n = len(strs)
    if n == 0:
        return b"", np.zeros(0, np.int64), np.zeros(0, np.int64)
    joined = "\x00".join(strs)
    if joined.count("\x00") != n - 1:
        return None
    blob = joined.encode()
    seps = np.nonzero(np.frombuffer(blob, np.uint8) == 0)[0]
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = seps + 1
    ends = np.empty(n, np.int64)
    ends[:-1] = seps
    ends[-1] = len(blob)
    return blob, starts, ends - starts


def native_intern_rows_columnar(lib, rows: list, wild_ns_ids) -> Optional[NativeInterned]:
    """Intern ``InternalRow``s (they have ``namespace_id``) through the
    columnar entry point: five string columns, no per-row encode. None
    when a string embeds NUL."""
    n = len(rows)
    # C-speed column extraction: one attrgetter map per column
    ns = np.fromiter(map(attrgetter("namespace_id"), rows), np.int64, n)
    col_sid = list(map(attrgetter("subject_id"), rows))
    kind = np.fromiter((s is not None for s in col_sid), np.uint8, n)
    sns = np.fromiter(
        (v if v is not None else 0 for v in map(attrgetter("sset_namespace_id"), rows)),
        np.int64,
        n,
    )
    cols = []
    for attr, none_ok in (
        ("object", False), ("relation", False), ("subject_id", True),
        ("sset_object", True), ("sset_relation", True),
    ):
        vals = col_sid if attr == "subject_id" else list(map(attrgetter(attr), rows))
        if none_ok:
            # `or ""` maps None→"" and keeps "" as-is (the only falsy str)
            vals = [v or "" for v in vals]
        col = _string_column(vals)
        if col is None:
            return None
        cols.append(col)

    wild = np.asarray(sorted(wild_ns_ids), np.int64)
    args = [n, ns.ctypes.data_as(_PI64), kind.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sns.ctypes.data_as(_PI64)]
    for blob, starts, lens in cols:
        args += [blob, starts.ctypes.data_as(_PI64), lens.ctypes.data_as(_PI64)]
    args += [wild.ctypes.data_as(_PI64), len(wild)]
    handle = lib.graph_build_columnar(*args)
    if not handle:
        raise RuntimeError("graph_build_columnar returned no graph")
    return NativeInterned(lib, handle)


def _ucs4_ok(arr: np.ndarray) -> bool:
    """True when every cell's NUL padding is trailing-only: an embedded
    NUL code point would truncate in the C++ decoder (NUL is the pad)."""
    if arr.dtype.itemsize == 0 or arr.size == 0:
        return True
    v = arr.view(np.uint32).reshape(arr.shape[0], -1)
    if v.shape[1] <= 1:
        return True
    z = v == 0
    return not bool(np.any(z[:, :-1] & (v[:, 1:] != 0)))


def native_intern_columns(lib, columns: dict, wild_ns_ids) -> Optional[NativeInterned]:
    """Intern from the store's sorted column bundle (numpy '<U*' string
    arrays and the int/kind arrays): no per-row Python work, the C++ side
    decodes the UCS4 cells straight out of the numpy buffers. None (counted
    as ``columns_refused``) when a string column is not ``U`` or holds an
    embedded NUL code point; the caller interns the rows instead."""
    n = int(columns["ns"].shape[0])
    str_cols = []
    for name in ("obj", "rel", "sid", "sso", "ssr"):
        arr = np.ascontiguousarray(columns[name])
        if arr.dtype.kind != "U" or not _ucs4_ok(arr):
            COUNTERS["columns_refused"] += 1
            return None
        str_cols.append(arr)
    ns = np.ascontiguousarray(columns["ns"], np.int64)
    kind = np.ascontiguousarray(columns["kind"], np.uint8)
    sns = np.ascontiguousarray(columns["sns"], np.int64)
    wild = np.asarray(sorted(wild_ns_ids), np.int64)
    args = [n, ns.ctypes.data_as(_PI64), kind.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sns.ctypes.data_as(_PI64)]
    for arr in str_cols:
        args += [arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), arr.dtype.itemsize // 4]
    args += [wild.ctypes.data_as(_PI64), len(wild)]
    handle = lib.graph_build_ucs4(*args)
    if not handle:
        raise RuntimeError("graph_build_ucs4 returned no graph")
    COUNTERS["columns"] += 1
    return NativeInterned(lib, handle)


class NativeStreamBuilder:
    """Chunk-fed native interner (``ingest.cpp``'s ``stream_build_*``).

    ``feed(rows)`` packs one scan chunk into the wire format and hands it
    to the C++ worker pool; the call returns once the chunk is queued
    (blocking briefly on the bounded queue), so the caller's next store
    fetch overlaps interning. ``finish()`` merges the per-chunk shards in
    feed order, which gives the one-shot build's first-occurrence ids.

    A chunk the packer cannot frame (a string holding a separator byte)
    kills the stream: ``feed`` returns False and the caller replays its
    chunks through the Python interner, as the reference does.
    """

    def __init__(self, lib: ctypes.CDLL, wild_ns_ids):
        self._lib = lib
        wild = np.asarray(sorted(wild_ns_ids), np.int64)
        self._handle = lib.stream_build_new(wild.ctypes.data_as(_PI64), len(wild), 0)
        self._dead = not self._handle

    @classmethod
    def create(cls, wild_ns_ids) -> "NativeStreamBuilder":
        """A fresh builder on the port's host library; raises when the
        library cannot be built or loaded or refuses the builder."""
        sb = cls(_build.host_lib(), wild_ns_ids)
        if sb._dead:
            raise RuntimeError("stream_build_new returned no builder")
        return sb

    def feed(self, rows: list) -> bool:
        """Queue one chunk; False when the stream is unusable (a framing
        rejection, or an earlier malformed chunk)."""
        if self._dead:
            return False
        buf = pack_rows(rows)
        if buf.count(_FIELD) != 6 * len(rows) or buf.count(_RECORD) != len(rows):
            self.abort()
            return False
        if self._lib.stream_build_feed(self._handle, buf, len(buf), len(rows)) != 0:
            self.abort()
            return False
        return True

    def finish(self) -> Optional[NativeInterned]:
        """Join the workers and merge; None when the stream died (the
        caller interns its chunks in Python)."""
        if self._dead:
            return None
        handle = self._lib.stream_build_finish(self._handle)
        self._handle = None
        self._dead = True
        if not handle:
            return None
        return NativeInterned(self._lib, handle)

    def abort(self) -> None:
        if not self._dead:
            self._lib.stream_build_abort(self._handle)
            self._handle = None
            self._dead = True


def native_intern_rows(rows: Iterable, wild_ns_ids=frozenset()) -> Optional[NativeInterned]:
    """Native counterpart of ``intern_rows``. ``InternalRow``s go through the
    columnar entry point; rows it cannot take (a string with NUL, or rows
    without ``namespace_id``) through the packed buffer. None when the
    buffer's framing is unsafe too (a string holds NUL and a separator
    byte): the caller interns in Python, as the reference does."""
    lib = _build.host_lib()
    if not isinstance(rows, list):
        rows = list(rows)
    if rows and hasattr(rows[0], "namespace_id"):
        got = native_intern_rows_columnar(lib, rows, wild_ns_ids)
        if got is not None:
            COUNTERS["native"] += 1
            return got
    buf = pack_rows(rows)
    # strings holding the separator bytes would corrupt the framing,
    # detectable as a field-count mismatch
    if buf.count(_FIELD) != 6 * len(rows) or buf.count(_RECORD) != len(rows):
        return None
    wild = np.asarray(sorted(wild_ns_ids), np.int64)
    handle = lib.graph_build(buf, len(buf), wild.ctypes.data_as(_PI64), len(wild))
    if not handle:
        return None  # the parser rejected the buffer
    COUNTERS["native"] += 1
    return NativeInterned(lib, handle)
