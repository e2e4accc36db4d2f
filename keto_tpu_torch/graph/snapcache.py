"""Persistent snapshot cache: versioned on-disk layout, mmap reload.

A copy of keto_tpu/graph/snapcache.py at FORMAT_VERSION 6: the port writes
the same files as the reference (array by array and in ``meta.json``), so
each can load a cache the other wrote. A cold start otherwise re-ingests
every tuple and rebuilds the device layout and the 2-hop labels before the
label route answers. This module serializes a built ``GraphSnapshot`` (CSR
arrays, bucket matrices, interner tables, pattern-key columns, the label
arrays) into a directory of raw ``.npy``/blob files keyed by
``(format_version, watermark)`` and reloads it with ``numpy``
memory-mapping: the arrays page in lazily. The engine then catches up from
the cached watermark through the ordinary delta path
(keto_tpu_torch/graph/overlay.py) — the watermark doubles as the
snaptoken, so the cache key IS the consistency token.

Layout (one directory per cached snapshot, written to a temp dir and
renamed into place — a crashed save can never leave a half-readable
cache):

    <cache_dir>/v<FORMAT>-w<watermark>/
        meta.json            scalars, bucket geometry, wild_ns_ids, the
                             segment manifest (size + crc32) and groups
        raw2dev.npy fwd_indptr.npy fwd_indices.npy
        sink_indptr.npy sink_indices.npy rev_indptr.npy rev_indices.npy
        bucket_<i>.npy ...   (or bucket_<i>_s<j>.npy per shard)
        key_ns.npy key_obj.npy key_rel.npy key_wild.npy
        set_order.npy set_nsobj.npy set_rel.npy     (sorted set-key index)
        lab_out.npy lab_in.npy lab_processed.npy lab_out_ok.npy lab_in_ok.npy
        {obj,rel,leaf}_blob.bin {obj,rel,leaf}_off.npy
        {obj,rel,leaf}_hash.npy {obj,rel,leaf}_hord.npy

The interner reloads as a ``CachedInterned``: string→code resolution runs
as a crc32 probe into the sorted hash column (verified against the blob —
collisions are handled, not assumed away), set-key resolution as two
binary searches over the lexsorted ``(ns<<32|obj_code, rel_code)``
columns. No dict is ever materialized. The native bulk-resolution entry
point is absent on a cached interner, as in the reference
(keto_tpu/graph/snapcache.py:33-35); the engine resolves through its host
loop until the next full build.

Arrays reloaded from one file per segment are read-only memory maps:
whatever writes a host array in place works on a copy
(keto_tpu_torch/graph/carry.py ``host_tensor`` for every upload).

Where the port departs from the reference: ``load_latest`` quarantines a
``CacheCorrupt`` cache and moves past one it cannot read (``OSError``),
as the reference does, but lets every other error raise — a failed K8
launch in the list-layout re-derivation among them — where the reference
catches every ``Exception`` and tries the next cache
(keto_tpu/graph/snapcache.py:777-780): a failing kernel must not turn
into a silent full rebuild. A ``stats`` sink with ``set_gauge`` gets the
loaded buckets' bytes as ``cache_loaded_bytes`` (snapcache.py:770-775).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from keto_tpu_torch.graph.device_build import shard_row_ranges
from keto_tpu_torch.graph.interner import ExtendedInterned, InternedGraph
from keto_tpu_torch.graph.labels import LabelIndex
from keto_tpu_torch.graph.snapshot import Bucket, GraphSnapshot, build_list_layouts

#: bump when the on-disk layout or the snapshot's array semantics change —
#: the version is part of the directory key, so old caches are simply
#: never matched (and pruned as newer saves land — retention is
#: format-version-aware, see ``_prune``). v2: per-segment checksums in
#: meta.json + fsync-before-rename durability. v3: 2-hop reachability
#: label arrays (keto_tpu_torch/graph/labels.py) ride along, so a cold start
#: skips label construction too. v4: reverse-query orientations
#: (transposed CSR). v5: SEGMENTED layout — segments are grouped by the
#: pipeline stage that produces them (``meta.json`` ``groups``), written
#: in stage order at save time and verified+mapped in parallel at load,
#: so a mesh cold-starts shards concurrently and a single process's
#: reload is bounded by the slowest group, not the sum. v6: PER-SHARD
#: bucket segments — a sharded engine (keto_tpu_torch/parallel/sharded.py)
#: saves each bucket matrix striped by the serve-time shard row ranges
#: (``graph/device_build.shard_row_ranges`` — the same assignment the
#: upload partitions by), one ``bucket_<i>_s<j>.npy`` per shard in its
#: own ``shard<j>`` segment group, so a mesh cold start verifies and
#: loads every shard's stripe in parallel and reassembles the exact
#: single-device byte layout. Single-shard saves keep whole-file
#: buckets (and their lazy mmap reload).
FORMAT_VERSION = 6

#: caches kept per format version within a directory (newest watermarks
#: win). Retention never reaches across versions: a v(N-1) cache written
#: by the previous binary survives a vN upgrade until ITS version
#: accumulates KEEP newer caches — so a rollback (or a not-yet-upgraded
#: replica sharing the directory) always finds a loadable cache.
KEEP = 2

#: quarantined (corrupt) caches kept for forensics; older ones drop
QUARANTINE_KEEP = 2

#: segment-group of each segment file, by the pipeline stage that
#: produces it: "core" lands with the device build (CSRs, buckets,
#: renumbering), "interner" with the string tables, "reverse" with the
#: transposed orientation, "labels" with the 2-hop index. The loader
#: verifies and maps groups concurrently.
_SHARD_SEG_RE = re.compile(r"^bucket_\d+_s(\d+)\.npy$")


def _group_of(name: str) -> str:
    m = _SHARD_SEG_RE.match(name)
    if m is not None:
        return f"shard{int(m.group(1))}"
    if name.startswith(("rev_",)):
        return "reverse"
    if name.startswith("lab_"):
        return "labels"
    if name.startswith(("key_", "set_", "obj_", "rel_", "leaf_")):
        return "interner"
    return "core"


class CacheCorrupt(ValueError):
    """A cached snapshot failed its integrity verification (size or
    checksum mismatch, torn meta.json). The loader quarantines the
    directory and rebuilds — a corrupt cache must never serve wrong
    decisions, and must never crash the server either."""


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    """Flush directory metadata (the rename itself) to disk; best-effort
    on filesystems that refuse O_RDONLY fsync on directories."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _file_crc(path: Path, chunk: int = 1 << 22) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def _string_table(strings: list) -> Optional[tuple]:
    """(utf-8 blob, offsets int64[n+1], sorted crc32 hashes uint32[n],
    argsort order int64[n]) for a code-indexed string column."""
    encoded = [s.encode() for s in strings]
    n = len(encoded)
    off = np.zeros(n + 1, np.int64)
    if n:
        off[1:] = np.cumsum([len(b) for b in encoded])
    blob = b"".join(encoded)
    hashes = np.fromiter((zlib.crc32(b) for b in encoded), np.uint32, n)
    order = np.argsort(hashes, kind="stable")
    return blob, off, hashes[order], order.astype(np.int64)


def _ext_strings(codes: dict, floor: int, n: int) -> list:
    """The strings of an ``ExtendedInterned`` extension code table
    (string → code, codes from ``floor``), in code order up to ``n``."""
    out = [""] * (n - floor)
    for s, c in codes.items():
        if floor <= c < n:
            out[c - floor] = s
    return out


def _obj_strings(interned, n: int) -> list:
    """Code-indexed object-string column for any interner flavor (the C++
    interner's one code at a time through ctypes)."""
    if isinstance(interned, InternedGraph):
        out = [""] * n
        for s, c in interned.obj_codes.items():
            out[c] = s
        return out
    if isinstance(interned, ExtendedInterned):
        base = _obj_strings(interned._base, interned._obj_floor)
        return base + _ext_strings(interned._ext_obj_codes, interned._obj_floor, n)
    if isinstance(interned, CachedInterned):
        return [interned._obj_str(c) for c in range(n)]
    return [interned._str_at("graph_obj_str", c) for c in range(n)]


def _rel_strings(interned, n: int) -> list:
    if isinstance(interned, InternedGraph):
        out = [""] * n
        for s, c in interned.rel_codes.items():
            out[c] = s
        return out
    if isinstance(interned, ExtendedInterned):
        base = _rel_strings(interned._base, interned._rel_floor)
        return base + _ext_strings(interned._ext_rel_codes, interned._rel_floor, n)
    if isinstance(interned, CachedInterned):
        return [interned._rel_str(c) for c in range(n)]
    return [interned._str_at("graph_rel_str", c) for c in range(n)]


class CachedInterned:
    """InternedGraph-compatible resolution over the mmapped cache arrays.

    Implements the same interface the snapshot and engines consume
    (resolve_set/resolve_leaf/obj_code/rel_code, key arrays, reverse
    lookups) without materializing any dict — the whole point of the
    cache is an O(mmap) cold start. Lacks the native bulk
    ``resolve_queries`` entry point on purpose; the engine's host
    resolution path covers it.
    """

    def __init__(self, d: Path, meta: dict):
        self.num_sets = int(meta["num_sets"])
        self.num_leaves = int(meta["num_leaves"])
        self._n_obj = int(meta["n_obj"])
        self._n_rel = int(meta["n_rel"])
        mm = lambda name: np.load(d / name, mmap_mode="r")  # noqa: E731
        self.key_ns = mm("key_ns.npy")
        self.key_obj = mm("key_obj.npy")
        self.key_rel = mm("key_rel.npy")
        self.key_wild = np.asarray(mm("key_wild.npy")).astype(bool)
        self._set_order = mm("set_order.npy")
        self._set_nsobj = mm("set_nsobj.npy")
        self._set_rel = mm("set_rel.npy")
        self._tables = {}
        for kind in ("obj", "rel", "leaf"):
            blob = np.memmap(d / f"{kind}_blob.bin", dtype=np.uint8, mode="r") \
                if (d / f"{kind}_blob.bin").stat().st_size else np.zeros(0, np.uint8)
            self._tables[kind] = (
                blob,
                mm(f"{kind}_off.npy"),
                mm(f"{kind}_hash.npy"),
                mm(f"{kind}_hord.npy"),
            )

    @property
    def num_nodes(self) -> int:
        return self.num_sets + self.num_leaves

    def num_obj_codes(self) -> int:
        return self._n_obj

    def num_rel_codes(self) -> int:
        return self._n_rel

    # -- string tables -------------------------------------------------------

    def _str_of(self, kind: str, idx: int) -> str:
        blob, off, _, _ = self._tables[kind]
        return bytes(blob[int(off[idx]) : int(off[idx + 1])]).decode()

    def _code_of(self, kind: str, s: str) -> int:
        blob, off, hashes, order = self._tables[kind]
        b = s.encode()
        h = np.uint32(zlib.crc32(b))
        lo = int(np.searchsorted(hashes, h, "left"))
        hi = int(np.searchsorted(hashes, h, "right"))
        for k in range(lo, hi):
            i = int(order[k])
            if bytes(blob[int(off[i]) : int(off[i + 1])]) == b:
                return i
        return -1

    def _obj_str(self, code: int) -> str:
        return self._str_of("obj", code)

    def _rel_str(self, code: int) -> str:
        return self._str_of("rel", code)

    # -- resolution ----------------------------------------------------------

    def obj_code(self, s: str) -> int:
        return self._code_of("obj", s)

    def rel_code(self, s: str) -> int:
        return self._code_of("rel", s)

    def resolve_set(self, ns_id: int, obj: str, rel: str) -> int:
        oc = self.obj_code(obj)
        if oc < 0:
            return -1
        rc = self.rel_code(rel)
        if rc < 0:
            return -1
        key = (int(ns_id) << 32) | oc
        lo = int(np.searchsorted(self._set_nsobj, key, "left"))
        hi = int(np.searchsorted(self._set_nsobj, key, "right"))
        seg = self._set_rel[lo:hi]
        j = int(np.searchsorted(seg, rc, "left"))
        if j < seg.shape[0] and int(seg[j]) == rc:
            return int(self._set_order[lo + j])
        return -1

    def resolve_leaf(self, subject_id: str) -> int:
        return self._code_of("leaf", subject_id)

    # -- reverse lookups -----------------------------------------------------

    def set_key_of(self, raw_id: int):
        return (
            int(self.key_ns[raw_id]),
            self._str_of("obj", int(self.key_obj[raw_id])),
            self._str_of("rel", int(self.key_rel[raw_id])),
        )

    def leaf_str(self, idx: int) -> str:
        return self._str_of("leaf", idx)


def save_snapshot(
    snap: GraphSnapshot, cache_dir: str, shards: int = 1, labels_wait=None,
    timings: Optional[dict] = None,
) -> Optional[str]:
    """Serialize ``snap`` under ``cache_dir``; returns the cache path, or
    None when the snapshot isn't cacheable (pending overlay, an interner
    without code-table sizes, or key codes outside the packed-index
    range). Atomic: written to a temp dir and renamed into place.

    ``shards > 1`` (the sharded engine passes its graph-axis count)
    stripes each bucket matrix into per-shard row segments along the
    serve-time shard assignment, so a mesh cold start loads shards in
    parallel; reassembly is byte-identical to the single-file layout.

    ``labels_wait`` is called right before the label segments are read:
    the engine overlaps its label build with this save and passes a join
    so an in-flight index still lands in the cache instead of being
    silently dropped (a warm reload would otherwise rebuild it).

    ``timings`` (a dict, optional) receives the save's seconds by part:
    ``arrays_s`` (the array segments), ``labels_wait_s``, ``strings_s``
    (the string tables), ``manifest_s`` (fsync and crc32 of every segment,
    the rename), ``seconds`` in all, and ``bytes`` (the segments' sum)."""
    t_start = time.monotonic()
    parts = {"arrays_s": 0.0, "labels_wait_s": 0.0, "strings_s": 0.0, "manifest_s": 0.0}
    if snap.has_overlay:
        return None
    shards = max(1, int(shards))
    interned = snap.interned
    n_obj = getattr(interned, "num_obj_codes", lambda: None)()
    n_rel = getattr(interned, "num_rel_codes", lambda: None)()
    if n_obj is None or n_rel is None:
        return None
    key_ns = np.asarray(interned.key_ns, np.int64)
    key_obj = np.asarray(interned.key_obj, np.int64)
    key_rel = np.asarray(interned.key_rel, np.int64)
    if key_ns.size and (
        int(key_ns.min()) < 0
        or int(key_ns.max()) >= 1 << 31
        or int(key_obj.max()) >= 1 << 32
    ):
        return None  # outside the (ns<<32|obj) packed-index range

    base = Path(cache_dir)
    tag = f"v{FORMAT_VERSION}-w{snap.snapshot_id}"
    final = base / tag
    if final.exists():
        return str(final)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f".tmp-{tag}-{os.getpid()}-{threading.get_ident()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    n_bytes = 0
    try:
        t0 = time.monotonic()
        sv = lambda name, arr: np.save(tmp / name, np.ascontiguousarray(arr))  # noqa: E731
        sv("raw2dev", snap.raw2dev)
        sv("fwd_indptr", snap.fwd_indptr)
        sv("fwd_indices", snap.fwd_indices)
        sv("sink_indptr", snap.sink_indptr)
        sv("sink_indices", snap.sink_indices)
        # both reverse-query orientations persist (FORMAT_VERSION 4): the
        # transposed CSR reloads mmap'd; the bucketed list layouts are
        # re-derived from the forward CSR at load (cheap, deterministic)
        if snap.rev_indptr is not None:
            sv("rev_indptr", snap.rev_indptr)
            sv("rev_indices", snap.rev_indices)
        if shards > 1:
            # per-shard bucket stripes: rows split by the SERVE-TIME
            # shard ownership (graph/device_build.shard_row_ranges over
            # the global bitmap rows — bucket rows are contiguous bitmap
            # rows starting at the bucket offset); the last stripe also
            # carries the bucket's pow2 padding rows so concatenating
            # stripes in shard order reproduces the exact matrix
            ranges = shard_row_ranges(snap.num_int + 1, shards)
            rps = max(1, ranges[0][1] - ranges[0][0])
            for i, b in enumerate(snap.buckets):
                nbrs = np.asarray(b.nbrs)
                n_pad = nbrs.shape[0]
                cuts = [0]
                for s in range(shards - 1):
                    cuts.append(
                        int(np.clip((s + 1) * rps - b.offset, 0, b.n))
                    )
                cuts.append(n_pad)
                for s in range(shards):
                    sv(f"bucket_{i}_s{s}", nbrs[cuts[s] : cuts[s + 1]])
        else:
            for i, b in enumerate(snap.buckets):
                sv(f"bucket_{i}", b.nbrs)
        sv("key_ns", key_ns)
        sv("key_obj", key_obj)
        sv("key_rel", key_rel)
        sv("key_wild", np.asarray(interned.key_wild).astype(np.uint8))
        # lexsorted set-key index: (ns<<32|obj_code) with rel_code minor
        order = np.lexsort((key_rel, key_obj, key_ns))
        sv("set_order", order.astype(np.int64))
        sv("set_nsobj", (key_ns[order] << 32) | key_obj[order])
        sv("set_rel", key_rel[order])
        # 2-hop label arrays (overlay-free snapshots only reach a save, so
        # a present index is exactly the base graph's): the segment
        # manifest below covers them like every other array, and a
        # corrupted label segment quarantines the whole cache
        parts["arrays_s"] += time.monotonic() - t0
        if labels_wait is not None:
            t0 = time.monotonic()
            labels_wait()  # join an overlapped label build before reading
            parts["labels_wait_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        lab_meta = None
        idx = snap.labels
        if idx is not None:
            sv("lab_out", idx.out_lab)
            sv("lab_in", idx.in_lab)
            sv("lab_processed", idx.processed.astype(np.uint8))
            sv("lab_out_ok", idx.out_ok.astype(np.uint8))
            sv("lab_in_ok", idx.in_ok.astype(np.uint8))
            lab_meta = {
                "n": int(idx.n),
                "max_width": int(idx.max_width),
                "n_landmarks": int(idx.n_landmarks),
                "n_entries": int(idx.n_entries),
                "backend": str(idx.backend),
            }
        parts["arrays_s"] += time.monotonic() - t0
        t0 = time.monotonic()
        for kind, strings in (
            ("obj", _obj_strings(interned, n_obj)),
            ("rel", _rel_strings(interned, n_rel)),
            ("leaf", [interned.leaf_str(i) for i in range(interned.num_leaves)]),
        ):
            blob, off, hashes, order = _string_table(strings)
            (tmp / f"{kind}_blob.bin").write_bytes(blob)
            sv(f"{kind}_off", off)
            sv(f"{kind}_hash", hashes)
            sv(f"{kind}_hord", order)
        parts["strings_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        # per-segment integrity manifest: size + crc32 of every data file,
        # read back from disk so the checksum covers what actually landed.
        # The loader verifies before serving — a torn write (crash or
        # power loss mid-save that somehow survived the atomic-rename
        # protocol, bit rot, a truncating copy) is DETECTED and the cache
        # quarantined instead of silently yielding wrong decisions.
        segments = {}
        groups: dict[str, list] = {}
        for f in sorted(tmp.iterdir()):
            _fsync_file(f)  # durable before the rename publishes them
            segments[f.name] = {
                "size": f.stat().st_size,
                "crc32": _file_crc(f),
            }
            groups.setdefault(_group_of(f.name), []).append(f.name)
        n_bytes = sum(v["size"] for v in segments.values())
        meta = {
            "format": FORMAT_VERSION,
            "watermark": int(snap.snapshot_id),
            "wild_ns_ids": sorted(int(i) for i in snap.wild_ns_ids),
            "num_sets": int(interned.num_sets),
            "num_leaves": int(interned.num_leaves),
            "num_active": int(snap.num_active),
            "num_int": int(snap.num_int),
            "num_live": int(snap.num_live),
            "n_peeled": int(snap.n_peeled),
            "buckets": [{"offset": int(b.offset), "n": int(b.n)} for b in snap.buckets],
            "shards": shards,
            "n_obj": int(n_obj),
            "n_rel": int(n_rel),
            "labels": lab_meta,
            "segments": segments,
            "groups": groups,
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        _fsync_file(tmp / "meta.json")
        _fsync_dir(tmp)
        try:
            os.replace(tmp, final)
        except OSError:
            if not final.exists():
                raise
            # a concurrent saver landed the same watermark first — theirs
            # is identical; drop ours
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            # the rename is only durable once the parent directory is —
            # an acknowledged cache must survive the machine dying now
            _fsync_dir(base)
        parts["manifest_s"] = time.monotonic() - t0
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(base, keep=KEEP)
    if timings is not None:
        timings.update(parts, seconds=time.monotonic() - t_start, bytes=n_bytes)
    return str(final)


def export_manifest(cache_dir: str, max_watermark: Optional[int] = None) -> Optional[dict]:
    """Segment listing of the newest CURRENT-format cache under
    ``cache_dir`` with watermark ≤ ``max_watermark`` — the
    ``GET /snapshot/export`` manifest a replica mirrors segments from
    (ROADMAP A10 serves it). Returns ``{"tag", "watermark",
    "format_version", "segments": [{"name", "size", "crc32"}, …]}`` with
    ``meta.json`` itself included (crc32 null — its integrity is the
    loader's JSON parse + the per-segment checksums it declares), or
    None when no loadable-by-this-binary cache exists."""
    base = Path(cache_dir)
    if not cache_dir or not base.is_dir():
        return None
    candidates = []
    for d in base.iterdir():
        wm = _parse_tag(d.name) if d.is_dir() else None
        if wm is None:
            continue
        if max_watermark is not None and wm > max_watermark:
            continue
        candidates.append((wm, d))
    for wm, d in sorted(candidates, reverse=True):
        try:
            meta = json.loads((d / "meta.json").read_text())
        except Exception:
            continue  # torn/in-flight save: try the next-newest
        if meta.get("format") != FORMAT_VERSION:
            continue
        segments = [
            {"name": name, "size": int(info["size"]), "crc32": int(info["crc32"])}
            for name, info in sorted(meta.get("segments", {}).items())
        ]
        segments.append(
            {
                "name": "meta.json",
                "size": (d / "meta.json").stat().st_size,
                "crc32": None,
            }
        )
        return {
            "tag": d.name,
            "watermark": int(wm),
            "format_version": FORMAT_VERSION,
            "segments": segments,
        }
    return None


def _prune(base: Path, keep: int) -> None:
    """Drop all but the ``keep`` newest caches PER FORMAT VERSION.

    Retention is format-version-aware on purpose: pruning by mtime/
    watermark across versions would let the first post-upgrade v5 save
    evict the only v4 cache — and a rollback (or a replica still running
    the previous binary against the same directory) would cold-start
    from a full rebuild. Caches of other recognized versions age out
    only against caches of their OWN version; directories that are not
    ``v<N>-w<M>``-shaped at all are junk and removed. Dot-prefixed
    entries (in-flight ``.tmp-`` saves, ``.quarantine-`` forensics) are
    managed by their own lifecycles and skipped here."""
    by_fmt: dict[int, list] = {}
    for d in base.iterdir():
        if not d.is_dir() or d.name.startswith("."):
            continue
        parsed = _parse_any_tag(d.name)
        if parsed is None:
            shutil.rmtree(d, ignore_errors=True)  # not a cache dir at all
        else:
            fmt, wm = parsed
            by_fmt.setdefault(fmt, []).append((wm, d))
    for entries in by_fmt.values():
        entries.sort(reverse=True)
        for _, d in entries[keep:]:
            shutil.rmtree(d, ignore_errors=True)


def _quarantine(d: Path, stats=None) -> None:
    """Move a corrupt/unreadable cache aside instead of deleting it (an
    operator can post-mortem the torn segment) and never serve from it
    again. Bounded: only the newest QUARANTINE_KEEP quarantines are
    kept."""
    base = d.parent
    target = base / f".quarantine-{d.name}-{os.getpid()}"
    try:
        if target.exists():
            shutil.rmtree(target, ignore_errors=True)
        os.replace(d, target)
    except OSError:
        shutil.rmtree(d, ignore_errors=True)  # rename refused — just drop it
    if stats is not None:
        stats.incr("cache_quarantined")
    quarantines = sorted(
        (q for q in base.iterdir() if q.name.startswith(".quarantine-")),
        key=lambda q: q.stat().st_mtime,
        reverse=True,
    )
    for q in quarantines[QUARANTINE_KEEP:]:
        shutil.rmtree(q, ignore_errors=True)


#: verification workers: crc32 releases the GIL on large buffers, so a
#: cold-start verify is parallel real I/O + checksum work, bounded by
#: the slowest segment group instead of the byte sum
VERIFY_WORKERS = 4


def _verify_one(d: Path, name: str, want: dict) -> None:
    f = d / name
    if not f.is_file():
        raise CacheCorrupt(f"{d.name}/{name}: segment missing")
    size = f.stat().st_size
    if size != want.get("size"):
        raise CacheCorrupt(
            f"{d.name}/{name}: size {size} != recorded {want.get('size')}"
            " (torn write?)"
        )
    crc = _file_crc(f)
    if crc != want.get("crc32"):
        raise CacheCorrupt(
            f"{d.name}/{name}: crc32 {crc:#x} != recorded "
            f"{int(want.get('crc32', 0)):#x} (corrupt segment)"
        )


def _verify_segments(d: Path, meta: dict) -> None:
    """Integrity gate: every data file must match the manifest recorded
    at save time, and no manifest entry may be missing. Segments verify
    CONCURRENTLY (the v5 segmented layout's load-side win — zlib.crc32
    releases the GIL, so checksum throughput scales with workers).
    Raises CacheCorrupt on any mismatch."""
    segments = meta.get("segments")
    if not isinstance(segments, dict):
        raise CacheCorrupt(f"{d.name}: meta.json has no segment manifest")
    items = list(segments.items())
    if len(items) <= 2:
        for name, want in items:
            _verify_one(d, name, want)
        return
    with ThreadPoolExecutor(max_workers=VERIFY_WORKERS) as pool:
        futures = [pool.submit(_verify_one, d, name, want) for name, want in items]
        for fut in futures:
            fut.result()  # first corrupt segment propagates CacheCorrupt


def _parse_tag(name: str) -> Optional[int]:
    prefix = f"v{FORMAT_VERSION}-w"
    if not name.startswith(prefix):
        return None
    try:
        return int(name[len(prefix):])
    except ValueError:
        return None


_ANY_TAG_RE = re.compile(r"^v(\d+)-w(\d+)$")


def _parse_any_tag(name: str) -> Optional[tuple[int, int]]:
    """``(format, watermark)`` for ANY version's cache directory, or
    None for non-cache junk — retention (``_prune``) must recognize
    other versions' caches without being able to load them."""
    m = _ANY_TAG_RE.match(name)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2))


def load_snapshot(path: str, verify: bool = True, sorter=None) -> GraphSnapshot:
    """Reload one cached snapshot directory (mmap — arrays page lazily).
    ``sorter`` rides into the list-layout re-derivation (the one
    compute-bound step of a reload) so a cold start can run its sorts on
    the device (keto_tpu_torch/graph/device_build.py ``GovernedSorter``).

    ``verify`` checks every segment's size and crc32 against the manifest
    recorded at save time before anything is served from the cache —
    sequential reads at crc32 throughput, still orders of magnitude
    cheaper than the ingest+build it replaces. Raises CacheCorrupt on any
    mismatch (including a torn meta.json, surfaced as the JSON error)."""
    d = Path(path)
    try:
        meta = json.loads((d / "meta.json").read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CacheCorrupt(f"{d.name}/meta.json unreadable: {e}") from None
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"cache format {meta.get('format')} != {FORMAT_VERSION}")
    if verify:
        _verify_segments(d, meta)
    interned = CachedInterned(d, meta)
    mm = lambda name: np.load(d / name, mmap_mode="r")  # noqa: E731
    n_shards = int(meta.get("shards", 1))
    if n_shards > 1:
        # per-shard stripes reassemble concurrently — the mesh cold
        # start's parallel-shard load; concatenation in shard order is
        # byte-identical to the single-file layout by construction
        def load_bucket(i):
            stripes = [mm(f"bucket_{i}_s{s}.npy") for s in range(n_shards)]
            return np.concatenate([np.asarray(a) for a in stripes], axis=0)

        with ThreadPoolExecutor(max_workers=VERIFY_WORKERS) as pool:
            nbrs_list = list(pool.map(load_bucket, range(len(meta["buckets"]))))
        buckets = [
            Bucket(offset=int(b["offset"]), n=int(b["n"]), nbrs=nbrs_list[i])
            for i, b in enumerate(meta["buckets"])
        ]
    else:
        buckets = [
            Bucket(offset=int(b["offset"]), n=int(b["n"]), nbrs=mm(f"bucket_{i}.npy"))
            for i, b in enumerate(meta["buckets"])
        ]
    labels = None
    lm = meta.get("labels")
    if lm is not None:
        labels = LabelIndex(
            n=int(lm["n"]),
            out_lab=mm("lab_out.npy"),
            in_lab=mm("lab_in.npy"),
            processed=np.asarray(mm("lab_processed.npy")).astype(bool),
            out_ok=np.asarray(mm("lab_out_ok.npy")).astype(bool),
            in_ok=np.asarray(mm("lab_in_ok.npy")).astype(bool),
            max_width=int(lm["max_width"]),
            n_landmarks=int(lm["n_landmarks"]),
            n_entries=int(lm.get("n_entries", 0)),
            backend=str(lm.get("backend", "host")),
        )
    snap = GraphSnapshot(
        snapshot_id=int(meta["watermark"]),
        num_sets=int(meta["num_sets"]),
        num_leaves=int(meta["num_leaves"]),
        num_active=int(meta["num_active"]),
        num_int=int(meta["num_int"]),
        num_live=int(meta["num_live"]),
        n_peeled=int(meta["n_peeled"]),
        buckets=buckets,
        interned=interned,
        raw2dev=mm("raw2dev.npy"),
        wild_ns_ids=frozenset(meta["wild_ns_ids"]),
        fwd_indptr=mm("fwd_indptr.npy"),
        fwd_indices=mm("fwd_indices.npy"),
        sink_indptr=mm("sink_indptr.npy"),
        sink_indices=mm("sink_indices.npy"),
        labels=labels,
    )
    # reverse-query orientations: the persisted transposed CSR mmaps;
    # the bucketed list layouts re-derive from the forward CSR (shared
    # builder — identical to a from-scratch build; with the engine's
    # GovernedSorter its sorts run on the card, K8)
    snap.rev_indptr = mm("rev_indptr.npy")
    snap.rev_indices = mm("rev_indices.npy")
    fi = np.asarray(snap.fwd_indptr)
    snap.lay_fwd, snap.lay_rev = build_list_layouts(
        fi, np.asarray(snap.fwd_indices), fi.shape[0] - 1, snap.sink_base,
        sorter=sorter,
    )
    return snap


def load_latest(
    cache_dir: str, max_watermark: Optional[int] = None, stats=None, sorter=None,
    loaded: Optional[dict] = None,
) -> Optional[GraphSnapshot]:
    """Newest loadable cache under ``cache_dir`` with watermark ≤
    ``max_watermark`` (the store's current watermark — a cache AHEAD of
    the store belongs to other data and must never serve), or None.

    A cache that fails its integrity verification is QUARANTINED (moved
    aside, counted into ``stats`` as ``cache_quarantined`` when a
    MaintenanceStats-like sink is given) and the next-newest candidate is
    tried — the recovery contract is "loads clean or is rejected", never
    wrong decisions. A cache that cannot be read (``OSError``) is passed
    over for the next. Any other error raises (a failed device sort of the
    list-layout re-derivation among them): the reference tries the next
    cache on every exception, which would hide a failing kernel behind a
    silent full rebuild.

    ``loaded`` (a dict, optional) receives the loaded cache's ``path`` and
    ``bytes`` (its segments' sum, from the manifest)."""
    base = Path(cache_dir)
    if not base.is_dir():
        return None
    candidates = []
    for d in base.iterdir():
        wm = _parse_tag(d.name) if d.is_dir() else None
        if wm is None:
            continue
        if max_watermark is not None and wm > max_watermark:
            continue
        candidates.append((wm, d))
    for _, d in sorted(candidates, reverse=True):
        try:
            snap = load_snapshot(str(d), sorter=sorter)
        except CacheCorrupt:
            _quarantine(d, stats=stats)  # rejected; rebuild path takes over
            continue
        except OSError:
            continue  # unreadable → try the next
        # the cold-start upload the governor is about to plan, surfaced at
        # load time (snapcache.py:770-775); counter-only sinks skip it
        set_gauge = getattr(stats, "set_gauge", None)
        if set_gauge is not None:
            set_gauge("cache_loaded_bytes",
                      sum(int(np.asarray(b.nbrs).nbytes) for b in snap.buckets))
        if loaded is not None:
            meta = json.loads((d / "meta.json").read_text())
            loaded.update(path=str(d), bytes=sum(int(v["size"]) for v in meta["segments"].values()))
        return snap
    return None
