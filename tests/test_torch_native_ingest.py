"""The port's native interner (keto_tpu_torch/native/ingest.cpp behind
keto_tpu_torch/graph/native.py) against the Python interners.

The C++ must assign exactly the ids, edges and field codes of the
reference's Python ``intern_rows`` and of the port's own copy of it, at one
thread and at three (the chunked parallel interner and its merge), with
wildcard namespaces, unicode and empty strings. The host library is built
with g++ at first use into ``build/native/``; a failed build raises. The
reference's ``native/*.so`` is never loaded.
"""

from __future__ import annotations

import os
import random
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from keto_tpu_torch import _build
from keto_tpu_torch.graph import interner as port_interner
from keto_tpu_torch.graph import native
from keto_tpu_torch.graph.native import native_intern_rows
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.persistence.memory import InternalRow

ROOT = Path(__file__).resolve().parent.parent


def fuzz_rows(seed, n, row_type=InternalRow):
    """The rows of tests/test_native_ingest.py's fuzz (unicode, empty
    strings, subject sets in three namespaces)."""
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        ns = rng.choice([0, 1, 7])
        obj = rng.choice(["", "a", "b", "obj-long-name", "ünïcode-объект"])
        rel = rng.choice(["", "r", "member", "view"])
        if rng.random() < 0.5:
            rows.append(row_type(ns, obj, rel, rng.choice(["u1", "u2", "üser", ""]), None, None,
                                 None, i))
        else:
            rows.append(row_type(ns, obj, rel, None, rng.choice([0, 1, 7]),
                                 rng.choice(["", "x", "group"]), rng.choice(["", "member"]), i))
    return rows


def ref_rows(rows):
    """The same rows as the reference's InternalRow."""
    from keto_tpu.persistence.memory import InternalRow as RefRow

    return [RefRow(r.namespace_id, r.object, r.relation, r.subject_id, r.sset_namespace_id,
                   r.sset_object, r.sset_relation, r.seq) for r in rows]


def assert_interned_equal(nat, py):
    """Arrays, key ↔ id maps both ways, and the code tables, exactly."""
    assert (nat.num_sets, nat.num_leaves) == (py.num_sets, py.num_leaves)
    for k in ("src", "dst", "key_ns", "key_obj", "key_rel", "key_wild"):
        a, b = getattr(nat, k), getattr(py, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for key, i in py.set_ids.items():
        assert nat.resolve_set(*key) == i
        assert nat.set_key_of(i) == key
    for s, i in py.leaf_ids.items():
        assert nat.resolve_leaf(s) == i
        assert nat.leaf_str(i) == s
    assert nat.num_obj_codes() == py.num_obj_codes() == len(py.obj_codes)
    assert nat.num_rel_codes() == py.num_rel_codes() == len(py.rel_codes)
    for s, c in py.obj_codes.items():
        assert nat.obj_code(s) == c
    for s, c in py.rel_codes.items():
        assert nat.rel_code(s) == c
    assert nat.resolve_set(99, "no", "no") == -1 == py.resolve_set(99, "no", "no")
    assert nat.resolve_leaf("missing") == -1 == py.resolve_leaf("missing")
    assert nat.obj_code("missing") == -1 and nat.rel_code("missing") == -1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("wild_ns", [frozenset(), frozenset({7})])
@pytest.mark.parametrize("threads", ["1", "3"])
def test_native_interner_matches_python_interners(seed, wild_ns, threads, monkeypatch):
    from keto_tpu.graph.interner import intern_rows as ref_intern_rows

    # threads > 1 forces the chunked parallel interner even at this row
    # count: its merge must reproduce the serial first-occurrence ids
    monkeypatch.setenv("KETO_TPU_INGEST_THREADS", threads)
    rows = fuzz_rows(seed, 300)
    nat = native_intern_rows(rows, wild_ns)
    assert isinstance(nat, native.NativeInterned)
    assert_interned_equal(nat, ref_intern_rows(ref_rows(rows), wild_ns))
    assert_interned_equal(nat, port_interner.intern_rows(rows, wild_ns))


def test_packed_buffer_path_matches():
    """The packed buffer (graph_build: the path of rows whose strings hold
    NUL) assigns the same ids as the columnar path and Python."""
    rows = fuzz_rows(11, 200)
    buf = native.pack_rows(rows)
    assert buf == b"".join(native.encode_row(r) for r in rows)
    lib = _build.host_lib()
    wild = np.asarray([7], np.int64)
    handle = lib.graph_build(buf, len(buf), wild.ctypes.data_as(native._PI64), 1)
    assert handle
    assert_interned_equal(native.NativeInterned(lib, handle),
                          port_interner.intern_rows(rows, frozenset({7})))


def test_separator_bytes_intern_natively_with_parity():
    # 0x1F/0x1E corrupt the packed framing, but the columnar path carries
    # explicit lengths: these rows intern natively, with parity
    rows = [
        InternalRow(0, "bad\x1fobj", "r", "u\x1eser", None, None, None, 0),
        InternalRow(0, "bad\x1fobj", "r2", None, 0, "s\x1fet", "m", 1),
    ]
    nat = native_intern_rows(rows, frozenset())
    assert isinstance(nat, native.NativeInterned)
    assert_interned_equal(nat, port_interner.intern_rows(rows, frozenset()))


def test_nul_bytes_take_the_packed_buffer():
    # NUL separates the columnar blobs, so such rows take the packed
    # parser (where NUL is an ordinary byte), with parity
    rows = [InternalRow(0, "bad\x00obj", "r", "u", None, None, None, 0)]
    nat = native_intern_rows(rows, frozenset())
    assert isinstance(nat, native.NativeInterned)
    assert_interned_equal(nat, port_interner.intern_rows(rows, frozenset()))


def test_nul_and_separator_take_the_python_interner_and_count():
    """A string holding NUL and a separator byte defeats both native
    encodings: ``build_snapshot`` interns in Python (the reference's only
    fallback) and counts it; every other build counts as native."""
    from keto_tpu.graph.snapshot import build_snapshot as ref_build

    from test_torch_snapshot import assert_snapshots_equal

    bad = [InternalRow(0, "bad\x00\x1fobj", "r", "u", None, None, None, 0),
           InternalRow(0, "o", "r", None, 0, "bad\x00\x1fobj", "r", 1)]
    assert native_intern_rows(bad, frozenset()) is None
    before = dict(native.COUNTERS)
    snap = build_snapshot(bad, 5)
    assert native.COUNTERS["python"] == before["python"] + 1
    assert native.COUNTERS["native"] == before["native"]
    assert isinstance(snap.interned, port_interner.InternedGraph)
    assert_snapshots_equal(snap, ref_build(ref_rows(bad), 5))

    good = fuzz_rows(2, 100)
    snap = build_snapshot(good, 5, frozenset({7}))
    assert native.COUNTERS["native"] == before["native"] + 1
    assert native.COUNTERS["python"] == before["python"] + 1
    assert isinstance(snap.interned, native.NativeInterned)


def test_empty_and_out_of_range():
    nat = native_intern_rows([], frozenset())
    assert nat is not None and nat.num_nodes == 0 and nat.src.size == 0
    nat = native_intern_rows(fuzz_rows(0, 20), frozenset())
    with pytest.raises(IndexError):
        nat.leaf_str(nat.num_leaves)
    with pytest.raises(IndexError):
        nat.leaf_str(-1)


def test_resolve_queries_matches_single_lookups():
    """The bulk entry point resolves every record as resolve_set and
    resolve_leaf do (leaves offset by num_sets), and rejects a buffer whose
    framing is off."""
    rows = fuzz_rows(3, 300)
    nat = native_intern_rows(rows, frozenset())
    rng = random.Random(3)
    recs, want_start, want_sub = [], [], []
    for _ in range(200):
        ns = rng.choice([0, 1, 7, 9])
        obj = rng.choice(["a", "b", "obj-long-name", "ünïcode-объект", "zz"])
        rel = rng.choice(["r", "member", "view", "nope"])
        if rng.random() < 0.5:
            sid = rng.choice(["u1", "u2", "üser", "ghost"])
            recs.append(native.encode_row(InternalRow(ns, obj, rel, sid, None, None, None, 0)))
            leaf = nat.resolve_leaf(sid)
            want_sub.append(leaf + nat.num_sets if leaf >= 0 else -1)
        else:
            key = (rng.choice([0, 1, 7]), rng.choice(["x", "group", "q"]),
                   rng.choice(["", "member"]))
            recs.append(native.encode_row(InternalRow(ns, obj, rel, None, *key, 0)))
            want_sub.append(nat.resolve_set(*key))
        want_start.append(nat.resolve_set(ns, obj, rel))
    start, sub = nat.resolve_queries(b"".join(recs), len(recs))
    assert start.tolist() == want_start and sub.tolist() == want_sub
    assert nat.resolve_queries(b"".join(recs), len(recs) + 1) is None
    assert nat.resolve_queries(b"".join(recs)[:-1], len(recs)) is None


# -- the build ---------------------------------------------------------------


def test_library_is_built_from_the_port_sources():
    """The loaded library is the port's, under build/native/, named by a
    hash over its own sources; the reference's native/*.so is never
    mapped into the process."""
    lib = _build.host_lib()
    path = _build.host_library_path()
    assert Path(lib._name) == path and path.exists()
    assert path.parent == ROOT / "build" / "native"
    assert [p.name for p in _build.host_sources()] == ["ingest.cpp", "pack.cpp"]
    assert all(p.parent == ROOT / "keto_tpu_torch" / "native" for p in _build.host_sources())
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert str(path) in maps
    assert str(ROOT / "native" / "libketo") not in maps


def test_a_second_build_reuses_the_library():
    path = _build.host_build()
    mtime = path.stat().st_mtime_ns
    assert _build.host_build() == path
    assert path.stat().st_mtime_ns == mtime
    assert _build.host_lib() is _build.host_lib()


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed on"):
        _build.host_build()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.o"))


def test_a_compile_error_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError) as e:
        _build.host_build()
    msg = str(e.value)
    assert "broken.cpp" in msg and "undeclared_name" in msg
    assert _build.compiler_version() in msg and "g++" in _build.compiler_version()


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Four processes reaching an empty build directory together (the
    test workers' case) take turns on the lock: one compiles, all load the
    same library, nothing is left half-written."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from keto_tpu_torch import _build
        _build.HOST_BUILD_DIR = __import__("pathlib").Path({str(tmp_path)!r})
        lib = _build.host_lib()
        assert lib.graph_num_sets is not None
        print(_build.host_library_path(), _build.host_build_seconds > 0)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=dict(os.environ))
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert len({path for path, _ in lines}) == 1
    assert sum(built == "True" for _, built in lines) == 1
    assert [p.name for p in tmp_path.iterdir() if p.name != "build.lock"] == \
        [Path(lines[0][0]).name]


def _c_declarations(text: str) -> dict:
    """name → (return type, parameter count) of every function in the
    ``extern "C"`` block of a C++ source."""
    block = text[text.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^([A-Za-z_][\w\s\*]*?[\s\*])(\w+)\(([^)]*)\)\s*\{", block, re.M):
        params = [p for p in m.group(3).split(",") if p.strip() and p.strip() != "void"]
        out[m.group(2)] = (m.group(1).strip(), len(params))
    return out


def test_host_signatures_match_the_sources():
    decls = {}
    for src in _build.host_sources():
        decls.update(_c_declarations(src.read_text()))
    for name, (restype, argtypes) in _build._HOST_SIGNATURES.items():
        assert name in decls, name
        ret, n = decls[name]
        assert n == len(argtypes), name
        if restype is None:
            assert ret == "void", name
        elif restype is _build._P:
            assert ret.endswith("*"), name
        else:
            assert ret == "int64_t", name
