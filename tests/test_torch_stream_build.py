"""The port's full build (keto_tpu_torch/graph/stream_build.py) against the
serial build and the reference.

``full_build`` takes the store's column bundle, else the chunked scan when
the store prefers it, else ``snapshot_rows``. Every path must give the
snapshot the serial host build gives, across chunk sizes (1 row to the
whole table) and interners (the native stream pool, the one-shot
interner, the Python ``IncrementalInterner`` that replays a stream a
chunk's framing killed), and a store failure mid-scan must abort the
native builder and leave a retry to start afresh. ``native_intern_columns``
must equal the reference's Python ``intern_rows``. After a bulk load the
engine builds through the bundle, with the reference build's arrays and
the reference engine's decisions.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from keto_tpu_torch import _build
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.graph import native, stream_build
from keto_tpu_torch.graph.interner import IncrementalInterner, intern_rows
from keto_tpu_torch.graph.native import NativeStreamBuilder, native_intern_columns
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.persistence.memory import _DeferredRows
from keto_tpu_torch.relationtuple.model import SubjectID
from test_torch_bulk_ingest import T, port_store, rand_tuples, ref_store, ref_tuple
from test_torch_snapshot import assert_snapshots_equal

WILD = frozenset({3})
ARRAYS = ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices", "rev_indptr",
          "rev_indices")


def assert_same_snapshot(a, b):
    """Two of the port's snapshots: every array, the buckets, both list
    layouts and the interner's arrays, byte for byte."""
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    for k in ("snapshot_id", "num_sets", "num_leaves", "num_active", "num_int", "num_live",
              "n_peeled"):
        assert getattr(a, k) == getattr(b, k), k
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert (x.offset, x.n) == (y.offset, y.n) and x.nbrs.tobytes() == y.nbrs.tobytes()
    for orient in ("lay_fwd", "lay_rev"):
        la, lb = getattr(a, orient), getattr(b, orient)
        assert np.array_equal(la.order, lb.order) and len(la.buckets) == len(lb.buckets)
        for x, y in zip(la.buckets, lb.buckets):
            assert (x.offset, x.n) == (y.offset, y.n)
            assert np.array_equal(np.asarray(x.nbrs), np.asarray(y.nbrs))
    for k in ("src", "dst", "key_ns", "key_obj", "key_rel", "key_wild"):
        assert np.array_equal(getattr(a.interned, k), getattr(b.interned, k)), k


def assert_interned_equal(g, ref):
    """A native graph against the reference's Python ``InternedGraph``:
    arrays, code tables and the key ↔ id maps both ways."""
    assert (g.num_sets, g.num_leaves) == (ref.num_sets, ref.num_leaves)
    for k in ("src", "dst", "key_ns", "key_obj", "key_rel"):
        assert np.array_equal(getattr(g, k), getattr(ref, k)), k
    assert np.array_equal(np.asarray(g.key_wild, bool), np.asarray(ref.key_wild, bool))
    assert (g.num_obj_codes(), g.num_rel_codes()) == (ref.num_obj_codes(), ref.num_rel_codes())
    for key, i in ref.set_ids.items():
        assert g.resolve_set(*key) == i and g.set_key_of(i) == key
    for sid, i in ref.leaf_ids.items():
        assert g.resolve_leaf(sid) == i and g.leaf_str(i) == sid


def small_store(seed, n):
    """A store below the bulk threshold (no bundle): writes of 1,000."""
    p = port_store()
    tuples = rand_tuples(random.Random(seed), n)
    for i in range(0, n, 1000):
        p.write_relation_tuples(*tuples[i : i + 1000])
    return p


def streamed(p, **kw):
    """``full_build`` over the chunked scan (the store made to prefer it)."""
    p.scan_chunks_preferred = True
    prog = stream_build.BuildProgress()
    snap = stream_build.full_build(p, WILD, progress=prog, **kw)
    return snap, prog


# -- interners -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 7, 10_000])
def test_incremental_interner_matches_one_shot(chunk):
    rows, _ = small_store(11, 900).snapshot_rows()
    one = intern_rows(rows, WILD)
    inc = IncrementalInterner(WILD)
    for i in range(0, len(rows), chunk):
        inc.add_rows(rows[i : i + chunk])
    got = inc.finish()
    assert got.set_ids == one.set_ids and got.leaf_ids == one.leaf_ids
    assert np.array_equal(got.src, one.src) and np.array_equal(got.dst, one.dst)
    assert np.array_equal(got.key_wild, one.key_wild)


def test_native_stream_builder_matches_serial():
    from keto_tpu.graph.interner import intern_rows as ref_intern

    p = small_store(5, 2500)
    rows, _ = p.snapshot_rows()
    ref = ref_intern(ref_store_rows(p), WILD)
    sb = NativeStreamBuilder.create(WILD)
    for i in range(0, len(rows), 173):
        assert sb.feed(rows[i : i + 173])
    assert_interned_equal(sb.finish(), ref)


def ref_store_rows(p):
    from keto_tpu.persistence.memory import InternalRow as RefRow

    return [RefRow(r.namespace_id, r.object, r.relation, r.subject_id, r.sset_namespace_id,
                   r.sset_object, r.sset_relation, r.seq) for r in p.snapshot_rows()[0]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_intern_columns_matches_the_reference_python_interner(seed):
    from keto_tpu.graph.interner import intern_rows as ref_intern

    tuples = rand_tuples(random.Random(seed), 4096 + 900 * seed)
    p = port_store(tuples)
    cols = p.snapshot_columns(p.watermark())
    before = native.COUNTERS["columns"]
    g = native_intern_columns(_build.host_lib(), cols, WILD)
    assert native.COUNTERS["columns"] == before + 1
    assert_interned_equal(g, ref_intern(ref_store(tuples).snapshot_rows()[0], WILD))


def test_a_bundle_with_an_embedded_nul_is_refused_and_counted():
    tuples = rand_tuples(random.Random(3), 5000)
    tuples[100] = T("g", "a\x00b", "m", SubjectID("nul-user"))
    p = port_store(tuples)
    cols = p.snapshot_columns(p.watermark())
    assert cols is not None  # an embedded NUL survives numpy; only the decoder refuses it
    before = native.COUNTERS["columns_refused"]
    assert native_intern_columns(_build.host_lib(), cols, WILD) is None
    assert native.COUNTERS["columns_refused"] == before + 1
    # the engine's build goes on through the rows, counted once more
    e = TorchCheckEngine(p, p.namespaces, device="cpu", labels_enabled=False)
    try:
        snap = e.snapshot()
        assert e.build_info["path"] == "rows"
        assert native.COUNTERS["columns_refused"] == before + 2
        from keto_tpu.graph.snapshot import build_snapshot as jax_build

        assert_snapshots_equal(snap, jax_build(*ref_store(tuples).snapshot_rows(), WILD))
    finally:
        e.close()


# -- the streaming pipeline ----------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_streaming_build_parity_fuzz(seed):
    rng = random.Random(seed)
    p = small_store(seed, 1500 + 400 * seed)
    rows, wm = p.snapshot_rows()
    legacy = build_snapshot(rows, wm, WILD)
    before = native.COUNTERS["stream"]
    snap, prog = streamed(p, chunk_rows=rng.choice([1, 37, 512, 1 << 20]))
    assert snap.snapshot_id == wm and prog.path == "stream"
    assert native.COUNTERS["stream"] == before + 1
    assert_same_snapshot(legacy, snap)


@pytest.mark.parametrize("chunk_rows", [1, 7, 191, 1 << 20])
def test_chunk_size_sweep(chunk_rows):
    p = small_store(42, 600)
    rows, wm = p.snapshot_rows()
    legacy = build_snapshot(rows, wm, WILD)
    snap, _ = streamed(p, chunk_rows=chunk_rows)
    assert_same_snapshot(legacy, snap)


def test_a_chunk_the_packer_cannot_frame_is_replayed_in_python_and_counted():
    """A separator byte in a stored string kills the native stream at its
    chunk; the chunks so far and the rest intern in Python, same ids."""
    p = small_store(9, 800)
    p.write_relation_tuples(T("d", "zz\x1fobject", "m", SubjectID("u-sep")))
    rows, wm = p.snapshot_rows()
    bad_at = next(i for i, r in enumerate(rows) if "\x1f" in r.object)
    assert bad_at > 97  # not in the first chunk: earlier chunks are replayed
    legacy = build_snapshot(rows, wm, WILD)
    replays, streams = native.COUNTERS["stream_replays"], native.COUNTERS["stream"]
    snap, prog = streamed(p, chunk_rows=97)
    assert native.COUNTERS["stream_replays"] == replays + 1 and prog.path == "python"
    assert native.COUNTERS["stream"] == streams
    assert_same_snapshot(legacy, snap)


class FlakyScanStore:
    """A chunk-preferring wrapper whose first scan dies after half the rows."""

    scan_chunks_preferred = True

    def __init__(self, inner):
        self._inner = inner
        self.scan_calls = 0

    def watermark(self):
        return self._inner.watermark()

    def snapshot_scan(self, on_chunk, chunk_rows=262144):
        self.scan_calls += 1
        if self.scan_calls == 1:
            rows, _ = self._inner.snapshot_rows()
            on_chunk(rows[: len(rows) // 2])
            raise ConnectionError("server closed the connection")
        return self._inner.snapshot_scan(on_chunk, chunk_rows=chunk_rows)


def test_mid_scan_failure_aborts_and_a_retry_starts_afresh(monkeypatch):
    p = small_store(8, 500)
    rows, wm = p.snapshot_rows()
    legacy = build_snapshot(rows, wm, WILD)
    aborted = []
    orig_abort = NativeStreamBuilder.abort

    def abort(self):
        aborted.append(self._dead)
        orig_abort(self)

    monkeypatch.setattr(NativeStreamBuilder, "abort", abort)
    # without a retry the failure leaves full_build, the builder aborted
    with pytest.raises(ConnectionError):
        stream_build.full_build(FlakyScanStore(p), WILD, chunk_rows=64)
    assert aborted == [False]
    flaky, retries = FlakyScanStore(p), []

    def read_retry(fn, *args):
        for _ in range(3):
            try:
                return fn(*args)
            except ConnectionError as e:
                retries.append(e)
        raise AssertionError("no attempt succeeded")

    snap = stream_build.full_build(flaky, WILD, chunk_rows=64, read_retry=read_retry)
    assert flaky.scan_calls == 2 and len(retries) == 1 and aborted == [False, False]
    assert_same_snapshot(legacy, snap)


def test_build_progress_phases():
    p = stream_build.BuildProgress()
    assert p.current_phase == "idle" and p.durations() == {} and p.path == ""
    p.start()
    with p.phase("device_build"):
        assert p.current_phase == "device_build"
    p.add_rows(10)
    p.observe("scan", 0.5)
    p.observe("scan", 0.25)  # additive
    p.set_path("stream")
    d = p.durations()
    assert d["device_build"] >= 0.0 and d["scan"] == 0.75
    p.finish()
    assert p.current_phase == "idle" and p.rows_ingested == 10 and p.path == "stream"
    p.start()  # a new build resets the per-build view, the counters keep counting
    assert p.durations() == {} and p.path == "" and p.rows_ingested == 10


def test_full_build_paths_in_order():
    """The bundle first, the scan only when preferred, else the rows; each
    path counted, each snapshot the serial build's."""
    tuples = rand_tuples(random.Random(12), 5000)
    p = port_store(tuples)
    rows, wm = p.snapshot_rows()
    legacy = build_snapshot(rows, wm, WILD)
    for prefer, want in ((False, "columns"), (True, "columns")):
        p.scan_chunks_preferred = prefer
        prog = stream_build.BuildProgress()
        assert_same_snapshot(legacy, stream_build.full_build(p, WILD, progress=prog))
        assert prog.path == want and set(prog.durations()) == {"intern", "device_build"}
        assert prog.rows_ingested == len(rows) and prog.edges_ingested > 0
    p.write_relation_tuples(T("g", "late", "m", SubjectID("u1")))  # drops the bundle
    rows, wm = p.snapshot_rows()
    legacy = build_snapshot(rows, wm, WILD)
    for prefer, want in ((True, "stream"), (False, "rows")):
        p.scan_chunks_preferred = prefer
        prog = stream_build.BuildProgress()
        assert_same_snapshot(legacy, stream_build.full_build(p, WILD, progress=prog))
        assert prog.path == want
        assert set(prog.durations()) == {"scan", "intern", "device_build"}


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_builds_from_the_bundle_like_the_reference(seed):
    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    tuples = rand_tuples(random.Random(seed), 4500 + 1000 * seed)
    p, ref = port_store(tuples, log_cap=4096), ref_store(tuples)
    assert isinstance(p._row_list, _DeferredRows)
    e = TorchCheckEngine(p, p.namespaces, device="cpu")
    before = dict(native.COUNTERS)
    try:
        snap = e.snapshot()
        info = e.build_info
        assert info["path"] == "columns" and native.COUNTERS["columns"] == before["columns"] + 1
        assert native.COUNTERS["native"] == before["native"]
        assert set(info["phases_s"]) == {"intern", "device_build"}
        assert info["intern_s"] == info["phases_s"]["intern"] and info["sort_s"] is not None
        assert isinstance(p._row_list, _DeferredRows)  # the build read no row
        assert_snapshots_equal(snap, jax_build(*ref.snapshot_rows(), WILD))
        queries = rand_tuples(random.Random(100 + seed), 300, with_dups=False)
        ref_engine = TpuCheckEngine(ref, ref.namespaces)
        assert e.batch_check(queries) == ref_engine.batch_check([ref_tuple(q) for q in queries])
        # a write after the bundle: the engine's next full build reads rows
        p.write_relation_tuples(T("g", "late", "m", SubjectID("u1")))
        snap2 = e.snapshot()
        assert snap2.snapshot_id == 2
    finally:
        e.close()


def test_engine_full_build_raises_when_the_host_library_fails(monkeypatch):
    p = port_store(rand_tuples(random.Random(2), 4200))
    e = TorchCheckEngine(p, p.namespaces, device="cpu", labels_enabled=False)

    def refuse():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(_build, "host_lib", refuse)
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            e.snapshot()
    finally:
        e.close()
