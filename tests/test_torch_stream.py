"""The streaming check pipeline on the CPU against the JAX engine and the
oracle: the slice controller and the staging pool (copies of
keto_tpu/check/tpu_engine.py's, held to the reference's classes), the
ready-order stream and its per-slice route info, the staging lease
discipline, the truncation re-run mid-stream, failures, and the batcher's
stream dispatch.

The fuzz store is tests/test_slice_tail.py's: direct grants beside chains
of depth 2–8 and wildcard queries, so slices land on every route
(label, hybrid, bfs, host).
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import Future

import numpy as np
import pytest

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.check.stream import StreamSliceController, _StagingPool
from keto_tpu_torch.driver.batch import BATCH, CheckBatcher, _Item
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store

NS = [("docs", 1), ("groups", 2)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def mixed_depth(seed=3, n_groups=24, n_users=60, depth=8, n_queries=400, cycles=False):
    """(rows, queries): tests/test_slice_tail.py's ``_mixed_depth_store``;
    with ``cycles`` each chain closes into a cycle, so it stays on the
    device (a chain without one is peeled to the host walk)."""
    rng = random.Random(seed)
    rows = []
    for g in range(n_groups):
        for _ in range(4):
            rows.append(T("groups", f"g{g}", "member", SubjectID(f"user-{rng.randrange(n_users)}")))
    for d in range(40):
        rows.append(T("docs", f"doc-{d}", "view",
                      SubjectSet("groups", f"g{rng.randrange(n_groups)}", "member")))
    for k in range(2, depth + 1):
        for i in range(k):
            rows.append(T("groups", f"c{k}-{i}", "member", SubjectSet("groups", f"c{k}-{i+1}", "member")))
        rows.append(T("groups", f"c{k}-{k}", "member", SubjectID(f"deep-{k}")))
        rows.append(T("docs", f"chain-doc-{k}", "view", SubjectSet("groups", f"c{k}-0", "member")))
        if cycles:
            rows.append(T("groups", f"c{k}-{k}", "member", SubjectSet("groups", f"c{k}-0", "member")))
    queries = []
    for _ in range(n_queries):
        r = rng.random()
        if r < 0.75:
            queries.append(T("docs", f"doc-{rng.randrange(40)}", "view",
                             SubjectID(f"user-{rng.randrange(n_users)}")))
        elif r < 0.9:
            k = rng.randrange(2, depth + 1)
            queries.append(T("docs", f"chain-doc-{k}", "view",
                             SubjectID(f"deep-{k}" if rng.random() < 0.5 else "nobody")))
        else:
            queries.append(T("", "", "", SubjectID(f"user-{rng.randrange(n_users)}")))
    return rows, queries


def to_jax(q):
    from keto_tpu.relationtuple import model as jm

    sub = (jm.SubjectID(q.subject.id) if isinstance(q.subject, SubjectID)
           else jm.SubjectSet(q.subject.namespace, q.subject.object, q.subject.relation))
    return jm.RelationTuple(namespace=q.namespace, object=q.object, relation=q.relation,
                            subject=sub)


def engine_on(rows, **kw):
    p = port_store(NS, rows)
    e = TorchCheckEngine(p, p.namespaces, device="cpu", **kw)
    e.labels_settled()
    return p, e


def scribble_free(pool):
    """Lease every free buffer of ``pool``, overwrite it, give it back: a
    buffer released before its slice landed would now ship garbage."""
    for size in list(pool.snapshot()["sizes"]):
        bufs = [pool.acquire(size) for _ in range(_StagingPool.MAX_FREE_PER_SIZE)]
        for buf in bufs:
            buf.fill_(-7)
            pool.release(buf)


def _hooked(queries, hooks):
    for i, q in enumerate(queries):
        if i in hooks:
            hooks[i]()
        yield q


def lease_guard(monkeypatch, engine):
    """Pin the lease discipline: every buffer a slice leased must still
    hold what the slice packed into it when the slice releases it (a
    buffer re-leased before its slice landed would have been overwritten),
    and no buffer is leased twice at once. Returns the release count."""
    held: dict = {}
    released = [0]
    dispatch, release = engine._dispatch_slices, engine._stage_release

    def dispatch_spy(*a, **kw):
        for rec in dispatch(*a, **kw):
            for buf in rec[4]:
                assert id(buf) not in held, "a buffer was leased twice at once"
                held[id(buf)] = buf.clone()
            yield rec

    def release_spy(leases):
        for buf in leases or ():
            assert buf.equal(held.pop(id(buf))), "a leased buffer changed before its slice landed"
            released[0] += 1
        release(leases)

    monkeypatch.setattr(engine, "_dispatch_slices", dispatch_spy)
    monkeypatch.setattr(engine, "_stage_release", release_spy)
    return released


# -- the controller and the pool against the reference's classes -----------------


def _observations(seed):
    rng = random.Random(seed)
    obs = []
    for i in range(300):
        route = rng.choice(["label", "hybrid", "bfs", "host"])
        nq = rng.choice([32, 256, 2048, 8192, 32768])
        ms = rng.choice([0.5, 2.0, 10.0, 40.0, 120.0, 900.0]) * rng.random()
        obs.append((nq, ms, route, rng.randrange(0, 40), rng.choice([None, 0, nq, 4 * nq])))
    return obs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_reference(seed):
    from keto_tpu.check.tpu_engine import StreamSliceController as Ref

    for kw in ({}, {"target_ms": 10.0, "floor": 32, "tail_ratio": 3.0}):
        mine, ref = StreamSliceController(**kw), Ref(**kw)
        for nq, ms, route, steps, ent in _observations(seed):
            mine.observe(nq, ms, route=route, bfs_steps=steps, entries=ent)
            ref.observe(nq, ms, route=route, bfs_steps=steps, entries=ent)
            assert mine.cap() == ref.cap()
            assert mine.entry_budget() == ref.entry_budget()
        a, b = mine.snapshot(), ref.snapshot()
        assert a == b


def test_model_narrows_after_one_slow_route_observation():
    ctrl = StreamSliceController(target_ms=40.0, floor=32)
    wide = ctrl.cap()
    ctrl.observe(wide, 2.0, route="label", entries=wide)
    assert ctrl.cap() >= wide
    ctrl.observe(wide, 400.0, route="bfs", bfs_steps=64, entries=4 * wide)
    narrowed = ctrl.cap()
    assert narrowed < wide
    assert narrowed * (400.0 / wide) <= ctrl.target_ms * 1.01 or narrowed == 32


def test_entry_budget_tracks_slow_route():
    ctrl = StreamSliceController(target_ms=40.0, floor=32)
    assert ctrl.entry_budget() is None
    ctrl.observe(1024, 10.0, route="bfs", entries=4096)
    budget = ctrl.entry_budget()
    assert budget is not None and 256 <= budget <= int(40.0 / (10.0 / 4096)) + 1
    ctrl.observe(1024, 400.0, route="bfs", entries=4096)
    assert ctrl.entry_budget() < budget


def test_tail_guard_engages_on_blown_ratio():
    ctrl = StreamSliceController(target_ms=10.0, floor=32, tail_ratio=5.0)
    for _ in range(3):
        for _ in range(31):
            ctrl.observe(64, 1.0, route="label", entries=64)
        ctrl.observe(64, 500.0, route="bfs", entries=4096)
    snap = ctrl.snapshot()
    assert snap["tail_guard"] < 1.0
    assert snap["tail_p99_ms"] > 5.0 * snap["tail_p50_ms"]
    for _ in range(8 * 32):
        ctrl.observe(64, 1.0, route="label", entries=64)
    assert ctrl.snapshot()["tail_guard"] > snap["tail_guard"]


def test_staging_pool_accounting_and_reuse():
    import torch

    pool = _StagingPool()
    a = pool.acquire(128)
    assert a.shape == (128,) and a.dtype == torch.int32
    assert not a.is_pinned() and pool.snapshot()["bytes"] == 512
    pool.release(a)
    assert pool.snapshot()["leased"] == 0 and pool.snapshot()["free_buffers"] == 1
    assert pool.acquire(128) is a, "a freed buffer is re-leased, not re-allocated"
    b = pool.acquire(256)
    assert b is not a and pool.snapshot()["bytes"] == 512 + 1024
    assert pool.snapshot()["leased"] == 2
    # past MAX_FREE_PER_SIZE free buffers of one size, a release frees it
    extra = [pool.acquire(64) for _ in range(_StagingPool.MAX_FREE_PER_SIZE + 2)]
    for buf in extra:
        pool.release(buf)
    snap = pool.snapshot()
    assert snap["leased"] == 2 and snap["free_buffers"] == _StagingPool.MAX_FREE_PER_SIZE
    assert snap["bytes"] == 512 + 1024 + 4 * 64 * _StagingPool.MAX_FREE_PER_SIZE


@pytest.mark.parametrize("bad", ["short", "long", "int64_out", "int64_array"])
def test_pack_entries_refuses_a_staging_buffer_that_does_not_fit(bad):
    """A staging buffer that does not fit the packed entries raises: it is
    never silently replaced by a new array while the old buffer ships."""
    from keto_tpu_torch.check.pack import pack_entries

    arrays = [np.arange(k, dtype=np.int32) for k in (4, 4, 2, 2, 3, 3, 32)]
    n = sum(a.shape[0] for a in arrays)
    out = np.empty(n, np.int32)
    got, sizes = pack_entries(arrays, out=out)
    assert got is out and sizes == (4, 2, 3, 32)
    assert out.tolist() == np.concatenate(arrays).tolist()
    if bad == "short":
        out = np.empty(n - 1, np.int32)
    elif bad == "long":
        out = np.empty(n + 1, np.int32)
    elif bad == "int64_out":
        out = np.empty(n, np.int64)
    else:
        arrays[2] = arrays[2].astype(np.int64)
    with pytest.raises(ValueError, match="pack_entries"):
        pack_entries(arrays, out=out)


# -- the stream ---------------------------------------------------------------------


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staging_reuse_never_corrupts_decisions(monkeypatch, ordered, seed):
    """Pooled staging, a forced mid-stream width switch and a mid-stream
    scribble over every free buffer of the pool: every decision equals the
    oracle's, no leased buffer changes before its slice lands, and no lease
    outlives its slice."""
    rows, queries = mixed_depth(seed=seed)
    p, engine = engine_on(rows, max_batch=64)
    try:
        released = lease_guard(monkeypatch, engine)
        oracle = CheckEngine(p)
        want = [oracle.subject_is_allowed(q) for q in queries]
        n = len(queries)
        hooks = {
            n // 4: lambda: engine.stream_ctrl.observe(engine.stream_ctrl.cap(), 100_000.0),
            n // 2: lambda: scribble_free(engine._staging),
        }
        if ordered:
            got = np.concatenate(list(engine.batch_check_stream(_hooked(queries, hooks)))).tolist()
        else:
            got = [None] * n
            gen, tok = engine.batch_check_stream_with_token(_hooked(queries, hooks), ordered=False)
            for off, out in gen:
                got[off : off + len(out)] = out.tolist()
            assert tok == p.watermark()
        assert got == want
        assert released[0] > 0
        assert engine.staging_snapshot()["leased"] == 0, "a staging lease outlived its slice"
        assert engine.stream_slice_stats.snapshot()["count"] > 0
    finally:
        engine.close()


def test_abandoned_stream_releases_leases(monkeypatch):
    rows, queries = mixed_depth(seed=4)
    p, engine = engine_on(rows, max_batch=32)
    try:
        lease_guard(monkeypatch, engine)
        gen, _ = engine.batch_check_stream_with_token(iter(queries), ordered=False)
        next(gen)  # one slice landed, more in flight
        assert engine.staging_snapshot()["leased"] > 0
        gen.close()
        assert engine.staging_snapshot()["leased"] == 0
        oracle = CheckEngine(p)
        assert engine.batch_check(queries[:32]) == [oracle.subject_is_allowed(q) for q in queries[:32]]
    finally:
        engine.close()


@pytest.mark.parametrize("labels", [True, False])
def test_stream_matches_batch_and_reference_per_slice(labels):
    """At a pinned slice width the stream lands the same slices as the
    reference's, on the same routes, with the same decisions; ordered and
    unordered streams equal ``batch_check`` and the reference's stream."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    rows, queries = mixed_depth(seed=5)
    p, engine = engine_on(rows, labels_enabled=labels)
    jp = jax_store(NS, rows)
    ref = TpuCheckEngine(jp, jp.namespaces, labels_enabled=labels)
    try:
        ref.labels_settled()
        jq = [to_jax(q) for q in queries]
        want = engine.batch_check(queries)
        assert want == [bool(x) for x in ref.batch_check(jq)]
        ordered = np.concatenate(list(engine.batch_check_stream(queries, slice_cap=64))).tolist()
        assert ordered == want
        ref_ordered = np.concatenate(list(ref.batch_check_stream(jq, slice_cap=64))).tolist()
        assert ref_ordered == want

        def slices(eng, qs):
            gen, _ = eng.batch_check_stream_with_token(qs, ordered=False, with_info=True,
                                                        slice_cap=32)
            return {off: (info["route"], info["width"], out.tolist()) for off, out, info in gen}

        mine, theirs = slices(engine, queries), slices(ref, jq)
        assert mine == theirs
        routes = {r for r, _, _ in mine.values()}
        assert routes >= ({"label", "hybrid"} if labels else {"bfs"})
        assert sum(w for _, w, _ in mine.values()) == len(queries)
        # a slice no query of which reaches the device lands on "host"
        nowhere = [T("nope", "x", "view", SubjectID("u")), T("docs", "doc-1", "view", SubjectID("u"))]
        assert slices(engine, nowhere) == slices(ref, [to_jax(q) for q in nowhere])
        assert [r for r, _, _ in slices(engine, nowhere[:1]).values()] == ["host"]
        snap = engine.stream_route_snapshot()
        assert snap["host"]["slices"] >= 1
        assert sum(v["queries"] for v in snap.values()) == 2 * len(queries) + 3
        engine.reset_route_stats()
        assert engine.stream_route_snapshot() == {} and engine.bfs_steps_stats.snapshot()["count"]
    finally:
        engine.close()
        ref.close()


def test_with_info_requires_unordered():
    rows, queries = mixed_depth(seed=6, n_queries=10)
    _, engine = engine_on(rows)
    try:
        with pytest.raises(ValueError, match="with_info requires ordered=False"):
            engine.batch_check_stream_with_token(queries, ordered=True, with_info=True)
    finally:
        engine.close()


def test_truncated_slice_reruns_exactly_mid_stream(monkeypatch):
    """``it_cap=1`` truncates every deep slice; each re-runs exactly inside
    the stream, before it is delivered."""
    rows, queries = mixed_depth(seed=7, cycles=True)
    p, engine = engine_on(rows, it_cap=1, labels_enabled=False)
    try:
        rungs = []
        real = engine._run_exact
        monkeypatch.setattr(engine, "_run_exact", lambda s, t, it_cap=None: (
            rungs.append(it_cap), real(s, t, it_cap=it_cap))[1])
        oracle = CheckEngine(p)
        got = np.concatenate(list(engine.batch_check_stream(queries, slice_cap=32))).tolist()
        assert got == [oracle.subject_is_allowed(q) for q in queries]
        # the stream's re-run starts at 8 × it_cap; the ladder goes on to
        # the bound that cannot truncate
        limit = engine._cap_limit(engine.snapshot())
        assert rungs and 8 in rungs and max(rungs) == limit and all(c in (8, limit) for c in rungs)
        assert engine.staging_snapshot()["leased"] == 0
    finally:
        engine.close()


def test_predicted_slow_chunks_split_before_dispatch(monkeypatch):
    rows, queries = mixed_depth(seed=8)
    p, engine = engine_on(rows, labels_enabled=False)
    try:
        snap = engine.snapshot()
        batch = queries[:128]
        n_default = 0
        for rec in engine._dispatch_slices(snap, batch):
            engine._stage_release(rec[4])
            n_default += 1
        splits = engine.counters().get("slice_splits", 0)
        assert splits == n_default - 1
        monkeypatch.setattr(engine.stream_ctrl, "entry_budget", lambda: 64)
        recs = list(engine._dispatch_slices(snap, batch))
        assert len(recs) > n_default, "the entry budget did not split the chunk"
        assert engine.counters()["slice_splits"] == splits + len(recs) - 1
        landed = [engine._land_slice(dev, host_ans, nq, leases)
                  for dev, host_ans, nq, _chunk, leases, _n in recs]
        assert not any(trunc for _, _, trunc, _ in landed)
        out = np.concatenate([bits for bits, *_ in landed])
        assert out.tolist() == [CheckEngine(p).subject_is_allowed(q) for q in batch]
        assert engine.staging_snapshot()["leased"] == 0
    finally:
        engine.close()


def test_device_error_mid_stream_raises_without_retry(monkeypatch):
    rows, queries = mixed_depth(seed=9)
    _, engine = engine_on(rows, labels_enabled=False)
    try:
        calls = [0]
        real = kernels.check_step

        def failing(*a, **kw):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected device fault")
            return real(*a, **kw)

        monkeypatch.setattr(kernels, "check_step", failing)
        with pytest.raises(RuntimeError, match="injected device fault"):
            for _ in engine.batch_check_stream(queries, slice_cap=32):
                pass
        assert calls[0] == 2, "the stream dispatched again after the fault"
        assert engine.staging_snapshot()["leased"] == 0
    finally:
        engine.close()


# -- the batcher ---------------------------------------------------------------------


def test_batcher_resolves_futures_through_the_stream(monkeypatch):
    rows, queries = mixed_depth(seed=10)
    p, engine = engine_on(rows)
    monkeypatch.setattr(engine, "batch_check_with_token",
                        lambda *a, **kw: pytest.fail("the batcher bypassed the stream"))
    streams = [0]
    real = engine.batch_check_stream_with_token

    def spy(*a, **kw):
        streams[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(engine, "batch_check_stream_with_token", spy)
    oracle = CheckEngine(p)
    b = CheckBatcher(engine, window_ms=5)
    b.start()
    try:
        results: dict = {}

        def worker(k):
            results[k] = b.check_batch(queries[k * 40 : (k + 1) * 40], timeout=60)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = [x for k in range(8) for x in results[k]]
        assert got == [oracle.subject_is_allowed(q) for q in queries[:320]]
        assert b.check(queries[0]) == oracle.subject_is_allowed(queries[0])
        assert streams[0] >= 1
    finally:
        b.stop()
        engine.close()


def test_failed_stream_dispatch_fails_every_rider(monkeypatch):
    rows, queries = mixed_depth(seed=11, n_queries=20)
    _, engine = engine_on(rows, labels_enabled=False)
    monkeypatch.setattr(kernels, "check_step",
                        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("injected")))
    b = CheckBatcher(engine, window_ms=50)
    b.start()
    try:
        errors = []

        def worker(q):
            try:
                b.check(q, timeout=30)
            except RuntimeError as e:
                errors.append(str(e))

        deep = [T("docs", "chain-doc-5", "view", SubjectID(f"u{k}")) for k in range(4)]
        threads = [threading.Thread(target=worker, args=(q,)) for q in deep]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert errors == ["injected"] * 4
    finally:
        b.stop()
        engine.close()


def test_batcher_round_is_bounded_by_the_planned_width():
    rows, queries = mixed_depth(seed=12)
    _, engine = engine_on(rows)
    try:
        b = CheckBatcher(engine, batch_size=8192, batch_sub_slice=8192)
        engine.stream_ctrl.observe(engine.stream_ctrl.cap(), 1_000_000.0)
        cap = engine.stream_ctrl.cap()
        assert cap < 8192
        with b._cond:
            # a batch-lane chunk wider than the planned width: the round
            # takes a partial chunk of exactly that width
            item = _Item([queries[0]] * (cap + 100), Future(), None, False, None, BATCH)
            b._lanes[BATCH].append(item)
            b._lane_tuples[BATCH] += item.n
            took = b._take_locked()
        assert [(it, start, count) for it, start, count in took] == [(item, 0, cap)], \
            "the round is not bounded by the planned slice width"
    finally:
        engine.close()
