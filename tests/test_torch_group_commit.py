"""Group commit, against the JAX package on the CPU (tests/
test_group_commit.py:95-160, :230-420, without its Watch and SQLite cases).

- ``transact_many`` (keto_tpu_torch/persistence/memory.py): one group of
  the tricky per-writer shapes — a keyed insert, an insert and a delete in
  one writer, a no-op writer, an in-group replay, a delete of an earlier
  writer's insert — gives the same tokens, replay flags, rows, watermark
  and counters as the JAX package's store; groups drawn from numpy seeds
  equal the same writes committed one by one, on either store;
  ``Manager.transact_many``'s default is that serial loop, and
  ``ManagerWrapper`` passes every write through; a writer the store
  refuses (an unknown namespace, a nil subject) gets its own error in its
  place and applies nothing, and the rest of its group commits as the
  reference commits those writers alone (the reference's group would fail
  them all with that writer's error);
- ``GroupCommitCoordinator`` (keto_tpu_torch/driver/group_commit.py):
  concurrent writers coalesce into few groups with consecutive tokens as
  the reference's coordinator does, a keyed retry replays, a store error
  fails every writer of its group with the same exception and the
  coordinator goes on, a refused writer fails alone, ``stop()`` fails the writers left over, a full
  queue blocks its enqueue (and times out) instead of shedding, and the
  daemon drains its writers before it stops;
- the engine over group commits: grouped keyed and unkeyed writes with
  tombstones, wildcards and folds decide as the oracle, the JAX engine
  and a serially committed twin do.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.driver.group_commit import GroupCommitCoordinator
from keto_tpu_torch.relationtuple.manager import Manager, ManagerWrapper, TransactWrite
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet

from test_torch_idempotency import _all_rows, _ref_rows
from test_torch_overlay import jt
from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]
WILD_NS = [("g", 1), ("d", 2), ("", 3)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def jw(w: TransactWrite):
    """The same writer for the JAX package's store."""
    from keto_tpu.relationtuple.manager import TransactWrite as JW

    return JW(insert=tuple(jt(t) for t in w.insert), delete=tuple(jt(t) for t in w.delete),
              idempotency_key=w.idempotency_key)


def _group():
    a = T("g", "grp", "m", SubjectID("a"))
    b = T("g", "grp", "m", SubjectID("b"))
    c = T("g", "grp", "m", SubjectID("c"))
    return [
        TransactWrite(insert=(a,)),
        TransactWrite(insert=(b,), idempotency_key="k1"),
        TransactWrite(insert=(c,), delete=(a,)),  # sees writer 0's row
        TransactWrite(delete=(T("g", "grp", "m", SubjectID("ghost")),)),  # no-op
        TransactWrite(insert=(b,), idempotency_key="k1"),  # in-group replay
    ]


def test_transact_many_equals_reference():
    mine, ref = port_store(NS, []), jax_store(NS, [])
    got = mine.transact_many(_group())
    want = ref.transact_many([jw(w) for w in _group()])
    assert [(r.snaptoken, r.replayed) for r in got] == [(r.snaptoken, r.replayed) for r in want]
    assert [r.replayed for r in got] == [False, False, False, False, True]
    toks = [r.snaptoken for r in got]
    assert toks[4] == toks[1] and toks[1] == toks[0] + 1 and toks[2] == toks[1] + 1
    assert _all_rows(mine) == _ref_rows(ref) == [("g", "grp", "m", "b"), ("g", "grp", "m", "c")]
    assert mine.watermark() == ref.watermark()
    r = mine.transact_relation_tuples([T("g", "grp", "m", SubjectID("b"))], [],
                                      idempotency_key="k1")
    assert r.replayed and r.snaptoken == toks[1]
    assert (mine.group_commits, mine.group_commit_writers) == (ref.group_commits,
                                                               ref.group_commit_writers) == (1, 5)
    assert mine.transact_many([]) == [] and mine.group_commits == 1


def _writes(rng, live, rnd):
    objs, users = [f"o{i}" for i in range(5)], [f"u{i}" for i in range(5)]
    out = []
    for _ in range(rng.integers(1, 6)):
        if live and rng.random() < 0.35:
            out.append(TransactWrite(delete=(live[rng.integers(len(live))],)))
        else:
            sub = (SubjectID(users[rng.integers(5)]) if rng.random() < 0.7
                   else SubjectSet("g", objs[rng.integers(5)], "m"))
            key = f"r{rnd}-{len(out)}" if rng.random() < 0.5 else None
            if key is not None and rnd and rng.random() < 0.2:
                key = f"r{rnd - 1}-0"  # a retry of an earlier group's writer
            out.append(TransactWrite(insert=(T("g", objs[rng.integers(5)], "m", sub),),
                                     idempotency_key=key))
    return out


def _tuples(p):
    return [RelationTuple.from_string(f"{ns}:{o}#{r}@{s}") for ns, o, r, s in _all_rows(p)]


@pytest.mark.parametrize("seed", range(3))
def test_groups_equal_serial_commits_and_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    grouped, serial, ref = port_store(NS, []), port_store(NS, []), jax_store(NS, [])
    live: list = []
    for rnd in range(12):
        writes = _writes(rng, live, rnd)
        got = grouped.transact_many(writes)
        solo = [serial.transact_relation_tuples(w.insert, w.delete,
                                                idempotency_key=w.idempotency_key)
                for w in writes]
        want = ref.transact_many([jw(w) for w in writes])
        key = [(r.snaptoken, r.replayed) for r in got]
        assert key == [(r.snaptoken, r.replayed) for r in solo]
        assert key == [(r.snaptoken, r.replayed) for r in want]
        assert grouped.watermark() == serial.watermark() == ref.watermark()
        assert _all_rows(grouped) == _all_rows(serial) == _ref_rows(ref)
        live = _tuples(grouped)
    assert grouped.idempotent_replays == serial.idempotent_replays == ref.idempotent_replays
    assert (grouped.group_commits, grouped.group_commit_writers) == (ref.group_commits,
                                                                     ref.group_commit_writers)
    assert serial.group_commits == 0


def test_manager_default_is_the_serial_loop_and_the_wrapper_passes_through():
    inner = port_store(NS, [])
    spy = ManagerWrapper(inner)
    got = spy.transact_many(_group())
    assert [r.replayed for r in got] == [False, False, False, False, True]
    assert inner.group_commits == 1 and spy.watermark() == inner.watermark()
    r = spy.transact_relation_tuples([T("g", "grp", "m", SubjectID("b"))], [],
                                     idempotency_key="k1")
    assert r.replayed

    class Serial(type(inner)):
        transact_many = Manager.transact_many  # the contract's default loop

    loop = Serial(inner._nm)
    res = loop.transact_many(_group())
    assert [(r.snaptoken, r.replayed) for r in res] == [(r.snaptoken, r.replayed) for r in got]
    assert loop.group_commits == 0
    assert _all_rows(loop) == [("g", "grp", "m", "b"), ("g", "grp", "m", "c")]


def _refused(kind):
    """One writer the store refuses, and the port's error it raises."""
    from keto_tpu_torch.x.errors import ErrNamespaceUnknown, ErrNilSubject

    return {
        "namespace": (TransactWrite(insert=(T("nope", "o", "m", SubjectID("z")),),
                                    idempotency_key="bad"), ErrNamespaceUnknown),
        "subject-set namespace": (TransactWrite(insert=(T("g", "o", "m",
                                                          SubjectSet("nope", "o", "m")),)),
                                  ErrNamespaceUnknown),
        "delete namespace": (TransactWrite(insert=(T("g", "o", "m", SubjectID("y")),),
                                           delete=(T("nope", "o", "m", SubjectID("z")),)),
                             ErrNamespaceUnknown),
        "nil subject": (TransactWrite(insert=(T("g", "o", "m", None),),
                                      idempotency_key="bad"), ErrNilSubject),
    }[kind]


@pytest.mark.parametrize("at", [0, 2, 5])
@pytest.mark.parametrize("kind", ["namespace", "subject-set namespace", "delete namespace",
                                  "nil subject"])
@pytest.mark.parametrize("serial", [False, True])
def test_a_refused_writer_fails_alone_and_the_group_commits(kind, at, serial):
    """The refused writer's place holds its error and nothing of it applies;
    the other writers get the tokens, replays and rows the reference's
    store gives them committed without it."""
    bad, err = _refused(kind)
    good = _group()
    writes = good[:at] + [bad] + good[at:]
    store = port_store(NS, [])
    if serial:
        class Serial(type(store)):
            transact_many = Manager.transact_many  # the contract's default loop

        store = Serial(store._nm)
    ref = jax_store(NS, [])
    got = store.transact_many(writes)
    want = [ref.transact_relation_tuples([jt(t) for t in w.insert], [jt(t) for t in w.delete],
                                         idempotency_key=w.idempotency_key) for w in good]
    assert isinstance(got[at], err)
    rest = got[:at] + got[at + 1:]
    assert [(r.snaptoken, r.replayed) for r in rest] == [(r.snaptoken, r.replayed) for r in want]
    assert _all_rows(store) == _ref_rows(ref) and store.watermark() == ref.watermark()
    # the refused writer's key was not recorded: its corrected retry applies
    fixed = store.transact_relation_tuples([T("g", "o", "m", SubjectID("fixed"))], [],
                                           idempotency_key="bad")
    assert not fixed.replayed and fixed.snaptoken == ref.watermark() + 1
    if not serial:
        assert (store.group_commits, store.group_commit_writers) == (1, len(writes))


# -- the coordinator -----------------------------------------------------------------------


def _run_writers(co, n, make, key=None):
    barrier = threading.Barrier(n)
    results: list = [None] * n

    def writer(i):
        barrier.wait()
        try:
            results[i] = co.transact([make(i)], [], idempotency_key=key(i) if key else None)
        except Exception as e:  # surfaced by the caller
            results[i] = e

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_coordinator_coalesces_and_preserves_tokens_as_the_reference():
    from keto_tpu.driver.group_commit import GroupCommitCoordinator as RefCoordinator
    from keto_tpu.relationtuple.model import RelationTuple as JT

    n = 32
    mine, ref = port_store(NS, []), jax_store(NS, [])
    out = {}
    for tag, store, cls, mk in (
        ("port", mine, GroupCommitCoordinator, lambda i: T("g", "grp", "m", SubjectID(f"w{i}"))),
        ("jax", ref, RefCoordinator, lambda i: JT.from_string(f"g:grp#m@w{i}")),
    ):
        co = cls(store, max_writers=64, window_ms=100.0)
        co.start()
        try:
            results = _run_writers(co, n, mk)
            assert not [r for r in results if isinstance(r, Exception)]
            toks = sorted(r.snaptoken for r in results)
            assert toks == list(range(1, n + 1)), "tokens shared or skipped"
            assert co.writers_total == n and store.group_commit_writers == n
            assert co.flush_total <= 4, f"no coalescing: {co.flush_total} groups"
            t0 = mk(999)
            r1 = co.transact([t0], [], idempotency_key="ck")
            r2 = co.transact([t0], [], idempotency_key="ck")
            assert not r1.replayed and r2.replayed and r2.snaptoken == r1.snaptoken
            assert co.drain(5.0) and co.inflight == 0
            out[tag] = (toks, r1.snaptoken, store.watermark(), store.idempotent_replays)
        finally:
            co.stop()
    assert out["port"] == out["jax"]
    assert _all_rows(mine) == _ref_rows(ref)


def test_coordinator_stress_under_a_short_switch_interval():
    """More writer threads than cores, each committing several keyed writes
    and retrying each once, with the interpreter switching threads every
    microsecond: no write is lost or applied twice, every token is taken
    once, and every retry replays its own write's token."""
    import os
    import sys

    n, per = max(16, 2 * (os.cpu_count() or 1)), 5
    p = port_store(NS, [])
    co = GroupCommitCoordinator(p, max_writers=16, window_ms=1.0, max_pending=32)
    co.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tokens: dict = {}
    errors: list = []
    try:
        def writer(i):
            try:
                for k in range(per):
                    t = T("g", f"o{i}", "m", SubjectID(f"u{k}"))
                    a = co.transact([t], [], idempotency_key=f"{i}-{k}", timeout_s=60.0)
                    b = co.transact([t], [], idempotency_key=f"{i}-{k}", timeout_s=60.0)
                    assert b.replayed and b.snaptoken == a.snaptoken and not a.replayed
                    tokens[(i, k)] = a.snaptoken
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a writer hung"
    finally:
        sys.setswitchinterval(old)
        co.stop()
    assert not errors, errors[:3]
    assert sorted(tokens.values()) == list(range(1, n * per + 1))
    assert len(_all_rows(p)) == n * per and p.watermark() == n * per
    assert co.writers_total == 2 * n * per and p.idempotent_replays == n * per


def test_coordinator_store_error_fails_every_writer_of_the_group():
    p = port_store(NS, [])
    boom = RuntimeError("store down")
    orig = p.transact_many
    armed = {"once": True}

    def flaky(writes):
        if armed.pop("once", None):
            time.sleep(0.05)
            raise boom
        return orig(writes)

    p.transact_many = flaky
    co = GroupCommitCoordinator(p, max_writers=8, window_ms=50.0)
    co.start()
    try:
        results = _run_writers(co, 4, lambda i: T("g", "grp", "m", SubjectID(f"e{i}")))
        errs = [r for r in results if isinstance(r, Exception)]
        assert errs and all(e is boom for e in errs)
        assert co.flush_errors == 1
        # the failed group applied nothing; the coordinator goes on
        r = co.transact([T("g", "grp", "m", SubjectID("after"))], [])
        assert r.snaptoken == p.watermark()
        failed = {f"e{i}" for i, r in enumerate(results) if isinstance(r, Exception)}
        subjects = {row[3] for row in _all_rows(p)}
        assert "after" in subjects and not failed & subjects
    finally:
        co.stop()


def test_coordinator_fails_a_refused_writer_alone():
    """One writer of a coalesced group names an unknown namespace: it alone
    raises that error, the others commit with consecutive tokens."""
    from keto_tpu_torch.x.errors import ErrNamespaceUnknown

    n, bad = 6, 3
    p = port_store(NS, [])
    co = GroupCommitCoordinator(p, max_writers=16, window_ms=100.0)
    co.start()
    try:
        results = _run_writers(
            co, n, lambda i: T("nope" if i == bad else "g", "grp", "m", SubjectID(f"w{i}")),
            key=lambda i: f"w{i}")
        assert isinstance(results[bad], ErrNamespaceUnknown)
        good = [r for i, r in enumerate(results) if i != bad]
        assert sorted(r.snaptoken for r in good) == list(range(1, n))
        assert co.flush_errors == 0 and co.writers_total == n
        assert sorted(row[3] for row in _all_rows(p)) == [f"w{i}" for i in range(n) if i != bad]
    finally:
        co.stop()


def test_coordinator_stop_fails_the_writers_left_over():
    p = port_store(NS, [])
    co = GroupCommitCoordinator(p, max_writers=128, window_ms=30000.0)
    co.start()
    got: list = []

    def writer():
        try:
            got.append(co.transact([T("g", "grp", "m", SubjectID("x"))], []))
        except RuntimeError as e:
            got.append(e)

    t = threading.Thread(target=writer)
    t.start()
    time.sleep(0.2)  # the writer waits in the open window
    co.stop()
    t.join(timeout=10)
    assert len(got) == 1
    assert isinstance(got[0], RuntimeError) or got[0].snaptoken is not None
    with pytest.raises(RuntimeError, match="stopped"):
        co.transact([T("g", "grp", "m", SubjectID("y"))], [])


def test_a_full_queue_blocks_and_times_out_instead_of_shedding():
    p = port_store(NS, [])
    co = GroupCommitCoordinator(p, max_writers=1, max_pending=1, window_ms=0.0)
    # not started: the first writer waits in the queue, the second finds it full
    errors: list = []
    t = threading.Thread(target=lambda: errors.append(
        pytest.raises(TimeoutError, co.transact, [T("g", "o", "m", SubjectID("a"))], [],
                      timeout_s=0.3)))
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="queue full"):
        co.transact([T("g", "o", "m", SubjectID("b"))], [], timeout_s=0.2)
    assert time.monotonic() - t0 >= 0.19, "a full queue shed instead of blocking"
    t.join()
    assert p.watermark() == 0
    co.stop()


def test_daemon_drains_its_writers():
    d = Daemon([tns.Namespace(id=0, name="acl")], device="cpu")
    d.start()
    results = _run_writers(d.writer, 8, lambda i: RelationTuple.from_string(f"acl:o#r@u{i}"))
    out = d.drain_and_shutdown(5.0)
    assert out["writers_idle"] and out["batcher_idle"] and out["servers_idle"]
    assert sorted(r.snaptoken for r in results) == list(range(1, 9))
    with pytest.raises(RuntimeError, match="stopped"):
        d.writer.transact([RelationTuple.from_string("acl:o#r@late")], [])


# -- the engine over group commits -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_group_commit_overlay_fuzz_parity(seed):
    """Grouped keyed and unkeyed writes with tombstones, a wildcard key and
    subject sets, on an engine with a tiny overlay budget and segment-bounded
    folds: its decisions equal the oracle's, the JAX engine's over the same
    groups and a serially committed twin's store."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    rng = np.random.default_rng(3000 + seed)
    n = 6
    base = [T("d", "doc", "view", SubjectSet("g", "s0", "m")),
            T("g", "grp", "", SubjectID("seed"))]
    base += [T("g", f"s{i}", "m", SubjectSet("g", f"s{(i + 1) % n}", "m")) for i in range(n)]
    base.append(T("g", "s2", "m", SubjectID("u0")))
    p, twin, ref = port_store(WILD_NS, base), port_store(WILD_NS, base), jax_store(WILD_NS, base)
    kw = dict(compact_after_s=3600.0, overlay_edge_budget=6, fold_segment_edges=3)
    eng = TorchCheckEngine(p, p.namespaces, device="cpu", **kw)
    reng = TpuCheckEngine(ref, ref.namespaces, **kw)
    try:
        users = [f"u{i}" for i in range(4)] + ["ghost"]
        qs = [T("d", "doc", "view", SubjectID(u)) for u in users]
        qs += [T("g", f"s{i}", "m", SubjectID(u)) for i in range(n) for u in users[:2]]
        qs.append(T("", "", "", SubjectID("seed")))
        oracle = CheckEngine(p)
        live = list(base)
        for rnd in range(8):
            writes = []
            for _ in range(rng.integers(1, 5)):
                if live and rng.random() < 0.3:
                    writes.append(TransactWrite(delete=(live[rng.integers(len(live))],)))
                else:
                    sub = (SubjectID(users[rng.integers(len(users))]) if rng.random() < 0.5
                           else SubjectSet("g", f"s{rng.integers(n)}", "m"))
                    key = f"f{seed}-{rnd}-{len(writes)}" if rng.random() < 0.5 else None
                    writes.append(TransactWrite(insert=(T("g", f"s{rng.integers(n)}", "m", sub),),
                                                idempotency_key=key))
            got = p.transact_many(writes)
            ref.transact_many([jw(w) for w in writes])
            solo = [twin.transact_relation_tuples(w.insert, w.delete,
                                                  idempotency_key=w.idempotency_key)
                    for w in writes]
            assert [r.snaptoken for r in got] == [r.snaptoken for r in solo]
            assert _all_rows(p) == _all_rows(twin) == _ref_rows(ref)
            live = _tuples(p)
            want = [oracle.subject_is_allowed(q) for q in qs]
            assert eng.batch_check(qs) == want == reng.batch_check([jt(q) for q in qs]), rnd
            if rnd % 3 == 2:
                for e in (eng, reng):
                    for _ in range(6):
                        e._refresh_pass()
                        if not e._snapshot.has_overlay:
                            break
                assert eng.batch_check(qs) == want == reng.batch_check([jt(q) for q in qs])
    finally:
        eng.close()
        reng.close()


def test_store_reads_of_a_group_are_consistent():
    """A reader between groups sees every writer of a committed group or
    none of an uncommitted one: the group holds the store lock."""
    p = port_store(NS, [])
    stop = threading.Event()
    seen: list = []

    def reader():
        while not stop.is_set():
            n = len(p.get_relation_tuples(RelationQuery(namespace="g"))[0])
            seen.append(n)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for k in range(20):
            p.transact_many([TransactWrite(insert=(T("g", f"o{k}", "m", SubjectID(f"u{i}")),))
                             for i in range(5)])
    finally:
        stop.set()
        t.join()
    assert all(n % 5 == 0 for n in seen), sorted(set(seen))
