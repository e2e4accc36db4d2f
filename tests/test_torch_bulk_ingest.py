"""The port store's bulk path against the reference store's.

A write of 4,096 tuples or more takes ``_bulk_ingest``: one column pass,
the ORDER BY as a numpy lexsort, and, into an empty store, the sorted
column bundle that ``snapshot_columns`` hands the snapshot builder. Past
``LOG_CAP`` the row objects are parked (``_DeferredRows``) until a reader
needs them. The bundle must equal the reference store's array for array
(the reference's bulk path is pure numpy), the rows its ``sort_key``
order, parked rows the rows the row path builds, and every reader of the
rows must work on a parked store.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.persistence.memory import InternalRow, MemoryPersister, _DeferredRows
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.pagination import with_size

NSS = [("g", 1), ("d", 2), ("", 3)]
BUNDLE_KEYS = ("ns", "kind", "sns", "obj", "rel", "sid", "sso", "ssr")


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def rand_tuples(rng, n, with_wild=True, with_dups=True):
    """Sinks, interior chains, a wildcard-named namespace, duplicates,
    unicode and empty strings."""
    objects = [f"o{i}" for i in range(40)] + ["", "ünï", "объект"]
    users = [f"u{i}" for i in range(200)] + ["", "üser"]
    out = []
    while len(out) < n:
        ns = rng.choice(["g", "d"] + ([""] if with_wild else []))
        rel = rng.choice(["m", "v", ""])
        if rng.random() < 0.5:
            sub = SubjectID(id=rng.choice(users))
        else:
            sub = SubjectSet(namespace=rng.choice(["g", "d"]), object=rng.choice(objects),
                             relation=rng.choice(["m", "v", ""]))
        out.append(T(ns, rng.choice(objects), rel, sub))
        if with_dups and rng.random() < 0.1:
            out.append(out[-1])
    return out[:n]


def port_store(tuples=(), log_cap=None):
    p = MemoryPersister(tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NSS]))
    if log_cap is not None:
        p.LOG_CAP = log_cap
    if tuples:
        p.write_relation_tuples(*tuples)
    return p


def ref_tuple(t):
    from keto_tpu.relationtuple.model import RelationTuple as JT
    from keto_tpu.relationtuple.model import SubjectID as JID
    from keto_tpu.relationtuple.model import SubjectSet as JSet

    s = t.subject
    sub = JID(id=s.id) if isinstance(s, SubjectID) else JSet(s.namespace, s.object, s.relation)
    return JT(namespace=t.namespace, object=t.object, relation=t.relation, subject=sub)


def ref_store(tuples=()):
    from keto_tpu import namespace as jns
    from keto_tpu.persistence.memory import MemoryPersister as JaxPersister

    p = JaxPersister(jns.MemoryManager([jns.Namespace(id=i, name=n) for n, i in NSS]))
    if tuples:
        p.write_relation_tuples(*(ref_tuple(t) for t in tuples))
    return p


def rows_of(store):
    return [r.key7() + (r.seq,) for r in store.snapshot_rows()[0]]


def assert_bundles_equal(mine, ref):
    assert mine is not None and ref is not None
    assert set(mine) == set(ref) == set(BUNDLE_KEYS)
    for k in BUNDLE_KEYS:
        a, b = mine[k], ref[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("seed,n", [(0, 4096), (1, 5000), (2, 9000)])
def test_bundle_equals_the_reference_store(seed, n):
    tuples = rand_tuples(random.Random(seed), n)
    mine, ref = port_store(tuples), ref_store(tuples)
    assert mine.watermark() == ref.watermark() == 1
    assert_bundles_equal(mine.snapshot_columns(1), ref.snapshot_columns(1))
    assert mine.snapshot_columns(0) is None
    assert rows_of(mine) == rows_of(ref)


def test_parked_rows_materialize_identically():
    """tests/test_streaming_build.py:383 on the port: past the log cap a
    bulk load parks its rows; the first reader builds the rows the row path
    builds, and the snapshots agree."""
    n = MemoryPersister.LOG_CAP + 512
    tuples = rand_tuples(random.Random(77), n, with_wild=False, with_dups=False)
    lazy = port_store(tuples)
    eager = port_store(tuples, log_cap=10**9)  # the cap is never passed: no parking
    assert isinstance(lazy._row_list, _DeferredRows) and lazy._row_list.n == n
    assert isinstance(eager._row_list, list)
    # the snapshot builder reads the bundle: still parked after
    cols = lazy.snapshot_columns(lazy.watermark())
    assert cols is not None and isinstance(lazy._row_list, _DeferredRows)
    assert_bundles_equal(cols, eager.snapshot_columns(eager.watermark()))
    got, wm1 = lazy.snapshot_rows()
    want, wm2 = eager.snapshot_rows()
    assert isinstance(lazy._row_list, list)
    assert [r.key7() + (r.seq,) for r in got] == [r.key7() + (r.seq,) for r in want]
    assert rows_of(lazy) == rows_of(ref_store(tuples))
    wild = frozenset({3})
    a, b = build_snapshot(want, wm2, wild), build_snapshot(got, wm1, wild)
    for k in ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    # a parked load keeps no insert log: no delta can span it
    assert lazy.rows_since(0) is None and lazy.changes_since(0) is None
    assert eager.rows_since(0) is not None


def test_bulk_sort_matches_key_sort():
    """tests/test_native_ingest.py:158 on the port: the lexsort orders rows
    exactly as ``sort_key`` (NULL-first, code-point order, seq ties)."""
    rng = random.Random(4)
    tuples = []
    for _ in range(5000):
        sub = (SubjectID(rng.choice(["", "a", "b", "ü", "\U0001f600"])) if rng.random() < 0.5
               else SubjectSet("g", rng.choice(["", "x", "y"]), rng.choice(["", "r"])))
        tuples.append(T("g", rng.choice(["", "o1", "o2", "Ö"]), rng.choice(["", "r1"]), sub))
    p = port_store(tuples)
    assert p.snapshot_columns(p.watermark()) is not None  # the bulk path ran
    rows, _ = p.snapshot_rows()
    resorted = sorted(rows, key=InternalRow.sort_key)
    assert [r.key7() + (r.seq,) for r in rows] == [r.key7() + (r.seq,) for r in resorted]
    # and the row path (below the bulk threshold, one write a tuple) agrees
    q = port_store()
    for i in range(0, len(tuples), 1000):
        q.write_relation_tuples(*tuples[i : i + 1000])
    assert [r.key7() for r in q.snapshot_rows()[0]] == [r.key7() for r in rows]


def test_trailing_nul_and_long_strings_take_the_row_path():
    """tests/test_manager_contract.py:353 on the port: numpy strips a
    trailing NUL and one long string inflates its column, so such a batch
    takes the exact row path and keeps no bundle."""
    for extra in ("a\x00", "x" * 5000):
        p = port_store()
        tuples = [T("g", f"o{i}", "m", SubjectID(f"u{i}")) for i in range(4200)]
        tuples.append(T("g", extra, "m", SubjectID("odd-user")))
        tuples.append(T("g", "a", "m", SubjectID("plain-user")))
        p.write_relation_tuples(*tuples)
        got, _ = p.get_relation_tuples(RelationQuery(namespace="g", object=extra))
        assert [t.subject.id for t in got] == ["odd-user"]
        got, _ = p.get_relation_tuples(RelationQuery(namespace="g", object="a"))
        assert [t.subject.id for t in got] == ["plain-user"]
        assert p.snapshot_columns(p.watermark()) is None
        assert rows_of(p) == rows_of(ref_store(tuples))


MUTATIONS = {
    "small write": lambda p: p.write_relation_tuples(T("g", "late", "m", SubjectID("u1"))),
    "delete": lambda p: p.delete_relation_tuples(T("g", "late", "m", SubjectID("u1"))),
    "bulk write": lambda p: p.write_relation_tuples(*rand_tuples(random.Random(9), 4500)),
    "bulk write with a delete": lambda p: p.transact_relation_tuples(
        rand_tuples(random.Random(9), 4500), [T("g", "o1", "m", SubjectID("u1"))]),
}


@pytest.mark.parametrize("what", sorted(MUTATIONS))
@pytest.mark.parametrize("parked", [False, True])
def test_any_mutation_drops_the_bundle(what, parked):
    tuples = rand_tuples(random.Random(5), 5000)
    p = port_store(tuples, log_cap=4096 if parked else None)
    assert isinstance(p._row_list, _DeferredRows) == parked
    assert p.snapshot_columns(1) is not None
    MUTATIONS[what](p)
    assert p.snapshot_columns(p.watermark()) is None and p.snapshot_columns(1) is None
    ref = ref_store(tuples)
    MUTATIONS[what](_RefView(ref))
    assert rows_of(p) == rows_of(ref)


class _RefView:
    """Applies a port mutation to the reference store (its own tuples)."""

    def __init__(self, ref):
        self.ref = ref

    def write_relation_tuples(self, *ts):
        self.ref.write_relation_tuples(*(ref_tuple(t) for t in ts))

    def delete_relation_tuples(self, *ts):
        self.ref.delete_relation_tuples(*(ref_tuple(t) for t in ts))

    def transact_relation_tuples(self, ins, dels):
        self.ref.transact_relation_tuples([ref_tuple(t) for t in ins],
                                          [ref_tuple(t) for t in dels])


def _read_all(p, query, size=500):
    out, tok = [], ""
    while True:
        from keto_tpu_torch.x.pagination import with_token

        got, tok = p.get_relation_tuples(query, with_token(tok), with_size(size))
        out += [str(t) for t in got]
        if not tok:
            return out


READERS = {
    "get_relation_tuples (scan)": lambda p: _read_all(p, RelationQuery(namespace="g")),
    "get_relation_tuples (LHS index)": lambda p: _read_all(
        p, RelationQuery(namespace="g", object="o1", relation="m")),
    "transact (write)": lambda p: (p.write_relation_tuples(T("d", "o2", "v", SubjectID("new"))),
                                   rows_of(p))[1],
    "transact (delete)": lambda p: (p.delete_relation_tuples(T("g", "o1", "m", SubjectID("u1"))),
                                    rows_of(p))[1],
    "snapshot_rows": rows_of,
    "snapshot_scan": lambda p: (lambda chunks: (p.snapshot_scan(chunks.append, chunk_rows=777),
                                                [r.key7() + (r.seq,) for c in chunks for r in c])[1])(
        []),
    "fork": lambda p: rows_of(p.fork()),
    "oracle CheckEngine": lambda p: [CheckEngine(p).subject_is_allowed(t)
                                     for t in rand_tuples(random.Random(3), 40)],
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_every_reader_works_on_a_parked_store(reader):
    tuples = rand_tuples(random.Random(6), 5000)
    parked = port_store(tuples, log_cap=4096)
    eager = port_store(tuples, log_cap=10**9)
    assert isinstance(parked._row_list, _DeferredRows)
    assert READERS[reader](parked) == READERS[reader](eager)
    assert isinstance(parked._row_list, list)


def test_fork_materializes_once_and_carries_the_bundle():
    tuples = rand_tuples(random.Random(8), 5000)
    p = port_store(tuples, log_cap=4096)
    cols = p.snapshot_columns(p.watermark())
    f = p.fork()
    assert isinstance(p._row_list, list) and isinstance(f._row_list, list)
    assert f.watermark() == p.watermark()
    assert f.snapshot_columns(f.watermark()) is cols
    assert rows_of(f) == rows_of(p)
    # a write to the fork drops the fork's bundle, not the parent's
    f.write_relation_tuples(T("g", "fork-only", "m", SubjectID("u")))
    assert f.snapshot_columns(f.watermark()) is None
    assert p.snapshot_columns(p.watermark()) is cols


def test_a_bulk_load_into_a_full_store_keeps_no_bundle():
    p = port_store(rand_tuples(random.Random(1), 10))
    more = rand_tuples(random.Random(2), 4500)
    p.write_relation_tuples(*more)
    assert p.snapshot_columns(p.watermark()) is None
    ref = ref_store(rand_tuples(random.Random(1), 10))
    ref.write_relation_tuples(*(ref_tuple(t) for t in more))
    assert rows_of(p) == rows_of(ref)
    # bulk rows come sorted, and the insert log keeps them in that order
    rows, _ = p.rows_since(1)
    assert [r.key7() for r in rows] == [r.key7() for r in ref.rows_since(1)[0]]
