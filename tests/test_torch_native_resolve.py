"""The engine's native bulk resolve against the host loops.

``TorchCheckEngine._resolve_bulk`` (the C++ intern tables through
``_resolve_bulk_native``) must equal the reference's ``_resolve_bulk_py``
(JAX-CPU ``TpuCheckEngine``) and the port's own ``_resolve_bulk_py`` entry
for entry (``sd``, ``tg``, ``multi``): on the fuzz of
tests/test_tpu_check.py:216-259, its empty-subject-namespace cases, after
inserts that create overlay nodes, after a fold (``ExtendedInterned``), and
where a separator byte sends the batch to the counted host loop. The
engines' decisions then equal the reference engine's, unsharded and
sharded.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.graph.interner import ExtendedInterned
from keto_tpu_torch.graph.native import NativeInterned
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_overlay import Pair, jt
from test_torch_write_path import QUIET

NS3 = [("ns0", 0), ("ns1", 1), ("", 3)]
#: no namespace named "": a graph without wildcard nodes takes inserts as deltas
NS2 = NS3[:2]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def fuzz_case(seed):
    """The store and 128 queries of tests/test_tpu_check.py:216-259."""
    rng = random.Random(seed)
    ns_names = ["ns0", "ns1", ""]
    objects = [f"o{i}" for i in range(6)]
    relations = ["r0", "r1", ""]
    users = [f"u{i}" for i in range(5)]

    def rand_set():
        return SubjectSet(rng.choice(ns_names), rng.choice(objects), rng.choice(relations))

    tuples = []
    for _ in range(rng.randrange(10, 80)):
        sub = SubjectID(rng.choice(users)) if rng.random() < 0.4 else rand_set()
        tuples.append(T(rng.choice(ns_names), rng.choice(objects), rng.choice(relations), sub))
    queries = []
    for _ in range(128):
        sub = SubjectID(rng.choice(users + ["ghost"])) if rng.random() < 0.5 else rand_set()
        queries.append(
            T(rng.choice(ns_names + ["nope"]), rng.choice(objects), rng.choice(relations), sub)
        )
    return tuples, queries


class Engines:
    """A port engine and the reference engine over the same writes."""

    def __init__(self, namespaces, tuples, **kw):
        from keto_tpu.check.tpu_engine import TpuCheckEngine

        self.pair = Pair(namespaces, tuples)
        nm = tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in namespaces])
        self.port = TorchCheckEngine(self.pair.mine, nm, device="cpu", labels_enabled=False,
                                     **kw)
        self.ref = TpuCheckEngine(self.pair.ref, self.pair.ref.namespaces, labels_enabled=False,
                                  native_pack_enabled=False, device_build_enabled=False, **kw)

    def resolve(self, queries, path="resolve_native_batches"):
        """The port's ``_resolve_bulk`` on the path named, equal to both host
        loops entry for entry; returns the port's snapshot."""
        snap, rsnap = self.port.snapshot(), self.ref.snapshot()
        before = self.port.counters().get(path, 0)
        got = self.port._resolve_bulk(snap, queries)
        assert self.port.counters()[path] == before + 1
        assert_resolved_equal(got, self.port._resolve_bulk_py(snap, queries))
        assert_resolved_equal(got, self.ref._resolve_bulk_py(rsnap, [jt(q) for q in queries]))
        return snap

    def close(self):
        self.port.close()
        self.ref.close()


def assert_resolved_equal(a, b):
    (sd, tg, multi), (sd2, tg2, multi2) = a, b
    assert sd.dtype == sd2.dtype and np.array_equal(sd, sd2)
    assert tg.dtype == tg2.dtype and np.array_equal(tg, tg2)
    assert multi.keys() == multi2.keys()
    for i in multi:
        for x, y in zip(multi[i], multi2[i]):
            assert np.array_equal(x, y), i


@pytest.fixture
def engines():
    made = []

    def make(*args, **kw):
        e = Engines(*args, **kw)
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


@pytest.mark.parametrize("seed", range(4))
def test_bulk_resolve_fuzz_parity(engines, seed):
    tuples, queries = fuzz_case(seed)
    e = engines(NS3, tuples)
    snap = e.resolve(queries)
    assert isinstance(snap.interned, NativeInterned)


def test_bulk_resolve_wild_subject_namespace_parity(engines):
    # tests/test_tpu_check.py:262: a literal start with an empty-namespace
    # subject set resolves literally (a single row, never -2)
    e = engines([("ns0", 0), ("", 3)], [T("ns0", "o0", "r1", SubjectSet("", "o5", "r0")),
                                         T("", "o5", "r0", SubjectID("u1"))])
    queries = [T("ns0", "o0", "r1", SubjectSet("", "o5", "r0")),
               T("ns0", "o0", "r1", SubjectID("u1"))]
    snap = e.resolve(queries)
    sd, tg, multi = e.port._resolve_bulk(snap, queries)
    assert sd[0] >= 0 and tg[0] >= 0 and 0 not in multi
    assert e.port.batch_check(queries) == [True, True]


def test_bulk_resolve_wild_subject_without_empty_namespace(engines):
    # no namespace named "": the start resolves, the target cannot exist
    e = engines([("ns0", 0)], [T("ns0", "o0", "r1", SubjectID("u1"))])
    queries = [T("ns0", "o0", "r1", SubjectSet("", "o5", "r0"))]
    snap = e.resolve(queries)
    sd, tg, _ = e.port._resolve_bulk(snap, queries)
    assert sd[0] >= 0 and tg[0] == -1
    assert e.port.batch_check(queries) == [False]


GROUPS = [T("ns0", "doc", "view", SubjectSet("ns0", "team", "member")),
          T("ns0", "team", "member", SubjectSet("ns1", "core", "m")),
          T("ns1", "core", "m", SubjectSet("ns0", "team", "member")),
          T("ns1", "core", "m", SubjectID("alice")),
          T("ns1", "core", "m", SubjectID("bob"))]
NEW = [T("ns0", "team", "member", SubjectID("carol")),
       T("ns0", "doc2", "view", SubjectSet("ns1", "new", "m")),
       T("ns0", "doc2", "view", SubjectID("dave")),
       T("ns1", "core", "m", SubjectSet("ns1", "new", "m"))]


def universe():
    objs = [("ns0", "doc"), ("ns0", "doc2"), ("ns0", "team"), ("ns1", "core"), ("ns1", "new"),
            ("", "any"), ("ns0", ""), ("nope", "doc")]
    rels = ["view", "member", "m", "r0"]
    subs = [SubjectID(u) for u in ("alice", "bob", "carol", "dave", "ghost")]
    subs += [SubjectSet(ns, o, r) for ns, o in objs[:5] for r in ("member", "m")]
    subs += [SubjectSet("", "any", "r0"), SubjectSet("nope", "core", "m")]
    return [T(ns, o, r, s) for ns, o in objs for r in rels for s in subs]


def test_bulk_resolve_overlay_nodes_then_fold(engines):
    """Inserts create overlay set nodes and leaves the C++ tables do not
    hold: their misses re-resolve through the host loop in one call. After
    the fold the snapshot interns through ``ExtendedInterned`` over the
    native base, whose ``resolve_queries`` re-offsets the leaves."""
    e = engines(NS2, GROUPS, **QUIET)
    queries = universe()
    e.resolve(queries)
    e.pair.write(NEW)
    snap = e.resolve(queries)
    assert snap.has_overlay and snap.ov_set_ids and snap.ov_leaf_ids
    want = e.ref.batch_check([jt(q) for q in queries])
    assert e.port.batch_check(queries) == [bool(x) for x in want]
    for eng in (e.port, e.ref):
        eng._refresh_force_full = True
        for _ in range(20):
            eng._refresh_pass()
            if not eng._snapshot.has_overlay:
                break
    snap = e.resolve(queries)
    assert not snap.has_overlay
    assert isinstance(snap.interned, ExtendedInterned)
    assert isinstance(snap.interned._base, NativeInterned)
    assert e.port.counters()["compactions"] == 1
    # the leaves past the base's sets moved by the extension set count
    start, sub = snap.interned.resolve_queries(
        b"0\x1fteam\x1fmember\x1f1\x1falice\x1f\x1f\x1e", 1)
    assert sub[0] == snap.interned.resolve_leaf("alice") + snap.num_sets
    assert e.port.batch_check(queries) == [bool(x) for x in want]


def test_separator_byte_takes_the_counted_host_loop(engines):
    e = engines(NS2, GROUPS + [T("ns0", "bad\x1fobj", "view", SubjectID("alice"))])
    queries = [T("ns0", "bad\x1fobj", "view", SubjectID("alice")),
               T("ns0", "doc", "view", SubjectID("alice"))]
    e.resolve(queries, path="resolve_python_batches")
    assert e.port.batch_check(queries) == [True, True]
    e.resolve(queries[1:])


@pytest.mark.parametrize("graph", [None, 3])
@pytest.mark.parametrize("labels", [False, True])
def test_decisions_equal_the_reference_engine(graph, labels):
    """The whole Check over the native resolve and pack: the reference
    engine's decisions and the oracle's, on the fuzz and on the group
    universe, unsharded and on a 3-shard mesh, on the BFS and label
    routes; every batch took the native resolve."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    cases = [fuzz_case(s) for s in range(4)] + [(GROUPS + NEW, universe())]
    for tuples, queries in cases:
        pair = Pair(NS3, tuples)
        nm = tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NS3])
        port = TorchCheckEngine(pair.mine, nm, device="cpu", labels_enabled=labels,
                                mesh=None if graph is None else make_mesh(graph=graph,
                                                                         device="cpu"))
        ref = TpuCheckEngine(pair.ref, pair.ref.namespaces, labels_enabled=False)
        try:
            port.labels_settled()
            got = port.batch_check(queries)
            assert got == [bool(x) for x in ref.batch_check([jt(q) for q in queries])]
            oracle = CheckEngine(pair.mine)
            assert got == [oracle.subject_is_allowed(q) for q in queries]
            c = port.counters()
            assert c["resolve_native_batches"] >= 1 and "resolve_python_batches" not in c
            if labels and port.snapshot().labels is not None:
                assert c.get("label_checks", 0) > 0
        finally:
            port.close()
            ref.close()
