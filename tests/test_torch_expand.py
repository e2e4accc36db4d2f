"""Expand on the port against the reference.

The port's Manager-backed ``ExpandEngine`` and its ``SnapshotExpandEngine``
over ``TorchCheckEngine(device="cpu")`` must build the trees the
reference's do on the same writes: ``ExpandEngine`` over the reference
store and ``SnapshotExpandEngine`` over a JAX-CPU ``TpuCheckEngine``, tree
for tree with children in order, overlays pending included. The cases are
tests/test_expand_engine.py's and tests/test_tpu_expand.py's, each held
against the reference as well as against its own claim (the snapshot
engine's trees equal the Manager's, exactly on literal stores and after
collapsing duplicate siblings on wildcard stores).
"""

from __future__ import annotations

import random

import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.expand import LEAF, UNION, ExpandEngine, Tree
from keto_tpu_torch.expand.snapshot_engine import SnapshotExpandEngine
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.errors import (
    ErrBadRequest,
    ErrDuplicateSubject,
    ErrNamespaceUnknown,
    ErrNilSubject,
)


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def to_ref(x):
    """A port tuple or subject as the reference's type."""
    from keto_tpu.relationtuple.model import RelationTuple as JT
    from keto_tpu.relationtuple.model import SubjectID as JID
    from keto_tpu.relationtuple.model import SubjectSet as JSet

    if isinstance(x, SubjectID):
        return JID(id=x.id)
    if isinstance(x, SubjectSet):
        return JSet(x.namespace, x.object, x.relation)
    return JT(namespace=x.namespace, object=x.object, relation=x.relation,
              subject=to_ref(x.subject))


def from_ref(tree):
    return None if tree is None else Tree.from_json(tree.to_json())


class Pair:
    """The same writes in the port's store and the reference's, with the
    Manager-backed and snapshot-backed expand engines of both."""

    def __init__(self, namespaces):
        from keto_tpu import namespace as jns
        from keto_tpu.check.tpu_engine import TpuCheckEngine
        from keto_tpu.expand.engine import ExpandEngine as RefExpand
        from keto_tpu.expand.tpu_engine import SnapshotExpandEngine as RefSnapshotExpand
        from keto_tpu.persistence.memory import MemoryPersister as JaxPersister

        self.p = MemoryPersister(tns.MemoryManager([tns.Namespace(id=i, name=n)
                                                    for n, i in namespaces]))
        self.r = JaxPersister(jns.MemoryManager([jns.Namespace(id=i, name=n)
                                                 for n, i in namespaces]))
        # no time-based fold on either side: both hold their overlays until
        # a write passes the budget, so the two snapshots stay comparable
        self.engine = TorchCheckEngine(self.p, self.p.namespaces, device="cpu",
                                       labels_enabled=False, compact_after_s=3600.0)
        self.ref_engine = TpuCheckEngine(self.r, self.r.namespaces, compact_after_s=3600.0)
        self.host = ExpandEngine(self.p)
        self.snap = SnapshotExpandEngine(self.engine, self.p.namespaces)
        self.ref_host = RefExpand(self.r)
        self.ref_snap = RefSnapshotExpand(self.ref_engine, self.r.namespaces)

    def write(self, *ts):
        self.p.write_relation_tuples(*ts)
        self.r.write_relation_tuples(*(to_ref(t) for t in ts))

    def delete(self, *ts):
        self.p.delete_relation_tuples(*ts)
        self.r.delete_relation_tuples(*(to_ref(t) for t in ts))

    def trees(self, sub, depth):
        """(port Manager, port snapshot) trees, each held equal, in order,
        to its reference counterpart; the two snapshot engines see the
        same overlay."""
        h = self.host.build_tree(sub, depth)
        s = self.snap.build_tree(sub, depth)
        assert_tree_identical(h, from_ref(self.ref_host.build_tree(to_ref(sub), depth)),
                              f"manager {sub}@{depth}")
        assert_tree_identical(s, from_ref(self.ref_snap.build_tree(to_ref(sub), depth)),
                              f"snapshot {sub}@{depth}")
        assert self.engine.snapshot().has_overlay == self.ref_engine.snapshot().has_overlay
        return h, s

    def close(self):
        self.engine.close()
        close = getattr(self.ref_engine, "close", None)
        if close is not None:
            close()


@pytest.fixture
def pairs():
    made = []

    def make(namespaces):
        made.append(Pair(namespaces))
        return made[-1]

    yield make
    for p in made:
        p.close()


def assert_tree_identical(a, b, path="root"):
    assert (a is None) == (b is None), f"{path}: {a} vs {b}"
    if a is None:
        return
    assert a.type == b.type, f"{path}: type {a.type} != {b.type}"
    assert a.subject == b.subject, f"{path}: subject {a.subject} != {b.subject}"
    assert [str(c.subject) for c in a.children] == [str(c.subject) for c in b.children], path
    for i, (ca, cb) in enumerate(zip(a.children, b.children)):
        assert_tree_identical(ca, cb, f"{path}.{i}")


def normalize(tree):
    """Collapse duplicate siblings (same subject), keeping the expanded
    occurrence if any: the multiplicity the snapshot engine collapses."""
    if tree is None:
        return None
    by_subject, order = {}, []
    for c in tree.children:
        nc = normalize(c)
        k = str(nc.subject)
        prev = by_subject.get(k)
        if prev is None:
            by_subject[k] = nc
            order.append(k)
        elif nc.children and not prev.children:
            by_subject[k] = nc
    tree.children = [by_subject[k] for k in order]
    return tree


def reached_subjects(tree, acc=None):
    acc = set() if acc is None else acc
    if tree is not None:
        acc.add(str(tree.subject))
        for c in tree.children:
            reached_subjects(c, acc)
    return acc


# -- tests/test_expand_engine.py, both engines ---------------------------------

ENGINES = ["manager", "snapshot"]


def pick(pair_trees, which):
    return pair_trees[ENGINES.index(which)]


@pytest.mark.parametrize("which", ENGINES)
def test_expand_id_subject_is_leaf(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "x", "r", SubjectID("someone")))
    tree = pick(p.trees(SubjectID("user"), 100), which)
    assert tree.type == LEAF and tree.subject == SubjectID("user")


@pytest.mark.parametrize("which", ENGINES)
def test_expand_union_of_members(pairs, which):
    p = pairs([("n", 1)])
    users = ["u1", "u2", "u3"]
    for u in users:
        p.write(T("n", "obj", "access", SubjectID(u)))
    tree = pick(p.trees(SubjectSet("n", "obj", "access"), 100), which)
    assert tree.type == UNION
    assert [str(c.subject) for c in tree.children] == users
    assert all(c.type == LEAF for c in tree.children)


@pytest.mark.parametrize("which", ENGINES)
def test_expand_nested(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "obj", "access", SubjectSet("n", "org", "member")),
            T("n", "org", "member", SubjectID("u1")),
            T("n", "org", "member", SubjectID("u2")))
    tree = pick(p.trees(SubjectSet("n", "obj", "access"), 100), which)
    assert tree.type == UNION and len(tree.children) == 1
    org = tree.children[0]
    assert org.type == UNION and org.subject == SubjectSet("n", "org", "member")
    assert {str(c.subject) for c in org.children} == {"u1", "u2"}


@pytest.mark.parametrize("which", ENGINES)
def test_expand_depth_limit_truncates_to_leaf(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "obj", "access", SubjectSet("n", "org", "member")),
            T("n", "org", "member", SubjectID("u1")))
    tree = pick(p.trees(SubjectSet("n", "obj", "access"), 2), which)
    assert tree.type == UNION
    assert tree.children[0].type == LEAF
    assert tree.children[0].subject == SubjectSet("n", "org", "member")


@pytest.mark.parametrize("which", ENGINES)
def test_expand_depth_zero_and_empty_set_are_none(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "other", "rel", SubjectID("u")))
    assert pick(p.trees(SubjectSet("n", "obj", "rel"), 0), which) is None
    assert pick(p.trees(SubjectSet("n", "obj", "rel"), 10), which) is None


@pytest.mark.parametrize("which", ENGINES)
def test_expand_cycle_terminates(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "a", "r", SubjectSet("n", "b", "r")),
            T("n", "b", "r", SubjectSet("n", "a", "r")))
    tree = pick(p.trees(SubjectSet("n", "a", "r"), 100), which)
    assert tree.type == UNION
    b = tree.children[0]
    assert b.subject == SubjectSet("n", "b", "r")
    assert b.children[0].type == LEAF and b.children[0].subject == SubjectSet("n", "a", "r")


@pytest.mark.parametrize("which", ENGINES)
def test_tree_json_roundtrip(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "obj", "access", SubjectSet("n", "org", "member")),
            T("n", "org", "member", SubjectID("u1")))
    tree = pick(p.trees(SubjectSet("n", "obj", "access"), 100), which)
    assert Tree.from_json(tree.to_json()).equals(tree)
    from keto_tpu.expand.tree import Tree as RefTree

    ref = RefTree.from_json(tree.to_json())
    assert ref.to_json() == tree.to_json() and str(ref) == str(tree)


@pytest.mark.parametrize("which", ENGINES)
def test_expand_agrees_with_check(pairs, which):
    p = pairs([("n", 1)])
    p.write(T("n", "obj", "access", SubjectSet("n", "org", "member")),
            T("n", "obj", "access", SubjectID("direct")),
            T("n", "org", "member", SubjectID("u1")))
    tree = pick(p.trees(SubjectSet("n", "obj", "access"), 100), which)
    e = CheckEngine(p.p)

    def leaves(t):
        if t.type == LEAF and isinstance(t.subject, SubjectID):
            yield t.subject
        for c in t.children:
            yield from leaves(c)

    found = list(leaves(tree))
    assert {s.id for s in found} == {"direct", "u1"}
    for s in found:
        assert e.subject_is_allowed(T("n", "obj", "access", s))
        assert p.engine.subject_is_allowed(T("n", "obj", "access", s))


@pytest.mark.parametrize("body,err", [
    ({"type": "nope", "subject_id": "u"}, ErrBadRequest),
    ({"type": "leaf"}, ErrNilSubject),
    ({"type": "leaf", "subject_id": "u", "subject_set": {"namespace": "n"}}, ErrDuplicateSubject),
    ({"type": "leaf", "subject_id": 3}, ErrBadRequest),
    ({"type": "union", "subject_id": "u", "children": {}}, ErrBadRequest),
])
def test_tree_from_json_rejects_like_the_reference(body, err):
    from keto_tpu.expand.tree import Tree as RefTree
    from keto_tpu.x.errors import KetoError as RefError

    with pytest.raises(err):
        Tree.from_json(body)
    with pytest.raises(RefError):
        RefTree.from_json(body)


# -- tests/test_tpu_expand.py --------------------------------------------------


def _literal_store(pairs, seed):
    rng = random.Random(seed)
    p = pairs([("ns0", 1), ("ns1", 2)])
    names, objs, rels, users = ["ns0", "ns1"], [f"o{i}" for i in range(8)], ["r0", "r1", "r2"], \
        [f"u{i}" for i in range(6)]
    seen, tuples = set(), []
    for _ in range(rng.randrange(30, 150)):
        sub = (SubjectID(rng.choice(users)) if rng.random() < 0.4
               else SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels)))
        t = T(rng.choice(names), rng.choice(objs), rng.choice(rels), sub)
        if str(t) not in seen:  # duplicates collapse in the graph: tier 2's topic
            seen.add(str(t))
            tuples.append(t)
    p.write(*tuples)
    return p, names, objs, rels, users


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_parity_literal_fuzz(pairs, seed):
    p, names, objs, rels, users = _literal_store(pairs, seed)
    rng = random.Random(1000 + seed)
    for _ in range(60):
        sub = SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels))
        depth = rng.choice([1, 2, 3, 5, 100])
        h, s = p.trees(sub, depth)
        assert_tree_identical(h, s, f"{sub}@{depth}")
    h, s = p.trees(SubjectID(users[0]), 5)
    assert_tree_identical(h, s)


def _wild_store(pairs, seed):
    rng = random.Random(seed)
    p = pairs([("ns0", 1), ("ns1", 2), ("", 3)])
    names, objs, rels, users = ["ns0", "ns1", ""], [f"o{i}" for i in range(6)], \
        ["r0", "r1", ""], [f"u{i}" for i in range(5)]
    tuples = []
    for _ in range(rng.randrange(20, 120)):
        sub = (SubjectID(rng.choice(users)) if rng.random() < 0.4
               else SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels)))
        tuples.append(T(rng.choice(names), rng.choice(objs), rng.choice(rels), sub))
    p.write(*tuples)
    return p, names, objs, rels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalized_parity_wildcard_fuzz(pairs, seed):
    p, names, objs, rels = _wild_store(pairs, seed)
    rng = random.Random(2000 + seed)
    for _ in range(50):
        sub = SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels))
        depth = rng.choice([1, 2, 3, 5, 100])
        h, s = (normalize(t) for t in p.trees(sub, depth))
        if h is None or s is None:
            assert h is None and s is None, f"{sub}@{depth}: {h} vs {s}"
        else:
            assert h.equals(s), f"{sub}@{depth}:\n{h}\nvs\n{s}"


def test_depth_and_cycle_semantics(pairs):
    p = pairs([("g", 1)])
    p.write(T("g", "a", "m", SubjectSet("g", "b", "m")),
            T("g", "b", "m", SubjectSet("g", "a", "m")),
            T("g", "b", "m", SubjectID("u")))
    for depth in (1, 2, 3, 4, 10):
        assert_tree_identical(*p.trees(SubjectSet("g", "a", "m"), depth), f"depth={depth}")
    assert p.trees(SubjectSet("g", "a", "m"), 0) == (None, None)
    assert p.trees(SubjectID("u"), 3)[1].type == "leaf"
    assert p.trees(SubjectSet("g", "nope", "m"), 5) == (None, None)


def test_unknown_namespace_raises(pairs):
    from keto_tpu.x.errors import ErrNamespaceUnknown as RefUnknown

    p = pairs([("g", 1)])
    p.write(T("g", "a", "m", SubjectID("u")))
    with pytest.raises(ErrNamespaceUnknown):
        p.snap.build_tree(SubjectSet("ghost", "a", "m"), 5)
    with pytest.raises(RefUnknown):
        p.ref_snap.build_tree(to_ref(SubjectSet("ghost", "a", "m")), 5)


def test_expand_sees_delta_overlay(pairs):
    p = pairs([("g", 1)])
    p.write(T("g", "root", "m", SubjectSet("g", "mid", "m")),
            T("g", "mid", "m", SubjectSet("g", "leafgrp", "m")),
            T("g", "leafgrp", "m", SubjectID("u1")))
    assert p.trees(SubjectSet("g", "root", "m"), 10)[1] is not None
    # interior → sink and interior → interior (a cycle through the delta)
    p.write(T("g", "mid", "m", SubjectID("u2")),
            T("g", "mid", "m", SubjectSet("g", "root", "m")))
    h, s = (normalize(t) for t in p.trees(SubjectSet("g", "root", "m"), 10))
    assert h is not None and s is not None and h.equals(s), f"{h}\nvs\n{s}"


def test_pattern_root_sees_delta_overlay(pairs):
    p = pairs([("g", 1)])
    p.write(T("g", "r", "m", SubjectSet("g", "a", "m")),
            T("g", "a", "m", SubjectSet("g", "b", "m")),
            T("g", "b", "m", SubjectSet("g", "c", "m")),
            T("g", "c", "m", SubjectID("u")))
    p.trees(SubjectSet("g", "c", "m"), 5)  # the base snapshot
    p.write(T("g", "c", "m", SubjectSet("g", "b", "m")))
    h, s = (normalize(t) for t in p.trees(SubjectSet("g", "c", ""), 3))
    assert h is not None and s is not None and h.equals(s), f"{h}\nvs\n{s}"


def test_pattern_root_without_node(pairs):
    p = pairs([("a", 1), ("b", 2)])
    p.write(T("a", "o1", "r", SubjectID("u1")),
            T("a", "o2", "r", SubjectID("u2")),
            T("b", "o1", "r", SubjectID("u3")))
    for sub in (SubjectSet("", "o1", "r"), SubjectSet("a", "", "r"), SubjectSet("", "", "r"),
                SubjectSet("", "", "")):
        h, s = (normalize(t) for t in p.trees(sub, 5))
        if h is None or s is None:
            assert h is None and s is None, f"{sub}: {h} vs {s}"
        else:
            assert h.equals(s), f"{sub}:\n{h}\nvs\n{s}"


def test_delta_self_loop_renders_child(pairs):
    p = pairs([("g", 1), ("", 3)])
    p.write(T("g", "team", "r0", SubjectID("u1")),
            T("g", "x", "m", SubjectSet("g", "team", "")))
    p.trees(SubjectSet("g", "team", ""), 5)  # the base snapshot
    p.write(T("g", "team", "r1", SubjectSet("g", "team", "")))
    snap = p.engine.snapshot()
    assert snap.has_overlay or snap.ov_set_ids is None  # a delta or a rebuild: both legal
    h, s = (normalize(t) for t in p.trees(SubjectSet("g", "team", ""), 5))
    assert h is not None and s is not None and h.equals(s), f"{h}\nvs\n{s}"


def test_overlay_children_keep_manager_order(pairs):
    p = pairs([("g", 1)])
    p.write(T("g", "root", "m", SubjectID("zz")))
    p.trees(SubjectSet("g", "root", "m"), 5)
    p.write(T("g", "root", "m", SubjectID("aa")))  # sorts before the base child
    h, s = p.trees(SubjectSet("g", "root", "m"), 5)
    assert [str(c.subject) for c in h.children] == ["aa", "zz"]
    assert_tree_identical(h, s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlay_pending_semantic_parity_fuzz(pairs, seed):
    p, names, objs, rels = _wild_store(pairs, seed)
    rng = random.Random(3000 + seed)
    p.trees(SubjectSet(names[0], objs[0], rels[0]), 3)  # the base snapshot
    users = [f"u{i}" for i in range(5)]
    for _ in range(4):
        extra = []
        for _ in range(5):
            sub = (SubjectID(rng.choice(users)) if rng.random() < 0.4
                   else SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels)))
            extra.append(T(rng.choice(names), rng.choice(objs), rng.choice(rels), sub))
        p.write(*extra)
        for _ in range(15):
            sub = SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels))
            d = rng.choice([1, 2, 3, 100])
            h, s = p.trees(sub, d)
            assert (h is None) == (s is None), f"{sub}@{d}"
            assert reached_subjects(h) == reached_subjects(s), f"{sub}@{d}"


def test_delta_self_loop_on_existing_node(pairs):
    p = pairs([("g", 1)])
    p.write(T("g", "team", "r0", SubjectID("u1")))
    p.trees(SubjectSet("g", "team", "r0"), 5)
    p.write(T("g", "team", "r0", SubjectSet("g", "team", "r0")))
    h, s = p.trees(SubjectSet("g", "team", "r0"), 5)
    assert_tree_identical(h, s)
    assert sorted(str(c.subject) for c in s.children) == ["g:team#r0", "u1"]
    q = T("g", "team", "r0", SubjectSet("g", "team", "r0"))
    assert CheckEngine(p.p).subject_is_allowed(q) is True
    assert p.engine.subject_is_allowed(q) is True


def test_overlay_fast_path_serves_without_manager(pairs):
    p = pairs([("g", 1)])
    p.write(T("g", "root", "m", SubjectSet("g", "mid", "m")),
            T("g", "mid", "m", SubjectID("zz")),
            T("g", "mid", "m", SubjectID("kk")))
    p.trees(SubjectSet("g", "root", "m"), 5)

    def boom(*a, **k):
        raise AssertionError("expand delegated to the Manager engine")

    p.snap._manager_engine.build_tree = boom
    p.ref_snap._manager_engine.build_tree = boom
    p.write(T("g", "mid", "m", SubjectID("aa")))
    p.delete(T("g", "mid", "m", SubjectID("kk")))
    assert p.engine.snapshot().has_overlay, "the fixture must be served by a delta"
    h, s = p.trees(SubjectSet("g", "root", "m"), 5)
    assert_tree_identical(h, s)
    assert [str(c.subject) for c in s.children[0].children] == ["aa", "zz"]


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_overlay_order_parity_fuzz_no_wildcards(pairs, seed):
    rng = random.Random(seed)
    p = pairs([("g", 1), ("d", 2)])
    objs, rels, users = [f"o{i}" for i in range(6)], ["r0", "r1"], [f"u{i}" for i in range(5)]
    seen = set()

    def rand_tuple():
        # distinct tuples: duplicate store rows are the documented divergence
        for _ in range(50):
            sub = (SubjectID(rng.choice(users)) if rng.random() < 0.5
                   else SubjectSet("g", rng.choice(objs), rng.choice(rels)))
            t = T(rng.choice(["g", "d"]), rng.choice(objs), rng.choice(rels), sub)
            if str(t) not in seen:
                seen.add(str(t))
                return t
        return t

    p.write(*[rand_tuple() for _ in range(25)])
    p.trees(SubjectSet("g", objs[0], "r0"), 3)

    def boom(*a, **k):
        raise AssertionError("expand delegated to the Manager engine")

    p.snap._manager_engine.build_tree = boom
    for _ in range(5):
        p.write(*[rand_tuple() for _ in range(3)])
        tuples, _ = p.p.get_relation_tuples(RelationQuery())
        if tuples and rng.random() < 0.7:
            p.delete(rng.choice(tuples))
        for _ in range(10):
            sub = SubjectSet(rng.choice(["g", "d"]), rng.choice(objs), rng.choice(rels))
            d = rng.choice([1, 2, 3, 100])
            h, s = p.trees(sub, d)
            if h is None or s is None:
                assert h is None and s is None, f"{sub}@{d}: {h} vs {s}"
            else:
                assert_tree_identical(h, s)


def test_expand_after_a_bulk_load_builds_from_the_bundle(pairs):
    """The snapshot the expand serves after a bulk load is the column
    build's: the trees equal the reference's."""
    p = pairs([("g", 1), ("d", 2)])
    rng = random.Random(21)
    tuples = [T(rng.choice(["g", "d"]), f"o{rng.randrange(60)}", rng.choice(["m", "v"]),
                SubjectID(f"u{rng.randrange(400)}") if rng.random() < 0.6
                else SubjectSet("g", f"o{rng.randrange(60)}", "m")) for _ in range(4500)]
    p.write(*tuples)
    for i in range(40):
        h, s = p.trees(SubjectSet("g", f"o{i}", "m"), 3)
        assert reached_subjects(normalize(h)) == reached_subjects(normalize(s))
    assert p.engine.build_info["path"] == "columns"
