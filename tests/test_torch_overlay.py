"""The write path's host half and its kernel against the JAX package.

- the store's change logs: ``changes_since``/``rows_since`` of the port's
  ``MemoryPersister`` equal the JAX store's across mixed writes, log
  overflow included;
- ``apply_delta`` (keto_tpu_torch/graph/overlay.py) equals the JAX
  package's on every field it returns, over fuzz stores with insert-only
  windows, deletes, delete-then-reinsert, insert-then-delete in one window
  and wildcard attach, stacked twice; it returns ``None`` in exactly the
  cases where JAX does;
- K9's plain version (``slot_set_ref``, the dispatcher on CPU tensors)
  equals ``jnp.ndarray.at[].set`` word for word on the write path's layouts,
  keeps the last entry per duplicate slot, copies unless asked to write in
  place, and raises on an entry outside its target; over several targets
  (``slot_set_many``) it equals one slot set a target and raises before
  any target is written.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import random_slot_case
from keto_tpu_torch.graph.overlay import apply_delta, overlay_device_bytes, rows_as_ops
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]
WILD_NS = [("g", 1), ("d", 2), ("", 3)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def jt(t):
    from keto_tpu.relationtuple.model import RelationTuple as JT

    return JT.from_string(str(t))


def rand_tuple(rng, objects, users, nss=("g", "d")):
    rels = ["m", "v"]
    sub = (
        SubjectID(rng.choice(users))
        if rng.random() < 0.5
        else SubjectSet("g", rng.choice(objects), rng.choice(rels))
    )
    return T(rng.choice(nss), rng.choice(objects), rng.choice(rels), sub)


class Pair:
    """The same writes on the port's store and the JAX package's."""

    def __init__(self, namespaces, rows):
        self.ns = namespaces
        self.mine = port_store(namespaces, rows)
        self.ref = jax_store(namespaces, rows)

    def write(self, insert=(), delete=()):
        a = self.mine.transact_relation_tuples(list(insert), list(delete)).snaptoken
        b = self.ref.transact_relation_tuples([jt(t) for t in insert], [jt(t) for t in delete])
        assert a == b.snaptoken

    def snapshots(self):
        from keto_tpu.graph.snapshot import build_snapshot as jax_build

        wild = frozenset(i for n, i in self.ns if n == "")
        return (build_snapshot(*self.mine.snapshot_rows(), wild),
                jax_build(*self.ref.snapshot_rows(), wild))


def _ops_key(ops):
    return [(kind, p if kind == "del" else p.key7()) for kind, p in ops]


# -- the change logs ----------------------------------------------------------


@pytest.mark.parametrize("cap", [65536, 7])
def test_change_logs_equal_jax(monkeypatch, cap):
    from keto_tpu.persistence import memory as jax_memory

    monkeypatch.setattr(MemoryPersister, "LOG_CAP", cap)
    monkeypatch.setattr(jax_memory._SharedState, "LOG_CAP", cap)
    rng = random.Random(31 + cap)
    objects, users = [f"o{i}" for i in range(5)], [f"u{i}" for i in range(4)]
    pair = Pair(NS, [rand_tuple(rng, objects, users) for _ in range(12)])
    marks = [pair.mine.watermark()]
    for _ in range(10):
        tuples, _ = pair.mine.get_relation_tuples(RelationQuery())
        ins = [rand_tuple(rng, objects, users) for _ in range(rng.randrange(0, 5))]
        dels = rng.sample(tuples, min(len(tuples), rng.randrange(0, 3)))
        dels += [T("g", "nope", "m", SubjectID("ghost"))]  # not effective
        pair.write(ins, dels)
        marks.append(pair.mine.watermark())
    # a bulk write past the cap resets the log: no delta can span it
    pair.write([T("g", f"bulk{i}", "m", SubjectID("u0")) for i in range(cap + 1)])
    marks.append(pair.mine.watermark())
    for wm in [0] + marks:
        a, b = pair.mine.changes_since(wm), pair.ref.changes_since(wm)
        assert (a is None) == (b is None), wm
        if a is not None:
            assert a[1] == b[1] and _ops_key(a[0]) == _ops_key(b[0]), wm
        a, b = pair.mine.rows_since(wm), pair.ref.rows_since(wm)
        assert (a is None) == (b is None), wm
        if a is not None:
            assert a[1] == b[1] and [r.key7() for r in a[0]] == [r.key7() for r in b[0]]
    assert pair.mine.changes_since(marks[-2]) is None
    assert pair.mine.changes_since(marks[-1]) == ([], marks[-1])


def test_bulk_load_keeps_no_log():
    p = port_store(NS, [])
    p.write_relation_tuples(*[T("g", f"o{i}", "m", SubjectID("u")) for i in range(70_000)])
    assert p._insert_log == [] and p._log_floor == p.watermark()
    p.write_relation_tuples(T("g", "o1", "m", SubjectID("v")))
    ops, wm = p.changes_since(p.watermark() - 1)
    assert len(ops) == 1 and wm == p.watermark()


# -- apply_delta ----------------------------------------------------------------


def _dict_equal(a, b, what):
    a, b = a or {}, b or {}
    assert set(a) == set(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, k)
        else:
            assert x == y, (what, k)


def assert_delta_equal(mine, ref):
    assert (mine is None) == (ref is None)
    if mine is None:
        return
    for k in ("snapshot_id", "ov_next", "has_overlay", "n_edges"):
        assert getattr(mine, k) == getattr(ref, k), k
    for k in ("ov_set_ids", "ov_leaf_ids", "ov_class", "ov_out", "ov_sink_in", "ov_fwd"):
        _dict_equal(getattr(mine, k), getattr(ref, k), k)
    for k in ("ov_ell", "ov_removed"):
        a, b = getattr(mine, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert mine.ov_ell_delta == ref.ov_ell_delta
    assert mine.ell_patch == ref.ell_patch
    assert (mine.lab_dirty or set()) == (ref.lab_dirty or set())
    assert overlay_device_bytes(mine) == __import__(
        "keto_tpu.graph.overlay", fromlist=["x"]).overlay_device_bytes(ref)


def _delta_round(pair, mine, ref, wild):
    from keto_tpu.graph.overlay import apply_delta as jax_apply

    a = pair.mine.changes_since(mine.snapshot_id)
    b = pair.ref.changes_since(ref.snapshot_id)
    assert a[1] == b[1] and _ops_key(a[0]) == _ops_key(b[0])
    got = apply_delta(mine, a[0], a[1], wild)
    want = jax_apply(ref, b[0], b[1], wild)
    assert_delta_equal(got, want)
    return got, want


SCENARIOS = ("insert-only", "deletes", "delete-reinsert", "insert-delete", "wildcard", "mixed")


def _safe_inserts(rng, tuples, n):
    """Inserts a delta can mostly express: users (some new) on LHS keys
    that already have out-edges, and now and then a subject set that is
    already some tuple's subject (an overlay-ELL or sink edge, or a class
    change where the rows do not allow one)."""
    sets = [x.subject for x in tuples if isinstance(x.subject, SubjectSet)]
    out = []
    for _ in range(n):
        a = rng.choice(tuples)
        if rng.random() < 0.85 or not sets:
            sub = SubjectID(f"u{rng.randrange(8)}")
        else:
            sub = rng.choice(sets)
        out.append(T(a.namespace, a.object, a.relation, sub))
    return out


def _writes(kind, rng, pair, objects, users):
    tuples, _ = pair.mine.get_relation_tuples(RelationQuery())
    if kind == "insert-only":
        pair.write(_safe_inserts(rng, tuples, rng.randrange(1, 6)))
    elif kind == "deletes":
        pair.write((), rng.sample(tuples, min(3, len(tuples))))
    elif kind == "delete-reinsert":
        victims = rng.sample(tuples, min(2, len(tuples)))
        pair.write((), victims)
        pair.write(victims)
    elif kind == "insert-delete":
        new = _safe_inserts(rng, tuples, 3)
        pair.write(new)
        pair.write((), new[:2])
    elif kind == "wildcard":
        # literal inserts into a graph with wildcard nodes: they attach
        pair.write(_safe_inserts(rng, [t for t in tuples if t.relation], 3))
    else:
        pair.write(_safe_inserts(rng, tuples, 2) + [rand_tuple(rng, objects, users)],
                   rng.sample(tuples, min(rng.randrange(0, 3), len(tuples))))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", SCENARIOS)
def test_apply_delta_equals_jax(kind, seed):
    rng = random.Random(100 * SCENARIOS.index(kind) + seed)
    objects, users = [f"o{i}" for i in range(7)], [f"u{i}" for i in range(5)]
    ns = WILD_NS if kind == "wildcard" else NS
    rows = [rand_tuple(rng, objects, users) for _ in range(30)]
    if kind == "wildcard":
        rows += [T("g", objects[0], "", SubjectID("seed")),
                 T("d", "doc", "view", SubjectSet("g", objects[1], "")),
                 T("", objects[2], "m", SubjectID("u0"))]
    pair = Pair(ns, rows)
    wild = frozenset(i for n, i in ns if n == "")
    mine, ref = pair.snapshots()
    applied: list = []
    for _ in range(2):  # stacked deltas
        _writes(kind, rng, pair, objects, users)
        got, want = _delta_round(pair, mine, ref, wild)
        if got is None:
            break
        applied.append(got.has_overlay)
        mine, ref = got, want
    if kind in ("insert-only", "deletes", "delete-reinsert"):
        assert applied, "the scenario never applied a delta"


@pytest.mark.parametrize(
    "trigger",
    ["delete_in_wildcard_graph", "sink_gains_out", "static_gains_in", "new_wildcard_lhs",
     "namespace_config", "empty_base"],
)
def test_apply_delta_none_where_jax_is_none(trigger):
    from keto_tpu.graph.overlay import apply_delta as jax_apply

    rows = [T("g", "team", "member", SubjectSet("g", "sub", "member")),
            T("g", "sub", "member", SubjectID("alice"))]
    if trigger == "delete_in_wildcard_graph":
        rows.append(T("d", "doc", "view", SubjectSet("g", "sub", "")))
    if trigger == "empty_base":
        rows = []
    pair = Pair(NS, rows)
    mine, ref = pair.snapshots()
    wild = frozenset()
    if trigger == "delete_in_wildcard_graph":
        pair.write((), [T("g", "sub", "member", SubjectID("alice"))])
    elif trigger == "sink_gains_out":
        pair.write([T("g", "team", "member", SubjectSet("g", "leafset", "x"))])
        mine, ref = pair.snapshots()
        pair.write([T("g", "leafset", "x", SubjectID("bob"))])
    elif trigger == "static_gains_in":
        pair.write([T("d", "doc", "view", SubjectSet("g", "team", "member"))])
    elif trigger == "new_wildcard_lhs":
        pair.write([T("g", "other", "", SubjectID("bob"))])
    elif trigger == "namespace_config":
        pair.write([T("g", "team", "member", SubjectID("bob"))])
        wild = frozenset({9})
    else:
        pair.write([T("g", "team", "member", SubjectID("bob"))])
    a = pair.mine.changes_since(mine.snapshot_id)
    b = pair.ref.changes_since(ref.snapshot_id)
    got = apply_delta(mine, a[0], a[1], wild)
    want = jax_apply(ref, b[0], b[1], wild)
    assert got is None and want is None


def test_rows_since_as_ops_equals_jax():
    """An insert-only window read through ``rows_since`` and wrapped by
    ``rows_as_ops`` overlays as JAX's does."""
    from keto_tpu.graph.overlay import apply_delta as jax_apply
    from keto_tpu.graph.overlay import rows_as_ops as jax_rows_as_ops

    pair = Pair(NS, TEAM_ROWS)
    mine, ref = pair.snapshots()
    pair.write([T("g", "team", "member", SubjectID("bob")), T("d", "doc2", "view", SubjectID("c"))])
    rows, wm = pair.mine.rows_since(mine.snapshot_id)
    jrows, jwm = pair.ref.rows_since(ref.snapshot_id)
    assert_delta_equal(apply_delta(mine, rows_as_ops(rows), wm, frozenset()),
                       jax_apply(ref, jax_rows_as_ops(jrows), jwm, frozenset()))


TEAM_ROWS = [T("d", "doc", "view", SubjectSet("g", "team", "member")),
             T("g", "team", "member", SubjectID("alice")),
             T("g", "team", "member", SubjectSet("g", "core", "member")),
             T("g", "core", "member", SubjectSet("g", "team", "member"))]


def test_overlay_arms_equal_jax():
    """The overlay-aware resolution and host gathers against the JAX
    snapshot's."""
    from keto_tpu.graph.overlay import apply_delta as jax_apply

    pair = Pair(NS, TEAM_ROWS)
    mine, ref = pair.snapshots()
    pair.write([T("g", "team", "member", SubjectID("bob")), T("d", "doc2", "view", SubjectID("carol")),
                T("g", "core", "member", SubjectSet("g", "new", "x"))])
    pair.write((), [T("g", "team", "member", SubjectID("alice"))])
    rows, wm = pair.mine.changes_since(mine.snapshot_id)
    got = apply_delta(mine, rows, wm, frozenset())
    want = jax_apply(ref, *pair.ref.changes_since(ref.snapshot_id), frozenset())
    assert_delta_equal(got, want)
    for key in ((2, "doc2", "view"), (1, "new", "x"), (1, "team", "member"), (1, "zz", "m")):
        assert got.resolve_set(*key) == want.resolve_set(*key)
    for s in ("bob", "carol", "alice", "ghost"):
        assert got.resolve_leaf(s) == want.resolve_leaf(s)
    nodes = np.arange(got.ov_next, dtype=np.int64)
    for fn in ("out_neighbors_bulk", "sink_in_rows_bulk"):
        arg = nodes if fn == "out_neighbors_bulk" else nodes[got.sink_base:]
        a, b = getattr(got, fn)(arg), getattr(want, fn)(arg)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), fn
    for dev in range(got.ov_next + 1):
        assert got.is_answerable_target(dev) == want.is_answerable_target(dev)
    assert np.array_equal(got.resolve_starts(2, "", "view"), want.resolve_starts(2, "", "view"))


# -- K9: the slot set ----------------------------------------------------------------

SLOT_LAYOUTS = {  # rows, ld, entries, 1-D
    "bucket": (64, 4, 20, False),
    "bucket-cap1": (128, 1, 9, False),
    "overlay-rows": (16, 8, 24, False),
    "overlay-dst": (16, 1, 7, True),
    "mirror": (40, 64, 300, False),
    "empty": (8, 2, 0, False),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", sorted(SLOT_LAYOUTS))
def test_slot_set_equals_jax_scatter(name, seed):
    import jax.numpy as jnp

    n, ld, m, one_d = SLOT_LAYOUTS[name]
    buf, r, c, v = random_slot_case(np.random.default_rng(seed), n, ld, m, one_d=one_d)
    idx = (r,) if one_d else (r, c)
    want = np.asarray(jnp.asarray(buf).at[idx].set(jnp.asarray(v)))
    t = torch.from_numpy(buf.copy())
    got = kernels.slot_set(t, r, c, v)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(t.numpy(), buf), "a functional slot set wrote its target"
    same = kernels.slot_set(t, r, c, v, in_place=True)
    assert same is t and np.array_equal(t.numpy(), want)


def test_slot_set_keeps_last_entry_per_slot():
    buf, r, c, v = random_slot_case(np.random.default_rng(5), 30, 4, 60, dup=True)
    want = buf.copy()
    for i in range(len(r)):  # sequential: the last write wins
        want[r[i], c[i]] = v[i]
    assert np.array_equal(kernels.slot_set(torch.from_numpy(buf), r, c, v).numpy(), want)


def test_slot_set_raises_out_of_range():
    buf = torch.zeros((4, 3), dtype=torch.int32)
    for r, c in (([4], [0]), ([0], [3]), ([-1], [0])):
        with pytest.raises(ValueError, match="outside"):
            kernels.slot_set(buf, r, c, [1])
    with pytest.raises(ValueError, match="outside"):
        kernels.slot_set(torch.zeros(5, dtype=torch.int32), [5], None, [1])


#: several targets in one call: (rows, ld, entries, duplicates, 1-D) each
SLOT_MANY = {
    "bucket-patch": [(64, 4, 20, False, False), (128, 1, 9, False, False),
                     (32, 8, 40, False, False)],
    "overlay-rows-and-dst": [(16, 8, 24, False, False), (16, 1, 7, False, True)],
    "mirror-sides": [(40, 64, 300, False, False), (40, 64, 250, False, False)],
    "duplicates": [(30, 4, 60, True, False), (50, 1, 30, True, True)],
    "one-empty": [(8, 2, 0, False, False), (20, 3, 12, False, False)],
}


def _many_case(name, seed):
    rng = np.random.default_rng(seed)
    return [random_slot_case(rng, n, ld, m, dup=dup, one_d=one_d)
            for n, ld, m, dup, one_d in SLOT_MANY[name]]


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("name", sorted(SLOT_MANY))
def test_slot_set_many_equals_one_slot_set_per_target(name, in_place):
    cases = _many_case(name, len(name))
    bufs = [torch.from_numpy(buf.copy()) for buf, *_ in cases]
    targets = [(b, r, c, v) for b, (_, r, c, v) in zip(bufs, cases)]
    for fn in (kernels.slot_set_many, kernels.slot_set_many_ref):
        mine = [b.clone() for b in bufs]
        got = fn([(m, *t[1:]) for m, t in zip(mine, targets)], in_place=in_place)
        assert len(got) == len(cases)
        for out, m, (buf, r, c, v) in zip(got, mine, cases):
            want = kernels.slot_set_ref(torch.from_numpy(buf.copy()), r, c, v)
            assert np.array_equal(out.numpy(), want.numpy())
            if in_place:
                assert out is m
            else:
                assert out is not m and np.array_equal(m.numpy(), buf), "a target was written"


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("bad", [0, 1])
def test_slot_set_many_out_of_range_leaves_every_target_unchanged(bad, in_place):
    cases = _many_case("mirror-sides", 7)
    bufs = [torch.from_numpy(buf.copy()) for buf, *_ in cases]
    targets = [(b, r, c.copy(), v) for b, (_, r, c, v) in zip(bufs, cases)]
    targets[bad][2][-1] = 64  # one column past the target
    for fn in (kernels.slot_set_many, kernels.slot_set_many_ref):
        with pytest.raises(ValueError, match="outside"):
            fn(targets, in_place=in_place)
        for b, (buf, *_) in zip(bufs, cases):
            assert np.array_equal(b.numpy(), buf)
