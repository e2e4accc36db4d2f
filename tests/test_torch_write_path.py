"""The write path of Check on the CPU against the JAX engine and the oracle.

Every scenario drives a ``TorchCheckEngine`` (``device="cpu"``: the plain
K2, K3, K6, K7 and K9) and a ``TpuCheckEngine`` over the same writes, and
holds the decisions against each other and against the recursive oracle,
and the maintenance counters (``delta_applies``, ``full_rebuilds``,
``compactions``, ``fold_runs``, ``label_patches``, ``label_rebuilds``,
``label_invalidations``, ``overlay_device_applies`` and the route counters)
against the reference's: the engine scenarios of tests/test_incremental.py,
tests/test_compaction.py:115-345 and tests/test_labels.py:327-400, a fuzz
differential of interleaved inserts and deletes, and the freshness contract
of tests/test_consistency.py. Plus what only the port promises: a batch
that captured a snapshot keeps its tensors through a later delete
(copy-on-write), the serving path catches up through a delta while a
label build is held in flight (20 times in a row), REST ``PUT`` then
``GET /check?snaptoken=``, and a failed K9 launch, fold or device label
patch raises instead of falling back.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.batch import CheckBatcher
from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.graph import label_build
from keto_tpu_torch.relationtuple.model import RelationQuery, SubjectID, SubjectSet

from test_torch_overlay import NS, Pair, T, jt

#: the counters both engines keep
MAINT = ("delta_applies", "full_rebuilds", "compactions", "fold_runs", "label_patches",
         "label_patch_aborts", "label_rebuilds", "label_invalidations", "overlay_device_applies",
         "label_checks", "label_fallbacks", "label_builds", "label_device_builds")
QUIET = dict(compact_after_s=3600.0, overlay_edge_budget=1 << 20)


def manager():
    return tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NS])


class Both:
    """A port engine and a reference engine over the same writes."""

    def __init__(self, rows, **kw):
        from keto_tpu.check.tpu_engine import TpuCheckEngine

        self.pair = Pair(NS, rows)
        self.port = TorchCheckEngine(self.pair.mine, manager(), device="cpu", **kw)
        self.ref = TpuCheckEngine(self.pair.ref, self.pair.ref.namespaces, **kw)
        self.settle()

    def write(self, insert=(), delete=()):
        # a delta carries its base's index only once the base's background
        # build has landed (in both engines): settle first, so both agree
        self.settle()
        self.pair.write(insert, delete)

    def snapshots(self):
        return self.port.snapshot(), self.ref.snapshot()

    def check(self, queries, **kw):
        """Decisions of both engines and the oracle; all three agree. Both
        engines settle first (a rebuild's label build lands), so the route
        each query takes, and with it the counters, is deterministic."""
        self.settle()
        got = self.port.batch_check(queries, **kw)
        want = self.ref.batch_check([jt(q) for q in queries], **kw)
        oracle = CheckEngine(self.pair.mine)
        assert got == want, "the port diverged from the reference engine"
        assert got == [oracle.subject_is_allowed(q) for q in queries], "diverged from the oracle"
        return got

    def settle(self):
        self.port.labels_settled()
        self.ref.labels_settled()

    def fold(self):
        """Run maintenance passes on both until the overlay is folded."""
        for eng in (self.port, self.ref):
            eng._refresh_force_full = True
            for _ in range(20):
                eng._refresh_pass()
                if not eng._snapshot.has_overlay:
                    break
        self.settle()

    def counters(self):
        c = self.port.counters()
        m = self.ref.maintenance.snapshot()
        mine = {k: c.get(k, 0) for k in MAINT}
        assert mine == {k: m.get(k, 0) for k in MAINT}, "maintenance counters diverged"
        return mine

    def close(self):
        self.port.close()
        self.ref.close()


@pytest.fixture
def both():
    made = []

    def make(rows, **kw):
        b = Both(rows, **kw)
        made.append(b)
        return b

    yield make
    for b in made:
        b.close()


CHAIN = [
    T("d", "doc", "view", SubjectSet("g", "g1", "m")),
    T("g", "g1", "m", SubjectSet("g", "g2", "m")),
    T("g", "g2", "m", SubjectID("u1")),
    T("g", "g2", "m", SubjectSet("g", "g2b", "m")),
    T("g", "g2b", "m", SubjectSet("g", "g2", "m")),
    T("g", "g2b", "m", SubjectID("u2")),
]
TEAM = [T("d", "doc", "view", SubjectSet("g", "team", "member")),
        T("g", "team", "member", SubjectID("alice"))]


def deep_rows(depth, users=("alice", "bob")):
    rows = [T("d", "doc", "view", SubjectSet("g", "c0", "m"))]
    rows += [T("g", f"c{i}", "m", SubjectSet("g", f"c{i + 1}", "m")) for i in range(depth - 1)]
    rows.append(T("g", f"c{depth - 1}", "m", SubjectSet("g", "c0", "m")))
    rows += [T("g", f"c{depth - 1}", "m", SubjectID(u)) for u in users]
    return rows


# -- deltas (tests/test_incremental.py) ------------------------------------------


def test_insert_only_applies_as_delta(both):
    b = both(TEAM, **QUIET)
    base, _ = b.snapshots()
    b.write([T("g", "team", "member", SubjectID("bob")), T("d", "doc2", "view", SubjectID("carol"))])
    snap, ref = b.snapshots()
    assert snap is not base and snap.has_overlay and ref.has_overlay
    assert snap.device is base.device, "an insert-only delta re-uploaded the buckets"
    b.check([T("d", "doc", "view", SubjectID("bob")), T("d", "doc", "view", SubjectID("alice")),
             T("d", "doc2", "view", SubjectID("carol")), T("d", "doc2", "view", SubjectID("alice")),
             T("g", "team", "member", SubjectID("bob"))])
    assert b.counters()["full_rebuilds"] == 1


def test_multi_hop_through_overlay_ell_edges(both):
    rows = CHAIN[:5] + [
        T("d", "doc2", "view", SubjectSet("g", "h1", "m")),
        T("g", "h1", "m", SubjectSet("g", "h2", "m")),
        T("g", "h2", "m", SubjectID("u2")),
        T("g", "h2", "m", SubjectSet("g", "h2b", "m")),
        T("g", "h2b", "m", SubjectSet("g", "h2", "m")),
    ]
    b = both(rows, **QUIET)
    b.check([T("d", "doc", "view", SubjectID("u2"))])
    b.write([T("g", "g2", "m", SubjectSet("g", "h2", "m"))])
    snap, _ = b.snapshots()
    assert snap.ov_ell is not None and len(snap.ov_ell) == 1
    assert snap.device_overlay is not None
    b.check([T("d", "doc", "view", SubjectID("u2")), T("d", "doc", "view", SubjectID("u1")),
             T("d", "doc2", "view", SubjectID("u1")), T("g", "g1", "m", SubjectID("u2"))])
    b.counters()


def test_wildcard_node_attaches_delta_tuples(both):
    b = both([T("g", "team", "owner", SubjectID("alice")),
              T("d", "doc", "view", SubjectSet("g", "team", ""))], **QUIET)
    b.check([T("d", "doc", "view", SubjectID("alice")), T("d", "doc", "view", SubjectID("bob"))])
    b.write([T("g", "team", "editor", SubjectID("bob"))])
    assert b.snapshots()[0].has_overlay
    b.check([T("d", "doc", "view", SubjectID("bob")), T("d", "doc", "view", SubjectID("alice")),
             T("d", "doc", "view", SubjectID("eve"))])
    b.counters()


def test_reinserted_tuple_and_overlay_lhs(both):
    import numpy as np

    b = both(TEAM, **QUIET)
    b.snapshots()
    b.write([T("d", "doc", "view", SubjectSet("g", "team", "member")),
             T("g", "team", "member", SubjectSet("g", "newset", "x"))])
    snap, _ = b.snapshots()
    rows, cnts = snap.out_neighbors_bulk(np.asarray([snap.resolve_set(2, "doc", "view")]))
    assert cnts.tolist() == [1], "duplicate edge in merged out-neighbours"
    assert not snap.ov_out
    b.check([T("d", "doc", "view", SubjectID("alice")), T("d", "doc", "view", SubjectID("bob")),
             T("g", "newset", "x", SubjectID("alice")),
             T("d", "doc", "view", SubjectSet("g", "newset", "x")),
             T("g", "newset", "x", SubjectSet("g", "newset", "x"))])
    b.counters()


@pytest.mark.parametrize(
    "trigger", ["delete_in_wildcard_graph", "sink_gains_out", "static_gains_in", "new_wildcard_lhs"]
)
def test_full_rebuild_triggers(both, trigger):
    b = both([T("g", "team", "member", SubjectSet("g", "sub", "member")),
              T("g", "sub", "member", SubjectID("alice"))], **QUIET)
    base, _ = b.snapshots()
    if trigger == "delete_in_wildcard_graph":
        b.write([T("d", "doc", "view", SubjectSet("g", "sub", ""))])
        base, _ = b.snapshots()
        assert not base.has_overlay
        b.write((), [T("g", "sub", "member", SubjectID("alice"))])
    elif trigger == "sink_gains_out":
        b.write([T("g", "team", "member", SubjectSet("g", "leafset", "x"))])
        b.snapshots()
        b.write([T("g", "leafset", "x", SubjectID("bob"))])
    elif trigger == "static_gains_in":
        b.write([T("d", "doc", "view", SubjectSet("g", "team", "member"))])
    else:
        b.write([T("g", "other", "", SubjectID("bob"))])
    snap, _ = b.snapshots()
    assert snap is not base and not snap.has_overlay, f"{trigger} must force a full rebuild"
    b.check([T("g", "team", "member", SubjectID("alice")), T("g", "team", "member", SubjectID("bob")),
             T("g", "sub", "member", SubjectID("alice"))])
    b.settle()
    assert b.counters()["full_rebuilds"] >= 2


def test_no_target_sentinel_never_collides_with_overlay_ids(both):
    b = both([T("g", "a", "m", SubjectSet("g", "b", "m")), T("g", "b", "m", SubjectSet("g", "a", "m")),
              T("g", "b", "m", SubjectID("u1"))], **QUIET)
    snap, _ = b.snapshots()
    assert snap.num_live == snap.n_base_nodes
    b.write([T("g", "x", "m", SubjectID("s_new"))])
    snap2, _ = b.snapshots()
    assert min(snap2.ov_leaf_ids.values()) >= snap.num_live
    b.check([T("g", "x", "m", SubjectID("ghost")), T("g", "x", "m", SubjectID("s_new")),
             T("g", "a", "m", SubjectID("ghost")), T("g", "a", "m", SubjectID("u1"))])
    b.counters()


@pytest.mark.parametrize("case", ["leaf", "ell", "static", "reinsert", "net-out", "overlay-edge"])
def test_deletes_served_by_deltas(both, case):
    rows = {"leaf": TEAM + [T("g", "team", "member", SubjectID("bob"))], "ell": CHAIN,
            "static": [T("d", "doc", "view", SubjectSet("g", "team", "member")),
                       T("d", "doc2", "view", SubjectSet("g", "team", "member")),
                       T("g", "team", "member", SubjectID("alice"))],
            "reinsert": CHAIN, "net-out": TEAM, "overlay-edge": TEAM}[case]
    b = both(rows, **QUIET)
    base, _ = b.snapshots()
    qs = [T("d", "doc", "view", SubjectID(u)) for u in ("alice", "bob", "u1", "u2")]
    b.check(qs)
    if case == "leaf":
        b.write((), [T("g", "team", "member", SubjectID("alice"))])
    elif case == "ell":
        b.write((), [T("g", "g2", "m", SubjectSet("g", "g2b", "m"))])
    elif case == "static":
        b.write((), [T("d", "doc", "view", SubjectSet("g", "team", "member"))])
    elif case == "reinsert":
        victim = T("g", "g2", "m", SubjectSet("g", "g2b", "m"))
        b.write((), [victim])
        b.check(qs)
        b.write([victim])
    elif case == "net-out":
        b.write([T("g", "team", "member", SubjectID("bob"))])
        b.write((), [T("g", "team", "member", SubjectID("bob"))])
        b.write((), [T("g", "team", "member", SubjectID("ghost"))])
    else:
        b.write([T("g", "team", "member", SubjectID("bob"))])
        b.check(qs)
        b.write((), [T("g", "team", "member", SubjectID("bob"))])
    snap, ref = b.snapshots()
    assert snap.has_overlay == ref.has_overlay
    if case == "ell":
        assert snap.device is not base.device and snap.ov_removed is not None
        assert snap.device.buckets is not base.device.buckets, "the bucket slot was not patched"
    b.check(qs + [T("d", "doc2", "view", SubjectID("alice")),
                  T("g", "g2b", "m", SubjectID("u1")),
                  T("d", "doc", "view", SubjectSet("g", "team", "member"))])
    assert b.counters()["full_rebuilds"] == 1


def _rand_tuple(rng, objects, users):
    sub = (SubjectID(rng.choice(users)) if rng.random() < 0.5
           else SubjectSet("g", rng.choice(objects), rng.choice(["r0", "r1"])))
    return T(rng.choice(["g", "d"]), rng.choice(objects), rng.choice(["r0", "r1"]), sub)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_differential_interleaved_writes(both, seed):
    """Inserts and deletes interleaved with checks; a fold every other
    round so deltas stack on compacted snapshots; counters equal."""
    rng = random.Random(100 + seed)
    objects, users = [f"o{i}" for i in range(8)], [f"u{i}" for i in range(6)]
    b = both([_rand_tuple(rng, objects, users) for _ in range(40)], **QUIET)
    for round_ in range(6):
        queries = [T(rng.choice(["g", "d", "nope"]), rng.choice(objects), rng.choice(["r0", "r1"]),
                     SubjectID(rng.choice(users + ["ghost"])) if rng.random() < 0.6
                     else SubjectSet("g", rng.choice(objects), rng.choice(["r0", "r1"])))
                   for _ in range(40)]
        b.check(queries)
        tuples, _ = b.pair.mine.get_relation_tuples(RelationQuery())
        b.write([_rand_tuple(rng, objects, users) for _ in range(rng.randrange(1, 5))],
                rng.sample(tuples, min(2, len(tuples))))
        if round_ % 2:
            b.fold()
        b.settle()
        b.counters()


def test_stale_serving_during_rebuild(both):
    b = both([T("g", "team", "member", SubjectID("alice"))], **QUIET)
    eng, p = b.port, b.pair.mine
    base = eng.snapshot()
    gate, entered = threading.Event(), threading.Event()
    orig = p.snapshot_rows

    def blocked():
        entered.set()
        gate.wait(timeout=10)
        return orig()

    p.snapshot_rows = blocked
    p.changes_since = lambda wm: None  # as after a log overflow
    p.delete_relation_tuples(T("g", "team", "member", SubjectID("alice")))
    t = threading.Thread(target=eng.snapshot)
    t.start()
    assert entered.wait(timeout=10)
    assert eng.snapshot(at_least=base.snapshot_id) is base
    gate.set()
    t.join(timeout=10)
    assert eng.snapshot().snapshot_id == p.watermark()
    assert not eng.subject_is_allowed(T("g", "team", "member", SubjectID("alice")))


# -- folds (tests/test_compaction.py:115-345) ------------------------------------------


@pytest.mark.parametrize("case", ["insert-burst", "tombstones-restore"])
def test_fold_equals_overlay_and_rebuild(both, case):
    """(overlay) == (compacted) == (a fresh engine's full rebuild) over the
    whole small universe, on both engines."""
    if case == "insert-burst":
        rows = [T("d", "doc", "view", SubjectSet("g", "team", "member")),
                T("g", "team", "member", SubjectSet("g", "core", "member")),
                T("g", "core", "member", SubjectSet("g", "ring", "member")),
                T("g", "ring", "member", SubjectSet("g", "team", "member")),
                T("g", "core", "member", SubjectID("alice"))]
        writes = ([T("g", "core", "member", SubjectID("bob")),
                   T("g", "team", "member", SubjectID("carol")),
                   T("g", "team", "member", SubjectSet("g", "ring", "member")),
                   T("g", "team", "member", SubjectSet("g", "new", "member")),
                   T("d", "doc2", "view", SubjectSet("g", "core", "member"))], [])
        objects, rels, users = ["doc", "doc2", "team", "core", "ring", "new"], ["view", "member"], \
            ["alice", "bob", "carol", "ghost"]
    else:
        rows = [T("d", "doc", "view", SubjectSet("g", "a", "m")),
                T("g", "a", "m", SubjectSet("g", "b", "m")), T("g", "b", "m", SubjectSet("g", "a", "m")),
                T("g", "a", "m", SubjectID("u1")), T("g", "b", "m", SubjectID("u2"))]
        writes = None
        objects, rels, users = ["doc", "a", "b"], ["view", "m"], ["u1", "u2"]
    b = both(rows, **QUIET)
    b.settle()
    if writes:
        b.write(*writes)
    else:
        b.write((), [T("g", "a", "m", SubjectID("u1"))])
        b.write((), [T("g", "a", "m", SubjectSet("g", "b", "m"))])
        b.write([T("g", "a", "m", SubjectSet("g", "b", "m"))])
    qs = [T(ns, o, r, SubjectID(u)) for ns in ("g", "d") for o in objects for r in rels for u in users]
    qs += [T(ns, o, r, SubjectSet("g", so, rels[1])) for ns in ("g", "d") for o in objects
           for r in rels for so in objects]
    assert b.snapshots()[0].has_overlay
    got = b.check(qs)
    b.fold()
    snap, _ = b.snapshots()
    assert not snap.has_overlay and snap.ov_removed is None
    assert b.check(qs) == got
    fresh = TorchCheckEngine(b.pair.mine, manager(), device="cpu", labels_enabled=False)
    assert fresh.batch_check(qs) == got
    fresh.close()
    c = b.counters()
    assert c["full_rebuilds"] == 1 and c["compactions"] == 1


def test_fold_applies_pending_restore_patch(both):
    b = both([T("d", "doc", "view", SubjectSet("g", "a", "m")), T("g", "a", "m", SubjectSet("g", "b", "m")),
              T("g", "b", "m", SubjectSet("g", "a", "m")), T("g", "b", "m", SubjectID("u2"))],
             compact_after_s=3600.0, overlay_edge_budget=2)
    b.snapshots()
    b.write((), [T("g", "a", "m", SubjectSet("g", "b", "m"))])
    s1, _ = b.snapshots()
    assert s1.has_overlay and s1.ov_removed is not None
    b.check([T("d", "doc", "view", SubjectID("u2"))])
    b.write([T("g", "a", "m", SubjectSet("g", "b", "m"))]
            + [T("g", "b", "m", SubjectID(f"x{i}")) for i in range(3)])
    s2, _ = b.snapshots()
    assert s2.has_overlay, "the serving snapshot() must not pay the fold"
    b.fold()
    assert not b.port._snapshot.has_overlay
    b.check([T("d", "doc", "view", SubjectID(u)) for u in ("u2", "x1", "x2", "x3", "ghost")])
    b.counters()


def test_engine_write_burst_folds_without_rebuild(both):
    b = both([T("d", "doc", "view", SubjectSet("g", "team", "member")),
              T("g", "team", "member", SubjectSet("g", "core", "member")),
              T("g", "core", "member", SubjectSet("g", "team", "member")),
              T("g", "core", "member", SubjectID("alice"))],
             compact_after_s=3600.0, overlay_edge_budget=8)
    b.snapshots()
    b.write([T("g", "core", "member", SubjectID(f"b{i}")) for i in range(40)])
    snap, _ = b.snapshots()
    assert snap.snapshot_id == b.pair.mine.watermark() and snap.has_overlay
    snap = b.port.maintenance_settled(timeout=30)  # the background pass folds it
    assert not snap.has_overlay
    b.fold()
    b.check([T("d", "doc", "view", SubjectID(f"b{i}")) for i in range(40)]
            + [T("d", "doc", "view", SubjectID("alice")), T("d", "doc", "view", SubjectID("nope"))])
    c = b.counters()
    assert c["full_rebuilds"] == 1 and c["compactions"] >= 1


def test_overlay_compacts_in_background():
    p = Pair(NS, [T("g", "team", "member", SubjectID("alice"))]).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", compact_after_s=0.1)
    try:
        eng.snapshot()
        p.write_relation_tuples(T("g", "team", "member", SubjectID("bob")))
        assert eng.snapshot().has_overlay
        time.sleep(0.15)
        deadline = time.time() + 10
        while eng.snapshot().has_overlay and time.time() < deadline:
            time.sleep(0.05)
        assert not eng.snapshot().has_overlay, "the quiet overlay never folded"
        assert eng.subject_is_allowed(T("g", "team", "member", SubjectID("bob")))
        assert eng.counters()["full_rebuilds"] == 1
    finally:
        eng.close()


def test_checks_correct_during_compaction_races():
    rng = random.Random(3)
    p = Pair(NS, []).mine
    users = [f"u{i}" for i in range(8)]
    for g in range(6):
        p.write_relation_tuples(T("g", f"grp{g}", "m", SubjectSet("g", f"grp{(g + 1) % 6}", "m")),
                                *[T("g", f"grp{g}", "m", SubjectID(u)) for u in rng.sample(users, 3)])
    eng = TorchCheckEngine(p, manager(), device="cpu", compact_after_s=0.0)
    oracle = CheckEngine(p)
    try:
        for round_ in range(10):
            p.write_relation_tuples(T("g", f"grp{round_ % 6}", "m", SubjectID(f"w{round_}")))
            qs = [T("g", f"grp{rng.randrange(6)}", "m",
                    SubjectID(rng.choice(users + [f"w{round_}", "ghost"]))) for _ in range(30)]
            assert eng.batch_check(qs) == [oracle.subject_is_allowed(q) for q in qs], round_
        eng.maintenance_settled(timeout=30)
    finally:
        eng.close()


# -- labels (tests/test_labels.py:327-400) ----------------------------------------------


@pytest.mark.parametrize("patch", ["host", "device"])
def test_overlay_ell_insert_blocks_then_fold_restores(both, patch):
    kw = dict(QUIET, labels_device_min_edges=0 if patch == "device" else 1 << 30)
    b = both(deep_rows(6), **kw)
    b.settle()
    q = T("d", "doc", "view", SubjectID("alice"))
    b.check([q])
    b.write([T("g", "c1", "m", SubjectSet("g", "c4", "m"))])
    snap, _ = b.snapshots()
    assert snap.has_overlay and snap.ov_ell is not None and snap.lab_dirty
    m0 = b.counters()
    qs = [q, T("g", "c4", "m", SubjectID("alice")), T("g", "c5", "m", SubjectID("ghost"))]
    got = b.check(qs)
    m1 = b.counters()
    assert m1["label_invalidations"] >= 1 and m1["label_checks"] == m0["label_checks"]
    b.fold()
    snap, _ = b.snapshots()
    assert snap.labels is not None and not snap.lab_dirty
    assert b.check(qs) == got
    m2 = b.counters()
    assert m2["label_patches"] == 1 and m2["label_checks"] > m1["label_checks"]


def test_sink_burst_keeps_labels_live(both):
    b = both(deep_rows(6), **QUIET)
    b.settle()
    b.write([T("g", "c5", "m", SubjectID(f"burst-{i}")) for i in range(10)])
    snap, _ = b.snapshots()
    assert snap.has_overlay and not snap.lab_dirty
    m0 = b.counters()
    b.check([T("d", "doc", "view", SubjectID(f"burst-{i}")) for i in range(10)]
            + [T("d", "doc", "view", SubjectID("ghost"))])
    m1 = b.counters()
    assert m1["label_checks"] > m0["label_checks"] and m1["label_invalidations"] == 0


def test_tombstoned_ell_edge_blocks_labels(both):
    b = both(deep_rows(5), **QUIET)
    b.settle()
    b.write((), [T("g", "c1", "m", SubjectSet("g", "c2", "m"))])
    snap, _ = b.snapshots()
    assert snap.has_overlay and snap.lab_dirty
    assert b.check([T("d", "doc", "view", SubjectID("alice"))]) == [False]
    b.fold()
    assert b.check([T("d", "doc", "view", SubjectID("alice"))]) == [False]
    c = b.counters()
    assert c["label_rebuilds"] == 1 and c["label_builds"] == 2


# -- copy-on-write ----------------------------------------------------------------------


def test_delete_leaves_captured_tensors_unchanged():
    """A batch that captured the old snapshot keeps gathering the old
    tensors: the delete's bucket patch and the overlay scatter write copies,
    installed on the new snapshot only."""
    p = Pair(NS, deep_rows(6)).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", **QUIET)
    try:
        old = eng.snapshot()
        captured = [b.clone() for b in old.device.buckets]
        refs = list(old.device.buckets)
        p.delete_relation_tuples(T("g", "c1", "m", SubjectSet("g", "c2", "m")))
        # three overlay rows: a [4, 1] pack with one spare row
        p.write_relation_tuples(*[T("g", f"c{a}", "m", SubjectSet("g", f"c{b}", "m"))
                                  for a, b in ((0, 3), (1, 4), (2, 5))])
        new = eng.snapshot()
        p.write_relation_tuples(T("g", "c3", "m", SubjectSet("g", "c1", "m")))
        newer = eng.snapshot()
        assert eng.counters()["overlay_device_applies"] == 1
        for r, c in zip(refs, captured):
            assert r.equal(c), "a delete wrote a bucket a captured batch still reads"
        assert all(a is b for a, b in zip(old.device.buckets, refs))
        assert any(not a.equal(b) for a, b in zip(new.device.buckets, refs))
        assert new.device_overlay is not None and newer.device_overlay is not None
        assert not new.device_overlay[0].equal(newer.device_overlay[0])
        assert new.device_overlay[0].data_ptr() != newer.device_overlay[0].data_ptr()
    finally:
        eng.close()


# -- freshness (tests/test_consistency.py) ---------------------------------------------


def test_serving_mode_catches_up_via_delta_while_labels_build():
    """The reference's timing-dependent test, made deterministic: a label
    build held in flight by an event must not make the serving path serve
    stale. 20 times in a row."""
    for _ in range(20):
        p = Pair(NS, TEAM).mine
        eng = TorchCheckEngine(p, manager(), device="cpu", labels_device_min_edges=0)
        gate = threading.Event()
        real = eng._build_label_index

        def held(snap, real=real, gate=gate):
            gate.wait(30)
            return real(snap)

        eng._build_label_index = held
        try:
            eng.snapshot()  # the first build; its label build is now held
            eng._last_full_build_s = 60.0  # an expensive-rebuild history
            p.write_relation_tuples(T("g", "team", "member", SubjectID("bob")))
            p.delete_relation_tuples(T("g", "team", "member", SubjectID("alice")))
            got, token = eng.batch_check_with_token(
                [T("d", "doc", "view", SubjectID("bob")), T("d", "doc", "view", SubjectID("alice"))],
                mode="serving",
            )
            assert got == [True, False] and token == p.watermark()
        finally:
            gate.set()
            eng._label_build_wait()
            eng.close()


def test_serving_mode_never_stalls_on_rebuild():
    p = Pair(NS, TEAM).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", **QUIET)
    try:
        base = eng.snapshot()
        eng._last_full_build_s = 60.0
        gate, entered = threading.Event(), threading.Event()
        orig = p.snapshot_rows

        def blocked():
            entered.set()
            gate.wait(30)
            return orig()

        p.snapshot_rows = blocked
        p.changes_since = lambda wm: None  # forces the rebuild path
        p.write_relation_tuples(T("g", "team", "member", SubjectID("bob")))
        got, token = eng.batch_check_with_token(
            [T("d", "doc", "view", SubjectID("alice")), T("d", "doc", "view", SubjectID("bob"))],
            mode="serving")
        assert got == [True, False] and token == base.snapshot_id
        assert entered.wait(10)
        gate.set()
        eng.maintenance_settled(timeout=30)
        assert eng.batch_check([T("d", "doc", "view", SubjectID("bob"))]) == [True]
    finally:
        eng.close()


def test_at_least_token_round_trip(both):
    b = both(TEAM, **QUIET)
    b.snapshots()
    b.write([T("g", "team", "member", SubjectID("bob"))])
    token = b.pair.mine.watermark()
    got, used = b.port.batch_check_with_token([T("d", "doc", "view", SubjectID("bob"))],
                                              at_least=token)
    assert got == [True] and used >= token
    # an older token is satisfied by the current snapshot as it stands
    assert b.port.snapshot(at_least=token - 1).snapshot_id == token
    b.check([T("d", "doc", "view", SubjectID("bob"))], at_least=token)


def test_batcher_coalesces_mixed_consistency():
    p = Pair(NS, TEAM).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", **QUIET)
    seen = []
    real = eng.batch_check_stream_with_token

    def spy(tuples, **kw):
        # the batcher dispatches a round through the engine's stream, with
        # the slice info its request timelines stamp
        assert kw.pop("ordered") is False and kw.pop("with_info") is True
        seen.append(dict(kw))
        return real(tuples, ordered=False, with_info=True, **kw)

    eng.batch_check_stream_with_token = spy
    batcher = CheckBatcher(eng, window_ms=50)
    batcher.start()
    try:
        eng.snapshot()
        p.write_relation_tuples(T("g", "team", "member", SubjectID("bob")))
        token = p.watermark()
        q = T("d", "doc", "view", SubjectID("bob"))
        assert batcher.check(q) and batcher.check(q, at_least=token) and batcher.check(q, latest=True)
        assert {"at_least": None, "mode": "serving"} in seen
        assert {"at_least": token, "mode": "serving"} in seen and {"mode": "latest"} in seen
        assert batcher.check_batch([q, T("d", "doc", "view", SubjectID("ghost"))],
                                   at_least=token) == [True, False]
    finally:
        batcher.stop()
        eng.close()


def _req(method, port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw = resp.read()
            return resp.status, dict(resp.headers), json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, dict(e.headers), json.loads(raw) if raw else None


def test_rest_put_then_check_with_snaptoken():
    d = Daemon([tns.Namespace(id=i, name=n) for n, i in NS], device="cpu", tuples=deep_rows(4),
               engine_options=QUIET)
    d.start()
    try:
        new = T("g", "c3", "m", SubjectID("carol"))
        status, headers, _ = _req("PUT", d.write.port, "/relation-tuples", new.to_json())
        assert status == 201
        token = int(headers["X-Keto-Snaptoken"])
        q = T("d", "doc", "view", SubjectID("carol"))
        status, headers, body = _req("GET", d.read.port, f"/check?{q.to_url_query()}&snaptoken={token}")
        assert (status, body) == (200, {"allowed": True})
        assert int(headers["X-Keto-Snaptoken"]) >= token
        status, _, body = _req("POST", d.read.port, f"/check/batch?snaptoken={token}&latest=true",
                               {"tuples": [q.to_json(), T("d", "doc", "view", SubjectID("x")).to_json()]})
        assert (status, body) == (200, {"results": [True, False]})
        assert _req("GET", d.read.port, f"/check?{q.to_url_query()}&snaptoken=abc")[0] == 400
        status, headers, _ = _req("DELETE", d.write.port, "/relation-tuples?" + new.to_url_query())
        assert status == 204
        token = int(headers["X-Keto-Snaptoken"])
        status, _, body = _req("GET", d.read.port, f"/check?{q.to_url_query()}&snaptoken={token}")
        assert (status, body) == (403, {"allowed": False})
        assert d.engine.counters()["full_rebuilds"] == 1
    finally:
        d.stop()


# -- no quiet fallback ------------------------------------------------------------------


def test_failed_slot_set_raises(monkeypatch):
    p = Pair(NS, CHAIN).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", **QUIET)
    try:
        eng.snapshot()

        def broken(*a, **k):
            raise RuntimeError("CUDA kernel keto_slot_set failed to launch")

        monkeypatch.setattr(kernels, "slot_set", broken)
        p.delete_relation_tuples(T("g", "g2", "m", SubjectSet("g", "g2b", "m")))
        with pytest.raises(RuntimeError, match="keto_slot_set"):
            eng.batch_check([T("d", "doc", "view", SubjectID("u2"))])
        monkeypatch.undo()
        assert eng.batch_check([T("d", "doc", "view", SubjectID("u2"))]) == [False]
        assert eng.counters().get("full_rebuilds") == 1
    finally:
        eng.close()


def test_failed_fold_raises(monkeypatch):
    p = Pair(NS, TEAM).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", **QUIET)
    try:
        eng.snapshot()
        p.write_relation_tuples(T("g", "team", "member", SubjectID("bob")))
        assert eng.snapshot().has_overlay

        def broken(snap):
            raise RuntimeError("fold exploded")

        monkeypatch.setattr(eng, "_compact_locked", broken)
        with pytest.raises(RuntimeError, match="background refresh failed"):
            eng.maintenance_settled(fold=True, timeout=30)
        c = eng.counters()
        assert c["compaction_failures"] >= 1 and c["refresh_failures"] >= 1
        assert c.get("full_rebuilds") == 1, "a failed fold fell back to a rebuild"
    finally:
        eng.close()


def test_failed_device_label_patch_raises_not_retried_on_host(monkeypatch):
    p = Pair(NS, deep_rows(6)).mine
    eng = TorchCheckEngine(p, manager(), device="cpu", labels_device_min_edges=0, **QUIET)
    host_calls = []
    try:
        assert eng.labels_settled()
        p.write_relation_tuples(T("g", "c1", "m", SubjectSet("g", "c4", "m")))
        assert eng.snapshot().lab_dirty

        def broken(*a, **k):
            raise RuntimeError("device patch exploded")

        monkeypatch.setattr(label_build, "device_patch_labels", broken)
        import keto_tpu_torch.check.gpu_engine as ge

        monkeypatch.setattr(ge, "patch_labels", lambda *a, **k: host_calls.append(a))
        with pytest.raises(RuntimeError, match="background refresh failed"):
            eng.maintenance_settled(fold=True, timeout=30)
        assert eng.counters()["label_patch_failures"] >= 1 and not host_calls
    finally:
        eng.close()
