"""Reverse queries of the port against the JAX package, the oracle and Check.

Ported from tests/test_list_watch.py (the list half; watch, the snapshot
cache is out of scope):

- ``SnapshotListEngine`` on the CPU equals the JAX package's
  ``SnapshotListEngine``, the Manager oracle (the port's and JAX's) and a
  brute-force closure through Check, on fuzz graphs with and without
  wildcards;
- overlay churn (inserts, deletes, restores) keeps every listing equal,
  through the ``lst_*`` mirror, and again after the fold; ``apply_delta``'s
  mirror, ``compact_snapshot``'s re-derived layouts, ``_overlay_stage`` and
  ``build_list_layouts`` equal JAX's byte for byte;
- ``lst_dirty`` routes to the host lister with the same answers;
- page tokens pin the snaptoken, across a fold too;
- the list site of K9 patches each snapshot's own upload;
- a device error raises and is counted, with no answer from the host; the
  engine's build sorter counts its dispatches and a failed sort raises;
- the device-memory governor's ``reverse`` rung routes listings to the
  host lister ("evicted") with equal answers and restores; a refused sort
  transient sorts on the host with equal permutations, counted.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.graph import sort_kernels
from keto_tpu_torch.graph.compaction import compact_snapshot
from keto_tpu_torch.graph.device_build import GovernedSorter
from keto_tpu_torch.graph.overlay import apply_delta
from keto_tpu_torch.graph.snapshot import build_list_layouts
from keto_tpu_torch.list import gpu_engine
from keto_tpu_torch.list.engine import ListEngine, decode_page_token
from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.errors import ErrMalformedPageToken

from test_torch_overlay import SCENARIOS, Pair, _writes
from test_torch_overlay import NS as PAIR_NS
from test_torch_overlay import WILD_NS as PAIR_WILD_NS
from test_torch_overlay import rand_tuple as pair_rand_tuple
from test_torch_sort import _assert_layout_equal

NSS = [("ns0", 0), ("ns1", 1)]
OBJECTS = [f"o{i}" for i in range(7)]
USERS = [f"u{i}" for i in range(6)]
RELATIONS = ["r0", "r1"]
NS = ["ns0", "ns1"]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def rand_tuple(rng, wild=False):
    ns_pool = NS + ([""] if wild else [])
    obj_pool = OBJECTS + ([""] if wild else [])
    rel_pool = RELATIONS + ([""] if wild else [])
    if rng.random() < 0.5:
        sub = SubjectID(rng.choice(USERS))
    else:
        sub = SubjectSet(rng.choice(ns_pool), rng.choice(obj_pool), rng.choice(rel_pool))
    return T(rng.choice(ns_pool), rng.choice(obj_pool), rng.choice(rel_pool), sub)


def jsub(sub):
    from keto_tpu.relationtuple.model import SubjectID as JID
    from keto_tpu.relationtuple.model import SubjectSet as JSet

    if isinstance(sub, SubjectID):
        return JID(sub.id)
    return JSet(sub.namespace, sub.object, sub.relation)


class Engines:
    """The same tuples in both packages, with their check and list engines."""

    def __init__(self, tuples, wild=False):
        from keto_tpu.check.tpu_engine import TpuCheckEngine
        from keto_tpu.list.engine import ListEngine as JaxOracle
        from keto_tpu.list.tpu_engine import SnapshotListEngine as JaxLister

        nss = NSS + ([("", 3)] if wild else [])
        self.pair = Pair(nss, tuples)
        p, jp = self.pair.mine, self.pair.ref
        self.eng = TorchCheckEngine(p, p.namespaces, device="cpu")
        self.lst = SnapshotListEngine(self.eng, p.namespaces, device="cpu")
        self.oracle = ListEngine(p)
        self.chk = CheckEngine(p)
        self.tpu = TpuCheckEngine(jp, jp.namespaces)
        self.jlst = JaxLister(self.tpu, jp.namespaces)
        self.joracle = JaxOracle(jp)

    def write(self, insert=(), delete=()):
        self.pair.write(insert, delete)

    def close(self):
        self.eng.close()


@pytest.fixture
def engines():
    made = []

    def make(tuples, wild=False):
        e = Engines(tuples, wild)
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


def assert_parity(e: Engines, *, brute=True, info=None, users=USERS, objects=OBJECTS):
    for ns in NS:
        for rel in RELATIONS:
            for u in users:
                got, tok = e.lst.list_objects(ns, rel, SubjectID(u))
                want = e.oracle.list_objects(ns, rel, SubjectID(u))
                jgot, jtok = e.jlst.list_objects(ns, rel, jsub(SubjectID(u)))
                assert got == want == jgot, (info, ns, rel, u, got, want, jgot)
                assert tok == jtok
                if brute:
                    bf = sorted(o for o in OBJECTS
                                if e.chk.subject_is_allowed(T(ns, o, rel, SubjectID(u))))
                    assert got == bf, (info, ns, rel, u, got, bf)
            for obj in objects:
                got, _ = e.lst.list_subjects(ns, obj, rel)
                want = e.oracle.list_subjects(ns, obj, rel)
                jgot, _ = e.jlst.list_subjects(ns, obj, rel)
                assert got == want == jgot, (info, ns, obj, rel, got, want, jgot)
                if brute:
                    bf = sorted(u for u in USERS
                                if e.chk.subject_is_allowed(T(ns, obj, rel, SubjectID(u))))
                    assert got == bf, (info, ns, obj, rel, got, bf)


def _device_listings(lst) -> int:
    return sum(v for (_, path), v in lst.requests_total.items() if path == "device")


# -- fuzz parity ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_list_fuzz_parity(engines, seed):
    rng = random.Random(seed)
    e = engines([rand_tuple(rng) for _ in range(rng.randrange(15, 70))])
    assert_parity(e, info=seed)
    assert _device_listings(e.lst) > 0  # fuzz without the device path proves nothing
    # subject-set subjects list too
    sub = SubjectSet("ns1", "o1", "r0")
    assert e.lst.list_objects("ns0", "r0", sub)[0] == e.oracle.list_objects("ns0", "r0", sub)


@pytest.mark.parametrize("seed", range(2))
def test_list_fuzz_parity_wildcards(engines, seed):
    """Wildcard-bearing graphs (empty fields, a configured "" namespace):
    the pattern expansion round-trips through both orientations, and
    wildcard-namespace queries take the oracle route."""
    rng = random.Random(50 + seed)
    e = engines([rand_tuple(rng, wild=True) for _ in range(rng.randrange(15, 60))], wild=True)
    assert_parity(e, info=seed, users=USERS[:4], objects=OBJECTS[:4])
    before = e.lst.requests_total.get(("objects", "oracle"), 0)
    got, _ = e.lst.list_objects("", "r0", SubjectID("u0"))
    assert got == e.oracle.list_objects("", "r0", SubjectID("u0"))
    assert got == e.jlst.list_objects("", "r0", jsub(SubjectID("u0")))[0]
    assert e.lst.requests_total[("objects", "oracle")] == before + 1


@pytest.mark.parametrize("seed", range(3))
def test_list_fuzz_overlay_churn(engines, seed):
    """Interleaved inserts and deletes ride the delta overlay (lst_ov_edges,
    tombstone patches in both orientations); parity holds every round and
    again after the fold, which clears the mirror."""
    rng = random.Random(100 + seed)
    base = [rand_tuple(rng) for _ in range(40)]
    e = engines(base)
    e.eng.snapshot()
    e.tpu.snapshot()
    live = list(base)
    deltas = 0
    for round_ in range(6):
        ins = [rand_tuple(rng) for _ in range(rng.randrange(0, 5))]
        dels = rng.sample(live, min(len(live), rng.randrange(0, 3)))
        if round_ == 3 and dels:
            ins.append(dels[0])  # a restore of a tombstoned edge
        e.write(ins, dels)
        live = [t for t in live if t not in dels] + ins
        assert_parity(e, brute=False, info=(seed, round_))
        deltas = e.eng.counters().get("delta_applies", 0)
    snap = e.eng.maintenance_settled(fold=True, timeout=60)
    assert not snap.has_overlay and not snap.lst_dirty
    assert snap.lst_ov_edges is None and snap.lst_patch is None and snap.lay_fwd is not None
    assert deltas > 0
    assert_parity(e, brute=True, info=(seed, "final"))


# -- the host half against JAX: the mirror, the fold, the overlay stage ----------


def _lst_fields(s):
    return (s.lst_ov_edges, s.lst_patch, s.lst_dirty)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", SCENARIOS)
def test_apply_delta_list_mirror_equals_jax(kind, seed):
    from keto_tpu.graph.overlay import apply_delta as jax_apply

    rng = random.Random(700 + 100 * SCENARIOS.index(kind) + seed)
    objects, users = [f"o{i}" for i in range(7)], [f"u{i}" for i in range(5)]
    ns = PAIR_WILD_NS if kind == "wildcard" else PAIR_NS
    rows = [pair_rand_tuple(rng, objects, users) for _ in range(30)]
    pair = Pair(ns, rows)
    wild = frozenset(i for n, i in ns if n == "")
    mine, ref = pair.snapshots()
    for _ in range(3):  # stacked deltas: lst_patch is append-only across them
        _writes(kind, rng, pair, objects, users)
        a = pair.mine.changes_since(mine.snapshot_id)
        b = pair.ref.changes_since(ref.snapshot_id)
        got = apply_delta(mine, a[0], a[1], wild)
        want = jax_apply(ref, b[0], b[1], wild)
        assert (got is None) == (want is None)
        if got is None:
            break
        ga, gb, gc = _lst_fields(got)
        wa, wb, wc = _lst_fields(want)
        assert ga == wa and gb == wb and gc == wc
        if mine.lst_patch:
            assert got.lst_patch[: len(mine.lst_patch)] == mine.lst_patch
        assert got.device_list is None
        mine, ref = got, want


@pytest.mark.parametrize("seed", range(4))
def test_fold_rederives_layouts_like_jax(seed):
    """``compact_snapshot`` re-derives the transposed CSR and both layouts
    (through the radix sorter too) exactly as JAX's fold does."""
    from keto_tpu.graph.compaction import compact_snapshot as jax_compact
    from keto_tpu.graph.overlay import apply_delta as jax_apply

    rng = random.Random(900 + seed)
    objects, users = [f"o{i}" for i in range(7)], [f"u{i}" for i in range(5)]
    pair = Pair(PAIR_NS, [pair_rand_tuple(rng, objects, users) for _ in range(30)])
    mine, ref = pair.snapshots()
    _writes("mixed", rng, pair, objects, users)
    a = pair.mine.changes_since(mine.snapshot_id)
    b = pair.ref.changes_since(ref.snapshot_id)
    got = apply_delta(mine, a[0], a[1], frozenset())
    want = jax_apply(ref, b[0], b[1], frozenset())
    assert got is not None and want is not None  # the seeds are chosen to overlay
    w = jax_compact(want)
    for sorter in (None, GovernedSorter("cpu", min_size=0)):
        g = compact_snapshot(got, sorter=sorter)
        assert (g is None) == (w is None)
        if g is None:
            continue
        for k in ("rev_indptr", "rev_indices"):
            x, y = getattr(g.snapshot, k), getattr(w.snapshot, k)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        _assert_layout_equal(g.snapshot.lay_fwd, w.snapshot.lay_fwd)
        _assert_layout_equal(g.snapshot.lay_rev, w.snapshot.lay_rev)
        assert _lst_fields(g.snapshot) == (None, None, False)


def test_overlay_stage_and_layouts_equal_jax(engines):
    from keto_tpu.graph.snapshot import build_list_layouts as jax_layouts
    from keto_tpu.list.tpu_engine import SnapshotListEngine as JaxLister

    # a cycle of active rows a → b → c → a, and d a passive row under a doc
    rows = [T("ns0", "a", "r0", SubjectSet("ns0", "b", "r0")),
            T("ns0", "b", "r0", SubjectSet("ns0", "c", "r0")),
            T("ns0", "c", "r0", SubjectSet("ns0", "a", "r0")),
            T("ns1", "doc", "r1", SubjectSet("ns0", "a", "r0")),
            T("ns1", "doc2", "r1", SubjectSet("ns0", "d", "r0"))]
    rows += [T("ns0", x, "r0", SubjectID(f"u{i}")) for i, x in enumerate("abcd")]
    e = engines(rows)
    e.eng.snapshot()
    e.tpu.snapshot()
    # overlay-ELL edges into active rows, one of them out of the passive row
    e.write([T("ns0", "a", "r0", SubjectSet("ns0", "c", "r0")),
             T("ns0", "b", "r0", SubjectSet("ns0", "a", "r0")),
             T("ns0", "d", "r0", SubjectSet("ns0", "b", "r0"))])
    snap, jsnap = e.eng.snapshot(), e.tpu.snapshot()
    assert e.eng.counters()["full_rebuilds"] == 1 and snap.has_overlay
    assert snap.lst_ov_edges and snap.lst_ov_edges == jsnap.lst_ov_edges
    for orient in ("fwd", "rev"):
        lay = snap.lay_fwd if orient == "fwd" else snap.lay_rev
        jlay = jsnap.lay_fwd if orient == "fwd" else jsnap.lay_rev
        nbrs, dst = e.lst._overlay_stage(snap, lay)
        jn, jd = JaxLister._overlay_stage(e.jlst, jsnap, jlay)
        assert np.array_equal(nbrs.numpy(), np.asarray(jn))
        assert np.array_equal(dst.numpy(), np.asarray(jd))
    mine = build_list_layouts(snap.fwd_indptr, snap.fwd_indices, snap.n_nodes, snap.sink_base)
    ref = jax_layouts(jsnap.fwd_indptr, jsnap.fwd_indices, jsnap.n_nodes, jsnap.sink_base)
    for a, b in zip(mine, ref):
        _assert_layout_equal(a, b)
    assert_parity(e, brute=False, objects=list("abcd"))


def test_in_neighbors_bulk_equals_jax(engines):
    rng = random.Random(17)
    e = engines([rand_tuple(rng) for _ in range(50)])
    e.eng.snapshot()
    e.tpu.snapshot()
    live, _ = e.pair.mine.get_relation_tuples(RelationQuery())
    e.write([rand_tuple(rng) for _ in range(4)], live[:2])
    snap, jsnap = e.eng.snapshot(), e.tpu.snapshot()
    nodes = np.arange(max(snap.ov_next, snap.n_nodes), dtype=np.int64)
    a, b = snap.in_neighbors_bulk(nodes), jsnap.in_neighbors_bulk(nodes)
    assert np.array_equal(a[1], b[1])
    for i in range(nodes.size):  # overlay extras may come in another order
        s = int(np.sum(a[1][:i]))
        assert sorted(a[0][s:s + a[1][i]]) == sorted(b[0][s:s + b[1][i]])


# -- routes and failures ------------------------------------------------------------


def test_lst_dirty_routes_to_the_host_lister(engines):
    rng = random.Random(7)
    e = engines([rand_tuple(rng) for _ in range(50)])
    queries = [(ns, rel, SubjectID(u)) for ns in NS for rel in RELATIONS for u in USERS]
    device = {q: e.lst.list_objects(*q)[0] for q in queries}
    assert _device_listings(e.lst) > 0
    snap = e.eng.snapshot()
    e.eng._snapshot = dataclasses.replace(snap, lst_dirty=True)
    e.lst._cache.clear()
    host_before = e.lst.requests_total.get(("objects", "host"), 0)
    dev_before = _device_listings(e.lst)
    for q, want in device.items():
        assert e.lst.list_objects(*q)[0] == want, q
    assert e.lst.requests_total[("objects", "host")] - host_before >= len(device) // 2
    assert _device_listings(e.lst) == dev_before


def test_device_error_raises_and_is_counted(engines, monkeypatch):
    """No quiet host retry: the listing raises, the error is counted, and the
    host lister does not answer in its place."""
    rng = random.Random(7)
    e = engines([rand_tuple(rng) for _ in range(50)])

    def boom(*a, **k):
        raise RuntimeError("K5 launch failed")

    monkeypatch.setattr(gpu_engine, "list_step", boom)
    raised = 0
    for u in USERS:
        try:
            e.lst.list_objects("ns0", "r0", SubjectID(u))
        except RuntimeError as err:
            assert "K5 launch failed" in str(err)
            raised += 1
    assert raised and e.lst.device_errors == raised
    assert ("objects", "device") not in e.lst.requests_total
    assert e.lst.requests_total.get(("objects", "host"), 0) == len(USERS) - raised


def test_list_site_patches_a_private_upload(engines):
    """A tombstoned interior-class edge patches the new snapshot's own upload
    (K9's list site); the base snapshot's upload keeps the edge."""
    rows = [T("ns0", "a", "r0", SubjectSet("ns0", "b", "r0")),
            T("ns0", "b", "r0", SubjectSet("ns0", "c", "r0")),
            T("ns1", "doc", "r1", SubjectSet("ns0", "a", "r0"))]
    rows += [T("ns0", x, "r0", SubjectID(f"u{i}")) for i, x in enumerate("abc")]
    e = engines(rows)
    assert e.lst.list_subjects("ns0", "a", "r0")[0] == ["u0", "u1", "u2"]
    base = e.eng.snapshot()
    base_bufs = {o: [t.clone() for t in base.device_list[o][0].buckets] for o in base.device_list}
    e.write((), [rows[1]])
    assert e.lst.list_subjects("ns0", "a", "r0")[0] == ["u0", "u1"]
    assert e.lst.list_objects("ns1", "r1", SubjectID("u2"))[0] == []
    snap = e.eng.snapshot()
    assert snap.lst_patch and len(snap.lst_patch) == 2 and snap.device_list is not base.device_list
    for o, (dl, applied) in snap.device_list.items():
        assert applied == len(snap.lst_patch)
        lay = snap.lay_fwd if o == "fwd" else snap.lay_rev
        for (ob, bi, row, col, val) in snap.lst_patch:
            if ob == o:
                assert int(dl.buckets[bi][row, col]) == val == lay.n_rows
                assert int(lay.buckets[bi].nbrs[row, col]) != val  # host arrays untouched
    for o, bufs in base_bufs.items():
        for a, b in zip(base.device_list[o][0].buckets, bufs):
            assert torch.equal(a, b)
    assert_parity(e, brute=False, objects=list("abc"))


def test_list_engine_runs_on_cuda_unless_told(engines):
    rng = random.Random(3)
    e = engines([rand_tuple(rng) for _ in range(10)])
    if torch.cuda.is_available():
        assert SnapshotListEngine(e.eng, e.pair.mine.namespaces).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SnapshotListEngine(e.eng, e.pair.mine.namespaces)


def test_engine_build_sorter_counts_and_reports(engines):
    rng = random.Random(5)
    e = engines([rand_tuple(rng) for _ in range(40)])
    e.eng.snapshot()
    c = e.eng.counters()
    assert c["device_build_host_dispatches"] >= 5 and "device_build_dispatches" not in c
    info = e.eng.build_info
    assert info["build_sort_bytes"] > 0 and info["sort_s"]["host"] > 0
    p = e.pair.mine
    off = TorchCheckEngine(p, p.namespaces, device="cpu", device_build_enabled=False)
    try:
        off.snapshot()
        assert not any(k.startswith("device_build") for k in off.counters())
    finally:
        off.close()


def test_failed_build_sort_raises_and_is_counted(monkeypatch):
    """A failed K8 sort in the full build raises to the caller and counts
    ``device_build_errors``; nothing retries it on the host."""
    from test_torch_snapshot import port_store

    rng = random.Random(11)
    p = port_store(NSS, [rand_tuple(rng) for _ in range(20)])
    eng = TorchCheckEngine(p, p.namespaces, device="cpu", labels_enabled=False)
    eng._build_sorter = GovernedSorter("cpu", min_size=0, on_count=eng._incr)

    def boom(arrays):
        raise RuntimeError("K8 launch failed")

    monkeypatch.setattr(sort_kernels, "radix_argsort_many", boom)
    try:
        with pytest.raises(RuntimeError, match="K8 launch failed"):
            eng.snapshot()
        assert eng.counters()["device_build_errors"] == 1
        assert eng.counters().get("full_rebuilds", 0) == 0
        monkeypatch.undo()
        eng.snapshot()
        assert eng.counters()["device_build_dispatches"] >= 3
    finally:
        eng.close()


# -- the device-memory governor's reverse rung and build transients ------------


@pytest.mark.parametrize("seed", range(2))
def test_listings_under_the_reverse_rung_equal_the_reference(engines, seed):
    """The ``reverse`` rung (keto_tpu/list/tpu_engine.py:171-199) drops the
    layouts' device arrays: listings run on the host lister under the
    route "evicted", equal to the JAX package's, the oracle's and Check's;
    restored, the layouts upload again on first use."""
    rng = random.Random(70 + seed)
    e = engines([rand_tuple(rng) for _ in range(rng.randrange(30, 70))])
    assert_parity(e, brute=False)
    gov = e.eng.hbm
    assert gov.ledger()["reverse"] == e.lst.device_bytes(e.eng._snapshot) > 0
    gov.evict_one("test")  # staging
    assert gov.evict_one("test") == "labels"
    assert gov.evict_one("test") == "reverse"
    assert e.lst._suspended and "reverse" not in gov.ledger()
    assert e.eng._snapshot.device_list is None
    e.lst._cache.clear()
    dev_before = _device_listings(e.lst)
    assert_parity(e, info=seed)
    assert _device_listings(e.lst) == dev_before
    assert sum(v for (_, path), v in e.lst.requests_total.items() if path == "evicted") > 0
    assert gov.maybe_restore() == 3 and not e.lst._suspended
    e.lst._cache.clear()
    assert_parity(e, brute=False)
    assert _device_listings(e.lst) > dev_before
    assert gov.ledger()["reverse"] == e.lst.device_bytes(e.eng._snapshot) > 0


def test_a_refused_reverse_plan_routes_to_the_host_lister(engines):
    rng = random.Random(77)
    e = engines([rand_tuple(rng) for _ in range(50)])
    e.eng.snapshot()
    e.eng.hbm.set_budget_bytes(1)  # no rung makes room for the layouts
    assert_parity(e, brute=False)
    assert _device_listings(e.lst) == 0 and e.lst._suspended
    assert e.eng.hbm.snapshot()["evicted"][:3] == ["staging", "labels", "reverse"]


def test_a_refused_sort_transient_sorts_on_the_host():
    """``GovernedSorter`` plans ``16 · size`` bytes a batch with
    ``evict=False``: a refused plan sorts on the host with the same
    permutations, counted ``device_build_skipped``; an accepted one
    registers ``build`` for the dispatch and releases it."""
    from keto_tpu_torch.driver.hbm import HbmGovernor

    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 1 << 20, n).astype(np.int64) for n in (300, 1000, 40)]
    want = [np.argsort(a, kind="stable") for a in arrays]
    counts: dict = {}
    seen_build: list = []

    class Spy(HbmGovernor):
        def register(self, tag, nbytes):
            seen_build.append((tag, nbytes))
            super().register(tag, nbytes)

    gov = Spy(budget_bytes=1 << 30)
    gov.attach_rungs([("labels", lambda: seen_build.append("evicted") or 0, lambda: None)])
    s = GovernedSorter("cpu", hbm=gov, min_size=0,
                       on_count=lambda k: counts.__setitem__(k, counts.get(k, 0) + 1))
    got = s.argsort_many(arrays)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert seen_build == [("build", 16 * 1340)] and "build" not in gov.ledger()
    assert counts == {"device_build_dispatches": 1}
    gov.register("snapshot", (1 << 30) - 16 * 1340 + 1)
    got = s.argsort_many(arrays)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert counts == {"device_build_dispatches": 1, "device_build_skipped": 1}
    assert gov.rung_depth == 0 and "evicted" not in seen_build
    assert s.take_seconds()["host"] > 0


def test_an_engine_build_under_pressure_sorts_on_the_host(engines):
    rng = random.Random(79)
    e = engines([rand_tuple(rng) for _ in range(60)])
    p = e.pair.mine
    eng = TorchCheckEngine(p, p.namespaces, device="cpu", labels_enabled=False)
    ref = TorchCheckEngine(p, p.namespaces, device="cpu", labels_enabled=False)
    try:
        eng._build_sorter = GovernedSorter("cpu", hbm=eng.hbm, min_size=0, on_count=eng._incr)
        ref._build_sorter = GovernedSorter("cpu", hbm=ref.hbm, min_size=0, on_count=ref._incr)
        eng.hbm.set_budget_bytes(1)
        a, b = eng.snapshot(), ref.snapshot()
        c = eng.counters()
        assert c["device_build_skipped"] >= 3 and "device_build_dispatches" not in c
        assert ref.counters()["device_build_dispatches"] >= 3
        for lay in ("lay_fwd", "lay_rev"):
            _assert_layout_equal(getattr(a, lay), getattr(b, lay))
        assert np.array_equal(a.fwd_indptr, b.fwd_indptr)
    finally:
        eng.close()
        ref.close()


# -- pagination -------------------------------------------------------------------


def test_pagination_tokens_and_snaptoken_pin(engines):
    subs = [f"u{i:03d}" for i in range(25)]
    e = engines([T("ns0", "doc", "view", SubjectID(u)) for u in subs])
    lst = e.lst
    page1, tok1, snap1 = lst.page_subjects("ns0", "doc", "view", page_size=10)
    assert page1 == subs[:10] and tok1
    w, cursor = decode_page_token(tok1)
    assert w == snap1 and cursor == subs[9]
    # writes land mid-pagination: later pages pin at least snap1, and the
    # VALUE cursor keeps the iteration duplicate-free
    e.write([T("ns0", "doc", "view", SubjectID("u000a")),
             T("ns0", "doc", "view", SubjectID("u015a"))])
    e.eng.snapshot()
    page2, tok2, snap2 = lst.page_subjects("ns0", "doc", "view", page_size=10, page_token=tok1)
    assert snap2 >= snap1
    assert "u000a" not in page2
    assert page2 == subs[10:16] + ["u015a"] + subs[16:19]
    rest, tok3, _ = lst.page_subjects("ns0", "doc", "view", page_size=100, page_token=tok2)
    assert rest == subs[19:] and tok3 == ""
    with pytest.raises(ErrMalformedPageToken):
        lst.page_subjects("ns0", "doc", "view", page_token="$$$not-a-token$$$")
    # objects page the same way
    objs, tok, _ = lst.page_objects("ns0", "view", SubjectID("u001"), page_size=1)
    assert objs == ["doc"] and tok == ""


def test_pagination_consistent_across_a_fold(engines):
    subs = [f"u{i:03d}" for i in range(30)]
    e = engines([T("ns0", "doc", "view", SubjectID(u)) for u in subs])
    e.eng.snapshot()
    page1, tok1, _ = e.lst.page_subjects("ns0", "doc", "view", page_size=12)
    e.write([T("ns0", "other", "view", SubjectID("zz"))])
    snap = e.eng.maintenance_settled(fold=True, timeout=60)
    assert not snap.has_overlay and e.eng.counters()["compactions"] >= 1
    e.lst._cache.clear()  # recompute on the folded snapshot
    page2, tok2, _ = e.lst.page_subjects("ns0", "doc", "view", page_size=12, page_token=tok1)
    page3, tok3, _ = e.lst.page_subjects("ns0", "doc", "view", page_size=12, page_token=tok2)
    assert page1 + page2 + page3 == subs and tok3 == ""
