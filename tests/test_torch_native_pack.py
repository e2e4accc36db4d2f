"""The native pack walk (keto_tpu_torch/native/pack.cpp behind
keto_tpu_torch/check/native_pack.py) against the numpy walk.

``pack_chunk(native=True)`` must equal ``pack_chunk(native=False)`` and the
reference's ``pack_chunk(native=False)`` byte for byte in all seven entry
arrays and ``host_ans``: on the fuzz of tests/test_native_pack.py (deep
chains, wildcard multi-starts), at three peel caps (static and peeled
multi-hop chains), on a sink with many in-rows, on a cycle closed by an
overlay, and on hops wide enough for the threaded gather. A snapshot with
host-visible overlay state (``ov_out``, tombstones, ``ov_sink_in``) routes
to numpy, counted, with decisions unchanged.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check import native_pack
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.check.pack import pack_chunk
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_overlay import Pair, jt
from test_torch_write_path import QUIET

NS = [("a", 1), ("b", 2)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def fuzz_case(seed, n_tuples=300, chain=40):
    """tests/test_native_pack.py's store and queries."""
    rng = random.Random(seed)
    names = ["a", "b"]
    objs = [f"o{i}" for i in range(12)]
    rels = ["r0", "r1", "r2"]
    users = [f"u{i}" for i in range(10)]
    rows = []
    for _ in range(n_tuples):
        sub = (SubjectID(rng.choice(users)) if rng.random() < 0.5
               else SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels)))
        rows.append(T(rng.choice(names), rng.choice(objs), rng.choice(rels), sub))
    # a deep chain, so the walk iterates many hops
    for i in range(chain):
        rows.append(T("a", f"c{i}", "r0", SubjectSet("a", f"c{i+1}", "r0")))
    rows.append(T("a", f"c{chain}", "r0", SubjectID("deep-user")))
    queries = []
    for _ in range(200):
        r = rng.random()
        if r < 0.1:
            queries.append(T("", "", "", SubjectID(rng.choice(users))))
        elif r < 0.2:
            queries.append(T(rng.choice(names), "", rng.choice(rels),
                             SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels))))
        else:
            sub = (SubjectID(rng.choice(users)) if rng.random() < 0.6
                   else SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels)))
            queries.append(T(rng.choice(names), rng.choice(objs), rng.choice(rels), sub))
    queries.append(T("a", "c0", "r0", SubjectID("deep-user")))
    return rows, queries


def hub_case(n=200):
    """A sink with ``n`` interior in-rows (a ring of x nodes, each also
    granting the sink), queried from every ring node."""
    rows = []
    for i in range(n):
        rows.append(T("a", f"x{i}", "r1", SubjectSet("a", "hub", "r2")))
        rows.append(T("a", f"x{i}", "r1", SubjectSet("a", f"x{(i + 1) % n}", "r1")))
    rows.append(T("b", "top", "r0", SubjectSet("a", "x0", "r1")))
    queries = [T("a", f"x{i}", "r1", SubjectSet("a", "hub", "r2")) for i in range(0, n, 7)]
    queries += [T("b", "top", "r0", SubjectSet("a", "hub", "r2")),
                T("a", "", "r1", SubjectSet("a", "hub", "r2")),
                T("b", "top", "r0", SubjectSet("a", "x5", "r1"))]
    return rows, queries


class Engines:
    """A port engine and the reference engine (numpy walk) on the same
    writes, labels off."""

    def __init__(self, rows, **kw):
        from keto_tpu.check.tpu_engine import TpuCheckEngine

        self.pair = Pair(NS, rows)
        nm = tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NS])
        self.port = TorchCheckEngine(self.pair.mine, nm, device="cpu", labels_enabled=False,
                                     **kw)
        self.ref = TpuCheckEngine(self.pair.ref, self.pair.ref.namespaces, labels_enabled=False,
                                  native_pack_enabled=False, device_build_enabled=False, **kw)

    def assert_packs_equal(self, queries, bounds=None, native=True):
        """Every chunk of ``bounds`` packs byte-equal three ways; returns
        whether the port's snapshot took the native walk."""
        from keto_tpu.check import tpu_engine as te

        snap, rsnap = self.port.snapshot(), self.ref.snapshot()
        sd, tg, multi = self.port._resolve_bulk(snap, queries)
        rsd, rtg, rmulti = self.ref._resolve_bulk_py(rsnap, [jt(q) for q in queries])
        eligible = native_pack.walk_eligible(snap)
        for i0, i1 in bounds or [(0, len(queries))]:
            before = dict(native_pack.COUNTERS)
            pn, hn = pack_chunk(snap, sd, tg, multi, i0, i1, native=native)
            path = "native" if native and eligible else "numpy"
            assert native_pack.COUNTERS[path] == before[path] + 1
            pp, hp = pack_chunk(snap, sd, tg, multi, i0, i1, native=False)
            pr, hr = te.pack_chunk(rsnap, rsd, rtg, rmulti, i0, i1, native=False)
            assert hn.dtype == hp.dtype == hr.dtype
            assert hn.tobytes() == hp.tobytes() == hr.tobytes()
            assert (pn is None) == (pp is None) == (pr is None)
            if pn is not None:
                for k, (a, b, c) in enumerate(zip(pn, pp, pr)):
                    assert a.dtype == b.dtype == c.dtype, k
                    assert a.shape == b.shape == c.shape, k
                    assert a.tobytes() == b.tobytes() == c.tobytes(), k
        return native and eligible

    def check(self, queries):
        got = self.port.batch_check(queries)
        assert got == [bool(x) for x in self.ref.batch_check([jt(q) for q in queries])]
        oracle = CheckEngine(self.pair.mine)
        assert got == [oracle.subject_is_allowed(q) for q in queries]
        return got

    def close(self):
        self.port.close()
        self.ref.close()


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


@pytest.mark.parametrize("seed", range(6))
def test_native_pack_byte_parity_fuzz(engines, seed):
    rows, queries = fuzz_case(seed)
    e = engines(rows)
    assert e.assert_packs_equal(queries, [(0, len(queries)), (17, 130), (60, 61)])


@pytest.mark.parametrize("peel_seed_cap", [0.0, 4.0, 64.0])
def test_static_and_peeled_chains(engines, peel_seed_cap):
    """Chains walked on the host: static starts (no cap) and peeled
    interior rows (the default and a wide cap) seed the device after
    several hops or decide on the host."""
    rows, queries = fuzz_case(7, n_tuples=120, chain=12)
    e = engines(rows, peel_seed_cap=peel_seed_cap)
    if peel_seed_cap:
        assert e.port.snapshot().n_peeled > 0
    assert e.assert_packs_equal(queries)
    e.check(queries)


def test_sink_with_many_in_rows(engines):
    rows, queries = hub_case()
    e = engines(rows)
    snap = e.port.snapshot()
    hub = snap.resolve_set(1, "hub", "r2")
    assert snap.sink_base <= hub < snap.num_live
    assert snap.sink_indptr[hub - snap.sink_base + 1] - snap.sink_indptr[hub - snap.sink_base] \
        == 200
    assert e.assert_packs_equal(queries, [(0, len(queries)), (3, 9)])
    assert all(e.check(queries))


def test_sink_gather_parity(engines):
    rows, _ = fuzz_case(7)
    e = engines(rows + hub_case()[0])
    snap = e.port.snapshot()
    sinks = np.arange(snap.sink_base, snap.num_live, dtype=np.int64)
    assert sinks.size
    rn, cn = native_pack.sink_gather(snap, sinks)
    rp, cp = snap.sink_in_rows_bulk(sinks)
    assert cn.dtype == cp.dtype and cn.tobytes() == cp.tobytes()
    assert rn.dtype == rp.dtype and rn.tobytes() == rp.tobytes()


def test_threaded_hops(engines, monkeypatch):
    """Hops of more than 65,536 gathered neighbours fan out over worker
    threads; their per-chunk merge keeps the numpy walk's order."""
    monkeypatch.setenv("KETO_TPU_PACK_THREADS", "3")
    n = 40_000
    rows = []
    for i in range(n):
        rows.append(T("a", f"d{i}", "r0", SubjectSet("b", f"g{i % 50}", "m")))
        rows.append(T("a", f"d{i}", "r0", SubjectID(f"u{i % 7}")))
    for j in range(50):
        rows.append(T("b", f"g{j}", "m", SubjectSet("b", f"g{(j + 1) % 50}", "m")))
        rows.append(T("b", f"g{j}", "m", SubjectID(f"v{j}")))
    queries = [T("a", "", "r0", SubjectID("u3")), T("a", "", "r0", SubjectID("v9")),
               T("a", "", "r0", SubjectSet("b", "g7", "m")), T("a", "d5", "r0", SubjectID("u5")),
               T("a", "", "r0", SubjectID("nobody"))]
    e = engines(rows)
    snap = e.port.snapshot()
    assert snap.num_int == 50 and snap.fwd_indptr[-1] >= 2 * n
    assert e.assert_packs_equal(queries)
    assert e.check(queries) == [True, True, True, True, False]


def test_cycle_closed_by_an_overlay(engines):
    """Inserts that close a cycle through two rings of interior rows
    (overlay ELL, device side) keep the native walk; an insert out of a
    static node (host adjacency ``ov_out``) routes to numpy. Packs equal
    throughout."""
    rows = [T("b", "top", "r0", SubjectSet("a", "p0", "r0"))]
    rows += [T("a", f"p{i}", "r0", SubjectSet("a", f"p{(i + 1) % 7}", "r0")) for i in range(7)]
    rows += [T("a", "p6", "r0", SubjectID("end")), T("a", "p3", "r0", SubjectID("mid"))]
    rows += [T("a", "q0", "r0", SubjectSet("a", "q1", "r0")),
             T("a", "q1", "r0", SubjectSet("a", "q0", "r0")),
             T("a", "q1", "r0", SubjectID("qu"))]
    queries = [T("b", "top", "r0", SubjectID(u)) for u in ("end", "mid", "qu", "none")]
    queries += [T("a", f"p{i}", "r0", SubjectSet("a", "p0", "r0")) for i in range(7)]
    queries += [T("a", "p2", "r0", SubjectID("qu")), T("a", "", "r0", SubjectID("mid"))]
    e = engines(rows, peel_seed_cap=0.0, **QUIET)
    assert e.assert_packs_equal(queries)
    e.pair.write([T("a", "p4", "r0", SubjectSet("a", "q0", "r0")),
                  T("a", "q1", "r0", SubjectSet("a", "p2", "r0"))])
    snap = e.port.snapshot()
    assert snap.has_overlay and snap.ov_ell is not None and not snap.ov_out
    assert e.assert_packs_equal(queries)
    assert e.check(queries) == [True, True, True, False] + [True] * 7 + [True, True]
    e.pair.write([T("b", "top", "r0", SubjectSet("a", "q0", "r0"))])
    snap = e.port.snapshot()
    assert snap.ov_out
    assert not e.assert_packs_equal(queries)
    assert e.check(queries)[2]


@pytest.mark.parametrize("state", ["tombstone", "ov_out", "ov_sink_in"])
def test_overlay_state_routes_to_numpy(engines, state):
    """Host-visible overlay state makes the snapshot ineligible: chunks
    take the numpy walk (counted), byte-equal to the reference's, and the
    decisions still match."""
    rows, queries = fuzz_case(4, n_tuples=120, chain=10)
    rows += hub_case(20)[0]
    queries += hub_case(20)[1]
    e = engines(rows, **QUIET)
    assert e.assert_packs_equal(queries)
    if state == "tombstone":
        e.pair.write((), [T("a", "c5", "r0", SubjectSet("a", "c6", "r0"))])
    elif state == "ov_out":
        e.pair.write([T("b", "top", "r0", SubjectID("new-user"))])
    else:
        e.pair.write([T("a", "x3", "r1", SubjectSet("b", "newsink", "r0"))])
    snap = e.port.snapshot()
    assert snap.has_overlay and not native_pack.walk_eligible(snap)
    assert {"tombstone": snap.ov_removed is not None and snap.ov_removed.size > 0,
            "ov_out": bool(snap.ov_out), "ov_sink_in": bool(snap.ov_sink_in)}[state]
    before = dict(native_pack.COUNTERS)
    assert not e.assert_packs_equal(queries)
    got = e.check(queries)
    assert native_pack.COUNTERS["numpy"] >= before["numpy"] + 2
    assert native_pack.COUNTERS["native"] == before["native"]
    assert any(got)


def test_engine_takes_the_native_walk_unless_pinned(engines):
    rows, queries = fuzz_case(9)
    e = engines(rows)
    before = dict(native_pack.COUNTERS)
    e.check(queries)
    assert native_pack.COUNTERS["native"] > before["native"]
    nm = tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NS])
    pinned = TorchCheckEngine(e.pair.mine, nm, device="cpu", labels_enabled=False,
                              native_pack_enabled=False)
    try:
        before = dict(native_pack.COUNTERS)
        assert pinned.batch_check(queries) == e.port.batch_check(queries)
        assert native_pack.COUNTERS["numpy"] > before["numpy"]
    finally:
        pinned.close()
