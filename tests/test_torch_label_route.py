"""The label route of Check on the CPU against the JAX engine and the oracle.

A labels-on ``TorchCheckEngine`` (``device="cpu"``: the plain versions of
K3, K6 and K7) must decide exactly as ``TpuCheckEngine`` with labels on,
as the port's labels-off (BFS) engine and as the recursive oracle, AND
count the same ``label_checks``/``label_fallbacks``/``label_builds``/
``label_device_builds`` as the reference on the same queries: the
scenarios of tests/test_labels.py (deep chain, router fallbacks, coverage
gaps under ``labels_max_width=1`` and ``labels_landmarks=1``) and 6 fuzz
seeds of write rounds, each with the host build (the default size gate)
and the device build (``labels_device_min_edges=0``). Plus read-your-
writes over REST while a label rebuild runs in the background.
"""

from __future__ import annotations

import json
import random
import sys
import threading
import urllib.error
import urllib.request

import pytest

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]
COUNTERS = ("label_checks", "label_fallbacks", "label_builds", "label_device_builds")
#: the two build paths: the default size gate (host build at these sizes)
#: and a gate of 0 ELL slots (the device build)
BUILDS = {"host": {}, "device": {"labels_device_min_edges": 0}}


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def deep_rows(depth=8, users=("alice", "bob")):
    """doc → c0 → … → c{depth-1} → users, with a back edge so the chain
    stays active interior (tests/test_labels.py ``deep_store``)."""
    rows = [T("d", "doc", "view", SubjectSet("g", "c0", "m"))]
    for i in range(depth - 1):
        rows.append(T("g", f"c{i}", "m", SubjectSet("g", f"c{i+1}", "m")))
    rows.append(T("g", f"c{depth-1}", "m", SubjectSet("g", "c0", "m")))
    rows.extend(T("g", f"c{depth-1}", "m", SubjectID(u)) for u in users)
    return rows


def manager():
    return tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NS])


def reference_run(rows, queries, **kw):
    """(decisions, counters) of a fresh labels-on TpuCheckEngine."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu.relationtuple.model import RelationTuple as JaxTuple

    p = jax_store(NS, rows)
    ref = TpuCheckEngine(p, p.namespaces, **kw)
    ref.labels_settled()
    got = ref.batch_check([JaxTuple.from_string(str(q)) for q in queries])
    m = ref.maintenance.snapshot()
    return got, {k: m.get(k, 0) for k in COUNTERS}


def port_counters(engine):
    c = engine.counters()
    return {k: c.get(k, 0) for k in COUNTERS}


def assert_route_parity(rows, queries, *, expect_label_use=True, **kw):
    """labels-on port == reference (decisions and counters) == labels-off
    port == oracle; returns the labels-on port engine."""
    p = port_store(NS, rows)
    on = TorchCheckEngine(p, manager(), device="cpu", **kw)
    off = TorchCheckEngine(p, manager(), device="cpu", labels_enabled=False)
    assert on.labels_settled()
    got = on.batch_check(queries)
    want, ref_counts = reference_run(rows, queries, **kw)
    oracle = CheckEngine(p)
    assert got == want, "label route diverged from the reference"
    assert got == off.batch_check(queries), "label route diverged from the BFS route"
    assert got == [oracle.subject_is_allowed(q) for q in queries], "diverged from the oracle"
    assert port_counters(on) == ref_counts
    assert off.counters().get("label_checks", 0) == 0
    if expect_label_use:
        assert ref_counts["label_checks"] > 0, "the label route never engaged"
    return on


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_deep_chain_served_by_labels(build):
    qs = [
        T("d", "doc", "view", SubjectID("alice")),
        T("d", "doc", "view", SubjectID("ghost")),
        T("g", "c0", "m", SubjectID("bob")),
        T("g", "c9", "m", SubjectSet("g", "c2", "m")),
    ]
    on = assert_route_parity(deep_rows(depth=10), qs, **BUILDS[build])
    c = port_counters(on)
    assert c["label_builds"] == 1 and c["label_fallbacks"] == 0
    assert c["label_device_builds"] == (build == "device")


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_router_fallbacks_stay_bit_identical(build):
    qs = [
        T("g", "", "", SubjectID("alice")),  # full wildcard
        T("g", "c0", "", SubjectID("alice")),  # relation wildcard
        T("g", "c3", "m", SubjectSet("g", "c3", "m")),  # self through the cycle
        T("g", "loner", "m", SubjectID("alice")),  # unknown object
        T("x", "c0", "m", SubjectID("alice")),  # unknown namespace
        T("d", "doc", "view", SubjectID("alice")),  # plain deep grant
    ]
    on = assert_route_parity(deep_rows(depth=6), qs, **BUILDS[build])
    assert port_counters(on)["label_fallbacks"] > 0


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("gap", [{"labels_max_width": 1}, {"labels_landmarks": 1}])
def test_coverage_gaps_fall_back_not_lie(gap, build):
    qs = [
        T("d", "doc", "view", SubjectID("alice")),
        T("d", "doc", "view", SubjectID("ghost")),
        T("g", "c2", "m", SubjectSet("g", "c6", "m")),
        T("g", "c6", "m", SubjectSet("g", "c2", "m")),
    ]
    on = assert_route_parity(deep_rows(depth=8), qs, expect_label_use=False, **gap, **BUILDS[build])
    assert port_counters(on)["label_fallbacks"] > 0


def _rand_tuple(rng, objects, relations, users):
    sub = (
        SubjectID(rng.choice(users))
        if rng.random() < 0.55
        else SubjectSet("g", rng.choice(objects), rng.choice(relations))
    )
    return T(rng.choice(["g", "d"]), rng.choice(objects), rng.choice(relations), sub)


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("seed", range(6))
def test_label_fuzz_parity(seed, build):
    """Write rounds (inserts, wildcard-relation rows, deletes): after each,
    the port engine — which rebuilds snapshot and labels — decides and
    counts exactly as a reference engine built fresh on the same store."""
    rng = random.Random(7000 + seed)
    objects = [f"o{i}" for i in range(6)]
    relations = ["m", "v"]
    users = [f"u{i}" for i in range(5)] + ["ghost"]
    rows = [_rand_tuple(rng, objects, relations, users) for _ in range(30)]
    queries = []
    for ns in ("g", "d"):
        for obj in objects:
            for rel in relations:
                queries.extend(T(ns, obj, rel, SubjectID(u)) for u in users)
                queries.extend(T(ns, obj, rel, SubjectSet("g", s, "m")) for s in objects)
    p = port_store(NS, rows)
    on = TorchCheckEngine(p, manager(), device="cpu", **BUILDS[build])
    oracle = CheckEngine(p)
    used = 0
    for round_ in range(2):
        before = port_counters(on)
        assert on.labels_settled()
        got = on.batch_check(queries)
        want, ref_counts = reference_run(rows, queries, **BUILDS[build])
        assert got == want, f"round {round_}: label route diverged from the reference"
        after = port_counters(on)
        delta = {k: after[k] - before[k] for k in COUNTERS}
        assert delta == ref_counts, f"round {round_}"
        used += delta["label_checks"]
        for i in random.Random(seed * 10 + round_).sample(range(len(queries)), 60):
            assert got[i] == oracle.subject_is_allowed(queries[i]), queries[i]
        new = [_rand_tuple(rng, objects, relations, users) for _ in range(rng.randrange(1, 5))]
        if round_ == 0:
            new.append(T("g", rng.choice(objects), "", SubjectID("seed")))
        gone = rng.sample(rows, min(rng.randrange(0, 3), len(rows)))
        p.write_relation_tuples(*new)
        if gone:
            p.delete_relation_tuples(*gone)
        rows = [r for r in rows if r not in gone] + [r for r in new if r not in gone]
    assert used > 0


#: the build knobs nothing else sets, each with the device gate at 0
KNOBS = {
    "batch32": {"labels_batch": 32},
    "min-gain": {"labels_batch": 32, "labels_min_gain": 0.1},
    "host-forced": {"labels_device_build": False},
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_build_knobs_route_as_reference(knobs):
    """``labels_batch``, ``labels_min_gain`` and ``labels_device_build``
    reach the build: the engine decides and counts as ``TpuCheckEngine``
    with the same knobs, and its build took the batches, the early stop
    and the backend the knobs name."""
    rng = random.Random(9100)
    objects = [f"o{i}" for i in range(40)]
    users = [f"u{i}" for i in range(8)] + ["ghost"]
    rows = [_rand_tuple(rng, objects, ["m", "v"], users) for _ in range(160)]
    queries = [T(rng.choice(["g", "d"]), rng.choice(objects), rng.choice(["m", "v"]),
                 SubjectID(rng.choice(users))) for _ in range(300)]
    kw = {"labels_device_min_edges": 0, **KNOBS[knobs]}
    on = assert_route_parity(rows, queries, **kw)
    snap, info = on.snapshot(), on.label_build_info
    if knobs == "host-forced":
        assert info is None and port_counters(on)["label_device_builds"] == 0
        return
    assert port_counters(on)["label_device_builds"] == 1
    assert info.batches > 1
    if knobs == "min-gain":
        assert info.truncated == "min_gain" and info.landmarks < snap.num_int
    else:
        assert info.truncated == "" and info.landmarks == snap.num_int


def _req(method, port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_rest_read_your_writes_across_label_rebuild(monkeypatch, build):
    """A PUT that a delta overlay cannot express (it gives the static
    ``d:doc#view`` an in-edge, a class change) makes a rebuilt snapshot
    whose label build runs in the background (held back here until the
    check has answered): the check right after the PUTs sees the writes on
    the BFS route, and once the new index lands the label route answers it
    the same way. The daemon passes the build knobs through
    ``engine_options``."""
    d = Daemon([tns.Namespace(id=i, name=n) for n, i in NS], device="cpu",
               tuples=deep_rows(depth=8), engine_options=BUILDS[build])
    d.start()
    try:
        eng = d.engine
        assert eng.labels_settled()
        q = T("d", "doc", "view", SubjectID("carol"))
        assert _req("GET", d.read.port, "/check?" + q.to_url_query())[0] == 403
        gate = threading.Event()
        real_build = eng._build_label_index

        def held_build(snap):
            gate.wait(30)
            return real_build(snap)

        monkeypatch.setattr(eng, "_build_label_index", held_build)
        new = T("g", "c7", "m", SubjectID("carol"))
        assert _req("PUT", d.write.port, "/relation-tuples", new.to_json())[0] == 201
        relayout = T("g", "zz", "m", SubjectSet("d", "doc", "view"))
        assert _req("PUT", d.write.port, "/relation-tuples", relayout.to_json())[0] == 201
        before = port_counters(eng)
        assert _req("GET", d.read.port, "/check?" + q.to_url_query()) == (200, {"allowed": True})
        assert eng.snapshot().labels is None, "the rebuilt index must not have landed yet"
        assert port_counters(eng)["label_checks"] == before["label_checks"]
        gate.set()
        assert eng.labels_settled()
        assert _req("GET", d.read.port, "/check?" + q.to_url_query()) == (200, {"allowed": True})
        assert _req("POST", d.read.port, "/check/batch", {"tuples": [
            q.to_json(), T("d", "doc", "view", SubjectID("dave")).to_json()]}) == (
            200, {"results": [True, False]})
        after = port_counters(eng)
        assert after["label_checks"] >= before["label_checks"] + 2
        assert after["label_builds"] == before["label_builds"] + 1
        assert after["label_device_builds"] == 2 * (build == "device")
    finally:
        d.stop()


def test_failed_label_build_is_raised_not_hidden(monkeypatch):
    """No quiet BFS fallback: a failing build surfaces in labels_settled()
    and in the next check."""
    p = port_store(NS, deep_rows(depth=4))
    eng = TorchCheckEngine(p, manager(), device="cpu")

    def broken(snap):
        raise RuntimeError("kernel exploded")

    monkeypatch.setattr(eng, "_build_label_index", broken)
    with pytest.raises(RuntimeError, match="label build failed"):
        eng.labels_settled()
    with pytest.raises(RuntimeError, match="label build failed"):
        eng.batch_check([T("d", "doc", "view", SubjectID("alice"))])


def test_concurrent_checks_while_labels_install():
    """8 threads check while the device label build lands (short switch
    interval): every decision stays exact, and every label-routed batch
    counts each of its queries once (a lost counter update would leave the
    total off a multiple of the batch)."""
    rows = deep_rows(depth=8, users=tuple(f"u{i}" for i in range(6)))
    qs = [T("d", "doc", "view", SubjectID(u)) for u in ("u0", "u3", "ghost", "nope", "u5")] * 10
    want = [q.subject.id.startswith("u") for q in qs]
    p = port_store(NS, rows)
    eng = TorchCheckEngine(p, manager(), device="cpu", labels_device_min_edges=0)
    errors: list = []

    def worker():
        try:
            for _ in range(15):
                assert eng.batch_check(qs) == want
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert eng.labels_settled()
    c = port_counters(eng)
    assert c["label_builds"] == c["label_device_builds"] == 1
    assert (c["label_checks"] + c["label_fallbacks"]) % len(qs) == 0
    assert eng.batch_check(qs) == want and port_counters(eng)["label_checks"] > c["label_checks"]


def test_config4_matches_reference_at_20k_tuples(monkeypatch):
    """BASELINE config 4 cut to 20k tuples, a size where the JAX build
    takes seconds: with the device build forced, the port's label arrays
    are byte-equal to ``TpuCheckEngine``'s, its ``BuildInfo`` equals the
    one the JAX ``device_build_labels`` returned inside that engine, and
    decisions and route counters equal the reference's and the analytic
    expectation."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu.graph import label_build as jax_label_build
    from keto_tpu.relationtuple.model import RelationTuple as JaxTuple

    from keto_tpu_torch.workloads import GITHUB_NAMESPACES, github_queries, github_workload
    from test_torch_labels import assert_index_equal

    rng = random.Random(20261017 + 4)
    tuples, ctx = github_workload(rng, 20_000)
    queries, expected = github_queries(rng, 2_000, ctx)
    ns = [(n.name, n.id) for n in GITHUB_NAMESPACES]
    jax_build, infos = jax_label_build.device_build_labels, []

    def keep_info(*a, **kw):
        idx, info = jax_build(*a, **kw)
        infos.append(info)
        return idx, info

    monkeypatch.setattr(jax_label_build, "device_build_labels", keep_info)
    jp = jax_store(ns, tuples)
    ref = TpuCheckEngine(jp, jp.namespaces, labels_device_min_edges=0)
    assert ref.labels_settled()
    want = ref.batch_check([JaxTuple.from_string(str(q)) for q in queries])
    m = ref.maintenance.snapshot()

    store = port_store(ns, tuples)
    eng = TorchCheckEngine(store, store.namespaces, device="cpu", labels_device_min_edges=0)
    assert eng.labels_settled()
    assert eng.batch_check(queries) == want == expected
    assert port_counters(eng) == {k: m.get(k, 0) for k in COUNTERS}
    assert port_counters(eng)["label_checks"] == len(queries)
    assert_index_equal(eng.snapshot().labels, ref.snapshot().labels)
    (jinfo,) = infos
    for k in ("landmarks", "batches", "restarts", "dispatches", "sweep_entries", "truncated",
              "gain_history"):
        assert getattr(eng.label_build_info, k) == getattr(jinfo, k), k


def test_config4_device_build_at_300k_tuples():
    """BASELINE config 4 cut to 300k tuples (the smoke's deep-phase seed):
    the device build (gate lowered, plain kernels) and the label route
    answer every check as the analytic expectation says. The pinned counts
    are those of the JAX ``device_build_labels`` on the same store (3,706
    interior rows, 3,460 ELL slots, 3,706 landmarks in 205 batches, 9,387
    restarts, 14,608 entries); running JAX here would take about a minute,
    so the live comparison is the 20k-tuple test above. They are the CPU
    rehearsal that PERF.md's config 4 prediction scaled from."""
    from keto_tpu_torch.workloads import GITHUB_NAMESPACES, github_queries, github_workload

    rng = random.Random(20261017 + 4)
    tuples, ctx = github_workload(rng, 300_000)
    queries, expected = github_queries(rng, 5_000, ctx)
    store = port_store([(n.name, n.id) for n in GITHUB_NAMESPACES], tuples)
    eng = TorchCheckEngine(store, store.namespaces, device="cpu", labels_device_min_edges=0)
    assert eng.labels_settled()
    snap = eng.snapshot()
    assert (snap.num_int, eng._interior_ell_slots(snap)) == (3_706, 3_460)
    info = eng.label_build_info
    assert (info.landmarks, info.batches, info.restarts) == (3_706, 205, 9_387)
    assert snap.labels.n_entries == 14_608
    assert eng.batch_check(queries) == expected
    c = port_counters(eng)
    assert c["label_device_builds"] == 1 and c["label_checks"] == len(queries)
