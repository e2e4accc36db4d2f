"""Decision provenance on the CPU against the JAX package: the witness
functions, the explain engine and the decision log (keto_tpu_torch/explain).

The scenarios of tests/test_explain.py, each run through the port's
``ExplainEngine`` over ``TorchCheckEngine(device="cpu")`` and the
reference's over ``TpuCheckEngine`` on the same tuples: the two responses
must be equal on ``allowed``, ``route``, ``witness``, ``certificate``,
``verified``, ``witness_source`` and ``landmark``, and every decision must
be the oracle's (grants verified, denies certified, no divergence). Also
the cpu route over the port's oracle, divergence counting, the landmark of
``label_witness_info`` and the cases where it has none, a failed K4 launch
raising out of ``label_witness_info`` and ``explain`` (counted), and the
decision log: explain records, rotation and retention, torn lines,
sampling bounds.
"""

from __future__ import annotations

import random
import time

import pytest

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.explain import (
    DecisionLog,
    ExplainEngine,
    build_witness,
    oracle_witness,
    verify_witness,
)
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]
FIELDS = ("allowed", "route", "witness", "certificate", "verified", "witness_source", "landmark")
QUIET = {"compact_after_s": 3600.0, "overlay_edge_budget": 1 << 20}


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def to_jax(q):
    from keto_tpu.relationtuple import model as jm

    sub = (jm.SubjectID(q.subject.id) if isinstance(q.subject, SubjectID)
           else jm.SubjectSet(q.subject.namespace, q.subject.object, q.subject.relation))
    return jm.RelationTuple(namespace=q.namespace, object=q.object, relation=q.relation,
                            subject=sub)


def wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def fuzz_rows(seed, n_tuples=120):
    """tests/test_explain.py's ``fuzz_store``: (rows, queries)."""
    rng = random.Random(seed)
    objects = [f"o{i}" for i in range(10)]
    relations = ["r0", "r1"]
    users = [f"u{i}" for i in range(6)]

    def rand_set():
        return SubjectSet("g", rng.choice(objects), rng.choice(relations))

    rows = []
    for _ in range(n_tuples):
        sub = SubjectID(rng.choice(users)) if rng.random() < 0.5 else rand_set()
        rows.append(T(rng.choice(["g", "d"]), rng.choice(objects), rng.choice(relations), sub))
    queries = []
    for _ in range(60):
        sub = SubjectID(rng.choice(users + ["ghost"])) if rng.random() < 0.5 else rand_set()
        queries.append(T(rng.choice(["g", "d"]), rng.choice(objects), rng.choice(relations), sub))
    return rows, queries


def deep_rows(depth=8, users=("alice", "bob")):
    rows = [T("d", "doc", "view", SubjectSet("g", "c0", "m"))]
    for i in range(depth - 1):
        rows.append(T("g", f"c{i}", "m", SubjectSet("g", f"c{i + 1}", "m")))
    rows.append(T("g", f"c{depth - 1}", "m", SubjectSet("g", "c0", "m")))
    rows += [T("g", f"c{depth - 1}", "m", SubjectID(u)) for u in users]
    return rows


class Pair:
    """The port's explain engine and the reference's over the same tuples
    (writes go to both stores)."""

    def __init__(self, rows, **kw):
        from keto_tpu.check.tpu_engine import TpuCheckEngine
        from keto_tpu.explain import ExplainEngine as RefExplain

        self.store = port_store(NS, rows)
        self.jstore = jax_store(NS, rows)
        self.engine = TorchCheckEngine(self.store, self.store.namespaces, device="cpu", **kw)
        self.ref = TpuCheckEngine(self.jstore, self.jstore.namespaces, **kw)
        self.engine.labels_settled()
        self.ref.labels_settled()
        self.ex = ExplainEngine(self.engine, self.store)
        self.ref_ex = RefExplain(self.ref, self.jstore)
        self.oracle = CheckEngine(self.store)

    def write(self, *rows):
        self.store.write_relation_tuples(*rows)
        self.jstore.write_relation_tuples(*(to_jax(r) for r in rows))

    def delete(self, *rows):
        self.store.delete_relation_tuples(*rows)
        self.jstore.delete_relation_tuples(*(to_jax(r) for r in rows))

    def settle(self):
        self.engine.labels_settled()
        self.ref.labels_settled()

    def close(self):
        self.engine.close()
        self.ref.close()

    def check(self, queries, routes=None) -> list:
        """Explain every query on both sides; the responses agree field by
        field and with the oracle. Returns the port's responses."""
        out = []
        for q in queries:
            got = self.ex.explain(q)
            want = self.ref_ex.explain(to_jax(q))
            for f in FIELDS:
                assert got.get(f) == want.get(f), (q, f, got, want)
            assert got["allowed"] == self.oracle.subject_is_allowed(q), (q, got)
            assert "decision_divergence" not in got, (q, got)
            if got["allowed"]:
                assert got["verified"] and got["witness"], (q, got)
                path = [RelationTuple.from_json(w) for w in got["witness"]]
                assert verify_witness(self.store, q, path) == (True, "")
            else:
                assert got["witness"] is None
                assert got["certificate"]["type"] == "frontier-exhaustion"
            if routes is not None:
                routes.add(got["route"])
            out.append(got)
        assert self.ex.verify_failures == 0
        return out


@pytest.fixture
def pair_of():
    made = []

    def make(rows, **kw):
        p = Pair(rows, **kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


# -- witness core --------------------------------------------------------------


def test_witness_grant_path_verifies():
    p = port_store(NS, [
        T("d", "doc", "view", SubjectSet("g", "eng", "m")),
        T("g", "eng", "m", SubjectSet("g", "core", "m")),
        T("g", "core", "m", SubjectID("alice")),
    ])
    rt = T("d", "doc", "view", SubjectID("alice"))
    found, path, cert = build_witness(p, rt)
    assert found and cert is None
    assert [str(t) for t in path] == ["d:doc#view@g:eng#m", "g:eng#m@g:core#m", "g:core#m@alice"]
    assert verify_witness(p, rt, path) == (True, "")


def test_witness_deny_certificate_counts_the_closure():
    p = port_store(NS, [
        T("d", "doc", "view", SubjectSet("g", "eng", "m")),
        T("g", "eng", "m", SubjectID("alice")),
    ])
    found, path, cert = build_witness(p, T("d", "doc", "view", SubjectID("mallory")))
    assert not found and path is None
    assert cert["type"] == "frontier-exhaustion"
    assert cert["subject_sets_expanded"] == 2 and cert["edges_scanned"] == 2
    assert cert["hops"] >= 1 and not cert["truncated"] and sum(cert["frontier_sizes"]) >= 1


@pytest.mark.parametrize("seed", [7, 8])
def test_witness_functions_match_reference_fuzz(seed):
    """``build_witness`` and ``oracle_witness`` return the reference's paths
    and certificates on the same store, and agree with the oracle."""
    from keto_tpu.explain import build_witness as ref_build, oracle_witness as ref_oracle

    rows, queries = fuzz_rows(seed)
    p, jp = port_store(NS, rows), jax_store(NS, rows)
    oracle = CheckEngine(p)
    for q in queries:
        jq = to_jax(q)
        found, path, cert = build_witness(p, q, page_size=3)
        rfound, rpath, rcert = ref_build(jp, jq, page_size=3)
        assert (found, cert) == (rfound, rcert)
        assert [str(t) for t in path or []] == [str(t) for t in rpath or []]
        opath = oracle_witness(p, q)
        assert [str(t) for t in opath or []] == [str(t) for t in ref_oracle(jp, jq) or []]
        assert found == (opath is not None) == oracle.subject_is_allowed(q)
        if opath is not None:
            assert verify_witness(p, q, opath) == (True, "")


def test_verify_rejects_forged_witnesses():
    p = port_store(NS, [
        T("d", "doc", "view", SubjectSet("g", "eng", "m")),
        T("g", "eng", "m", SubjectID("alice")),
    ])
    rt = T("d", "doc", "view", SubjectID("alice"))
    _, path, _ = build_witness(p, rt)
    forged = [path[0], T("g", "eng", "m", SubjectID("mallory"))]
    ok, reason = verify_witness(p, T("d", "doc", "view", SubjectID("mallory")), forged)
    assert not ok and "store" in reason
    assert not verify_witness(p, rt, [T("d", "doc", "view", SubjectSet("g", "other", "m")), path[1]])[0]
    assert not verify_witness(p, T("d", "doc", "view", SubjectID("bob")), path)[0]
    assert not verify_witness(p, rt, [])[0]


# -- decision parity with the reference across routes -------------------------------


@pytest.mark.parametrize("seed", [3, 11])
def test_explain_parity_fuzz(pair_of, seed):
    rows, queries = fuzz_rows(seed)
    pr = pair_of(rows, **QUIET)
    routes = set()
    pr.check(queries, routes)
    assert routes <= {"label", "hybrid", "bfs", "host"}
    assert sum(pr.ex.requests_by_route.values()) == len(queries)
    assert pr.ex.requests_by_route == pr.ref_ex.requests_by_route


def test_explain_parity_labels_off_pure_bfs(pair_of):
    rows, queries = fuzz_rows(seed=19)
    pr = pair_of(rows, labels_enabled=False, **QUIET)
    routes = set()
    pr.check(queries, routes)
    assert "label" not in routes and "hybrid" not in routes and "bfs" in routes


def test_explain_parity_deep_chain(pair_of):
    pr = pair_of(deep_rows(depth=8), **QUIET)
    queries = [
        T("d", "doc", "view", SubjectID("alice")),
        T("d", "doc", "view", SubjectID("bob")),
        T("d", "doc", "view", SubjectID("mallory")),
        T("g", "c0", "m", SubjectID("alice")),
        T("g", "c3", "m", SubjectSet("g", "c5", "m")),
        T("g", "c6", "m", SubjectSet("g", "c1", "m")),
    ]
    got = pr.check(queries)
    assert got[0]["allowed"] and len(got[0]["witness"]) >= 3
    # interior → interior grants ride the label route with a landmark
    assert got[4]["route"] == "label" and got[4]["landmark"]["kind"] == "2-hop-label"
    assert got[5]["landmark"]["landmark"].startswith("g:c")


def test_explain_parity_overlay_churn_and_tombstones(pair_of):
    rows, _ = fuzz_rows(seed=31, n_tuples=60)
    pr = pair_of(rows, **QUIET)
    pr.write(T("d", "o9", "r0", SubjectSet("g", "o1", "r1")), T("g", "o1", "r1", SubjectID("newcomer")))
    q = T("d", "o9", "r0", SubjectID("newcomer"))
    assert pr.check([q])[0]["allowed"]
    pr.delete(T("g", "o1", "r1", SubjectID("newcomer")))
    assert not pr.check([q])[0]["allowed"]


def test_explain_parity_wildcards(pair_of):
    pr = pair_of([
        T("d", "doc", "view", SubjectSet("g", "grp", "m")),
        T("g", "grp", "", SubjectID("seed")),
        T("g", "grp", "m", SubjectID("alice")),
        T("d", "sec", "view", SubjectID("alice")),
    ], **QUIET)
    got = pr.check([
        T("d", "doc", "view", SubjectID("alice")),
        T("d", "doc", "view", SubjectID("seed")),
        T("g", "grp", "m", SubjectID("seed")),
        T("d", "sec", "view", SubjectID("alice")),
        T("d", "sec", "view", SubjectID("anyone")),
        T("d", "doc", "", SubjectID("alice")),
    ])
    assert got[5]["allowed"] and "landmark" not in got[5]


def test_explain_parity_across_stacked_compactions(pair_of):
    rows, queries = fuzz_rows(seed=37, n_tuples=60)
    pr = pair_of(rows, compact_after_s=0.05, overlay_edge_budget=1 << 20)
    for round_i in range(3):
        pr.write(T("d", "o0", "r0", SubjectID(f"round{round_i}")))
        wait_for(lambda: not pr.engine.snapshot().has_overlay and not pr.ref.snapshot().has_overlay,
                 msg=f"compaction round {round_i}")
        pr.settle()
        pr.check(queries[:20] + [T("d", "o0", "r0", SubjectID(f"round{round_i}"))])


# -- the explain engine --------------------------------------------------------------


def test_explain_cpu_route_threads_the_oracle_traversal():
    from keto_tpu.check.engine import CheckEngine as RefOracle
    from keto_tpu.explain import ExplainEngine as RefExplain

    rows = [T("d", "doc", "view", SubjectSet("g", "eng", "m")), T("g", "eng", "m", SubjectID("alice"))]
    p, jp = port_store(NS, rows), jax_store(NS, rows)
    ex, ref = ExplainEngine(CheckEngine(p), p), RefExplain(RefOracle(jp), jp)
    for q in (T("d", "doc", "view", SubjectID("alice")), T("d", "doc", "view", SubjectID("eve"))):
        got, want = ex.explain(q), ref.explain(to_jax(q))
        assert {f: got.get(f) for f in FIELDS} == {f: want.get(f) for f in FIELDS}
        assert got["snaptoken"] == want["snaptoken"] == "1"
    got = ex.explain(T("d", "doc", "view", SubjectID("alice")))
    assert got["route"] == "cpu" and got["allowed"] and got["verified"]
    assert got["witness_source"] == "oracle"
    assert ex.requests_by_route == {"cpu": 3}


def test_explain_counts_divergence_when_decision_is_wrong():
    p = port_store(NS, [T("d", "doc", "view", SubjectID("alice"))])
    notes = []
    ex = ExplainEngine(None, p, decide=lambda rt, at_least: (True, "label", 1),
                       on_verify_failure=notes.append)
    got = ex.explain(T("d", "doc", "view", SubjectID("mallory")))
    assert got["allowed"] is True and got["decision_divergence"] is True
    assert not got["verified"] and got["witness"] is None
    assert ex.verify_failures == 1
    assert notes and "no witness path" in notes[0]["reason"]
    ex2 = ExplainEngine(None, p, decide=lambda rt, at_least: (False, "label", 1))
    got = ex2.explain(T("d", "doc", "view", SubjectID("alice")))
    assert got["allowed"] is False and got["decision_divergence"] is True
    assert ex2.verify_failures == 1


def test_label_witness_info_names_the_landmark(pair_of):
    pr = pair_of(deep_rows(depth=6), **QUIET)
    for q in (T("g", "c0", "m", SubjectSet("g", "c4", "m")),
              T("g", "c5", "m", SubjectSet("g", "c2", "m"))):
        info = pr.engine.label_witness_info(q)
        assert info == pr.ref.label_witness_info(to_jax(q))
        assert info["kind"] == "2-hop-label" and isinstance(info["landmark_dev"], int)
        assert info["landmark"].startswith("g:c")
        a, b = info["pair"]
        assert info["landmark_dev"] == pr.engine.snapshot().labels.witness_landmark(a, b)


def test_label_witness_info_has_no_landmark_where_the_labels_cannot_say(pair_of):
    pr = pair_of(deep_rows(depth=6), **QUIET)
    interior = T("g", "c0", "m", SubjectSet("g", "c4", "m"))
    # a sink target, a wildcard query: no single interior pair
    for q in (T("d", "doc", "view", SubjectID("alice")), T("g", "c0", "", SubjectSet("g", "c4", "m"))):
        assert pr.engine.label_witness_info(q) is None
        assert pr.ref.label_witness_info(to_jax(q)) is None
    # an overlay edge between interior rows dirties the labels
    pr.write(T("g", "c1", "m", SubjectSet("g", "c4", "m")))
    snap = pr.engine.snapshot()
    assert snap.lab_dirty and snap.labels is not None
    assert pr.engine.label_witness_info(interior) is None
    got = pr.check([interior])[0]
    assert got["route"] == "bfs" and "landmark" not in got
    # labels off
    off = TorchCheckEngine(pr.store, pr.store.namespaces, device="cpu", labels_enabled=False)
    try:
        assert off.label_witness_info(interior) is None
    finally:
        off.close()


def test_label_witness_info_reads_the_host_index_only_without_device_labels(pair_of, monkeypatch):
    pr = pair_of(deep_rows(depth=6), **QUIET)
    q = T("g", "c0", "m", SubjectSet("g", "c4", "m"))
    snap = pr.engine.snapshot()
    launches = []
    real = kernels.label_step_witness
    monkeypatch.setattr(kernels, "label_step_witness",
                        lambda *a: launches.append(1) or real(*a))
    want = pr.engine.label_witness_info(q)
    assert launches == [1]
    snap.device_labels = None
    assert pr.engine.label_witness_info(q) == want and launches == [1]


def test_failed_witness_launch_raises_and_is_counted(pair_of, monkeypatch):
    pr = pair_of(deep_rows(depth=6), **QUIET)
    q = T("g", "c0", "m", SubjectSet("g", "c4", "m"))

    def broken(*a):
        raise RuntimeError("CUDA kernel keto_label_witness failed to launch (cudaError 9)")

    monkeypatch.setattr(kernels, "label_step_witness", broken)
    with pytest.raises(RuntimeError, match="keto_label_witness"):
        pr.engine.label_witness_info(q)
    assert pr.engine.counters()["witness_errors"] == 1
    # the explain engine lets it through: no quiet "no landmark" answer
    with pytest.raises(RuntimeError, match="keto_label_witness"):
        pr.ex.explain(q)
    assert pr.engine.counters()["witness_errors"] == 2
    # a deny never asks for a landmark
    assert not pr.ex.explain(T("g", "c4", "m", SubjectSet("g", "nobody", "m")))["allowed"]


# -- the decision log ---------------------------------------------------------------


def test_explain_records_to_decision_log(tmp_path):
    p = port_store(NS, [T("d", "doc", "view", SubjectID("alice"))])
    dl = DecisionLog(str(tmp_path / "dlog"))
    ex = ExplainEngine(CheckEngine(p), p, decision_log=dl)
    ex.explain(T("d", "doc", "view", SubjectID("alice")), trace_id="t-1")
    ex.explain(T("d", "doc", "view", SubjectID("mallory")), tenant="acme")
    recs, corrupt = dl.read_all("default")
    assert corrupt == 0 and len(recs) == 1
    assert recs[0]["kind"] == "explain" and recs[0]["decision"] is True
    assert recs[0]["witness"] and recs[0]["trace_id"] == "t-1"
    acme, _ = dl.read_all("acme")
    assert len(acme) == 1 and acme[0]["decision"] is False
    assert acme[0]["certificate"]["type"] == "frontier-exhaustion"
    assert sorted(dl.tenants()) == ["acme", "default"]


def test_decision_log_rotation_and_retention(tmp_path):
    dl = DecisionLog(str(tmp_path), segment_bytes=256, retention=3)
    for i in range(60):
        dl.record("default", {"kind": "check", "i": i})
    sealed = [s for s in dl.segments("default") if "seg-" in s.name]
    assert sealed and len(sealed) <= 3
    assert dl.rotations_total >= len(sealed)
    recs, corrupt = dl.read_all("default")
    assert corrupt == 0
    assert [r["i"] for r in recs] == sorted(r["i"] for r in recs) and recs[-1]["i"] == 59
    assert all("ts" in r and r["tenant"] == "default" for r in recs)


def test_decision_log_tolerates_torn_and_corrupt_lines(tmp_path):
    dl = DecisionLog(str(tmp_path), segment_bytes=1 << 20)
    for i in range(5):
        dl.record("default", {"kind": "check", "i": i})
    dl.close()
    active = [s for s in dl.segments("default") if s.name.endswith(".tmp")]
    assert active
    with open(active[0], "a") as f:
        f.write('{"kind": "check", "i": 99')  # torn tail
    with open(active[0], "r+") as f:
        lines = f.readlines()
        lines[1] = "NOT JSON AT ALL\n"
        f.seek(0)
        f.writelines(lines)
        f.truncate()
    recs, corrupt = dl.read_all("default")
    assert corrupt == 2
    assert [r["i"] for r in recs] == [0, 2, 3, 4]


def test_decision_log_sampling_bounds(tmp_path):
    root = str(tmp_path / "never-written")
    assert not any(DecisionLog(root, sample=0.0).sampled() for _ in range(200))
    dl1 = DecisionLog(root, sample=1.0)
    assert all(dl1.sampled() for _ in range(200))
    dl_half = DecisionLog(root, sample=0.5, seed=42)
    assert 350 < sum(dl_half.sampled() for _ in range(1000)) < 650
