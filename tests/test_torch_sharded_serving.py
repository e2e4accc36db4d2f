"""Sharded serving of the PyTorch port on the CPU: the sharded
``TorchCheckEngine`` (``mesh=``, the plain K10 programs) against the
single-device engine, the oracle and the reference's sharded
``TpuCheckEngine``.

Port copies of tests/test_sharded_serving.py: bit parity with the
single-device engine and the oracle at graph 2, 4 and 8; the fuzz of
overlay churn, interior inserts (the overlay ELL, the label route blocked),
tombstones (ELL patches routed to the owning shard) and a compaction; the
row-range assignment; the bucket partition; the stream. Plus what the port
promises beside them: decisions, route counters, the ``shard_*`` counters
and each stream slice's ``halo_rounds`` equal to the reference's sharded
engine on the same writes; a sharded device label build equal to the
single one; listings and explain on a sharded engine; ``serve --mesh-graph
4 --device cpu``; a mesh over two devices raises; a failed sharded
dispatch raises and is counted.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.graph import label_build
from keto_tpu_torch.parallel import ShardMesh, make_mesh
from keto_tpu_torch.parallel import sharded as ps
from keto_tpu_torch.graph.device_build import shard_row_ranges
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_overlay import Pair, jt

NS3 = [("g", 1), ("d", 2), ("", 3)]
#: the counters both engines keep, the sharded ones among them
COUNTED = ("delta_applies", "full_rebuilds", "compactions", "label_checks", "label_fallbacks",
           "label_builds", "label_invalidations", "shard_halo_rounds", "shard_halo_bytes",
           "shard_frontier_bits")


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def manager():
    return tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in NS3])


def nested_rows(rng, n_random=150):
    """Real interior chains (docs → leaf → mid → top groups), so the sharded
    program has active buckets, plus random noise tuples (tests/
    test_sharded_serving.py:_nested_store)."""
    objs = [f"o{i}" for i in range(10)]
    users = [f"u{i}" for i in range(8)]
    rows = []
    for i, o in enumerate(objs):
        rows.append(T("d", o, "view", SubjectSet("g", f"leaf{i % 4}", "m")))
    for i in range(4):
        rows.append(T("g", f"leaf{i}", "m", SubjectSet("g", f"mid{i % 2}", "m")))
    for i in range(2):
        rows.append(T("g", f"mid{i}", "m", SubjectSet("g", "top", "m")))
    for i, u in enumerate(users):
        rows.append(T("g", "top", "m", SubjectID(u)) if i < 4
                    else T("g", f"leaf{i % 4}", "m", SubjectID(u)))
    names, rels = ["g", "d", ""], ["m", "view", ""]
    for _ in range(n_random):
        sub = (SubjectID(rng.choice(users)) if rng.random() < 0.4
               else SubjectSet(rng.choice(names), rng.choice(objs), rng.choice(rels)))
        rows.append(T(rng.choice(names), rng.choice(objs), rng.choice(rels), sub))
    return rows, objs, users


def queries(rng, objs, users, n=120):
    """Label hits, BFS fallbacks, wildcards and ghosts."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            out.append(T("d", rng.choice(objs), "view", SubjectID(rng.choice(users + ["ghost"]))))
        elif r < 0.7:
            out.append(T("g", rng.choice(["leaf0", "top", "mid1"]), "m",
                         SubjectID(rng.choice(users))))
        elif r < 0.85:
            out.append(T("", rng.choice(objs), "", SubjectID(rng.choice(users))))
        else:
            out.append(T("d", "", "view", SubjectSet("g", rng.choice(["leaf1", "top"]), "m")))
    return out


def cpu_mesh(g):
    return make_mesh(graph=g, device="cpu")


def store_of(rows):
    from keto_tpu_torch.persistence.memory import MemoryPersister

    p = MemoryPersister(manager())
    p.write_relation_tuples(*rows)
    return p


def assert_parity(tag, store, qs, sharded, single):
    oracle = CheckEngine(store)
    got = sharded.batch_check(qs)
    ref = single.batch_check(qs)
    for q, a, b in zip(qs, got, ref):
        w = oracle.subject_is_allowed(q)
        assert a == w == b, f"{tag}: {q}: sharded={a} single={b} oracle={w}"


@pytest.fixture
def engines():
    made = []

    def make(*args, **kw):
        e = TorchCheckEngine(*args, device="cpu", **kw)
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


@pytest.mark.parametrize("graph_axis", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_engine_matches_single_and_oracle(engines, graph_axis, seed):
    rng = random.Random(seed)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    single = engines(p, p.namespaces)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(graph_axis))
    assert sharded.shard_count == graph_axis and single.shard_count == 0
    assert_parity(f"g={graph_axis}", p, queries(rng, objs, users), sharded, single)
    c = sharded.counters()
    assert c.get("shard_halo_rounds", 0) > 0 and c.get("shard_halo_bytes", 0) > 0
    assert c.get("shard_frontier_bits", 0) > 0
    assert not any(k.startswith("shard_") for k in single.counters())


def test_sharded_fuzz_overlay_tombstone_compaction(engines):
    """Delta overlays (interior inserts that dirty the label index → BFS
    fallback), tombstone deletes and a forced compaction, with parity at
    every stage on a 2-shard mesh."""
    rng = random.Random(42)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    single = engines(p, p.namespaces, overlay_edge_budget=8, compact_after_s=3600)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(2), overlay_edge_budget=8,
                      compact_after_s=3600)
    sharded.labels_settled()  # parity below must exercise the label route too
    assert_parity("base", p, queries(rng, objs, users), sharded, single)
    c0 = sharded.counters()
    assert c0.get("label_checks", 0) > 0, "label route never exercised"
    assert c0.get("label_fallbacks", 0) > 0, "BFS fallback never exercised"

    p.write_relation_tuples(T("g", "leaf2", "m", SubjectID("newbie")),
                            T("d", "o3", "view", SubjectID("direct")))
    assert_parity("delta", p, queries(rng, objs, users) + [T("d", "o0", "view", SubjectID("newbie"))],
                  sharded, single)
    # interior→interior insert: the routed overlay stage and a blocked label route
    p.write_relation_tuples(T("g", "mid0", "m", SubjectSet("g", "leaf3", "m")))
    assert_parity("delta-interior", p, queries(rng, objs, users), sharded, single)
    assert sharded.snapshot().device_shard_overlay is not None
    assert sharded.snapshot().device_overlay is None

    # tombstones: bucket slots patched on the owning shard
    base = sharded.snapshot()
    p.delete_relation_tuples(T("g", "top", "m", SubjectID(users[0])))
    p.delete_relation_tuples(T("d", "o0", "view", SubjectSet("g", "leaf0", "m")))
    assert_parity("tombstone", p,
                  queries(rng, objs, users) + [T("d", "o0", "view", SubjectID(users[5]))],
                  sharded, single)

    for i in range(20):
        p.write_relation_tuples(T("g", f"leaf{i % 4}", "m", SubjectID(f"bulk{i}")))
    sharded.snapshot()
    single.snapshot()
    sharded.maintenance_settled(fold=True)
    single.maintenance_settled(fold=True)
    assert_parity("compacted", p,
                  queries(rng, objs, users) + [T("d", "o1", "view", SubjectID("bulk3"))],
                  sharded, single)
    c = sharded.counters()
    assert c.get("compactions", 0) >= 1 and c.get("delta_applies", 0) >= 2
    assert sharded.snapshot().shard_spec is not base.shard_spec  # the fold re-partitions


def test_shard_row_ranges_assignment():
    assert shard_row_ranges(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert shard_row_ranges(8, 2) == [(0, 4), (4, 8)]
    assert shard_row_ranges(1, 4) == [(0, 1), (1, 1), (1, 1), (1, 1)]
    assert shard_row_ranges(0, 2) == [(0, 0), (0, 0)]


def test_shard_spec_partition_covers_every_bucket_row(engines):
    """Every valid bucket row lands in exactly one shard's slice, local
    scatter rows stay inside the slab, and entry routing conserves valid
    entries."""
    rng = random.Random(1)
    rows, _, _ = nested_rows(rng)
    p = store_of(rows)
    snap = engines(p, p.namespaces).snapshot()
    for g in (2, 4, 8):
        spec = ps.make_shard_spec(snap, g)
        rps = spec.rows_per_shard
        assert rps * g >= snap.num_int + 1
        for bi, b in enumerate(snap.buckets):
            seen = []
            for s in range(g):
                dst = spec.dst_sh[bi][s]
                valid = dst < rps
                seen.extend((dst[valid] + s * rps).tolist())
            assert sorted(seen) == list(range(b.offset, b.offset + b.n))
        ni, B = snap.num_int, 32
        e1r = np.asarray([0, ni - 1, ni + 1, 1], np.int32)
        e1q = np.asarray([0, 1, 0, 2], np.int32)
        packed = (e1r, e1q, np.full(4, ni + 1, np.int32), np.zeros(4, np.int32),
                  np.full(4, ni, np.int32), np.zeros(4, np.int32), np.full(B, ni, np.int32))
        entries, sizes = ps.route_entries(spec, packed, B)
        S1 = sizes[0]
        routed = 0
        for s in range(g):
            r, q = entries[s, :S1], entries[s, S1 : 2 * S1]
            valid = r < rps
            routed += int(np.count_nonzero(valid))
            for a, b in zip(r[valid] + s * rps, q[valid]):
                assert (a, b) in {(0, 0), (ni - 1, 1), (1, 2)}
        assert routed == 3


def test_sharded_stream(engines):
    rng = random.Random(5)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(4))
    qs = queries(rng, objs, users, n=90)
    got = [bool(b) for arr in sharded.batch_check_stream(iter(qs), slice_cap=32) for b in arr]
    oracle = CheckEngine(p)
    assert got == [oracle.subject_is_allowed(q) for q in qs]


@pytest.mark.parametrize("g", [2, 3])
def test_sharded_engine_matches_reference_sharded_engine(g):
    """Decisions, route and ``shard_*`` counters and each stream slice's
    halo rounds and bytes equal the reference's sharded ``TpuCheckEngine``
    on the same writes (an overlay, a tombstone, a fold among them)."""
    import jax

    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu.parallel import make_mesh as jmesh

    rng = random.Random(7 + g)
    rows, objs, users = nested_rows(rng)
    pair = Pair(NS3, rows)
    kw = dict(overlay_edge_budget=1 << 20, compact_after_s=3600)
    port = TorchCheckEngine(pair.mine, pair.mine.namespaces, device="cpu", mesh=cpu_mesh(g), **kw)
    ref = TpuCheckEngine(pair.ref, pair.ref.namespaces,
                         mesh=jmesh(jax.devices()[:g], graph=g, data=1), sharded=True, **kw)
    for eng in (port, ref):
        # the controllers' entry budgets follow measured service times; a
        # split chunk dispatches more BFS sub-batches (more halo rounds)
        # with the same decisions, so pin them for a deterministic count
        eng.stream_ctrl.entry_budget = lambda: None
    try:
        def check(qs):
            port.labels_settled()
            ref.labels_settled()
            got = port.batch_check(qs)
            assert got == [bool(x) for x in ref.batch_check([jt(q) for q in qs])]
            oracle = CheckEngine(pair.mine)
            assert got == [oracle.subject_is_allowed(q) for q in qs]

        def counters():
            c, m = port.counters(), ref.maintenance.snapshot()
            mine = {k: c.get(k, 0) for k in COUNTED}
            assert mine == {k: m.get(k, 0) for k in COUNTED}
            return mine

        def slices(qs):
            port.labels_settled()
            ref.labels_settled()
            out = []
            for eng, batch in ((port, qs), (ref, [jt(q) for q in qs])):
                gen, _ = eng.batch_check_stream_with_token(batch, ordered=False, with_info=True,
                                                            slice_cap=32)
                out.append({off: (info["route"], info["bfs_steps"], info.get("halo_rounds"),
                                  info.get("halo_bytes"), [bool(x) for x in dec])
                            for off, dec, info in gen})
            assert out[0] == out[1]
            return out[0]

        check(queries(rng, objs, users))
        counters()
        got = slices(queries(rng, objs, users, n=96))
        assert any(v[2] for v in got.values()), "no slice ran the sharded BFS"
        pair.write([T("g", "mid1", "m", SubjectSet("g", "leaf0", "m")),
                    T("g", "leaf1", "m", SubjectID("fresh"))])
        check(queries(rng, objs, users) + [T("d", "o1", "view", SubjectID("fresh"))])
        # a delete in a graph with a wildcard namespace rebuilds (both engines)
        pair.write(delete=[T("g", "mid0", "m", SubjectSet("g", "top", "m"))])
        check(queries(rng, objs, users))
        pair.write([T("g", "leaf2", "m", SubjectSet("g", "mid1", "m"))])
        check(queries(rng, objs, users))
        slices(queries(rng, objs, users, n=64))
        for eng in (port, ref):
            eng._refresh_force_full = True
            for _ in range(20):
                eng._refresh_pass()
                if not eng._snapshot.has_overlay:
                    break
        check(queries(rng, objs, users))
        c = counters()
        assert c["shard_halo_rounds"] and c["compactions"] and c["label_checks"]
        assert c["full_rebuilds"] >= 2 and c["delta_applies"] >= 2
    finally:
        port.close()
        ref.close()


def test_sharded_device_label_build_equals_single():
    """``_ShardedSweeper`` stores the same entries as ``_Sweeper``: the whole
    index (both label arrays and the ok flags) is equal at 2 and 3 shards,
    and an incremental patch through the sharded sweeps equals one through
    the single sweeps."""
    rng = random.Random(3)
    rows, _, _ = nested_rows(rng, n_random=300)
    eng = TorchCheckEngine(store_of(rows), manager(), device="cpu", labels_enabled=False)
    try:
        snap = eng.snapshot()
    finally:
        eng.close()
    one, _ = label_build.device_build_labels(snap, max_width=8, batch=32, device="cpu")
    for g in (2, 3):
        idx, info = label_build.device_build_labels(snap, max_width=8, batch=32, device="cpu",
                                                    mesh=cpu_mesh(g), shard_count=g)
        assert idx.backend == "sharded" and one.backend == "device"
        for f in ("out_lab", "in_lab", "out_ok", "in_ok", "processed"):
            assert np.array_equal(getattr(idx, f), getattr(one, f)), f
        assert idx.n_entries == one.n_entries and info.landmarks == idx.n_landmarks
    edges = [(0, snap.num_int - 1)]
    a = label_build.device_patch_labels(one, snap, edges, batch=32, device="cpu")
    b = label_build.device_patch_labels(one, snap, edges, batch=32, device="cpu",
                                        mesh=cpu_mesh(3), shard_count=3)
    assert (a is None) == (b is None)
    if a is not None:
        assert np.array_equal(a.out_lab, b.out_lab) and np.array_equal(a.in_lab, b.in_lab)


def test_sharded_engine_builds_labels_on_the_sharded_sweeper(engines):
    rng = random.Random(4)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(4), labels_device_min_edges=1)
    single = engines(p, p.namespaces, labels_device_min_edges=1)
    assert sharded.labels_settled() and single.labels_settled()
    a, b = sharded.snapshot().labels, single.snapshot().labels
    assert a.backend == "sharded" and b.backend == "device"
    assert np.array_equal(a.out_lab, b.out_lab) and np.array_equal(a.in_lab, b.in_lab)
    out_sh, in_sh, rl = sharded.snapshot().device_shard_labels
    assert out_sh.shape[0] == 4 and sharded.snapshot().device_labels is None
    assert_parity("labels", p, queries(rng, objs, users), sharded, single)
    assert sharded.counters()["label_device_builds"] == 1


def test_listings_and_explain_on_a_sharded_engine(engines):
    """ListObjects and ListSubjects answer on their own device layouts
    while the check engine is sharded; explain names its landmark from the
    host index (the reference's sharded rule), and equals the single
    engine's explain field for field."""
    from keto_tpu_torch.explain import ExplainEngine
    from keto_tpu_torch.list.gpu_engine import SnapshotListEngine

    rng = random.Random(9)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(4))
    single = engines(p, p.namespaces)
    sharded.labels_settled()
    single.labels_settled()
    ls, l1 = (SnapshotListEngine(e, p.namespaces, device="cpu") for e in (sharded, single))
    for u in users + ["ghost"]:
        assert sorted(ls.list_objects("d", "view", SubjectID(u))[0]) == \
            sorted(l1.list_objects("d", "view", SubjectID(u))[0])
    for o in objs:
        assert sorted(map(str, ls.list_subjects("d", o, "view")[0])) == \
            sorted(map(str, l1.list_subjects("d", o, "view")[0]))
    # every listing of a known subject or object ran on the device layouts
    assert ls.requests_total == {("objects", "device"): len(users),
                                 ("subjects", "device"): len(objs)}
    es, e1 = ExplainEngine(sharded, p), ExplainEngine(single, p)
    named = 0
    for q in [T("g", "leaf0", "m", SubjectID("u0")), T("d", "o1", "view", SubjectID("u1")),
              T("g", "leaf1", "m", SubjectSet("g", "top", "m")),
              T("d", "o2", "view", SubjectID("ghost"))]:
        a, b = es.explain(q), e1.explain(q)
        for k in ("allowed", "verified", "route"):
            assert a.get(k) == b.get(k), (q, k, a, b)
        info = sharded.label_witness_info(q)
        assert info == single.label_witness_info(q)
        named += info is not None
    assert named, "no explain named a landmark"


def test_serve_with_mesh_graph_on_cpu(tmp_path):
    """``python -m keto_tpu_torch serve --mesh-graph 4 --device cpu`` serves
    the cat-videos checks from four shards and exits 0 on SIGTERM."""
    import re
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_rest import _req

    from keto_tpu_torch.workloads import CAT_VIDEOS_CHECKS, CAT_VIDEOS_TUPLES

    tuples = tmp_path / "tuples.txt"
    tuples.write_text(CAT_VIDEOS_TUPLES)
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "keto_tpu_torch", "serve", "--device", "cpu", "--mesh-graph", "4",
         "--read-port", "0", "--write-port", "0", "--namespace", "videos=1",
         "--tuples", str(tuples)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"read :(\d+), write :(\d+), device cpu, graph shards 4", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            assert _req("GET", int(m.group(1)), "/check?" + q)[0] == (200 if allowed else 403)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_daemon_passes_the_mesh():
    from keto_tpu_torch.cmd import build_parser
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.workloads import CAT_VIDEOS_NAMESPACES

    assert build_parser().parse_args(["serve", "--mesh-graph", "4"]).mesh_graph == 4
    assert build_parser().parse_args(["serve"]).mesh_graph == 1
    d = Daemon(CAT_VIDEOS_NAMESPACES, device="cpu", mesh_graph=3)
    try:
        assert d.engine.shard_count == 3 and d.engine._mesh.graph == 3
    finally:
        d.engine.close()
    assert Daemon(CAT_VIDEOS_NAMESPACES, device="cpu").engine.shard_count == 0


def test_a_mesh_over_two_devices_raises():
    with pytest.raises(NotImplementedError, match="A11"):
        make_mesh(devices=["cpu", "cuda:0"], graph=2)
    with pytest.raises(NotImplementedError, match="A11"):
        ShardMesh(devices=(torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(NotImplementedError, match="data"):
        make_mesh(devices=["cpu"] * 4, graph=2)
    mesh = make_mesh(devices=["cpu", "cpu"], graph=2)
    assert mesh.shape == {"graph": 2, "data": 1} and mesh.device == torch.device("cpu")
    assert make_mesh(devices=["cuda", "cuda:0"], graph=2).graph == 2  # one device, two names
    with pytest.raises(ValueError):
        TorchCheckEngine(store_of([]), manager(), device="cpu",
                         mesh=ShardMesh(devices=(torch.device("meta"),)))


def test_failed_sharded_dispatch_raises_and_is_counted(engines, monkeypatch):
    rng = random.Random(11)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(2), labels_enabled=False)
    qs = [T("d", o, "view", SubjectID(u)) for o in objs[:3] for u in users[:3]]
    assert sharded.batch_check(qs) == [CheckEngine(p).subject_is_allowed(q) for q in qs]

    def boom(*a, **kw):
        raise RuntimeError("CUDA kernel keto_shard_answer failed to launch (cudaError 98)")

    monkeypatch.setattr(ps, "check_step", boom)
    with pytest.raises(RuntimeError, match="keto_shard_answer"):
        sharded.batch_check(qs)
    assert sharded.counters()["shard_dispatch_failures"] == 1
    assert sharded.staging_snapshot()["leased"] == 0


def test_failed_sharded_routing_raises_and_is_counted(engines, monkeypatch):
    rng = random.Random(12)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    sharded = engines(p, p.namespaces, mesh=cpu_mesh(2), labels_enabled=False)
    qs = [T("d", o, "view", SubjectID(u)) for o in objs[:3] for u in users[:3]]

    def boom(*a, **kw):
        raise ValueError("routing failed")

    monkeypatch.setattr(ps, "route_entries", boom)
    with pytest.raises(ValueError, match="routing failed"):
        sharded.batch_check(qs)
    assert sharded.counters()["shard_dispatch_failures"] == 1
    assert sharded.staging_snapshot()["leased"] == 0


def test_store_fork_is_independent_and_keeps_row_ids():
    rng = random.Random(13)
    rows, objs, users = nested_rows(rng, n_random=20)
    p = store_of(rows)
    twin = store_of(rows)  # the same writes, never forked
    f = p.fork()
    assert f.watermark() == p.watermark() == twin.watermark()
    assert [r.key7() for r in f.snapshot_rows()[0]] == [r.key7() for r in p.snapshot_rows()[0]]
    extra = [T("d", "fresh", "view", SubjectID("u-new")), T("d", "other", "view", SubjectID("u0"))]
    p.write_relation_tuples(extra[0])
    twin.write_relation_tuples(extra[0])
    f.write_relation_tuples(extra[1])
    f.delete_relation_tuples(rows[0])
    # the fork's writes and deletes are invisible to the parent and back
    assert [(r.key7(), r.seq) for r in p.snapshot_rows()[0]] == \
        [(r.key7(), r.seq) for r in twin.snapshot_rows()[0]]
    fk = {r.key7() for r in f.snapshot_rows()[0]}
    pk = {r.key7() for r in p.snapshot_rows()[0]}
    assert fk ^ pk == {p._to_row(extra[0]).key7(), f._to_row(extra[1]).key7(),
                       p._to_row(rows[0]).key7()}
    assert p.watermark() == twin.watermark()
    seqs = [r.seq for r in f.snapshot_rows()[0]]
    assert len(set(seqs)) == len(seqs)


def test_per_shard_ledger_and_a_one_shard_oom_walk_one_mesh_wide_rung(engines, monkeypatch):
    """The port of tests/test_sharded_serving.py:187: the governor keeps
    each shard's owned bytes; an out-of-memory error in one sharded
    dispatch evicts ONE rung for the whole mesh, retries once and answers
    equal; a plan only the hottest shard's slice refuses drops the labels
    of every shard at once."""
    rng = random.Random(9)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    e = engines(p, p.namespaces, mesh=cpu_mesh(4))
    assert e.labels_settled()
    snap = e._snapshot
    spec = snap.shard_spec
    shards = e.hbm.shard_resident_bytes()
    gov = e.hbm.snapshot()
    assert gov["shard_count"] == 4 and gov["shards"] == shards and sum(shards) > 0
    assert e.hbm.shard_ledger()["snapshot"] == list(spec.owned_bucket_bytes)
    assert e.hbm.ledger()["snapshot"] == spec.padded_bucket_bytes() == \
        e.hbm_ledger_bytes()["snapshot"]
    assert e.hbm.ledger()["labels"] == e.hbm_ledger_bytes()["labels"] > 0

    qs = queries(rng, objs, users, n=60)
    want = [CheckEngine(p).subject_is_allowed(q) for q in qs]
    assert e.batch_check(qs) == want
    real, fired = ps.check_step, []

    def one_shard_oom(*a, **kw):
        if not fired:
            fired.append(1)
            raise torch.OutOfMemoryError("CUDA out of memory on shard 2's slab")
        return real(*a, **kw)

    monkeypatch.setattr(ps, "check_step", one_shard_oom)
    assert e.batch_check(qs) == want
    g = e.hbm.snapshot()
    assert fired and (g["oom_events"], g["oom_recoveries"], g["rung"]) == (1, 1, 1)
    monkeypatch.setattr(ps, "check_step", real)

    # the hottest shard binds: the global plan fits, one slice does not, and
    # the labels rung (every shard's labels) makes that slice fit
    res = e.hbm.shard_resident_bytes()
    lab = e.hbm.shard_ledger()["labels"]
    hot = max(range(4), key=lambda s: lab[s])
    after = res[hot] - lab[hot]
    x = max(max(res), -(-(e.hbm.resident_bytes() - 4 * after) // 3) + 1, 16)
    e.hbm.set_budget_bytes(4 * (after + x))
    per = [0, 0, 0, 0]
    per[hot] = x
    assert e.hbm.fits(x) and res[hot] + x > e.hbm.budget_bytes // 4
    assert e.hbm.plan(x, what="one shard", per_shard=per)
    assert e.hbm.snapshot()["evicted"] == ["staging", "labels"]
    assert e._snapshot.device_shard_labels is None and e._snapshot.labels is None
    assert "labels" not in e.hbm.shard_ledger()
    assert e.batch_check(qs) == want


def test_a_sharded_refresh_plans_against_the_hottest_shard(engines):
    rng = random.Random(5)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    e = engines(p, p.namespaces, mesh=cpu_mesh(4), labels_enabled=False)
    qs = queries(rng, objs, users, n=40)
    base = e.batch_check(qs)
    token = e._snapshot.snapshot_id
    # a budget every shard's slice of which is full: the next upload's
    # plan fails on every shard and the refresh is refused
    e.hbm.set_budget_bytes(4 * max(e.hbm.shard_resident_bytes()))
    p.write_relation_tuples(T("g", "mid0", "m", SubjectSet("g", "mid1", "m")))
    got, got_token = e.batch_check_with_token(qs, mode="serving")
    assert (got, got_token) == (base, token)
    assert e.health()["memory_pressure"] and e.hbm.snapshot()["refusals"] >= 1
    e.hbm.set_budget_bytes(1 << 30)
    e._refresh_task.kick()
    assert e.maintenance_settled(timeout=60).snapshot_id == p.watermark()
    assert e.batch_check(qs) == [CheckEngine(p).subject_is_allowed(q) for q in qs]


def test_sharded_warm_compile_registers_and_the_warm_ladder_is_mesh_wide(engines):
    """A sharded engine warms each width on K10a (one empty slice a width);
    the warm workspace spreads over the shards, and a plan only the hottest
    shard's slice refuses walks the ladder once for the whole mesh."""
    rng = random.Random(13)
    rows, objs, users = nested_rows(rng)
    p = store_of(rows)
    e = engines(p, p.namespaces, mesh=cpu_mesh(4), labels_enabled=False)
    qs = queries(rng, objs, users, n=50)
    want = [CheckEngine(p).subject_is_allowed(q) for q in qs]
    assert e.batch_check(qs) == want
    assert e.warm_compile() == len(e.stream_widths(e._snapshot))
    gov = e.hbm
    warm = gov.ledger()["warmup"]
    res = gov.shard_resident_bytes()
    assert warm > 0 and gov.shard_ledger()["snapshot"] == list(e._snapshot.shard_spec.owned_bucket_bytes)
    hot = max(range(4), key=lambda s: res[s])
    after = res[hot] - warm // 4
    x = max(16, -(-(gov.resident_bytes() - 4 * after) // 3) + 1, max(res) - after + 1)
    gov.set_budget_bytes(4 * (after + x))
    per = [0] * 4
    per[hot] = x
    assert gov.fits(x) and res[hot] + x > gov.budget_bytes // 4
    assert gov.plan(x, per_shard=per)
    snap = gov.snapshot()
    assert snap["evicted"] == ["staging", "labels", "reverse", "warm-ladder"]
    assert all(snap["evictions_by_rung"][r] == 1 for r in snap["evicted"])
    assert len(e._word_widths()) < 7 and e.warmup == 0
    assert e.batch_check(qs) == want
