"""The snapshot cache and the engine's cold start from it, against the JAX
package on the CPU.

- the saves are interchangeable: the port's ``save_snapshot`` of a
  snapshot writes the same files, byte for byte (``meta.json`` included),
  as the JAX package's of the same tuples, with and without labels, whole
  or striped per shard (g = 2..4), after a fold too; the port's engine
  loads a cache the JAX engine wrote and the JAX engine loads the port's,
  each deciding as the oracle does, without a build;
- integrity (tests/test_crashsafe.py:64-217): every segment is in the
  manifest; a torn bucket, a torn label segment and a torn ``meta.json``
  are each quarantined as the JAX package's loader quarantines them, the
  next older cache serves, and an engine rebuilds identically;
- an error of the reload that is not the cache's — a sorter that raises
  while the list layouts are re-derived, a failed upload — raises from the
  reload and counts ``cache_load_failures``, with no rebuild; an
  unreadable cache is passed over;
- labels (tests/test_labels.py:413-460, tests/test_label_build.py:
  333-400): cached labels install without a build and serve, host- or
  device-built; ``labels_enabled=False`` drops them; a cache without
  labels starts the label build;
- catch-up and folds over a reloaded snapshot (tests/test_compaction.py:
  350-420): the delta path from an older cache, a fold over the cached
  interner and its label patch, with the read-only mapped arrays never
  written in place (no ``torch.from_numpy`` warning about them);
- sharded segments (tests/test_sharded_serving.py:221-263) at g = 2..4,
  the list orientations (tests/test_list_watch.py:282-291), the segment
  groups and the format-aware retention (tests/test_streaming_build.py:
  333-380).

The inputs are made from numpy seeds. The ``cuda`` twins reload on the
card and skip where there is none.
"""

from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check import gpu_engine
from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.graph import snapcache
from keto_tpu_torch.graph.device_build import GovernedSorter
from keto_tpu_torch.graph.labels import build_labels
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_overlay import jt
from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]
WILD_NS = [("g", 1), ("d", 2), ("", 3)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def manager(namespaces=NS):
    return tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in namespaces])


def nested_rows(seed: int, n_random: int = 80, wild: bool = False):
    """Group chains with a cycle (docs → leaf → mid → top → leaf0), users on
    every level and numpy-seeded noise, so the snapshot has active buckets,
    peeled rows, sinks and labels to cache."""
    rng = np.random.default_rng(seed)
    objs = [f"o{i}" for i in range(8)]
    users = [f"u{i}" for i in range(6)]
    rows = [T("d", o, "view", SubjectSet("g", f"leaf{i % 4}", "m")) for i, o in enumerate(objs)]
    rows += [T("g", f"leaf{i}", "m", SubjectSet("g", f"mid{i % 2}", "m")) for i in range(4)]
    rows += [T("g", f"mid{i}", "m", SubjectSet("g", "top", "m")) for i in range(2)]
    rows.append(T("g", "top", "m", SubjectSet("g", "leaf0", "m")))
    rows += [T("g", ("top", f"leaf{i % 4}", f"mid{i % 2}")[i % 3], "m", SubjectID(u))
             for i, u in enumerate(users)]
    names = ["g", "d"] + ([""] if wild else [])
    rels = ["m", "view"]
    for _ in range(n_random):
        if rng.random() < 0.4:
            sub = SubjectID(users[rng.integers(len(users))])
        else:
            sub = SubjectSet(names[rng.integers(len(names))], objs[rng.integers(len(objs))],
                             rels[rng.integers(len(rels))])
        rows.append(T(names[rng.integers(len(names))], objs[rng.integers(len(objs))],
                      rels[rng.integers(len(rels))], sub))
    return rows, objs, users


def queries(seed: int, objs, users, n: int = 80):
    """Label hits, BFS fallbacks, pattern queries and ghosts."""
    rng = np.random.default_rng(seed + 1000)
    out = []
    for _ in range(n):
        r = rng.random()
        u = (users + ["ghost"])[rng.integers(len(users) + 1)]
        if r < 0.5:
            out.append(T("d", objs[rng.integers(len(objs))], "view", SubjectID(u)))
        elif r < 0.75:
            out.append(T("g", ("leaf0", "top", "mid1")[rng.integers(3)], "m", SubjectID(u)))
        elif r < 0.9:
            out.append(T("g", "", "", SubjectID(u)))
        else:
            out.append(T("d", "", "view", SubjectSet("g", ("leaf1", "top")[rng.integers(2)], "m")))
    return out


def oracle_of(store, qs):
    oracle = CheckEngine(store)
    return [oracle.subject_is_allowed(q) for q in qs]


def dir_bytes(path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(Path(path).iterdir())}


def assert_same_files(mine, ref):
    """Two cache directories hold the same files with the same bytes."""
    assert Path(mine).name == Path(ref).name
    a, b = dir_bytes(mine), dir_bytes(ref)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name


def published(cache) -> list:
    return sorted(d for d in Path(cache).iterdir() if d.is_dir() and not d.name.startswith("."))


@pytest.fixture
def engines():
    made = []

    def make(store, **kw):
        e = TorchCheckEngine(store, store.namespaces, device=kw.pop("device", "cpu"), **kw)
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


@pytest.fixture
def ref_engines():
    made = []

    def make(store, **kw):
        from keto_tpu.check.tpu_engine import TpuCheckEngine

        e = TpuCheckEngine(store, store.namespaces, **kw)
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


def _snapshot_pair(namespaces, rows, labels: bool):
    from keto_tpu.graph.labels import build_labels as jax_labels
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    wild = frozenset(i for n, i in namespaces if n == "")
    mine = build_snapshot(*port_store(namespaces, rows).snapshot_rows(), wild)
    ref = jax_build(*jax_store(namespaces, rows).snapshot_rows(), wild)
    if labels:
        mine.labels = build_labels(mine, max_width=8, landmarks=mine.num_int)
        ref.labels = jax_labels(ref, max_width=8, landmarks=ref.num_int)
    return mine, ref


# -- the saves are interchangeable ----------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_save_equals_reference_file_by_file(tmp_path, seed, labels, shards):
    from keto_tpu.graph import snapcache as jax_snapcache

    namespaces = WILD_NS if seed == 2 else NS
    rows, _, _ = nested_rows(seed, wild=seed == 2)
    mine, ref = _snapshot_pair(namespaces, rows, labels)
    a = snapcache.save_snapshot(mine, str(tmp_path / "port"), shards=shards)
    b = jax_snapcache.save_snapshot(ref, str(tmp_path / "jax"), shards=shards)
    assert a is not None and b is not None
    assert_same_files(a, b)
    meta = json.loads((Path(a) / "meta.json").read_text())
    assert meta["shards"] == shards and (meta["labels"] is not None) == labels


def test_save_of_an_empty_store_equals_reference(tmp_path):
    from keto_tpu.graph import snapcache as jax_snapcache

    mine, ref = _snapshot_pair(NS, [], labels=False)
    assert_same_files(snapcache.save_snapshot(mine, str(tmp_path / "port")),
                      jax_snapcache.save_snapshot(ref, str(tmp_path / "jax")))


def test_an_overlay_is_not_cached(tmp_path, engines):
    rows, _, _ = nested_rows(3)
    p = port_store(NS, rows)
    eng = engines(p, compact_after_s=3600.0)
    eng.snapshot()
    p.write_relation_tuples(T("g", "leaf1", "m", SubjectSet("g", "mid0", "m")))
    assert eng.snapshot().has_overlay
    assert snapcache.save_snapshot(eng.snapshot(), str(tmp_path)) is None


@pytest.mark.parametrize("device_labels", [False, True])
def test_engine_saves_equal_reference_engine_saves(tmp_path, engines, ref_engines, device_labels):
    """The same tuples through both engines, labels built on each one's
    host path or its device path (the plain kernels here): the caches the
    engines write are the same files."""
    kw = {"labels_device_min_edges": 0} if device_labels else {}
    rows, _, _ = nested_rows(4)
    a = engines(port_store(NS, rows), snapshot_cache_dir=str(tmp_path / "port"), **kw)
    b = ref_engines(jax_store(NS, rows), snapshot_cache_dir=str(tmp_path / "jax"), **kw)
    assert a.labels_settled() and b.labels_settled()
    pa, pb = a.save_snapshot_cache(), b.save_snapshot_cache()
    assert pa is not None and pb is not None
    assert_same_files(pa, pb)
    backend = json.loads((Path(pa) / "meta.json").read_text())["labels"]["backend"]
    assert backend == ("device" if device_labels else "host")


def test_folded_snapshot_saves_equal_reference(tmp_path, engines, ref_engines):
    """A fold over an ExtendedInterned (new nodes past the base tables) is
    cached as the JAX engine caches its fold."""
    rows, _, _ = nested_rows(5)
    kw = dict(compact_after_s=3600.0, overlay_edge_budget=1 << 20)
    ps, js = port_store(NS, rows), jax_store(NS, rows)
    a = engines(ps, snapshot_cache_dir=str(tmp_path / "port"), **kw)
    b = ref_engines(js, snapshot_cache_dir=str(tmp_path / "jax"), **kw)
    a.labels_settled()
    b.labels_settled()
    # a new static set node and a new leaf: overlay nodes the fold appends
    new = [T("d", "newdoc", "view", SubjectSet("g", "leaf2", "m")),
           T("g", "leaf3", "m", SubjectID("newbie"))]
    ps.write_relation_tuples(*new)
    js.write_relation_tuples(*[jt(t) for t in new])
    for eng in (a, b):
        eng._refresh_force_full = True
        for _ in range(10):
            eng._refresh_pass()
            if not eng._snapshot.has_overlay:
                break
    a.labels_settled()
    b.labels_settled()
    assert not a.snapshot().has_overlay and not b.snapshot().has_overlay
    assert type(a.snapshot().interned).__name__ == "ExtendedInterned"
    assert_same_files(a.save_snapshot_cache(), b.save_snapshot_cache())


@pytest.mark.parametrize("seed", [0, 2])
def test_port_loads_a_reference_cache(tmp_path, engines, ref_engines, seed):
    namespaces = WILD_NS if seed == 2 else NS
    rows, objs, users = nested_rows(seed, wild=seed == 2)
    cache = str(tmp_path / "cache")
    b = ref_engines(jax_store(namespaces, rows), snapshot_cache_dir=cache)
    assert b.labels_settled() and b.save_snapshot_cache() is not None
    p = port_store(namespaces, rows)
    a = engines(p, snapshot_cache_dir=cache)
    qs = queries(seed, objs, users)
    assert a.batch_check(qs) == oracle_of(p, qs) == b.batch_check([jt(q) for q in qs])
    c = a.counters()
    assert (c.get("cache_loads"), c.get("full_rebuilds", 0), c.get("label_builds", 0)) == (1, 0, 0)
    assert c.get("label_checks", 0) > 0 and c.get("resolve_python_batches", 0) >= 1
    assert a.last_cache_load["labels"] and a.last_cache_load["bytes"] > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_loads_a_port_cache(tmp_path, engines, ref_engines, seed):
    namespaces = WILD_NS if seed == 2 else NS
    rows, objs, users = nested_rows(seed, wild=seed == 2)
    cache = str(tmp_path / "cache")
    p = port_store(namespaces, rows)
    a = engines(p, snapshot_cache_dir=cache)
    assert a.labels_settled() and a.save_snapshot_cache() is not None
    b = ref_engines(jax_store(namespaces, rows), snapshot_cache_dir=cache)
    qs = queries(seed, objs, users)
    assert b.batch_check([jt(q) for q in qs]) == oracle_of(p, qs)
    m = b.maintenance.snapshot()
    assert (m.get("cache_loads"), m.get("full_rebuilds", 0), m.get("label_builds", 0)) == (1, 0, 0)


# -- integrity -------------------------------------------------------------------


def _saved(tmp_path, rows=None):
    rows = rows if rows is not None else nested_rows(6)[0]
    p = port_store(NS, rows)
    snap = build_snapshot(*p.snapshot_rows())
    snap.labels = build_labels(snap, max_width=8, landmarks=snap.num_int)
    cache = tmp_path / "snapcache"
    path = snapcache.save_snapshot(snap, str(cache))
    assert path is not None
    return cache, Path(path), p


def test_cache_save_records_segment_manifest_and_groups(tmp_path):
    _, path, _ = _saved(tmp_path)
    meta = json.loads((path / "meta.json").read_text())
    files = {f.name for f in path.iterdir()} - {"meta.json"}
    assert set(meta["segments"]) == files, "every data file must be checksummed"
    assert all(set(e) == {"size", "crc32"} for e in meta["segments"].values())
    groups = meta["groups"]
    assert {"core", "interner", "reverse", "labels"} <= set(groups)
    assert sorted(s for names in groups.values() for s in names) == sorted(meta["segments"])


def test_round_trip_verifies_and_equals_the_build(tmp_path):
    _, path, p = _saved(tmp_path)
    snap = build_snapshot(*p.snapshot_rows())
    loaded = snapcache.load_snapshot(str(path), sorter=GovernedSorter("cpu"))
    assert loaded.snapshot_id == p.watermark()
    for k in ("num_sets", "num_leaves", "num_active", "num_int", "num_live", "n_peeled"):
        assert getattr(loaded, k) == getattr(snap, k), k
    for k in ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices",
              "rev_indptr", "rev_indices"):
        assert np.array_equal(np.asarray(getattr(loaded, k)), getattr(snap, k)), k
    for a, b in zip(loaded.buckets, snap.buckets):
        assert (a.offset, a.n) == (b.offset, b.n) and np.array_equal(np.asarray(a.nbrs), b.nbrs)
    for a, b in ((loaded.lay_fwd, snap.lay_fwd), (loaded.lay_rev, snap.lay_rev)):
        assert (a.n_rows, a.n_active) == (b.n_rows, b.n_active)
        assert np.array_equal(a.order, b.order) and np.array_equal(a.dev2row, b.dev2row)
        for x, y in zip(a.buckets, b.buckets):
            assert np.array_equal(x.nbrs, y.nbrs)
    gi = loaded.interned
    for raw in range(snap.num_sets):
        key = snap.interned.set_key_of(raw)
        assert gi.set_key_of(raw) == key and gi.resolve_set(*key) == raw
    for i in range(snap.num_leaves):
        s = snap.interned.leaf_str(i)
        assert gi.leaf_str(i) == s and gi.resolve_leaf(s) == i
    assert gi.resolve_leaf("ghost") == -1 and gi.resolve_set(1, "nope", "m") == -1


class _Stats:
    def __init__(self):
        self.counts: dict = {}

    def incr(self, key, by=1):
        self.counts[key] = self.counts.get(key, 0) + by


def _corrupt(path: Path, victim: str) -> None:
    if victim == "torn-meta":
        meta = (path / "meta.json").read_bytes()
        (path / "meta.json").write_bytes(meta[: len(meta) // 2])
        return
    name = {"bucket-flip": "bucket_0.npy", "bucket-truncate": "bucket_0.npy",
            "label-flip": "lab_out.npy", "csr-flip": "fwd_indices.npy"}[victim]
    seg = path / name
    data = bytearray(seg.read_bytes())
    if victim.endswith("truncate"):
        data = data[:-3]
    else:
        data[len(data) // 2] ^= 0xFF
    seg.write_bytes(bytes(data))


VICTIMS = ["bucket-flip", "bucket-truncate", "label-flip", "csr-flip", "torn-meta"]


@pytest.mark.parametrize("victim", VICTIMS)
def test_torn_cache_is_quarantined_as_the_reference_does(tmp_path, victim):
    from keto_tpu.graph import snapcache as jax_snapcache

    cache, path, _ = _saved(tmp_path)
    twin = tmp_path / "twin"
    shutil.copytree(cache, twin)
    for c, loader in ((cache, snapcache), (twin, jax_snapcache)):
        target = c / path.name
        _corrupt(target, victim)
        stats = _Stats()
        assert loader.load_latest(str(c), stats=stats) is None
        assert stats.counts == {"cache_quarantined": 1}
        assert not target.exists(), "corrupt cache left in the serving set"
        assert len([d for d in c.iterdir() if d.name.startswith(".quarantine-")]) == 1
        # a second scan neither re-quarantines nor resurrects it
        assert loader.load_latest(str(c), stats=stats) is None
        assert stats.counts == {"cache_quarantined": 1}


@pytest.mark.parametrize("victim", VICTIMS)
def test_torn_newest_cache_falls_back_to_the_older_one(tmp_path, victim):
    cache, older, p = _saved(tmp_path)
    p.write_relation_tuples(T("g", "leaf1", "m", SubjectID("bob")))
    snap = build_snapshot(*p.snapshot_rows())
    snap.labels = build_labels(snap, max_width=8, landmarks=snap.num_int)
    newest = Path(snapcache.save_snapshot(snap, str(cache)))
    _corrupt(newest, victim)
    stats = _Stats()
    got = snapcache.load_latest(str(cache), stats=stats)
    assert got is not None and got.snapshot_id == int(older.name.split("-w")[1])
    assert stats.counts == {"cache_quarantined": 1}


@pytest.mark.parametrize("victim", VICTIMS)
def test_engine_rebuilds_identically_after_corruption(tmp_path, engines, victim):
    rows, objs, users = nested_rows(7)
    p = port_store(NS, rows)
    cache = tmp_path / "cache"
    a = engines(p, snapshot_cache_dir=str(cache))
    a.labels_settled()
    assert a.save_snapshot_cache() is not None
    assert a.cache_settled(30)
    for d in published(cache):
        _corrupt(d, victim)
    b = engines(p, snapshot_cache_dir=str(cache))
    qs = queries(7, objs, users)
    assert b.batch_check(qs) == engines(p).batch_check(qs) == oracle_of(p, qs)
    c = b.counters()
    assert c.get("cache_quarantined", 0) >= 1 and c.get("cache_loads", 0) == 0
    assert c.get("full_rebuilds") == 1


def test_cache_ahead_of_the_store_never_serves(tmp_path, engines):
    rows, _, _ = nested_rows(8)
    cache = str(tmp_path / "cache")
    a = engines(port_store(NS, rows), snapshot_cache_dir=cache)
    a.snapshot()
    assert a.save_snapshot_cache() is not None
    fresh = port_store(NS, [])
    b = engines(fresh, snapshot_cache_dir=cache)
    assert b.snapshot().n_nodes == 0 and b.counters().get("cache_loads", 0) == 0
    assert not b.subject_is_allowed(T("g", "top", "m", SubjectID("u0")))


def test_cache_of_other_wildcard_namespaces_is_not_used(tmp_path, engines):
    rows, objs, users = nested_rows(9)
    cache = str(tmp_path / "cache")
    a = engines(port_store(NS, rows), snapshot_cache_dir=cache)
    a.snapshot()
    assert a.save_snapshot_cache() is not None
    p = port_store(WILD_NS, rows)
    b = engines(p, snapshot_cache_dir=cache)
    qs = queries(9, objs, users)
    assert b.batch_check(qs) == oracle_of(p, qs)
    c = b.counters()
    assert c.get("cache_loads", 0) == 0 and c.get("full_rebuilds") == 1


# -- errors that are not the cache's raise ---------------------------------------------


class _RaisingSorter:
    """A build sorter whose device sort fails, as a failed K8 launch does."""

    def __init__(self):
        self.calls = 0

    def argsort(self, keys):
        return self.argsort_many([keys])[0]

    def argsort_many(self, arrays):
        self.calls += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def take_seconds(self):
        return {"device": 0.0, "host": 0.0}


@pytest.mark.parametrize("where", ["sort", "upload", "labels"])
def test_a_failed_reload_raises_and_is_counted_with_no_rebuild(tmp_path, engines, monkeypatch, where):
    rows, objs, users = nested_rows(10)
    p = port_store(NS, rows)
    cache = tmp_path / "cache"
    a = engines(p, snapshot_cache_dir=str(cache))
    a.labels_settled()
    saved = a.save_snapshot_cache()
    assert saved is not None and a.cache_settled(30)
    b = engines(p, snapshot_cache_dir=str(cache))
    boom = RuntimeError("CUDA error: an illegal memory access was encountered")
    if where == "sort":
        b._build_sorter = _RaisingSorter()
    elif where == "upload":
        monkeypatch.setattr(b, "_upload_buckets", lambda snap: (_ for _ in ()).throw(boom))
    else:
        monkeypatch.setattr(b, "_upload_labels", lambda snap: (_ for _ in ()).throw(boom))

    def no_build(*a, **kw):
        raise AssertionError("a failed reload fell back to a full rebuild")

    monkeypatch.setattr(gpu_engine, "full_build", no_build)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        b.snapshot()
    c = b.counters()
    assert c.get("cache_load_failures") == 1
    assert c.get("cache_loads", 0) == 0 and c.get("full_rebuilds", 0) == 0
    assert c.get("cache_quarantined", 0) == 0 and Path(saved).is_dir(), "a sound cache was dropped"
    # the next refresh tries the reload again, and raises again
    with pytest.raises(RuntimeError):
        b.batch_check(queries(10, objs, users)[:4])
    assert b.counters().get("cache_load_failures") == 2


def test_an_unreadable_cache_is_passed_over(tmp_path, monkeypatch):
    cache, older, p = _saved(tmp_path)
    p.write_relation_tuples(T("g", "leaf1", "m", SubjectID("bob")))
    newest = snapcache.save_snapshot(build_snapshot(*p.snapshot_rows()), str(cache))
    real = snapcache.load_snapshot

    def load(path, **kw):
        if path == newest:
            raise PermissionError(13, "Permission denied", path)
        return real(path, **kw)

    monkeypatch.setattr(snapcache, "load_snapshot", load)
    stats = _Stats()
    got = snapcache.load_latest(str(cache), stats=stats)
    assert got is not None and str(older).endswith(f"-w{got.snapshot_id}")
    assert stats.counts == {} and Path(newest).is_dir()


def test_an_unreadable_cache_directory_retries(tmp_path, engines, monkeypatch):
    rows, objs, users = nested_rows(11)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    a = engines(p, snapshot_cache_dir=cache)
    a.labels_settled()
    assert a.save_snapshot_cache() is not None
    real, calls = snapcache.load_latest, []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError(5, "Input/output error")
        return real(*args, **kw)

    monkeypatch.setattr(snapcache, "load_latest", flaky)
    b = engines(p, snapshot_cache_dir=cache)
    qs = queries(11, objs, users)
    assert b.batch_check(qs) == oracle_of(p, qs)
    c = b.counters()
    assert (c.get("cache_reload_retries"), c.get("cache_loads"), c.get("full_rebuilds", 0)) == (1, 1, 0)


# -- labels ----------------------------------------------------------------------------


def _label_counts(c: dict) -> tuple:
    return tuple(c.get(k, 0) for k in ("cache_loads", "full_rebuilds", "label_builds"))


@pytest.mark.parametrize("device_labels", [False, True])
def test_cached_labels_install_without_a_build(tmp_path, engines, ref_engines, device_labels):
    kw = {"labels_device_min_edges": 0} if device_labels else {}
    rows, objs, users = nested_rows(12)
    p, j = port_store(NS, rows), jax_store(NS, rows)
    mine, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    a = engines(p, snapshot_cache_dir=mine, **kw)
    r = ref_engines(j, snapshot_cache_dir=ref, **kw)
    assert a.labels_settled() and r.labels_settled()
    assert a.save_snapshot_cache() and r.save_snapshot_cache()
    b = engines(p, snapshot_cache_dir=mine, **kw)
    rb = ref_engines(j, snapshot_cache_dir=ref, **kw)
    snap = b.snapshot()
    assert snap.labels is not None and snap.labels.backend == ("device" if device_labels else "host")
    assert b.labels_settled()
    qs = queries(12, objs, users)
    assert b.batch_check(qs) == a.batch_check(qs) == rb.batch_check([jt(q) for q in qs])
    assert _label_counts(b.counters()) == _label_counts(rb.maintenance.snapshot()) == (1, 0, 0)
    assert b.counters().get("label_checks", 0) > 0
    assert b.counters().get("label_device_builds", 0) == 0


def test_labels_disabled_drops_cached_labels(tmp_path, engines):
    rows, objs, users = nested_rows(13)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    a = engines(p, snapshot_cache_dir=cache)
    a.labels_settled()
    assert a.save_snapshot_cache()
    b = engines(p, snapshot_cache_dir=cache, labels_enabled=False)
    qs = queries(13, objs, users)
    assert b.batch_check(qs) == oracle_of(p, qs)
    assert b.snapshot().labels is None and b.snapshot().device_labels is None
    c = b.counters()
    assert c.get("cache_loads") == 1 and c.get("label_checks", 0) == 0


def test_a_cache_without_labels_starts_the_label_build(tmp_path, engines, ref_engines):
    rows, objs, users = nested_rows(14)
    p, j = port_store(NS, rows), jax_store(NS, rows)
    cache = str(tmp_path / "cache")
    a = engines(p, snapshot_cache_dir=cache, labels_enabled=False)
    a.snapshot()
    path = a.save_snapshot_cache()
    assert json.loads((Path(path) / "meta.json").read_text())["labels"] is None
    assert a.cache_settled(30)
    ref_cache = str(tmp_path / "ref")
    shutil.copytree(cache, ref_cache)
    b = engines(p, snapshot_cache_dir=cache)
    rb = ref_engines(j, snapshot_cache_dir=ref_cache)
    assert b.labels_settled() and rb.labels_settled()
    qs = queries(14, objs, users)
    assert b.batch_check(qs) == rb.batch_check([jt(q) for q in qs]) == oracle_of(p, qs)
    assert _label_counts(b.counters()) == _label_counts(rb.maintenance.snapshot()) == (1, 0, 1)
    assert b.counters().get("label_checks", 0) > 0


# -- catch-up, folds and the read-only mapped arrays --------------------------------------


def test_reload_catches_up_folds_and_never_writes_mapped_arrays(tmp_path, engines, monkeypatch):
    """An older cache reloads, the delta path catches up, deletes patch the
    reloaded buckets (K9's plain version on copies), a fold patches the
    reloaded labels on the sweeper (``labels_device_min_edges=0``), a
    pattern query reads the cached interner; every step decides as a fresh
    build does, no full rebuild runs, and nothing warns about a
    non-writable array."""
    rows, objs, users = nested_rows(15)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    kw = dict(compact_after_s=3600.0, overlay_edge_budget=1 << 20, labels_device_min_edges=0)
    a = engines(p, snapshot_cache_dir=cache, **kw)
    a.labels_settled()
    assert a.save_snapshot_cache() is not None and a.cache_settled(30)
    # the store moves on past the cache
    p.write_relation_tuples(T("g", "leaf2", "m", SubjectID("late")),
                            T("g", "leaf1", "m", SubjectSet("g", "leaf3", "m")))
    qs = queries(15, objs, users + ["late"]) + [T("g", "", "", SubjectID("late"))]

    def no_build(*args, **kwargs):
        raise AssertionError("the reload rebuilt despite a valid cache")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        monkeypatch.setattr(gpu_engine, "full_build", no_build)
        b = engines(p, snapshot_cache_dir=cache, **kw)
        got = b.batch_check(qs)
        assert b.counters().get("cache_loads") == 1 and b.counters().get("delta_applies") == 1
        assert b.snapshot().has_overlay
        assert isinstance(b.snapshot().buckets[0].nbrs, np.memmap) or b.snapshot().buckets[0].nbrs.base is not None
        # a delete of an iterated base edge: bucket slots patched
        p.delete_relation_tuples(T("g", "leaf0", "m", SubjectSet("g", "mid0", "m")))
        got_del = b.batch_check(qs)
        # the fold over the cached interner, its labels patched
        b._refresh_force_full = True
        for _ in range(10):
            b._refresh_pass()
            if not b._snapshot.has_overlay:
                break
        assert not b.snapshot().has_overlay and b.labels_settled()
        got_fold = b.batch_check(qs)
        monkeypatch.undo()
    assert not [w for w in caught if "not writable" in str(w.message)], \
        [str(w.message) for w in caught]
    fresh = engines(p, **kw)
    assert got_del == got_fold == fresh.batch_check(qs) == oracle_of(p, qs)
    assert got != got_del  # the delete took a grant away
    c = b.counters()
    assert c.get("full_rebuilds", 0) == 0 and c.get("compactions", 0) + c.get("fold_runs", 0) >= 1
    # the folded snapshot is cached again and reloads
    assert b.cache_settled(30) and b.save_snapshot_cache() is not None
    again = engines(p, snapshot_cache_dir=cache, **kw)
    assert again.batch_check(qs) == got_fold and again.counters().get("cache_loads") == 1


def test_expand_and_listings_over_a_reloaded_snapshot(tmp_path, engines):
    from keto_tpu_torch.expand.snapshot_engine import SnapshotExpandEngine

    rows, objs, users = nested_rows(16)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    a = engines(p, snapshot_cache_dir=cache)
    a.labels_settled()
    assert a.save_snapshot_cache()
    b = engines(p, snapshot_cache_dir=cache)
    b.snapshot()
    assert b.counters().get("cache_loads") == 1
    nm = manager()
    for obj, rel in (("o1", "view"), ("top", "m"), ("leaf0", "m")):
        ns = "d" if rel == "view" else "g"
        want = SnapshotExpandEngine(a, nm).build_tree(SubjectSet(ns, obj, rel), 4)
        got = SnapshotExpandEngine(b, nm).build_tree(SubjectSet(ns, obj, rel), 4)
        assert (got.to_json() if got else None) == (want.to_json() if want else None)
    la = SnapshotListEngine(a, nm, device="cpu")
    lb = SnapshotListEngine(b, nm, device="cpu")
    for u in users:
        assert lb.list_objects("d", "view", SubjectID(u))[0] == la.list_objects("d", "view", SubjectID(u))[0]
    for o in objs:
        assert lb.list_subjects("d", o, "view")[0] == la.list_subjects("d", o, "view")[0]


def test_reload_preserves_the_list_orientations(tmp_path):
    cache, path, p = _saved(tmp_path)
    snap = build_snapshot(*p.snapshot_rows())
    loaded = snapcache.load_latest(str(cache))
    assert np.array_equal(np.asarray(loaded.rev_indptr), snap.rev_indptr)
    assert np.array_equal(np.asarray(loaded.rev_indices), snap.rev_indices)
    for a, b in ((loaded.lay_fwd, snap.lay_fwd), (loaded.lay_rev, snap.lay_rev)):
        assert (a.n_rows, a.n_active, len(a.buckets)) == (b.n_rows, b.n_active, len(b.buckets))


# -- sharded segments --------------------------------------------------------------------


@pytest.mark.parametrize("g", [2, 3, 4])
def test_sharded_save_stripes_per_shard_and_both_modes_reload(tmp_path, engines, g):
    rows, objs, users = nested_rows(20 + g)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    eng = engines(p, mesh=make_mesh(graph=g, device="cpu"), snapshot_cache_dir=cache)
    snap = eng.snapshot()
    eng.labels_settled()
    path = eng.save_snapshot_cache()
    names = [f.name for f in Path(path).iterdir()]
    assert len([n for n in names if n.startswith("bucket_") and "_s" in n]) == g * len(snap.buckets)
    meta = json.loads((Path(path) / "meta.json").read_text())
    assert meta["shards"] == g
    assert sorted(k for k in meta["groups"] if k.startswith("shard")) == [f"shard{s}" for s in range(g)]
    re_snap = snapcache.load_snapshot(path)
    for a, b in zip(re_snap.buckets, snap.buckets):
        assert np.array_equal(np.asarray(a.nbrs), np.asarray(b.nbrs))
    qs = queries(20 + g, objs, users)
    want = oracle_of(p, qs)
    cold = engines(p, mesh=make_mesh(graph=g, device="cpu"), snapshot_cache_dir=cache)
    assert cold.batch_check(qs) == want and cold.counters().get("cache_loads") == 1
    single = engines(p, snapshot_cache_dir=cache)
    assert single.batch_check(qs) == want and single.counters().get("cache_loads") == 1
    assert cold.counters().get("full_rebuilds", 0) == single.counters().get("full_rebuilds", 0) == 0


# -- layout and retention ------------------------------------------------------------------


def test_retention_is_format_version_aware_as_the_reference(tmp_path):
    from keto_tpu.graph import snapcache as jax_snapcache
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    names = {}
    for tag in ("port", "jax"):
        cache = tmp_path / tag
        for name in ("v4-w3", "v4-w9", "v4-w11", "v3-w2"):
            (cache / name).mkdir(parents=True)
            (cache / name / "meta.json").write_text("{}")
        (cache / "not-a-cache").mkdir()
        p, j = port_store(NS, []), jax_store(NS, [])
        for i in range(snapcache.KEEP + 2):
            t = T("g", "team", "m", SubjectID(f"u{i}"))
            p.write_relation_tuples(t)
            j.write_relation_tuples(jt(t))
            if tag == "port":
                assert snapcache.save_snapshot(build_snapshot(*p.snapshot_rows()), str(cache))
            else:
                assert jax_snapcache.save_snapshot(jax_build(*j.snapshot_rows()), str(cache))
        names[tag] = sorted(d.name for d in cache.iterdir())
    assert names["port"] == names["jax"]
    cur = [n for n in names["port"] if n.startswith(f"v{snapcache.FORMAT_VERSION}-")]
    assert len(cur) == snapcache.KEEP
    assert {"v4-w11", "v4-w9", "v3-w2"} <= set(names["port"]) and "not-a-cache" not in names["port"]


def test_export_manifest_names_the_newest_segments(tmp_path):
    from keto_tpu.graph import snapcache as jax_snapcache

    cache, path, _ = _saved(tmp_path)
    got = snapcache.export_manifest(str(cache))
    assert got == jax_snapcache.export_manifest(str(cache))
    assert got["tag"] == path.name and got["format_version"] == snapcache.FORMAT_VERSION
    assert {s["name"] for s in got["segments"]} == {f.name for f in path.iterdir()}
    assert snapcache.export_manifest(str(cache), max_watermark=0) is None


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reload_on_the_card(tmp_path, cuda_device, engines):
    """A cache written on the CPU reloads on the card (the list layouts
    re-derived through the engine's sorter, the buckets and labels
    uploaded) and decides as the oracle does, without a build."""
    rows, objs, users = nested_rows(30)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    a = engines(p, snapshot_cache_dir=cache)
    a.labels_settled()
    assert a.save_snapshot_cache()
    b = engines(p, snapshot_cache_dir=cache, device="cuda")
    qs = queries(30, objs, users)
    assert b.batch_check(qs) == oracle_of(p, qs)
    assert _label_counts(b.counters()) == (1, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 4])
def test_sharded_reload_on_the_card(tmp_path, cuda_device, engines, g):
    rows, objs, users = nested_rows(31 + g)
    p = port_store(NS, rows)
    cache = str(tmp_path / "cache")
    a = engines(p, mesh=make_mesh(graph=g, device="cpu"), snapshot_cache_dir=cache)
    a.labels_settled()
    assert a.save_snapshot_cache()
    b = engines(p, mesh=make_mesh(graph=g, device="cuda"), snapshot_cache_dir=cache,
                device="cuda")
    qs = queries(31 + g, objs, users)
    assert b.batch_check(qs) == oracle_of(p, qs)
    assert _label_counts(b.counters()) == (1, 0, 0)
