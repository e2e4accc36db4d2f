"""Snapshot, pack and carry of the PyTorch port against the JAX package.

The port's ``build_snapshot`` must produce every array it keeps byte for
byte as ``keto_tpu.graph.snapshot.build_snapshot`` does on the same tuples;
``pack_chunk``/``pack_entries`` must equal the JAX package's numpy path
(``native=False``); and ``carry.device_graph_from_arrays`` fed from a JAX
snapshot must give the same check output as the port's own build.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.check.kernels import check_step
from keto_tpu_torch.check.pack import pack_chunk, pack_entries
from keto_tpu_torch.graph.carry import device_graph_from_arrays, snapshot_arrays
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

NAMESPACES = [("ns0", 0), ("ns1", 1), ("ns2", 7), ("", 3)]


def fuzz_case(seed: int):
    """The graphs and queries of tests/test_tpu_check.py test_fuzz_differential."""
    rng = random.Random(seed)
    ns_names = [n for n, _ in NAMESPACES]
    objects = [f"o{i}" for i in range(6)]
    relations = ["r0", "r1", ""]
    users = [f"u{i}" for i in range(5)]

    def rand_set():
        return SubjectSet(rng.choice(ns_names), rng.choice(objects), rng.choice(relations))

    tuples = []
    for _ in range(rng.randrange(5, 60)):
        sub = SubjectID(rng.choice(users)) if rng.random() < 0.4 else rand_set()
        tuples.append(RelationTuple(rng.choice(ns_names), rng.choice(objects), rng.choice(relations), sub))
    queries = []
    for _ in range(64):
        sub = SubjectID(rng.choice(users + ["ghost"])) if rng.random() < 0.5 else rand_set()
        ns = rng.choice(ns_names + ["nope"])
        queries.append(RelationTuple(ns, rng.choice(objects), rng.choice(relations), sub))
    return tuples, queries


def port_store(namespaces, tuples):
    nm = tns.MemoryManager([tns.Namespace(id=i, name=n) for n, i in namespaces])
    p = MemoryPersister(nm)
    if tuples:
        p.write_relation_tuples(*tuples)
    return p


def jax_store(namespaces, tuples):
    """The same tuples in the JAX package's store (its own model types)."""
    from keto_tpu import namespace as jns
    from keto_tpu.persistence.memory import MemoryPersister as JaxPersister
    from keto_tpu.relationtuple.model import RelationTuple as JT

    nm = jns.MemoryManager([jns.Namespace(id=i, name=n) for n, i in namespaces])
    p = JaxPersister(nm)
    if tuples:
        p.write_relation_tuples(*(JT.from_string(str(t)) for t in tuples))
    return p


def wild_ids(namespaces):
    return frozenset(i for n, i in namespaces if n == "")


def assert_snapshots_equal(mine, ref):
    for k in ("snapshot_id", "num_sets", "num_leaves", "num_active", "num_int",
              "num_live", "n_peeled", "sink_base", "wild_ns_ids"):
        assert getattr(mine, k) == getattr(ref, k), k
    for k in ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices"):
        a, b = getattr(mine, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert len(mine.buckets) == len(ref.buckets)
    for bm, br in zip(mine.buckets, ref.buckets):
        assert (bm.offset, bm.n) == (br.offset, br.n)
        assert bm.nbrs.dtype == br.nbrs.dtype and bm.nbrs.shape == br.nbrs.shape
        assert bm.nbrs.tobytes() == br.nbrs.tobytes()
    gi, ri = mine.interned, ref.interned
    # the port interns natively (no Python dicts): the same key ↔ id maps,
    # both ways, over exactly as many keys
    assert (gi.num_sets, gi.num_leaves) == (len(ri.set_ids), len(ri.leaf_ids))
    for key, i in ri.set_ids.items():
        assert gi.resolve_set(*key) == i and gi.set_key_of(i) == key
    for sid, i in ri.leaf_ids.items():
        assert gi.resolve_leaf(sid) == i and gi.leaf_str(i) == sid
    for k in ("key_ns", "key_obj", "key_rel", "key_wild", "src", "dst"):
        assert getattr(gi, k).tobytes() == getattr(ri, k).tobytes(), k


@pytest.mark.parametrize("seed", range(12))
def test_build_snapshot_byte_equal(seed):
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    tuples, _ = fuzz_case(seed)
    rows, wm = port_store(NAMESPACES, tuples).snapshot_rows()
    jrows, jwm = jax_store(NAMESPACES, tuples).snapshot_rows()
    mine = build_snapshot(rows, wm, wild_ids(NAMESPACES))
    ref = jax_build(jrows, jwm, wild_ids(NAMESPACES))
    assert_snapshots_equal(mine, ref)


@pytest.mark.parametrize("peel_seed_cap", [0.0, 4.0, 64.0])
def test_build_snapshot_byte_equal_rbac(peel_seed_cap):
    """A config-3 graph (with peeled rows at the default cap)."""
    from keto_tpu.graph.snapshot import build_snapshot as jax_build
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_workload

    nss = [(n.name, n.id) for n in RBAC_NAMESPACES]
    tuples, _ = rbac_workload(random.Random(3), 3000)
    rows, wm = port_store(nss, tuples).snapshot_rows()
    jrows, jwm = jax_store(nss, tuples).snapshot_rows()
    mine = build_snapshot(rows, wm, peel_seed_cap=peel_seed_cap)
    assert_snapshots_equal(mine, jax_build(jrows, jwm, peel_seed_cap=peel_seed_cap))


def _jax_engine(store):
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    return TpuCheckEngine(store, store.namespaces, labels_enabled=False,
                          native_pack_enabled=False, device_build_enabled=False)


@pytest.mark.parametrize("seed", range(12))
def test_resolve_and_pack_byte_equal(seed):
    from keto_tpu.check import tpu_engine as te
    from keto_tpu.relationtuple.model import RelationTuple as JT

    tuples, queries = fuzz_case(seed)
    store = port_store(NAMESPACES, tuples)
    mine_eng = TorchCheckEngine(store, store.namespaces, device="cpu")
    jeng = _jax_engine(jax_store(NAMESPACES, tuples))
    snap, jsnap = mine_eng.snapshot(), jeng.snapshot()
    sd, tg, multi = mine_eng._resolve_bulk_py(snap, queries)
    jsd, jtg, jmulti = jeng._resolve_bulk_py(jsnap, [JT.from_string(str(q)) for q in queries])
    assert np.array_equal(sd, jsd) and np.array_equal(tg, jtg)
    assert multi.keys() == jmulti.keys()
    for i in multi:
        for a, b in zip(multi[i], jmulti[i]):
            assert np.array_equal(a, b)
    for force_W in (None, 8):
        packed, host = pack_chunk(snap, sd, tg, multi, 0, len(queries), force_W)
        jpacked, jhost = te.pack_chunk(jsnap, jsd, jtg, jmulti, 0, len(queries), force_W, native=False)
        assert np.array_equal(host, jhost)
        assert (packed is None) == (jpacked is None)
        if packed is None:
            continue
        for a, b in zip(packed, jpacked):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        buf, sizes = pack_entries(packed)
        jbuf, jsizes = te.pack_entries(jpacked)
        assert sizes == jsizes and buf.tobytes() == jbuf.tobytes()
        out = np.empty_like(buf)
        buf2, _ = pack_entries(packed, out=out)
        assert buf2 is out and out.tobytes() == buf.tobytes()


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_carry_from_jax_snapshot_matches_own_build(seed):
    tuples, queries = fuzz_case(seed)
    store = port_store(NAMESPACES, tuples)
    eng = TorchCheckEngine(store, store.namespaces, device="cpu")
    snap = eng.snapshot()
    jsnap = _jax_engine(jax_store(NAMESPACES, tuples)).snapshot()
    sd, tg, multi = eng._resolve_bulk_py(snap, queries)
    packed, _ = pack_chunk(snap, sd, tg, multi, 0, len(queries))
    assert packed is not None
    buf, sizes = pack_entries(packed)
    outs = []
    for g in (snap.device, device_graph_from_arrays(*snapshot_arrays(jsnap), "cpu")):
        outs.append(check_step(g.buckets, torch.from_numpy(buf), sizes=sizes,
                               n_active=g.num_active, n_int=g.num_int,
                               valid_rows=g.valid_rows, it_cap=4096))
    assert torch.equal(outs[0], outs[1])


def test_carry_rejects_a_gap_in_the_active_prefix():
    arrays = [np.zeros((2, 1), np.int32)]
    with pytest.raises(ValueError):
        device_graph_from_arrays(arrays, {"n": [2], "num_int": 3, "num_active": 3,
                                          "num_live": 3, "sink_base": 3}, "cpu")
