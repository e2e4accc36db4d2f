"""Overlay compaction and the incremental label patch against the JAX package.

- ``compact_snapshot`` (keto_tpu_torch/graph/compaction.py) equals the JAX
  package's on every array it keeps — the buckets, the forward CSR, the
  sink reverse CSR, ``raw2dev``, the counts of every node class and the
  extended interner's key arrays — and on ``touched_buckets``, over fuzz
  rounds of inserts and tombstoned deletes, stacked on already-compacted
  (``ExtendedInterned``) snapshots; it refuses (``None``) where JAX does;
- the label outcome of a fold and the index it carries equal JAX's, with
  the host patch and with the device patch (``device_patch_labels`` on the
  CPU, the plain K6/K7/K9);
- ``patch_labels`` and ``device_patch_labels`` are byte-equal to JAX's
  (``assert_index_equal``), including the abort outcome of a tiny visit
  budget and of truncated endpoint labels.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import pytest

from keto_tpu_torch.graph import label_build
from keto_tpu_torch.graph.compaction import compact_snapshot
from keto_tpu_torch.graph.labels import build_labels, patch_labels
from keto_tpu_torch.graph.overlay import apply_delta
from keto_tpu_torch.relationtuple.model import RelationQuery, SubjectID, SubjectSet

from test_torch_labels import assert_index_equal
from test_torch_overlay import NS, Pair, T, _safe_inserts

COUNTS = ("snapshot_id", "num_sets", "num_leaves", "num_active", "num_int", "num_live",
          "n_peeled", "sink_base", "n_edges")
ARRAYS = ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices")


def assert_compacted_equal(mine, ref):
    assert (mine is None) == (ref is None)
    if mine is None:
        return
    assert mine.touched_buckets == ref.touched_buckets
    assert mine.touched_bytes == ref.touched_bytes
    a, b = mine.snapshot, ref.snapshot
    assert not a.has_overlay and not b.has_overlay
    for k in COUNTS:
        assert getattr(a, k) == getattr(b, k), k
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    assert len(a.buckets) == len(b.buckets)
    for bm, br in zip(a.buckets, b.buckets):
        assert (bm.offset, bm.n) == (br.offset, br.n)
        assert bm.nbrs.shape == br.nbrs.shape and bm.nbrs.tobytes() == br.nbrs.tobytes()
    for k in ("key_ns", "key_obj", "key_rel", "key_wild"):
        assert np.array_equal(getattr(a.interned, k), getattr(b.interned, k)), k
    assert a.interned.num_obj_codes() == b.interned.num_obj_codes()
    for dev in range(a.n_nodes):
        assert a.key_of_dev(dev) == b.key_of_dev(dev)


def chain_rows(rng, depth=8, users=4):
    """A cycle of active interior rows with users hanging off it, a static
    doc on top, and some random extra edges."""
    rows = [T("d", "doc", "view", SubjectSet("g", "c0", "m"))]
    for i in range(depth):
        rows.append(T("g", f"c{i}", "m", SubjectSet("g", f"c{(i + 1) % depth}", "m")))
    for i in range(depth):
        for u in rng.sample(range(users), 2):
            rows.append(T("g", f"c{i}", "m", SubjectID(f"u{u}")))
    for _ in range(depth // 2):
        a, b = rng.sample(range(depth), 2)
        rows.append(T("g", f"c{a}", "m", SubjectSet("g", f"c{b}", "m")))
    return rows


def _ell_inserts(rng, depth, n):
    out = []
    for _ in range(n):
        a, b = rng.sample(range(depth), 2)
        out.append(T("g", f"c{a}", "m", SubjectSet("g", f"c{b}", "m")))
    return out


def _deltas(pair, mine, ref):
    from keto_tpu.graph.overlay import apply_delta as jax_apply

    a = pair.mine.changes_since(mine.snapshot_id)
    b = pair.ref.changes_since(ref.snapshot_id)
    return apply_delta(mine, *a, frozenset()), jax_apply(ref, *b, frozenset())


def _patchers(kind):
    """(the port's label patcher, JAX's) for a fold: the host walk or the
    device sweeps."""
    from keto_tpu.graph import label_build as jax_label_build

    if kind == "host":
        return None, None
    return (functools.partial(label_build.device_patch_labels, device="cpu", batch=32),
            functools.partial(jax_label_build.device_patch_labels, batch=32))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("labels", ["none", "host", "device"])
def test_compact_snapshot_equals_jax(seed, labels):
    from keto_tpu.graph.compaction import compact_snapshot as jax_compact
    from keto_tpu.graph.labels import build_labels as jax_build_labels

    rng = random.Random(500 + seed)
    depth = 8
    pair = Pair(NS, chain_rows(rng, depth))
    mine, ref = pair.snapshots()
    if labels != "none":
        mine.labels, ref.labels = build_labels(mine), jax_build_labels(ref)
    mp, jp = _patchers(labels)
    folded = 0
    for round_ in range(4):
        tuples, _ = pair.mine.get_relation_tuples(RelationQuery())
        ins = _safe_inserts(rng, tuples, 3) + _ell_inserts(rng, depth, 2 if round_ % 2 == 0 else 0)
        dels = rng.sample(tuples, 2) if round_ % 2 else []
        pair.write(ins, dels)
        got, want = _deltas(pair, mine, ref)
        assert (got is None) == (want is None)
        if got is None:
            mine, ref = pair.snapshots()
            continue
        a = compact_snapshot(got, label_patcher=mp)
        b = jax_compact(want, label_patcher=jp)
        assert_compacted_equal(a, b)
        if a is None:
            mine, ref = pair.snapshots()
            continue
        folded += 1
        assert a.labels == b.labels
        if labels != "none":
            assert (a.snapshot.labels is None) == (b.snapshot.labels is None)
            if a.snapshot.labels is not None:
                assert_index_equal(a.snapshot.labels, b.snapshot.labels)
        mine, ref = a.snapshot, b.snapshot
        if labels != "none" and mine.labels is None:
            # a fold with deletes leaves the index for a rebuild: rebuild it
            mine.labels, ref.labels = build_labels(mine), jax_build_labels(ref)
    assert folded >= 2


def test_compact_refuses_wildcard_source():
    from keto_tpu.graph.compaction import compact_snapshot as jax_compact

    pair = Pair(NS, [T("g", "grp", "", SubjectID("seed")), T("g", "grp", "m", SubjectID("u1"))])
    mine, ref = pair.snapshots()
    pair.write([T("g", "grp", "m", SubjectID("u2"))])
    got, want = _deltas(pair, mine, ref)
    assert got is not None and got.has_overlay
    assert compact_snapshot(got) is None and jax_compact(want) is None


def _patch_case(seed, depth=10, n_edges=3, max_width=64, landmarks=0):
    """(port snapshot, JAX snapshot, port index, JAX index, added edges): a
    fold of ``n_edges`` overlay-ELL inserts, with the base's index."""
    from keto_tpu.graph.compaction import compact_snapshot as jax_compact
    from keto_tpu.graph.labels import build_labels as jax_build_labels

    rng = random.Random(900 + seed)
    pair = Pair(NS, chain_rows(rng, depth))
    mine, ref = pair.snapshots()
    idx = build_labels(mine, max_width, landmarks)
    jidx = jax_build_labels(ref, max_width, landmarks)
    pair.write(_ell_inserts(rng, depth, n_edges))
    got, want = _deltas(pair, mine, ref)
    assert got is not None and got.ov_ell is not None
    a, b = compact_snapshot(got), jax_compact(want)
    edges = [tuple(e) for e in got.ov_ell.tolist()]
    assert edges == [tuple(e) for e in want.ov_ell.tolist()]
    return a.snapshot, b.snapshot, idx, jidx, edges


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["full", "narrow", "truncated", "landmark-cap", "budget-abort"])
def test_patch_labels_equal_jax(seed, case):
    from keto_tpu.graph import label_build as jax_label_build
    from keto_tpu.graph.labels import patch_labels as jax_patch

    kw = {"full": {}, "narrow": dict(max_width=3), "truncated": dict(max_width=1),
          "landmark-cap": dict(landmarks=4), "budget-abort": {}}[case]
    budget = 2 if case == "budget-abort" else 65536
    mine, ref, idx, jidx, edges = _patch_case(seed, **kw)
    host = patch_labels(idx, mine, edges, visit_budget=budget)
    jhost = jax_patch(jidx, ref, edges, visit_budget=budget)
    dev = label_build.device_patch_labels(idx, mine, edges, visit_budget=budget, batch=32,
                                          device="cpu")
    jdev = jax_label_build.device_patch_labels(jidx, ref, edges, visit_budget=budget, batch=32)
    assert (host is None) == (jhost is None) and (dev is None) == (jdev is None)
    if case in ("budget-abort", "truncated"):
        assert host is None and dev is None  # the caller rebuilds
        return
    if host is not None:
        assert_index_equal(host, jhost)
    if dev is not None:
        assert_index_equal(dev, jdev)
        assert dev.backend == jdev.backend == "device"
    if case == "full":
        # entry-identical to the host patch, and exact on the new graph
        assert host is not None and dev is not None
        for k in ("out_lab", "in_lab", "out_ok", "in_ok"):
            assert np.array_equal(getattr(host, k), getattr(dev, k)), k
