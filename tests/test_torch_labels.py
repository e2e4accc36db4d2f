"""The port's 2-hop labels and label step against the JAX package.

``keto_tpu_torch.graph.labels.build_labels`` must give byte-equal label
arrays and flags to ``keto_tpu.graph.labels.build_labels`` on the same
snapshot (fuzz graphs with width and landmark caps, and a 20k-tuple
BASELINE config 3), ``certifiable`` and ``query`` must agree, and the
port's ``label_step`` (its plain version, on the CPU) must equal the JAX
``label_step`` word for word over label widths 1 to 128, pad pairs and
batch widths 1, 8 and 64.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import random_label_case
from keto_tpu_torch.graph.labels import build_labels
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.workloads import rbac_workload

from test_torch_snapshot import jax_store, port_store

LABEL_NS = [("g", 1), ("d", 2)]
ARRAYS = ("out_lab", "in_lab", "processed", "out_ok", "in_ok")


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def fuzz_rows(seed: int, n_objects: int = 10, n_rows: int = 70):
    """Random g/d graphs with interior chains, cycles, sinks and a
    wildcard-relation row (the shape of tests/test_label_build.py)."""
    rng = random.Random(4100 + seed)
    objects = [f"o{i}" for i in range(n_objects)]
    rows = []
    for _ in range(n_rows):
        sub = (
            SubjectID(rng.choice(["u0", "u1", "u2", "u3"]))
            if rng.random() < 0.5
            else SubjectSet("g", rng.choice(objects), rng.choice(["m", "v"]))
        )
        rows.append(T(rng.choice(["g", "d"]), rng.choice(objects), rng.choice(["m", "v"]), sub))
    if seed % 2:
        rows.append(T("g", rng.choice(objects), "", SubjectID("seed")))
    return rows


def snapshots(namespaces, rows):
    """(the port's snapshot, the JAX package's) of the same tuples."""
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    mine = build_snapshot(*port_store(namespaces, rows).snapshot_rows())
    ref = jax_build(*jax_store(namespaces, rows).snapshot_rows())
    return mine, ref


def assert_index_equal(mine, ref):
    for k in ARRAYS:
        a, b = getattr(mine, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
    assert (mine.n, mine.n_entries, mine.n_landmarks, mine.max_width) == (
        ref.n, ref.n_entries, ref.n_landmarks, ref.max_width)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_width,landmarks", [(64, 0), (3, 0), (64, 4), (2, 3), (1, 0)])
def test_build_labels_byte_equal_fuzz(seed, max_width, landmarks):
    from keto_tpu.graph.labels import build_labels as jax_build_labels

    mine, ref = snapshots(LABEL_NS, fuzz_rows(seed))
    assert_index_equal(build_labels(mine, max_width, landmarks),
                       jax_build_labels(ref, max_width, landmarks))


def test_build_labels_byte_equal_rbac():
    """BASELINE config 3 at 20k tuples: 3-level group nesting."""
    from keto_tpu.graph.labels import build_labels as jax_build_labels

    from keto_tpu_torch.workloads import RBAC_NAMESPACES

    tuples, _ = rbac_workload(random.Random(3), 20_000)
    mine, ref = snapshots([(n.name, n.id) for n in RBAC_NAMESPACES], tuples)
    assert mine.num_int > 100
    assert_index_equal(build_labels(mine), jax_build_labels(ref))


@pytest.mark.parametrize("seed", range(3))
def test_certifiable_and_query_agree(seed):
    from keto_tpu.graph.labels import build_labels as jax_build_labels

    mine, ref = snapshots(LABEL_NS, fuzz_rows(seed))
    a_idx, b_idx = build_labels(mine, 2, 3), jax_build_labels(ref, 2, 3)
    n = mine.num_int
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n + 1, size=300)
    b = rng.integers(0, n + 1, size=300)
    assert np.array_equal(a_idx.certifiable(a, b), b_idx.certifiable(a, b))
    assert [a_idx.query(int(x), int(y)) for x, y in zip(a, b)] == [
        b_idx.query(int(x), int(y)) for x, y in zip(a, b)]
    assert a_idx.coverage == b_idx.coverage and a_idx.device_bytes() == b_idx.device_bytes()


LABEL_STEP_CASES = {
    "wo1-wi1-w1": dict(seed=0, n=40, Wo=1, Wi=1, W=1, pairs=20),
    "wo32-wi1-w8": dict(seed=1, n=60, Wo=32, Wi=1, W=8, pairs=300),
    "wo1-wi32-w8": dict(seed=2, n=60, Wo=1, Wi=32, W=8, pairs=300),
    "wo64-wi64-w8": dict(seed=3, n=80, Wo=64, Wi=64, W=8, pairs=700),
    "wo128-wi32-w64": dict(seed=4, n=50, Wo=128, Wi=32, W=64, pairs=2500),
    "wo32-wi128-w64": dict(seed=5, n=50, Wo=32, Wi=128, W=64, pairs=2100),
    "wo128-wi128-w1": dict(seed=6, n=30, Wo=128, Wi=128, W=1, pairs=40),
    "wo2-wi8-w64-many": dict(seed=7, n=200, Wo=2, Wi=8, W=64, pairs=5000),
}


@pytest.mark.parametrize("name", sorted(LABEL_STEP_CASES))
def test_label_step_matches_jax(name):
    import jax.numpy as jnp

    from keto_tpu.check.tpu_engine import label_step as jax_label_step

    kw = dict(LABEL_STEP_CASES[name])
    rng = np.random.default_rng(kw.pop("seed"))
    out_lab, in_lab, entries, P, B = random_label_case(rng, **kw)
    want = np.asarray(jax_label_step(jnp.asarray(out_lab), jnp.asarray(in_lab),
                                     jnp.asarray(entries), n_pairs=P, B=B))
    got = kernels.label_step(torch.from_numpy(out_lab), torch.from_numpy(in_lab),
                             torch.from_numpy(entries), n_pairs=P, B=B)
    got = got.numpy().view(np.uint32)
    assert got.shape == want.shape == (B // 32,)
    assert np.array_equal(got, want), f"{np.count_nonzero(got != want)} words differ"
    bits = np.unpackbits(want.view(np.uint8)).sum()
    assert 0 < bits < B, "the case must have both hits and misses"
