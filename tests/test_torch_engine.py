"""TorchCheckEngine on the CPU against the JAX engine and the oracle.

Every scenario of tests/test_tpu_check.py, the 12 fuzz seeds of its
differential test, and cases for unknown namespaces, wildcards, cycles,
empty relations, peeled rows, truncation and read-your-writes: the port
(``device="cpu"``, the plain PyTorch versions of the kernels) must decide
exactly as ``TpuCheckEngine(labels_enabled=False)`` and the recursive
oracle do.
"""

from __future__ import annotations

import random

import pytest
import torch

from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import NAMESPACES, fuzz_case, jax_store, port_store


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def _chain(depth):
    """doc#view → c0 → … → c{depth-1} → user, closed into a cycle so the
    whole chain stays in the device kernel (tests/test_tpu_check.py)."""
    rows = [T("d", "doc", "view", SubjectSet("g", "c0", "m"))]
    for i in range(depth - 1):
        rows.append(T("g", f"c{i}", "m", SubjectSet("g", f"c{i+1}", "m")))
    rows.append(T("g", f"c{depth-1}", "m", SubjectSet("g", "c0", "m")))
    rows.append(T("g", f"c{depth-1}", "m", SubjectID("user")))
    return rows


_SN, _ON = "some namespace", "all organizations"
_USER = SubjectID("some user")

#: name → (namespaces, tuples, [(query, expected decision)])
SCENARIOS = {
    "direct-inclusion": (
        [("test", 1)],
        [T("test", "object", "access", SubjectID("user"))],
        [(T("test", "object", "access", SubjectID("user")), True)],
    ),
    "indirect-level-2": (
        [(_SN, 1), (_ON, 2)],
        [
            T(_SN, "some object", "write", SubjectSet(_SN, "some object", "owner")),
            T(_SN, "some object", "owner", SubjectSet(_ON, "some organization", "member")),
            T(_ON, "some organization", "member", _USER),
        ],
        [
            (T(_SN, "some object", "write", _USER), True),
            (T(_ON, "some organization", "member", _USER), True),
            (T(_SN, "some object", "owner", _USER), True),
            (T(_SN, "some object", "write", SubjectID("other")), False),
        ],
    ),
    "empty-relation-not-transitive": (
        [("", 2)],
        [
            T("", "file", "parent", SubjectSet("", "directory", "")),
            T("", "directory", "access", SubjectID("user")),
        ],
        [
            (T("", "file", "access", SubjectID("user")), False),
            (T("", "file", "parent", SubjectSet("", "directory", "")), True),
        ],
    ),
    "cycle-terminates": (
        [("m", 0)],
        [T("m", x, "connected", SubjectSet("m", y, "connected"))
         for x, y in (("a", "b"), ("b", "c"), ("c", "a"))],
        [
            (T("m", "a", "connected", SubjectID("c")), False),
            (T("m", "a", "connected", SubjectSet("m", "c", "connected")), True),
            (T("m", "a", "connected", SubjectSet("m", "a", "connected")), True),
        ],
    ),
    "unknown-namespace": (
        [("known", 1)],
        [T("known", "o", "r", SubjectID("u"))],
        [
            (T("unknown", "o", "r", SubjectID("u")), False),
            (T("known", "o", "r", SubjectSet("unknown", "o", "r")), False),
            (T("known", "o", "r", SubjectID("u")), True),
        ],
    ),
    "wide-graph": (
        [("n", 1)],
        [T("n", "obj", "access", SubjectSet("n", o, "member")) for o in ("o1", "o2")]
        + [T("n", ("o1", "o2")[i % 2], "member", SubjectID(u))
           for i, u in enumerate(["u1", "u2", "u3", "u4"])],
        [(T("n", "obj", "access", SubjectID(u)), True) for u in ("u1", "u2", "u3", "u4")]
        + [(T("n", "obj", "access", SubjectID("u5")), False)],
    ),
    "requested-set-needs-a-tuple": (
        [("n", 1)],
        [T("n", "obj", "read", SubjectSet("n", "group", "member"))],
        [
            (T("n", "obj", "read", SubjectSet("n", "group", "member")), True),
            (T("n", "obj", "read", SubjectSet("n", "group", "other")), False),
            (T("n", "obj", "read", SubjectSet("n", "obj", "read")), False),
        ],
    ),
    "batch-mixed": (
        [("n", 1), ("m", 2)],
        [
            T("n", "doc", "view", SubjectSet("n", "doc", "own")),
            T("n", "doc", "own", SubjectID("alice")),
            T("m", "repo", "push", SubjectSet("n", "doc", "own")),
        ],
        [
            (T("n", "doc", "view", SubjectID("alice")), True),
            (T("n", "doc", "view", SubjectID("bob")), False),
            (T("m", "repo", "push", SubjectID("alice")), True),
            (T("bogus", "doc", "view", SubjectID("alice")), False),
            (T("n", "doc", "own", SubjectSet("n", "doc", "own")), False),
        ],
    ),
    "wildcards": (
        [("n", 1), ("", 2)],
        [
            T("n", "folder", "access", SubjectID("adam")),
            T("n", "folder", "edit", SubjectID("eve")),
            T("n", "file", "parent", SubjectSet("n", "folder", "")),
            T("", "x", "r", SubjectID("zed")),
        ],
        [
            (T("n", "file", "parent", SubjectID("adam")), True),
            (T("n", "file", "parent", SubjectID("eve")), True),
            (T("n", "folder", "", SubjectID("adam")), True),
            (T("n", "", "edit", SubjectID("eve")), True),
            (T("n", "", "edit", SubjectID("adam")), False),
            (T("", "x", "r", SubjectID("zed")), True),
            (T("", "", "", SubjectID("zed")), True),
            (T("", "", "", SubjectID("nobody")), False),
        ],
    ),
    "deep-chain": (
        [("g", 1), ("d", 2)],
        _chain(24),
        [
            (T("d", "doc", "view", SubjectID("user")), True),
            (T("d", "doc", "view", SubjectID("ghost")), False),
            (T("g", "c0", "m", SubjectID("user")), True),
            (T("g", "c5", "m", SubjectID("ghost")), False),
        ],
    ),
    "high-degree-node": (
        [("n", 1)],
        [T("n", "hub", "m", SubjectSet("n", f"g{i}", "m")) for i in range(300)]
        + [T("n", f"g{i}", "m", SubjectID(f"u{i}")) for i in range(300)],
        [(T("n", "hub", "m", SubjectID(f"u{i}")), True) for i in (0, 151, 299)]
        + [(T("n", "hub", "m", SubjectID("u300")), False)],
    ),
    "peeled-chain": (
        # a → b → user: a's only in-edge is from the static doc, so a peels
        # into host propagation
        [("d", 1), ("g", 2)],
        [
            T("d", "d1", "view", SubjectSet("g", "a", "m")),
            T("g", "a", "m", SubjectSet("g", "b", "m")),
            T("g", "b", "m", SubjectID("user")),
            T("g", "b", "m", SubjectSet("g", "c", "m")),
            T("g", "c", "m", SubjectID("other")),
        ],
        [
            (T("d", "d1", "view", SubjectID("user")), True),
            (T("d", "d1", "view", SubjectID("other")), True),
            (T("g", "a", "m", SubjectID("other")), True),
            (T("d", "d1", "view", SubjectID("ghost")), False),
            (T("d", "d1", "view", SubjectSet("g", "c", "m")), True),
        ],
    ),
    "empty-store": ([("n", 1)], [], [(T("n", "o", "r", SubjectID("u")), False)]),
}


def _jax_engine(store, **kw):
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    return TpuCheckEngine(store, store.namespaces, labels_enabled=False,
                          native_pack_enabled=False, device_build_enabled=False, **kw)


def _jax_decisions(namespaces, tuples, queries, **kw):
    from keto_tpu.relationtuple.model import RelationTuple as JT

    eng = _jax_engine(jax_store(namespaces, tuples), **kw)
    return eng.batch_check([JT.from_string(str(q)) for q in queries])


def _three_way(namespaces, tuples, queries, **kw):
    store = port_store(namespaces, tuples)
    got = TorchCheckEngine(store, store.namespaces, device="cpu", **kw).batch_check(queries)
    oracle = CheckEngine(store)
    want = [oracle.subject_is_allowed(q) for q in queries]
    assert got == want, [str(q) for q, g, w in zip(queries, got, want) if g != w]
    assert got == _jax_decisions(namespaces, tuples, queries, **kw)
    return got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario(name):
    namespaces, tuples, cases = SCENARIOS[name]
    queries = [q for q, _ in cases]
    assert _three_way(namespaces, tuples, queries) == [e for _, e in cases]


def test_peeled_rows_are_exercised():
    namespaces, tuples, _ = SCENARIOS["peeled-chain"]
    store = port_store(namespaces, tuples)
    assert TorchCheckEngine(store, store.namespaces, device="cpu").snapshot().n_peeled > 0


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_differential(seed):
    tuples, queries = fuzz_case(seed)
    _three_way(NAMESPACES, tuples, queries)


@pytest.mark.parametrize("it_cap", [1, 3])
def test_truncation_reruns_exact(it_cap):
    """A truncated kernel never decides a query: the engine re-runs the
    slice at an escalating cap (the reference ladder) and stays exact. The
    BFS route is pinned (labels off): a label index landing first would
    answer the chain without iterating."""
    namespaces, tuples, cases = SCENARIOS["deep-chain"]
    store = port_store(namespaces, tuples)
    eng = TorchCheckEngine(store, store.namespaces, device="cpu", it_cap=it_cap,
                           labels_enabled=False)
    rungs = []
    orig = eng._run_exact
    eng._run_exact = lambda s, t, it_cap=None: (rungs.append(it_cap), orig(s, t, it_cap=it_cap))[1]
    queries = [q for q, _ in cases]
    assert eng.batch_check(queries) == [e for _, e in cases]
    assert len(rungs) >= 2, "truncation retry ladder never engaged"
    assert eng.batch_check(queries) == _jax_decisions(namespaces, tuples, queries, it_cap=it_cap)


def test_block_iters_grows_with_depth():
    namespaces, tuples, cases = SCENARIOS["deep-chain"]
    store = port_store(namespaces, tuples)
    eng = TorchCheckEngine(store, store.namespaces, device="cpu", labels_enabled=False)
    eng.batch_check([q for q, _ in cases])
    assert eng._block_iters == 32


def test_rbac_config3_matches_expectations():
    """BASELINE config 3 at ~20k tuples: every decision equals the analytic
    expectation, and the JAX engine agrees on all of them."""
    from keto_tpu_torch.workloads import RBAC_NAMESPACES, rbac_queries, rbac_workload

    rng = random.Random(7)
    tuples, ctx = rbac_workload(rng, 20_000)
    queries, expected = rbac_queries(rng, 4000, ctx)
    namespaces = [(n.name, n.id) for n in RBAC_NAMESPACES]
    store = port_store(namespaces, tuples)
    eng = TorchCheckEngine(store, store.namespaces, device="cpu")
    got = eng.batch_check(queries)
    assert got == expected
    assert 0 < sum(expected) < len(expected)
    assert got == _jax_decisions(namespaces, tuples, queries)


def test_read_your_writes():
    store = port_store([("n", 1)], [T("n", "obj", "access", SubjectID("u1"))])
    eng = TorchCheckEngine(store, store.namespaces, device="cpu")
    q2 = T("n", "obj", "access", SubjectID("u2"))
    assert eng.batch_check_with_token([q2]) == ([False], 1)
    store.write_relation_tuples(q2)
    assert eng.batch_check_with_token([q2]) == ([True], 2)
    store.delete_relation_tuples(T("n", "obj", "access", SubjectID("u1")))
    assert eng.batch_check([T("n", "obj", "access", SubjectID("u1")), q2]) == [False, True]
    assert eng.snapshot().snapshot_id == 3


def test_default_device_is_cuda():
    store = port_store([("n", 1)], [])
    if torch.cuda.is_available():
        assert TorchCheckEngine(store, store.namespaces).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchCheckEngine(store, store.namespaces)
