"""The port's device label build against the JAX package.

``sweep_step_ref`` (K6's wave) must equal the JAX ``_sweep_step()`` on all five of
its outputs (visited, frontier, stored, active, visits) and
``_compute_covered`` (K7 with its lane-mask table) the JAX
``_compute_covered``, word for word, with the plain versions on the CPU;
the mirror's flush is one slot set a flush; ``device_build_labels`` must give byte-equal label arrays, flags
and ``BuildInfo`` to the JAX ``device_build_labels`` and equal arrays to
the port's host ``build_labels`` on 5 fuzz seeds, with and without a
landmark cap and with ``min_gain``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch.check.random_layouts import random_covered_case, random_sweep_case
from keto_tpu_torch.check import kernels
from keto_tpu_torch.graph import label_build, label_kernels
from keto_tpu_torch.graph.labels import build_labels, interior_adjacency

from test_torch_labels import ARRAYS, LABEL_NS, assert_index_equal, fuzz_rows, snapshots

SWEEP_CASES = {
    "wt1-small": dict(seed=0, n=40, caps=(1, 2, 4), rows=(10, 6, 3), wt=1),
    "wt2-wide-cap": dict(seed=1, n=70, caps=(1, 2048), rows=(30, 2), wt=2),
    "wt2-one-group": dict(seed=2, n=25, caps=(8,), rows=(9,), wt=2),
    "wt4-many": dict(seed=3, n=120, caps=(1, 2, 4, 8, 16, 32), rows=(20, 15, 10, 8, 5, 3), wt=4),
    "wt2-no-groups": dict(seed=4, n=10, caps=(), rows=(), wt=2),
}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_sweep_step_matches_jax(name, prune):
    import jax.numpy as jnp

    from keto_tpu.graph.label_build import _sweep_step

    kw = dict(SWEEP_CASES[name])
    rng = np.random.default_rng(kw.pop("seed"))
    groups, V, X, S, cov = random_sweep_case(rng, **kw)
    u = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
    want = _sweep_step()(
        tuple(jnp.asarray(nb) for nb, _ in groups), tuple(jnp.asarray(d) for _, d in groups),
        u(V), u(X), u(S), u(cov), prune_expansion=prune,
    )
    g = label_kernels.EllGroups.from_groups(groups, "cpu")
    V2, X2, S2, state = label_kernels.sweep_step_ref(
        g, _t(V.copy()), _t(X), _t(S.copy()), _t(cov), prune_expansion=prune
    )
    for got, ref, what in ((V2, want[0], "V"), (X2, want[1], "X"), (S2, want[2], "S")):
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref)), what
    assert state.tolist() == [int(bool(want[3])), int(want[4])]
    if groups:
        assert int(want[4]) > 0, "the case must visit"


COVERED_CASES = {
    "l1-wt1": dict(seed=0, rows=60, width=8, lanes=1, wt=1, pad=-1),
    "l32-wt1-in-pads": dict(seed=1, rows=90, width=16, lanes=32, wt=1, pad=-2),
    "l1-wt2-in-pads": dict(seed=2, rows=50, width=4, lanes=1, wt=2, pad=-2),
    "l32-wt2-own16": dict(seed=3, rows=70, width=64, lanes=32, wt=2, pad=-1, own_width=16),
    "l33-wt2-in-pads": dict(seed=4, rows=80, width=12, lanes=33, wt=2, pad=-2),
    "l64-wt2-mw64": dict(seed=5, rows=120, width=64, lanes=64, wt=2, pad=-1),
    "l64-wt2-own8-in-pads": dict(seed=6, rows=100, width=32, lanes=64, wt=2, pad=-2,
                                 own_width=8),
    "l33-wt2-width3": dict(seed=7, rows=40, width=3, lanes=33, wt=2, pad=-1),
    "l32-wt1-width1-in-pads": dict(seed=8, rows=25, width=1, lanes=32, wt=1, pad=-2),
    "l64-wt2-own-empty": dict(seed=9, rows=30, width=8, lanes=64, wt=2, pad=-1, empty=True),
}


def _covered_case(name):
    kw = dict(COVERED_CASES[name])
    rng = np.random.default_rng(kw.pop("seed"))
    wt = kw.pop("wt")
    lab, own = random_covered_case(rng, **kw)
    return lab, own, kw["lanes"], wt, kw["pad"], kw.get("empty", False)


@pytest.mark.parametrize("name", sorted(COVERED_CASES))
def test_covered_matches_jax(name):
    """The port's ``_compute_covered`` (K7's dense lane-mask table) against
    the reference's (its searchsorted over the sorted own entries), with
    the same arguments, word for word."""
    import jax.numpy as jnp

    from keto_tpu.graph.label_build import _compute_covered

    lab, own, lanes, wt, pad, empty = _covered_case(name)
    got = label_build._compute_covered(_t(lab), own, lanes, wt, pad).numpy().view(np.uint32)
    want = np.asarray(_compute_covered(jnp.asarray(lab), own, lanes, wt, pad))
    assert got.shape == want.shape == (lab.shape[0], wt)
    assert np.array_equal(got, want)
    assert bool(want.any()) != empty
    if not empty:  # the case's shared id, the id T-1 and the all-pad rows
        assert want[1].any() and not want[::7].any() and not want[-1].any()


def test_covered_rows_and_table_reuse():
    """A sharded sweep's output rows (past n+1 all zero) and one table for
    several calls: zero again after each, the outputs unchanged by reuse."""
    table = torch.zeros((120, 2), dtype=torch.int32)
    for name in ("l64-wt2-mw64", "l33-wt2-in-pads", "l1-wt2-in-pads"):
        lab, own, lanes, wt, pad, _ = _covered_case(name)
        T = lab.shape[0]
        want = label_build._compute_covered(_t(lab), own, lanes, wt, pad)
        tab = table[:T]
        got = label_build._compute_covered(_t(lab), own, lanes, wt, pad, rows=T + 9, table=tab)
        assert got.shape == (T + 9, wt) and torch.equal(got[:T], want) and not got[T:].any()
        assert not table.any()


@pytest.mark.parametrize("bad", ["T", "minus-3", "other-pad"])
def test_covered_refuses_own_entries_outside_the_label_rows(bad):
    lab, own, lanes, wt, pad, _ = _covered_case("l33-wt2-in-pads")
    own = own.copy()
    own[5, 0] = {"T": lab.shape[0], "minus-3": -3, "other-pad": -1}[bad]
    with pytest.raises(ValueError, match="neither the pad"):
        label_build._compute_covered(_t(lab), own, lanes, wt, pad)


def test_flush_device_is_one_slot_set_a_flush(monkeypatch):
    """The mirror's flush writes both sides through one ``slot_set_many``
    call and leaves the device arrays equal to the host mirror; a flush
    with nothing pending makes none. The build counts its flushes."""
    calls = []
    many = kernels.slot_set_many

    def counting(targets, **kw):
        calls.append(len(targets))
        return many(targets, **kw)

    monkeypatch.setattr(kernels, "slot_set_many", counting)
    m = label_build._Mirror(12, 4, "cpu")
    m.store("out", np.array([1, 3, 5]), 7)
    m.store("in", np.array([2, 3]), 7)
    m.store("out", np.array([3, 11]), 9)
    m.flush_device()
    assert calls == [2] and m.flushes == 1
    assert np.array_equal(m.out_d.numpy(), m.out_h) and np.array_equal(m.in_d.numpy(), m.in_h)
    m.flush_device()
    assert calls == [2]
    m.store("in", np.array([4]), 1)
    m.flush_device()
    assert calls == [2, 1] and m.flushes == 2 and np.array_equal(m.in_d.numpy(), m.in_h)
    calls.clear()
    mine, _ = snapshots(LABEL_NS, fuzz_rows(0, n_objects=12, n_rows=90))
    _, info = label_build.device_build_labels(mine, device="cpu", max_width=64, batch=32)
    assert len(calls) == info.flushes > 0 and info.flush_s >= 0.0


def test_ell_groups_and_estimate_match_jax():
    from keto_tpu.graph import label_build as jax_label_build

    mine, _ = snapshots(LABEL_NS, fuzz_rows(0))
    out_ip, out_ix, in_ip, in_ix = interior_adjacency(mine)
    n = mine.num_int
    for ip, ix in ((in_ip, in_ix), (out_ip, out_ix)):
        a = label_build.build_ell_groups(ip, ix, n)
        b = jax_label_build.build_ell_groups(ip, ix, n)
        assert len(a) == len(b) > 0
        for (na, da), (nb, db) in zip(a, b):
            assert np.array_equal(na, nb) and np.array_equal(da, db)
    for args in ((n, 64), (10_000, 8, 96), (0, 1, 32)):
        assert label_build.estimate_build_bytes(*args) == jax_label_build.estimate_build_bytes(*args)


BUILD_CASES = {
    "full": dict(max_width=64, landmarks=0, batch=32),
    "narrow": dict(max_width=3, landmarks=0, batch=32),
    "landmark-cap": dict(max_width=64, landmarks=5, batch=32),
    "min-gain": dict(max_width=64, landmarks=0, batch=32, min_gain=0.05),
    "batch64": dict(max_width=2, landmarks=0, batch=64),
}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_device_build_matches_jax_and_host(seed, case):
    from keto_tpu.graph.label_build import device_build_labels as jax_device_build

    kw = BUILD_CASES[case]
    mine, ref = snapshots(LABEL_NS, fuzz_rows(seed, n_objects=12, n_rows=90))
    idx, info = label_build.device_build_labels(mine, device="cpu", **kw)
    jidx, jinfo = jax_device_build(ref, **kw)
    assert_index_equal(idx, jidx)
    assert idx.backend == jidx.backend == "device"
    for k in ("batches", "dispatches", "landmarks", "truncated", "sweep_entries", "restarts",
              "gain_history"):
        assert getattr(info, k) == getattr(jinfo, k), k
    host = build_labels(mine, kw["max_width"], info.landmarks)
    for k in ARRAYS:
        assert np.array_equal(getattr(idx, k), getattr(host, k)), k
    if case == "min-gain":
        assert info.truncated == "min_gain" or info.landmarks == mine.num_int
