"""The whole frontier sweep (K6, and K10c on a mesh) against the JAX package.

The port's ``_Sweeper.sweep`` and ``_ShardedSweeper.sweep`` (one call of
``label_kernels.sweep`` / ``sharded.label_sweep`` a sweep; their plain
versions on the CPU) must return the JAX ``_Sweeper.sweep``'s and
``_ShardedSweeper.sweep``'s stored bitmap word for word, leave the same
remaining visit budget and return None on the same dry budgets, unsharded
and at g = 1..4 shards: the label build's sweeps (expansion pruning, seeds)
and the patch's (no pruning, ``start_rows``), with no budget, a budget the
run exactly spends, one that runs dry on the last wave with visits and one
that runs dry a wave earlier. The wrappers' failed launches raise and are
counted.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.graph import label_build, label_kernels
from keto_tpu_torch.graph.labels import interior_adjacency, landmark_order
from keto_tpu_torch.list import kernels as list_kernels
from keto_tpu_torch.parallel import make_mesh

from test_torch_labels import LABEL_NS, fuzz_rows, snapshots

#: (seed, objects, rows) of the fuzz graphs; 64 lanes (wt = 2)
GRAPHS = {"small": (0, 10, 70), "wide": (1, 24, 160)}
#: 0 = the unsharded sweeper; g > 0 = the sharded one over g shards
GS = (0, 1, 2, 3, 4)
BUDGETS = ("none", "exact", "last", "earlier")
LANES = 64


def _case(graph: str, mode: str):
    """(fwd groups, bwd groups, n, seeds, start_rows | None, cov, prune)."""
    seed, n_objects, n_rows = GRAPHS[graph]
    mine, _ = snapshots(LABEL_NS, fuzz_rows(seed, n_objects=n_objects, n_rows=n_rows))
    out_ip, out_ix, in_ip, in_ix = interior_adjacency(mine)
    n = mine.num_int
    fwd = label_build.build_ell_groups(in_ip, in_ix, n)
    bwd = label_build.build_ell_groups(out_ip, out_ix, n)
    order = landmark_order(out_ip, in_ip, n)
    rng = np.random.default_rng(seed)
    seeds = np.full(LANES, -1, np.int64)
    k = min(LANES, n)
    seeds[:k] = order[:k]
    start = None
    if mode == "patch":
        start = np.full(LANES, -1, np.int64)
        start[:k] = rng.integers(0, n, size=k)
    words = lambda: rng.integers(0, 2**32, size=(n + 1, LANES // 32), dtype=np.uint64)  # noqa: E731
    cov = (words() & words()).astype(np.uint32)
    cov[n] = 0
    return fwd, bwd, n, seeds, start, cov, mode == "build"


def _wave_visits(groups, n, seeds, start, cov, prune) -> list:
    """Each wave's visits, from the plain per-wave step."""
    g = label_kernels.EllGroups.from_groups(groups, "cpu")
    rows = seeds if start is None else start
    V = torch.from_numpy(label_build._seed_bitmap(rows, n, LANES // 32, n + 1))
    X, S = V.clone(), torch.zeros_like(V)
    c = torch.from_numpy(cov.view(np.int32))
    out = []
    while True:
        V, X, S, state = label_kernels.sweep_step_ref(g, V, X, S, c, prune_expansion=prune)
        out.append(int(state[1]))
        if not int(state[0]):
            return out


def _budget(kind: str, visits: list):
    """(budget, the wave it runs dry on or None)."""
    cum = np.cumsum(visits).tolist()
    total = cum[-1]
    positive = [i for i, v in enumerate(visits) if v]
    if kind == "none":
        return None, None
    if kind == "exact":
        return total, None
    at = positive[-1] if kind == "last" else positive[-2]
    return cum[at] - 1, at


def _cov(sw, cov: np.ndarray) -> torch.Tensor:
    """The covered mask ``cov`` (n+1 rows, as the reference's sweep takes
    it) at the port's sweeper's row count, the tail zero: a sharded
    sweeper's masks hold its g·rps rows."""
    out = torch.zeros((sw._rows(), cov.shape[1]), dtype=torch.int32)
    out[: cov.shape[0]] = torch.from_numpy(cov.view(np.int32))
    return out


def _sweepers(fwd, bwd, n, g):
    import jax

    from keto_tpu.graph import label_build as jlb
    from keto_tpu.parallel import make_mesh as jmesh

    if g == 0:
        return (label_build._Sweeper(fwd, bwd, n, "cpu"), jlb._Sweeper(fwd, bwd, n))
    return (label_build._ShardedSweeper(fwd, bwd, n, make_mesh(graph=g, device="cpu"), g, "cpu"),
            jlb._ShardedSweeper(fwd, bwd, n, jmesh(jax.devices()[:g], graph=g), g))


@pytest.mark.parametrize("budget_kind", BUDGETS)
@pytest.mark.parametrize("mode", ("build", "patch"))
@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sweep_matches_jax(graph, g, mode, budget_kind):
    import jax.numpy as jnp

    fwd, bwd, n, seeds, start, cov, prune = _case(graph, mode)
    visits = _wave_visits(fwd, n, seeds, start, cov, prune)
    assert len([v for v in visits if v]) >= 2, "the case must visit in two waves at least"
    budget, dry_at = _budget(budget_kind, visits)
    mine, ref = _sweepers(fwd, bwd, n, g)
    kw = dict(prune_expansion=prune, start_rows=start)
    b_mine = None if budget is None else [budget]
    b_ref = None if budget is None else [budget]
    got = mine.sweep(True, seeds, _cov(mine, cov), LANES // 32,
                     budget=b_mine, **kw)
    want = ref.sweep(True, seeds, jnp.asarray(cov), LANES // 32, budget=b_ref, **kw)
    assert b_mine == b_ref
    if dry_at is None:
        assert got is not None and want is not None
        assert got.dtype == np.uint32 and np.array_equal(got, np.asarray(want))
        assert got.any()
        if budget is not None:
            assert b_mine == [budget - sum(visits)]
    else:
        assert got is None and want is None
        assert b_mine == [budget - sum(visits[: dry_at + 1])] == [-1]
    assert mine.sweeps == 1 and mine.waves == (len(visits) if dry_at is None else dry_at + 1)


@pytest.mark.parametrize("g", GS)
def test_sweep_dry_on_an_inactive_last_wave_matches_jax(g):
    """Every store covered: the first wave visits, stores nothing and is the
    last; a budget below its visits runs dry on it, as the reference's loop
    subtracts before it tests ``active``."""
    import jax.numpy as jnp

    fwd, bwd, n, seeds, _, cov, _ = _case("small", "build")
    cov[:] = np.uint32(0xFFFFFFFF)
    visits = _wave_visits(fwd, n, seeds, None, cov, True)
    assert len(visits) == 1 and visits[0] > 0
    for budget in (visits[0] - 1, visits[0]):
        mine, ref = _sweepers(fwd, bwd, n, g)
        b_mine, b_ref = [budget], [budget]
        got = mine.sweep(True, seeds, _cov(mine, cov), LANES // 32,
                         budget=b_mine)
        want = ref.sweep(True, seeds, jnp.asarray(cov), LANES // 32, budget=b_ref)
        assert b_mine == b_ref == [budget - visits[0]]
        if budget < visits[0]:
            assert got is None and want is None
        else:
            assert np.array_equal(got, np.asarray(want)) and not got.any()


def test_sharded_sweep_counts_one_halo_round_a_wave():
    """The sharded sweep's collectives: one all-gather of the slabs and one
    psum of {active, visits} per wave run, as the reference's program."""
    from keto_tpu_torch.parallel import sharded as ps

    fwd, bwd, n, seeds, _, cov, _ = _case("wide", "build")
    g = 3
    sw = label_build._ShardedSweeper(fwd, bwd, n, make_mesh(graph=g, device="cpu"), g, "cpu")
    ps.reset_collective_counts()
    assert sw.sweep(False, seeds, _cov(sw, cov), LANES // 32) is not None
    waves = sw.waves
    assert waves >= 2
    assert ps.COLLECTIVE_CALLS["all_gather"] == ps.COLLECTIVE_CALLS["psum"] == waves
    assert ps.COLLECTIVE_BYTES["all_gather"] == waves * g * sw._rps * (LANES // 32) * 4
    assert ps.COLLECTIVE_BYTES["psum"] == waves * 2 * 4 * g


class _FailingLib:
    """A kernel library whose every entry point refuses the launch."""

    def __getattr__(self, name):
        return lambda *a: 9  # cudaErrorInvalidConfiguration


def _no_card(monkeypatch, module):
    monkeypatch.setattr(module, "_lib", lambda: _FailingLib())
    monkeypatch.setattr(module, "_need", lambda *a: None)
    monkeypatch.setattr(module, "_stream", lambda: 0)


def test_failed_sweep_launch_raises_and_is_counted(monkeypatch):
    fwd, _, n, seeds, _, cov, _ = _case("small", "build")
    _no_card(monkeypatch, label_kernels)
    groups = label_kernels.EllGroups.from_groups(fwd, "cpu")
    X0 = torch.from_numpy(label_build._seed_bitmap(seeds, n, LANES // 32, n + 1))
    before = dict(kernels.COUNTS)
    with pytest.raises(RuntimeError, match="keto_sweep_run"):
        label_kernels.sweep_cuda(groups, X0, torch.from_numpy(cov.view(np.int32)), n_dst=n + 1)
    assert kernels.COUNTS["sweep_run"] - before["sweep_run"] == 1
    assert kernels.COUNTS["sweep_waves"] == before["sweep_waves"]


def test_failed_list_fixpoint_launch_raises_and_is_counted(monkeypatch):
    from keto_tpu_torch.check.random_layouts import random_buckets

    rng = np.random.default_rng(0)
    _no_card(monkeypatch, list_kernels)
    n_rows = 40
    nb = [torch.from_numpy(b) for b in random_buckets(rng, n_rows, (1, 64), (20, 4))]
    R0 = torch.zeros((n_rows + 1, 1), dtype=torch.int32)
    ov = torch.full((2, 2), n_rows, dtype=torch.int32)
    ov_dst = torch.tensor([30, n_rows + 1], dtype=torch.int32)
    before = dict(kernels.COUNTS)
    with pytest.raises(RuntimeError, match="keto_list_fixpoint"):
        list_kernels.list_step_cuda(nb, R0, ov, ov_dst, n_active=24, valid_rows=(20, 4),
                                    it_cap=8)
    assert kernels.COUNTS["list_fixpoint"] - before["list_fixpoint"] == 1
    assert kernels.COUNTS["list_fixpoint_overlay"] - before["list_fixpoint_overlay"] == 1
    assert kernels.COUNTS["list_iters"] == before["list_iters"]
