"""The sharded programs of the PyTorch port (K10) against the JAX reference's
``shard_map`` programs, word for word.

``keto_tpu_torch.parallel.sharded``'s plain versions of ``check_step``
(K10a) and ``label_step`` (K10b), and one wave of the plain sharded sweep
(K10c: ``label_kernels.sweep_step_into_ref`` over ``sweep_ell_groups``'
table), must equal
``keto_tpu.parallel.sharded``'s ``check_kernel``, ``label_kernel`` and
``label_sweep_kernel`` on the 8-virtual-device CPU mesh of
tests/conftest.py, over sub-meshes of 1, 2, 3, 4 and 8 shards, on the same
numpy-seeded layouts: the whole ``uint32[W+3]`` / ``uint32[W]`` output
(decision bits, ``iters``, ``truncated``, the frontier-bit word) and every
slab word of the wave. The check layouts take narrow and odd widths (W =
1, 3, 5), a cap past 1,024 and it_cap cuts inside a block of steps. The
routing functions must equal the reference's byte for byte; the run table
of every shard's bucket runs must tile the active prefix, and a layout
whose runs do not is refused. The frontier-bit word, which the port counts
where its bits are set (the seeds' and the commits' newly set bits), must
equal the reference's psum of popcount(R_fix) on duplicate seed entries,
seeds past the slab, truncated runs and overlays, at g = 1, 3 and 5 with
slabs that do not divide the rows. The ``cuda`` tests hold every CUDA
entry point against its plain version on the card (K10a's run into a
sentinel-filled ``P``, its one answer launch on the answer layouts of
``random_answer_case``) and skip where there is none.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import (
    ANSWER_KINDS,
    SENTINEL,
    RefusingLib,
    random_answer_case,
    random_label_case,
    random_shard_case,
    random_sweep_case,
)
from keto_tpu_torch.graph import label_kernels
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.parallel import sharded as ps

GS = (1, 2, 3, 4, 8)

CHECK_CASES = {
    "w1-caps": dict(W=1, caps=(1, 2, 4), rows=(9, 7, 5)),
    "w8-cap16-uneven": dict(W=8, caps=(1, 16), rows=(20, 3), n_int=80, block_iters=3),
    "w8-overlay": dict(W=8, caps=(1, 4, 16), rows=(12, 8, 4), overlay=True, block_iters=1),
    "chain-trunc-cap3-b1": dict(W=8, caps=(1,), rows=(30,), it_cap=3, block_iters=1, chain=True),
    "chain-trunc-overlay": dict(W=8, caps=(1,), rows=(30,), it_cap=5, block_iters=3, chain=True,
                                overlay=True),
    "chain-trunc-cap2-b8": dict(W=1, caps=(1,), rows=(30,), it_cap=2, block_iters=8, chain=True),
    "n-active-0": dict(W=8, n_int=30),
    "w3-odd": dict(seed=10, W=3, caps=(1, 2, 8), rows=(14, 9, 4), n_int=40),
    "w5-cap1100-overlay": dict(seed=11, W=5, caps=(1, 1100), rows=(18, 2), n_int=60, overlay=True,
                               block_iters=2),
    "chain-trunc-cap7-b4-w5": dict(seed=13, W=5, caps=(1,), rows=(30,), n_int=40, it_cap=7,
                                   block_iters=4, chain=True),
}
LABEL_CASES = {  # (n, Wo, Wi, W, live pairs)
    "w1": (90, 1, 1, 1, 20),
    "wo32": (90, 32, 1, 8, 300),
    "w64": (61, 64, 64, 8, 500),
    "wo128": (50, 128, 32, 1, 40),
}
SWEEP_CASES = {  # (n, caps, rows per group, wt, expansion pruning)
    "prune-wt1": (40, (1, 2, 4), (10, 8, 5), 1, True),
    "noprune-wt2": (33, (1, 8), (20, 6), 2, False),
    "prune-wt2-cap16": (70, (1, 2, 16), (30, 10, 3), 2, True),
}


def _jax_mesh(g):
    import jax

    from keto_tpu.parallel import make_mesh as jmesh

    return jmesh(jax.devices()[:g], graph=g)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _shard_case(name, g):
    case = dict(CHECK_CASES[name])
    seed = case.pop("seed", None)
    if seed is None:  # the first cases are seeded by their place among themselves
        seed = sorted(n for n, c in CHECK_CASES.items() if "seed" not in c).index(name)
    return random_shard_case(np.random.default_rng(seed), g, **case)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_check_step_matches_jax(name, g):
    import jax.numpy as jnp

    from keto_tpu.parallel import sharded as js

    single, (spec, ent, ov, kw) = _shard_case(name, g)
    want = np.asarray(js.check_kernel(_jax_mesh(g))(
        tuple(jnp.asarray(a) for a in spec.nbrs_sh), tuple(jnp.asarray(a) for a in spec.dst_sh),
        jnp.asarray(ent), ov_nbrs=None if ov is None else jnp.asarray(ov[0]),
        ov_dst=None if ov is None else jnp.asarray(ov[1]), **kw))
    bk = ps.ShardedBuckets.from_spec(spec, "cpu")
    got = ps.check_step(make_mesh(graph=g, device="cpu"), bk, _t(ent),
                        *((None, None) if ov is None else (_t(ov[0]), _t(ov[1]))),
                        **kw).numpy().view(np.uint32)
    assert got.shape == want.shape
    assert np.array_equal(got, want), (
        f"{np.count_nonzero(got != want)} words differ; tail port={got[-3:]} jax={want[-3:]}")
    W = kw["B"] // 32
    buckets, entries, sov, k1 = single
    if k1["n_active"]:
        # the single-device K2 on the same layout: equal decisions and tail
        one = kernels.check_step(
            [_t(b) for b in buckets], _t(entries),
            *((None, None) if sov is None else (_t(sov[0]), _t(sov[1]))), **k1,
        ).numpy().view(np.uint32)
        assert np.array_equal(got[: W + 2], one)
    if name.startswith("chain-trunc"):
        assert want[W + 1] == 1, "the case must truncate"


@pytest.mark.parametrize("g", (1, 2, 3, 4))
@pytest.mark.parametrize("name", ["w1-caps", "w8-cap16-uneven", "w5-cap1100-overlay", "n-active-0"])
def test_shard_runs_tile_the_active_prefix(name, g):
    """One run a shard's slice of a bucket, shard by shard: the runs' output
    rows (global rows) tile [0, n_active) in order; a layout missing a run
    is ragged and refused."""
    single, (spec, _, _, kw) = _shard_case(name, g)
    bk = ps.ShardedBuckets.from_spec(spec, "cpu")
    W = kw["B"] // 32
    plan = ps.shard_runs(bk, g, kw["rps"], W)
    assert plan.n_rows == spec.n_active == single[3]["n_active"]
    assert list(plan.out) == [int(x) for x in np.cumsum([0, *plan.rows])[:-1]]
    assert all(k > 0 for k in plan.rows) and len(plan.rows) <= len(bk.nbrs) + g - 1
    if len(plan.rows) > 1:
        runs = [list(per) for per in bk.runs]
        b, s = next((b, s) for s in range(g) for b in range(len(runs)) if runs[b][s][1])
        runs[b][s] = (0, 0)  # shard s no longer pulls its rows of bucket b
        ragged = ps.ShardedBuckets(bk.nbrs, bk.dst, tuple(tuple(p) for p in runs))
        with pytest.raises(ValueError, match="tile"):
            ps.shard_runs(ragged, g, kw["rps"], W)


@pytest.mark.parametrize("g", (1, 2, 3, 4))
@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_shard_run_ref_matches_the_sharded_program(name, g):
    """The plain run over every shard on the global rows (what the CUDA run
    is held against) gives the plain sharded program's ``iters``,
    ``truncated`` and frontier-bit word, and writes no row past the active
    prefix of P."""
    _, (spec, ent, ov, kw) = _shard_case(name, g)
    rps, W = kw["rps"], kw["B"] // 32
    bk = ps.ShardedBuckets.from_spec(spec, "cpu")
    plan = ps.shard_runs(bk, g, rps, W)
    R = torch.zeros((g * rps, W), dtype=torch.int32)
    for s in range(g):
        R[s * rps : (s + 1) * rps] = kernels.seed_ref(_t(ent[s]), kw["sizes"], rps - 1, W)[0]
    P = torch.zeros_like(R)
    ovn, ovd = (None, None) if ov is None else (_t(ov[0]), _t(ov[1]))
    state = ps.shard_run_ref(plan, R, P, ovn, ovd, rps=rps, it_cap=kw["it_cap"],
                             block_iters=kw["block_iters"])
    want = ps.check_step_ref(make_mesh(graph=g, device="cpu"), bk, _t(ent), ovn, ovd, **kw)
    pop = int(label_kernels._popcount(R).sum()) & 0xFFFFFFFF
    assert [int(state[1]), int(state[0]), pop] == (want[W:].numpy().view(np.uint32)).tolist()
    assert not P[plan.n_rows :].any()
    # counted where set: the seeds' bits, then the commits' newly set bits
    counted = torch.zeros(1, dtype=torch.int32)
    R2 = torch.zeros_like(R)
    for s in range(g):
        R2[s * rps : (s + 1) * rps] = kernels.seed_ref(_t(ent[s]), kw["sizes"], rps - 1, W,
                                                       pop=counted)[0]
    ps.shard_run_ref(plan, R2, torch.zeros_like(R2), ovn, ovd, rps=rps, it_cap=kw["it_cap"],
                     block_iters=kw["block_iters"], pop=counted)
    assert torch.equal(R2, R) and int(counted) & 0xFFFFFFFF == pop


def test_failed_sharded_run_launch_raises_and_is_counted(monkeypatch):
    for module in (kernels, ps):
        monkeypatch.setattr(module, "_lib", lambda: RefusingLib("keto_check_run"))
        monkeypatch.setattr(module, "_need", lambda *a: None)
        monkeypatch.setattr(module, "_stream", lambda: 0)
    _, (spec, ent, ov, kw) = _shard_case("w8-overlay", 3)
    bk = ps.ShardedBuckets.from_spec(spec, "cpu")
    before = dict(kernels.COUNTS)
    with pytest.raises(RuntimeError, match="keto_check_run"):
        ps.check_step_cuda(make_mesh(graph=3, device="cpu"), bk, _t(ent), _t(ov[0]), _t(ov[1]),
                           **kw)
    counted = {k: kernels.COUNTS[k] - before[k] for k in kernels.COUNTS}
    assert {k: v for k, v in counted.items() if v} == {"seed": 3, "check_run": 1,
                                                       "check_run_overlay": 1}


def test_failed_shard_answer_launch_raises_and_is_counted(monkeypatch):
    for module in (kernels, ps):
        monkeypatch.setattr(module, "_lib", lambda: RefusingLib("keto_shard_answer"))
        monkeypatch.setattr(module, "_need", lambda *a: None)
        monkeypatch.setattr(module, "_stream", lambda: 0)
    _, (spec, ent, ov, kw) = _shard_case("w8-overlay", 3)
    bk = ps.ShardedBuckets.from_spec(spec, "cpu")
    before = dict(kernels.COUNTS)
    with pytest.raises(RuntimeError, match="keto_shard_answer"):
        ps.check_step_cuda(make_mesh(graph=3, device="cpu"), bk, _t(ent), _t(ov[0]), _t(ov[1]),
                           **kw)
    counted = {k: kernels.COUNTS[k] - before[k] for k in kernels.COUNTS}
    assert {k: v for k, v in counted.items() if v} == {"seed": 3, "check_run": 1,
                                                       "check_run_overlay": 1, "shard_answer": 1}


#: the frontier-bit layouts: a CHECK_CASES layout over 64 rows (g = 3 and 5
#: do not divide them) and what is done to its routed seeds
POP_CASES = {
    "dup-e1": ("w8-overlay", "e1-twice"),
    "dup-e1-e2": ("w8-overlay", "e1-and-e2"),
    "past-slab": ("w3-odd", "past-slab"),
    "trunc": ("chain-trunc-overlay", None),
    "overlay": ("w5-cap1100-overlay", None),
}


def _pop_case(name, g):
    base, edit = POP_CASES[name]
    case = dict(CHECK_CASES[base])
    seed = case.pop("seed", 0) + 100
    case["n_int"] = 63
    _, (spec, ent, ov, kw) = random_shard_case(np.random.default_rng(seed), g, **case)
    rps = kw["rps"]
    assert g == 1 or g * rps != 64, "the slabs must not divide the rows"
    S1, S2 = kw["sizes"][:2]
    edited = ent.copy()
    rng = np.random.default_rng(seed)
    for s in range(g):
        e = edited[s]
        live = np.flatnonzero(e[:S1] < rps)
        pad1 = np.flatnonzero(e[:S1] == rps)
        pad2 = 2 * S1 + np.flatnonzero(e[2 * S1 : 2 * S1 + S2] == rps)
        if edit == "e1-twice" and live.size and pad1.size:
            e[pad1[0]], e[pad1[0] + S1] = e[live[0]], e[live[0] + S1]
        if edit == "e1-and-e2" and live.size and pad2.size:
            e[pad2[0]], e[pad2[0] + S2] = e[live[-1]], e[live[-1] + S1]
        if edit == "past-slab":
            for pads, off in ((pad1[:3], S1), (pad2[:3], S2)):
                e[pads] = rps + np.array([1, 7, 10**6])[: pads.size]
                e[pads + off] = rng.integers(0, kw["B"], size=pads.size)
    if edit in ("e1-twice", "e1-and-e2"):
        assert not np.array_equal(edited, ent), "the layout must hold a duplicate seed"
    return spec, ent, edited, ov, kw


@pytest.mark.parametrize("g", (1, 3, 5))
@pytest.mark.parametrize("name", sorted(POP_CASES))
def test_frontier_bits_counted_where_set_match_jax(name, g):
    """The frontier-bit word counted where its bits are set — each shard's
    seeds (an entry seeded twice, in e1 or in e1 and e2, counts once; a
    seed past the slab drops) plus its commits' newly set bits, psummed —
    equals the reference's psum of popcount(R_fix), with the whole
    ``uint32[W+3]``. The reference scatter-adds its seeds, which is an OR
    only on the distinct pairs the engine packs: an e1 entry given twice is
    held against the reference on the layout without the copy."""
    import jax.numpy as jnp

    from keto_tpu.parallel import sharded as js

    spec, ent, edited, ov, kw = _pop_case(name, g)
    same = ent if POP_CASES[name][1] == "e1-twice" else edited
    want = np.asarray(js.check_kernel(_jax_mesh(g))(
        tuple(jnp.asarray(a) for a in spec.nbrs_sh), tuple(jnp.asarray(a) for a in spec.dst_sh),
        jnp.asarray(same), ov_nbrs=None if ov is None else jnp.asarray(ov[0]),
        ov_dst=None if ov is None else jnp.asarray(ov[1]), **kw))
    bk = ps.ShardedBuckets.from_spec(spec, "cpu")
    ovt = (None, None) if ov is None else (_t(ov[0]), _t(ov[1]))
    got = ps.check_step(make_mesh(graph=g, device="cpu"), bk, _t(edited), *ovt,
                        **kw).numpy().view(np.uint32)
    W = kw["B"] // 32
    assert np.array_equal(got, want), f"tail port={got[W:]} jax={want[W:]}"
    if name == "trunc":
        assert want[W + 1] == 1, "the case must truncate"
    # the count equals popcount(R) of the plain run from the same seeds
    rps = kw["rps"]
    R = torch.zeros((g * rps, W), dtype=torch.int32)
    for s in range(g):
        R[s * rps : (s + 1) * rps] = kernels.seed_ref(_t(edited[s]), kw["sizes"], rps - 1, W)[0]
    ps.shard_run_ref(ps.shard_runs(bk, g, rps, W), R, torch.zeros_like(R), *ovt, rps=rps,
                     it_cap=kw["it_cap"], block_iters=kw["block_iters"])
    assert int(got[W + 2]) == int(label_kernels._popcount(R).sum()) & 0xFFFFFFFF


@pytest.mark.parametrize("g", (1, 3, 4))
def test_check_step_all_padding_slice_decides_nothing(g):
    """The reference's warm geometry: every entry a sentinel. The sharded
    dispatch returns zero decision bits and the reference's tail."""
    import jax.numpy as jnp

    from keto_tpu.parallel import sharded as js

    _, (spec, _, ov, kw) = _shard_case("w8-overlay", g)
    ni, B = spec.n_int, kw["B"]
    e_rows, e_q = np.full(B, ni + 1, np.int32), np.zeros(B, np.int32)
    packed = (e_rows, e_q, e_rows, e_q, np.full(B, ni, np.int32), e_q, np.full(B, ni, np.int32))
    ent, sizes = ps.route_entries(spec, packed, B)
    jent, jsizes = js.route_entries(spec, packed, B)  # reads the spec's sizes only
    assert np.array_equal(ent, jent) and sizes == jsizes
    kw = dict(kw, sizes=sizes)
    got = ps.check_step(make_mesh(graph=g, device="cpu"), ps.ShardedBuckets.from_spec(spec, "cpu"),
                        _t(ent), _t(ov[0]), _t(ov[1]), **kw).numpy().view(np.uint32)
    want = np.asarray(js.check_kernel(_jax_mesh(g))(
        tuple(jnp.asarray(a) for a in spec.nbrs_sh), tuple(jnp.asarray(a) for a in spec.dst_sh),
        jnp.asarray(ent), ov_nbrs=jnp.asarray(ov[0]), ov_dst=jnp.asarray(ov[1]), **kw))
    assert np.array_equal(got, want)
    assert not got[: B // 32].any()


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("name", sorted(LABEL_CASES))
def test_label_step_matches_jax(name, g):
    import jax.numpy as jnp

    from keto_tpu.parallel import sharded as js

    n, Wo, Wi, W, pairs = LABEL_CASES[name]
    out_lab, in_lab, ent, P, B = random_label_case(np.random.default_rng(n + Wo), n, Wo, Wi, W,
                                                   pairs)
    o_sh, i_sh, rl, owned = ps.route_labels(out_lab, in_lab, g)
    jo, ji, jrl, jowned = js.route_labels(out_lab, in_lab, g)
    assert np.array_equal(o_sh, jo) and np.array_equal(i_sh, ji) and (rl, owned) == (jrl, jowned)
    want = np.asarray(js.label_kernel(_jax_mesh(g))(
        jnp.asarray(o_sh), jnp.asarray(i_sh), jnp.asarray(ent), n_pairs=P, B=B, rl=rl))
    got = ps.label_step(make_mesh(graph=g, device="cpu"), _t(o_sh), _t(i_sh), _t(ent),
                        n_pairs=P, B=B, rl=rl).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    one = kernels.label_step(_t(out_lab), _t(in_lab), _t(ent), n_pairs=P, B=B)
    assert np.array_equal(got, one.numpy().view(np.uint32))


def test_pair_row_exchange_keeps_the_pads():
    """A pair row no shard owned would rebuild as zeros on both sides and
    match (0 == 0); the stripes pad with each side's own pad, so at g = 3
    (rows that do not divide evenly) every pad pair still misses."""
    g, n = 3, 10
    out_lab = np.full((n + 1, 2), -1, np.int32)
    in_lab = np.full((n + 1, 2), -2, np.int32)
    out_lab[0, 0] = in_lab[5, 0] = 7  # one real grant: (0, 5)
    o_sh, i_sh, rl, _ = ps.route_labels(out_lab, in_lab, g)
    assert g * rl > n + 1  # the last stripe is padding past row n
    pa = np.array([0, n, g * rl - 1, 1], np.int32)  # a grant, the pad row, a pad stripe row
    pb = np.array([5, n, g * rl - 1, 2], np.int32)
    pq = np.array([0, 1, 2, 3], np.int32)
    got = ps.label_step(make_mesh(graph=g, device="cpu"), _t(o_sh), _t(i_sh),
                        _t(np.concatenate([pa, pb, pq])), n_pairs=4, B=32, rl=rl)
    assert got.tolist() == [1]
    oa = ps.exchange_pair_rows(_t(o_sh), _t(pa), rl)
    assert oa[2].tolist() == [-1, -1] and oa[0].tolist() == [7, -1]

    # rows no shard owns (negative, at or past g·rl) exchange as 0, never as
    # the nearest stripe's row; the rows at each stripe boundary come from
    # their owner; every pair's decision equals the JAX sharded_label_step's
    import jax.numpy as jnp

    from keto_tpu.parallel import sharded as js

    out_lab[:n, 0] = in_lab[:n, 0] = 100 + np.arange(n)
    o_sh, i_sh, rl, _ = ps.route_labels(out_lab, in_lab, g)
    bounds = sorted({s * rl for s in range(g)} | {s * rl - 1 for s in range(1, g + 1)})
    rows = np.asarray([-1, -rl, g * rl, g * rl + 5, *bounds], np.int32)
    owned = (rows >= 0) & (rows < g * rl)
    for sh in (o_sh, i_sh):
        got = ps.exchange_pair_rows(_t(sh), _t(rows), rl).numpy()
        flat = sh.reshape(g * rl, -1)
        assert np.array_equal(got, np.where(owned[:, None], flat[np.clip(rows, 0, g * rl - 1)], 0))
    pa, pb = np.repeat(rows, rows.size), np.tile(rows, rows.size)
    P = pa.size
    B = -(-P // 32) * 32
    ent = np.concatenate([pa, pb, np.arange(P)]).astype(np.int32)
    want = np.asarray(js.label_kernel(_jax_mesh(g))(jnp.asarray(o_sh), jnp.asarray(i_sh),
                                                    jnp.asarray(ent), n_pairs=P, B=B, rl=rl))
    got = ps.label_step(make_mesh(graph=g, device="cpu"), _t(o_sh), _t(i_sh), _t(ent),
                        n_pairs=P, B=B, rl=rl).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    # a pair hits when both rows are the same real row, or when no shard
    # owns either (0 == 0 in the reference too)
    hit = np.unpackbits(got.view(np.uint8), bitorder="little")[:P].astype(bool)
    real = owned & (rows < n)
    assert np.array_equal(hit, ((pa == pb) & np.repeat(real, rows.size))
                          | (~np.repeat(owned, rows.size) & ~np.tile(owned, rows.size)))


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_label_sweep_step_matches_jax(name, g):
    import jax.numpy as jnp

    from keto_tpu.parallel import sharded as js

    n, caps, rows, wt, prune = SWEEP_CASES[name]
    groups, V, X, S, cov = random_sweep_case(np.random.default_rng(n), n, caps, rows, wt)
    rps = -(-(n + 1) // g)
    routed = ps.route_label_ell(groups, n, g, rps)
    jr = js.route_label_ell(groups, n, g, rps)
    assert all(np.array_equal(a, b) and np.array_equal(c, d) for (a, c), (b, d) in zip(routed, jr))

    def stacked(a):
        o = np.zeros((g * rps, wt), np.int32)
        o[: a.shape[0]] = a
        return o.reshape(g, rps, wt)

    Vs, Xs, Ss, Cs = (stacked(a) for a in (V, X, S, cov))
    u = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
    jV, jX, jS, act, vis = js.label_sweep_kernel(_jax_mesh(g))(
        tuple(jnp.asarray(a) for a, _ in jr), tuple(jnp.asarray(b) for _, b in jr),
        u(Vs), u(Xs), u(Ss), u(Cs), rps=rps, prune_expansion=prune)
    # one wave of the plain sharded sweep: every shard's routed groups in one
    # table, the gathered bitmap read in global rows, each slab written
    flat = lambda a: _t(a.reshape(g * rps, wt).copy())  # noqa: E731
    V2, S2, X2 = flat(Vs), flat(Ss), torch.zeros((g * rps, wt), dtype=torch.int32)
    Xfull = ps.all_gather_rows(list(flat(Xs).view(g, rps, wt)))
    state = torch.zeros(2, dtype=torch.int32)
    label_kernels.sweep_step_into_ref(ps.sweep_ell_groups(routed, rps, "cpu"), Xfull, V2, S2,
                                      flat(Cs), X2, state, n_dst=rps, prune_expansion=prune)
    for mine, ref in ((V2, jV), (X2, jX), (S2, jS)):
        assert np.array_equal(mine.numpy().reshape(g, rps, wt).view(np.uint32), np.asarray(ref))
    assert state.tolist() == [int(bool(act)), int(vis)]


# -- routing ----------------------------------------------------------------------


def _snapshots(seed):
    """The same random store's snapshot from the port and from the reference."""
    from test_torch_overlay import NS, Pair, rand_tuple

    rng = random.Random(seed)
    objs = [f"o{i}" for i in range(12)]
    users = [f"u{i}" for i in range(6)]
    return Pair(NS, [rand_tuple(rng, objs, users) for _ in range(160)]).snapshots()


@pytest.mark.parametrize("g", GS)
def test_routing_matches_jax_byte_for_byte(g):
    from keto_tpu.parallel import sharded as js

    mine, ref = _snapshots(g)
    assert mine.num_int == ref.num_int and mine.num_int > 0
    spec, jspec = ps.make_shard_spec(mine, g), js.make_shard_spec(ref, g)
    for f in ("n_shards", "rows_per_shard", "n_int", "n_active", "owned_bucket_bytes"):
        assert getattr(spec, f) == getattr(jspec, f), f
    for f in ("nbrs_sh", "dst_sh", "bucket_lo"):
        a, b = getattr(spec, f), getattr(jspec, f)
        assert len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                        for x, y in zip(a, b)), f
    assert spec.padded_bucket_bytes() == jspec.padded_bucket_bytes()
    for bi, b in enumerate(mine.buckets):
        for row in range(b.n):
            assert spec.patch_pos(b.offset, bi, row) == jspec.patch_pos(b.offset, bi, row)
    for W in (1, 8):
        assert ps.halo_bytes_per_round(spec, W) == js.halo_bytes_per_round(jspec, W)

    rng = np.random.default_rng(g)
    ni, B = mine.num_int, 64
    rows = lambda k, hi, pad: np.concatenate(  # noqa: E731
        [rng.integers(0, hi, size=k), np.full(B - k, pad)]).astype(np.int32)
    qs = lambda: rng.integers(0, B, size=B).astype(np.int32)  # noqa: E731
    packed = (rows(40, ni + 1, ni + 1), qs(), rows(20, ni + 1, ni + 1), qs(),
              rows(10, ni, ni), qs(), rng.integers(0, ni + 1, size=B).astype(np.int32))
    a, sa = ps.route_entries(spec, packed, B)
    b, sb = js.route_entries(jspec, packed, B)
    assert sa == sb and a.dtype == b.dtype and np.array_equal(a, b)
    buf = np.empty_like(a)
    c, _ = ps.route_entries(spec, packed, B, out=buf)
    assert np.shares_memory(c, buf) and np.array_equal(c, a)

    if mine.num_active:
        dst = np.unique(rng.integers(0, mine.num_active, size=5))
        dst = np.concatenate([dst, [mine.num_active]])  # a pad row no shard owns
        nbrs = rng.integers(0, ni + 1, size=(dst.size, 4)).astype(np.int32)
        x, y = ps.route_overlay(spec, nbrs, dst, mine.num_active), \
            js.route_overlay(jspec, nbrs, dst, mine.num_active)
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) and x[2] == y[2]

    from keto_tpu.graph.label_build import build_ell_groups as jgroups

    from keto_tpu_torch.graph.label_build import build_ell_groups
    from keto_tpu_torch.graph.labels import interior_adjacency

    out_ip, out_ix, in_ip, in_ix = interior_adjacency(mine)
    groups = build_ell_groups(in_ip, in_ix, ni)
    assert all(np.array_equal(p[0], q[0]) and np.array_equal(p[1], q[1])
               for p, q in zip(groups, jgroups(in_ip, in_ix, ni)))
    rps = -(-(ni + 1) // g)
    for p, q in zip(ps.route_label_ell(groups, ni, g, rps), js.route_label_ell(groups, ni, g, rps)):
        assert p[0].dtype == q[0].dtype and np.array_equal(p[0], q[0]) and np.array_equal(p[1], q[1])


def test_shard_row_ranges_matches_jax():
    from keto_tpu.graph.device_build import shard_row_ranges as jranges

    from keto_tpu_torch.graph.device_build import shard_row_ranges

    for n in (0, 1, 7, 10, 64, 123_950):
        for g in (1, 2, 3, 4, 8):
            assert shard_row_ranges(n, g) == jranges(n, g)


# -- the CUDA entry points against their plain versions -------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g", (1, 2, 3, 4))
@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_check_step_cuda_matches_plain(name, g, cuda_device):
    _, (spec, ent, ov, kw) = _shard_case(name, g)
    mesh = make_mesh(graph=g, device=cuda_device)
    bk = ps.ShardedBuckets.from_spec(spec, cuda_device)
    args = [x if x is None else x.to(cuda_device)
            for x in (_t(ent), *((None, None) if ov is None else (_t(ov[0]), _t(ov[1]))))]
    got = ps.check_step_cuda(mesh, bk, *args, **kw)
    want = ps.check_step_ref(mesh, bk, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)



@pytest.mark.cuda
@pytest.mark.parametrize("g", (1, 2, 3, 4))
@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_sharded_run_cuda_matches_plain(name, g, cuda_device):
    """K10a's fixpoint: ONE keto_check_run over every shard (a halo copy
    each step run) into a sentinel-filled P, against the plain run
    (``shard_run_ref``): every word of R and of P's active rows, the state's
    {changed at exit, steps}, the steps and halo copies the card counted;
    and the whole step with no host read."""
    _, (spec, ent, ov, kw) = _shard_case(name, g)
    g_, rps, W = ent.shape[0], kw["rps"], kw["B"] // 32
    bk = ps.ShardedBuckets.from_spec(spec, cuda_device)
    plan = ps.shard_runs(bk, g, rps, W)
    n_active = plan.n_rows
    ent_d = _t(ent).to(cuda_device)
    R0 = torch.zeros((g * rps, W), dtype=torch.int32, device=cuda_device)
    for s in range(g):
        R0[s * rps : (s + 1) * rps] = kernels.seed_ref(ent_d[s], kw["sizes"], rps - 1, W)[0]
    Rc, Rr = R0.clone(), R0.clone()
    Pc = torch.full((g * rps, W), SENTINEL, dtype=torch.int32, device=cuda_device)
    Pc[n_active:] = 0
    Pr = torch.zeros_like(Pc)
    ovn, ovd = (None, None) if ov is None else (_t(ov[0]).to(cuda_device),
                                                _t(ov[1]).to(cuda_device))
    loop = dict(it_cap=kw["it_cap"], block_iters=kw["block_iters"])
    kernels.reset_run_counts()
    state = kernels.check_run_cuda(plan, Rc, Pc, G=torch.empty_like(Rc),
                                   ov=kernels.RunOverlay.of(ovn, ovd, rps, rps), **loop)
    steps, copies = kernels.run_counts(cuda_device)
    want = ps.shard_run_ref(plan, Rr, Pr, ovn, ovd, rps=rps, **loop)
    torch.cuda.synchronize()
    assert state[:2].tolist() == want[:2].tolist()
    assert steps == copies == int(want[1])  # a halo copy a step run
    assert torch.equal(Rc, Rr) and torch.equal(Pc, Pr)

    mesh = make_mesh(graph=g, device=cuda_device)
    args = [x if x is None else x.to(cuda_device)
            for x in (_t(ent), *((None, None) if ov is None else (_t(ov[0]), _t(ov[1]))))]
    before = dict(kernels.COUNTS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ps.check_step_cuda(mesh, bk, *args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counted = {k: kernels.COUNTS[k] - before[k] for k in ("seed", "check_run", "shard_answer",
                                                          "pull", "answer_pack")}
    assert counted == {"seed": g, "check_run": 1, "shard_answer": 1, "pull": 0, "answer_pack": 0}
    assert torch.equal(got, ps.check_step_ref(mesh, bk, *args, **kw))
    # the run's counter: the commits' newly set bits, as the plain run's
    Rc, Rr = R0.clone(), R0.clone()
    pc = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    pr = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    kernels.check_run_cuda(plan, Rc, torch.zeros_like(Rc), G=torch.empty_like(Rc),
                           ov=kernels.RunOverlay.of(ovn, ovd, rps, rps), pop=pc, **loop)
    ps.shard_run_ref(plan, Rr, torch.zeros_like(Rr), ovn, ovd, rps=rps, pop=pr, **loop)
    torch.cuda.synchronize()
    assert torch.equal(Rc, Rr) and pc.tolist() == pr.tolist()
    fresh = int(label_kernels._popcount(Rc).sum()) - int(label_kernels._popcount(R0).sum())
    assert int(pc) & 0xFFFFFFFF == fresh & 0xFFFFFFFF


def _shard_answer_inputs(case, dev):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(case["entries"]), case["sizes"], t(case["P"]), t(case["ans_base"]), t(case["R"]),
            case["rps"])


#: (kind, g, W, n_int): every answer layout at g = 1..8 at narrow and odd
#: widths, and config 3's width over 4 shards
SHARD_ANSWER_CASES = [(k, g, (1, 3, 5, 8)[g % 4], 96) for k in ANSWER_KINDS
                      for g in range(1, 9)] + [("random", 4, 4096, 4095),
                                               ("unowned", 4, 4096, 4095)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g,W,n_int", SHARD_ANSWER_CASES)
def test_shard_answer_cuda_matches_plain(kind, g, W, n_int, cuda_device):
    """ONE ``keto_shard_answer`` launch over every shard against
    ``shard_answer_ref``, word for word: the bits, iters and truncated,
    and the frontier-bit word left as the seeds and the run counted it."""
    case = random_answer_case(np.random.default_rng(g * 10 + W), kind, W, n_int=n_int, g=g)
    ent, sizes, P, ab, R, rps = _shard_answer_inputs(case, cuda_device)
    state = torch.tensor([0, 5, 0], dtype=torch.int32, device=cuda_device)
    out = torch.zeros(W + 3, dtype=torch.int32, device=cuda_device)
    out[W + 2] = -123  # what the seeds and the run counted
    before = kernels.COUNTS["shard_answer"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ps.shard_answer_cuda(ent, sizes, P, ab, R, rps, state, out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.COUNTS["shard_answer"] - before == 1
    want = ps.shard_answer_ref(ent, sizes, P, ab, R, rps, 5, False, (-123) & 0xFFFFFFFF)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    if kind == "all-hit":
        assert int(out[W // 2]) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("g", (1, 3, 4))
@pytest.mark.parametrize("name", sorted(LABEL_CASES))
def test_label_step_cuda_matches_plain(name, g, cuda_device):
    n, Wo, Wi, W, pairs = LABEL_CASES[name]
    out_lab, in_lab, ent, P, B = random_label_case(np.random.default_rng(n + Wo), n, Wo, Wi, W,
                                                   pairs)
    o_sh, i_sh, rl, _ = ps.route_labels(out_lab, in_lab, g)
    want = ps.label_step(make_mesh(graph=g, device="cpu"), _t(o_sh), _t(i_sh), _t(ent),
                         n_pairs=P, B=B, rl=rl)
    before = kernels.COUNTS["pair_rows"]
    got = ps.label_step(make_mesh(graph=g, device=cuda_device), _t(o_sh).to(cuda_device),
                        _t(i_sh).to(cuda_device), _t(ent).to(cuda_device), n_pairs=P, B=B, rl=rl)
    assert torch.equal(got.cpu(), want)
    assert kernels.COUNTS["pair_rows"] - before == 2  # one launch per side
    for sh, rows in ((o_sh, ent[:P]), (i_sh, ent[P : 2 * P])):
        a = ps.pair_rows_ref(_t(sh), _t(rows), rl)
        b = ps.pair_rows_cuda(_t(sh).to(cuda_device), _t(rows).to(cuda_device), rl)
        assert torch.equal(b.cpu(), a)


def _label_sweep_case(name, g, dev):
    """(merged routed groups, X0, cov, rps, prune) of a SWEEP_CASES layout
    over g shards on ``dev``: slabs of rps rows, the routing's padding rows
    (dst = rps) dropped."""
    n, caps, rows, wt, prune = SWEEP_CASES[name]
    groups, _, X0, _, cov = random_sweep_case(np.random.default_rng(n), n, caps, rows, wt)
    rps = -(-(n + 1) // g)

    def slabs(a):
        o = np.zeros((g * rps, wt), np.int32)
        o[: a.shape[0]] = a
        return _t(o).to(dev)

    merged = ps.sweep_ell_groups(ps.route_label_ell(groups, n, g, rps), rps, dev)
    return merged, slabs(X0), slabs(cov), rps, prune


@pytest.mark.cuda
@pytest.mark.parametrize("g", (1, 2, 3, 4))
@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_label_sweep_cuda_matches_plain(name, g, cuda_device):
    """K10c's whole sweep: every shard in one keto_sweep_run launch with the
    halo copy between waves, against the plain slabs, at several budgets."""
    runs = {}
    for dev in ("cpu", cuda_device):
        merged, X0, cov, rps, prune = _label_sweep_case(name, g, dev)
        mesh = make_mesh(graph=g, device=dev)
        runs[dev] = lambda b, m=merged, X=X0, c=cov, mesh=mesh: ps.label_sweep(
            mesh, m, X, c, rps=rps, prune_expansion=prune, budget=b)
    _, _, visits, _ = runs["cpu"](None)
    for budget in (None, visits, visits - 1, visits // 2):
        want = runs["cpu"](budget)
        got = runs[cuda_device](budget)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:], budget


@pytest.mark.cuda
def test_label_sweep_cuda_refuses_a_ragged_layout(cuda_device):
    merged, X0, cov, rps, _ = _label_sweep_case("prune-wt1", 3, cuda_device)
    with pytest.raises(ValueError):
        ps.label_sweep(make_mesh(graph=3, device=cuda_device), merged, X0[:-1], cov[:-1],
                       rps=rps)
