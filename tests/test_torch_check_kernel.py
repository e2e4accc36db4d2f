"""Check kernels of the PyTorch port against the JAX reference, word for word.

``check_step_ref`` (keto_tpu_torch/check/kernels.py) must equal
``keto_tpu.check.tpu_engine.check_step`` on the whole ``uint32[W+2]``
output — decision bits, iteration count and truncation flag — over random
bucket layouts made with numpy from a seed; ``pull_ref`` must equal
``_pull``. Both run through the port's dispatchers, which take the plain
version for CPU tensors. The layouts take narrow and odd widths (W = 1, 3,
5), caps past 1,024 and it_cap cuts inside a block of steps. The host-side
run table (``pull_runs``) is tested on the CPU: its arrays, and its
refusals (too many runs, a ragged layout, sizes past 32-bit indexing); so
is a failed run or answer launch, through a library that refuses it, and
every entry point's ctypes signature against its C declaration. The
``cuda`` tests hold the CUDA kernels (K1's ``keto_pull``, K2's
``keto_check_run``, ``keto_answer_pack`` on the answer layouts of
``random_answer_case``, the seeds' and the run's frontier-bit counters,
the whole step, and the write path's slot set, K9) against the plain
versions on the card, into sentinel-filled outputs, and skip where there
is none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch import _build
from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import (
    ANSWER_KINDS,
    SENTINEL,
    RefusingLib,
    random_answer_case,
    random_buckets,
    random_case,
    random_slot_case,
)


def _case(seed, **kw):
    return random_case(np.random.default_rng(seed), **kw)


CASES = {
    "w1-small-caps": dict(seed=0, W=1, caps=(1, 2, 4), rows=(9, 7, 5)),
    "w8-cap2048": dict(seed=1, W=8, caps=(1, 2048), rows=(20, 3), n_int=80, block_iters=3),
    "w64-overlay": dict(seed=2, W=64, caps=(1, 4, 16), rows=(12, 8, 4), overlay=True, block_iters=1),
    "w256-overlay": dict(seed=3, W=256, caps=(1, 2), rows=(10, 6), n_int=40, overlay=True),
    "chain-trunc-cap3-b1": dict(seed=4, W=8, caps=(1,), rows=(30,), it_cap=3, block_iters=1, chain=True),
    "chain-trunc-cap5-b3": dict(seed=5, W=8, caps=(1,), rows=(30,), it_cap=5, block_iters=3, chain=True),
    "chain-trunc-cap2-b8": dict(seed=6, W=1, caps=(1,), rows=(30,), it_cap=2, block_iters=8, chain=True),
    "chain-converge-overlay": dict(seed=7, W=8, caps=(1,), rows=(25,), block_iters=3, chain=True, overlay=True),
    "n-active-0": dict(seed=8, W=8, n_int=30),
    "w1-n-active-0": dict(seed=9, W=1, n_int=5),
    "w3-odd": dict(seed=10, W=3, caps=(1, 2, 8), rows=(14, 9, 4), n_int=40),
    "w5-cap1100-overlay": dict(seed=11, W=5, caps=(1, 1100), rows=(18, 2), n_int=60,
                               overlay=True, block_iters=2),
    "w1-cap4096": dict(seed=12, W=1, caps=(2, 4096), rows=(10, 2), n_int=50),
    "chain-trunc-cap7-b4-w5": dict(seed=13, W=5, caps=(1,), rows=(30,), it_cap=7, block_iters=4,
                                   chain=True),
}


def _jax_check(buckets, entries, ov, kw):
    import jax.numpy as jnp

    from keto_tpu.check.tpu_engine import _check_kernel

    out = _check_kernel(
        tuple(jnp.asarray(b) for b in buckets),
        jnp.asarray(entries),
        ov_nbrs=None if ov is None else jnp.asarray(ov[0]),
        ov_dst=None if ov is None else jnp.asarray(ov[1]),
        **kw,
    )
    return np.asarray(out)


def _torch_args(buckets, entries, ov, device):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (
        [t(b) for b in buckets],
        t(entries),
        None if ov is None else t(ov[0]),
        None if ov is None else t(ov[1]),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_step_matches_jax(name):
    buckets, entries, ov, kw = _case(**CASES[name])
    want = _jax_check(buckets, entries, ov, kw)
    nb, ent, ovn, ovd = _torch_args(buckets, entries, ov, "cpu")
    got = kernels.check_step(nb, ent, ovn, ovd, **kw).numpy().view(np.uint32)
    assert got.shape == want.shape
    assert np.array_equal(got, want), (
        f"{np.count_nonzero(got != want)} words differ; tail port={got[-2:]} jax={want[-2:]}"
    )
    if name.startswith("chain-trunc"):
        assert want[-1] == 1, "the case must truncate"


@pytest.mark.parametrize(
    "W,caps,rows",
    [(1, (1, 2, 8), (9, 6, 3)), (8, (1, 2048), (17, 2)), (64, (4, 32), (5, 6)),
     (3, (1, 2, 1100), (9, 6, 2)), (5, (1, 4), (12, 5))],
)
def test_pull_matches_jax(W, caps, rows):
    import jax.numpy as jnp

    from keto_tpu.check.tpu_engine import _pull

    rng = np.random.default_rng(W)
    n_int = 50
    buckets = random_buckets(rng, n_int, caps, rows)
    R = rng.integers(0, 2**32, size=(n_int + 1, W), dtype=np.uint64).astype(np.uint32)
    R[n_int] = 0
    want = np.asarray(_pull(tuple(jnp.asarray(b) for b in buckets), rows, jnp.asarray(R)))
    got = kernels.pull(
        [torch.from_numpy(b) for b in buckets], rows, torch.from_numpy(R.view(np.int32))
    ).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_dispatch_refuses_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.check_step([], t, sizes=(0, 0, 0, 4), n_active=0, n_int=0,
                           valid_rows=(), it_cap=1)


def _nb(caps, rows, n_int=30, seed=0):
    return [torch.from_numpy(b) for b in random_buckets(np.random.default_rng(seed), n_int, caps,
                                                         rows)]


def test_bucket_runs_table():
    nb = _nb((1, 4, 2048), (7, 0, 3))
    plan = kernels.bucket_runs(nb, (7, 0, 3), src_rows=31, W=5)
    assert plan.rows == (7, 3) and plan.out == (0, 7) and plan.n_rows == 10
    assert [t.data_ptr() for t in plan.nbrs] == [nb[0].data_ptr(), nb[2].data_ptr()]
    ptrs, rows, caps, outs, n = plan.args()
    assert n == 2 and list(ptrs[:2]) == [t.data_ptr() for t in plan.nbrs]
    assert list(rows[:2]) == [7, 3] and list(caps[:2]) == [1, 2048] and list(outs[:2]) == [0, 7]
    assert kernels.bucket_runs([], (), src_rows=31, W=5).n_rows == 0


@pytest.mark.parametrize("what", ["too-many", "ragged-gap", "ragged-overlap", "rows", "dtype",
                                  "int32-bitmap", "int32-matrix"])
def test_pull_runs_refuses(what):
    nb = _nb((1, 2), (4, 3))[0]
    runs = [(nb, 4, 0), (nb, 3, 4)]
    src_rows, W = 31, 8
    if what == "too-many":
        runs = [(nb, 1, i) for i in range(kernels.MAX_RUNS + 1)]
    elif what == "ragged-gap":
        runs = [(nb, 4, 0), (nb, 3, 5)]
    elif what == "ragged-overlap":
        runs = [(nb, 4, 0), (nb, 3, 3)]
    elif what == "rows":
        runs = [(nb, nb.shape[0] + 1, 0)]
    elif what == "dtype":
        runs = [(nb.long(), 4, 0)]
    elif what == "int32-bitmap":
        W = 2**31 // 16
    else:
        # a matrix of 2^31 words, on the meta device (no storage)
        runs = [(torch.empty((2**16, 2**15), dtype=torch.int32, device="meta"), 4, 0)]
    with pytest.raises(ValueError):
        kernels.pull_runs(runs, src_rows=src_rows, W=W)


def test_failed_check_run_launch_raises_and_is_counted(monkeypatch):
    monkeypatch.setattr(kernels, "_lib", lambda: RefusingLib("keto_check_run"))
    monkeypatch.setattr(kernels, "_need", lambda *a: None)
    monkeypatch.setattr(kernels, "_stream", lambda: 0)
    buckets, entries, ov, kw = _case(**CASES["w64-overlay"])
    nb, ent, ovn, ovd = _torch_args(buckets, entries, ov, "cpu")
    before = dict(kernels.COUNTS)
    with pytest.raises(RuntimeError, match="keto_check_run"):
        kernels.check_step_cuda(nb, ent, ovn, ovd, **kw)
    counted = {k: kernels.COUNTS[k] - before[k] for k in kernels.COUNTS}
    assert {k: v for k, v in counted.items() if v} == {"seed": 1, "check_run": 1,
                                                       "check_run_overlay": 1}


def test_failed_answer_pack_launch_raises_and_is_counted(monkeypatch):
    monkeypatch.setattr(kernels, "_lib", lambda: RefusingLib("keto_answer_pack"))
    monkeypatch.setattr(kernels, "_need", lambda *a: None)
    monkeypatch.setattr(kernels, "_stream", lambda: 0)
    buckets, entries, ov, kw = _case(**CASES["w64-overlay"])
    nb, ent, ovn, ovd = _torch_args(buckets, entries, ov, "cpu")
    before = dict(kernels.COUNTS)
    with pytest.raises(RuntimeError, match="keto_answer_pack"):
        kernels.check_step_cuda(nb, ent, ovn, ovd, **kw)
    counted = {k: kernels.COUNTS[k] - before[k] for k in kernels.COUNTS}
    assert {k: v for k, v in counted.items() if v} == {"seed": 1, "check_run": 1,
                                                       "check_run_overlay": 1, "answer_pack": 1}


def _c_params(name: str) -> list:
    """The parameters of ``extern "C" int name(...)`` in csrc/*.cu."""
    import re

    for src in _build.sources():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src.read_text())
        if m:
            return [a for a in (x.strip() for x in m.group(1).split(",")) if a and a != "void"]
    raise AssertionError(f"no entry point {name} in {_build.CSRC}")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_the_sources(name):
    """ctypes passes what ``_SIGNATURES`` says: a pointer for each pointer
    (and the stream), a 64- or 32-bit int for each int, in the C order."""
    import ctypes

    params = _c_params(name)
    sig = _build._SIGNATURES[name]
    assert len(params) == len(sig), (params, sig)
    for decl, t in zip(params, sig):
        want = (ctypes.c_void_p if "*" in decl else ctypes.c_int64 if decl.startswith("int64_t")
                else ctypes.c_int32)
        assert t is want, (decl, t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")



@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_check_step_cuda_matches_plain(name, cuda_device):
    """The whole step: the seeds, ONE keto_check_run launch (none without
    active rows) and the answer, with no host read in between."""
    buckets, entries, ov, kw = _case(**CASES[name])
    args = _torch_args(buckets, entries, ov, cuda_device)
    before = dict(kernels.COUNTS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernels.check_step_cuda(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counted = {k: kernels.COUNTS[k] - before[k] for k in kernels.BFS_KERNELS}
    want = kernels.check_step_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert counted == {"seed": 1, "check_run": int(bool(kw["n_active"])), "answer_pack": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in sorted(CASES) if CASES[n].get("rows")])
def test_pull_and_run_cuda_match_plain(name, cuda_device):
    """keto_pull alone and keto_check_run, each into a sentinel-filled P,
    against their plain versions: every word of R and of P's run rows, the
    state's {changed at exit, steps}, and the steps the card counted."""
    buckets, entries, ov, kw = _case(**CASES[name])
    nb, ent, ovn, ovd = _torch_args(buckets, entries, ov, cuda_device)
    n_active, n_int, W = kw["n_active"], kw["n_int"], kw["sizes"][3] // 32
    rng = np.random.default_rng(len(name))
    R = torch.from_numpy(rng.integers(0, 2**32, size=(n_int + 1, W), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).to(cuda_device)
    R[n_int] = 0
    P = torch.full((n_active + 3, W), SENTINEL, dtype=torch.int32, device=cuda_device)
    before = kernels.COUNTS["pull"]
    got = kernels.pull_cuda(nb, kw["valid_rows"], R, P=P)
    assert kernels.COUNTS["pull"] - before == 1  # one launch over every bucket
    torch.cuda.synchronize()
    assert torch.equal(got[:n_active], kernels.pull_ref(nb, kw["valid_rows"], R))
    assert (got[n_active:] == SENTINEL).all()

    R0, _ = kernels.seed_ref(ent, kw["sizes"], n_int, W)
    Rc, Rr = R0.clone(), R0.clone()
    Pc = torch.full((n_active + 1, W), SENTINEL, dtype=torch.int32, device=cuda_device)
    Pc[n_active] = 0
    Pr = torch.zeros_like(Pc)
    plan = kernels.bucket_runs(nb, kw["valid_rows"], src_rows=n_int + 1, W=W)
    kernels.reset_run_counts()
    state = kernels.check_run_cuda(plan, Rc, Pc, ov=kernels.RunOverlay.of(ovn, ovd, n_active),
                                   it_cap=kw["it_cap"], block_iters=kw["block_iters"])
    steps, copies = kernels.run_counts(cuda_device)
    want = kernels.check_run_ref(nb, kw["valid_rows"], Rr, Pr, ovn, ovd, it_cap=kw["it_cap"],
                                 block_iters=kw["block_iters"])
    torch.cuda.synchronize()
    assert state[:2].tolist() == want[:2].tolist()
    assert (steps, copies) == (int(want[1]), 0)
    assert torch.equal(Rc, Rr) and torch.equal(Pc, Pr)

    # a measured bare launch computes the same and stamps each step's phases in order
    Rs, Ps = R0.clone(), torch.full_like(Pc, SENTINEL)
    Ps[n_active] = 0
    ctl = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    stamps = torch.zeros((int(want[1]), kernels.RUN_STAMPS), dtype=torch.int64,
                         device=cuda_device)
    assert kernels.run_launch(kernels._lib(), plan, Rs, Ps, ctl,
                              ov=kernels.RunOverlay.of(ovn, ovd, n_active), it_cap=kw["it_cap"],
                              block_iters=kw["block_iters"], stamps=stamps,
                              stream=kernels._stream()) == 0
    torch.cuda.synchronize()
    assert ctl[:2].tolist() == want[:2].tolist()
    assert torch.equal(Rs, Rr) and torch.equal(Ps, Pr)
    assert (stamps > 0).all() and (stamps.diff(dim=1) >= 0).all()


def _answer_inputs(case, dev):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(case["entries"]), case["sizes"], case["n_active"], t(case["P"]),
            t(case["ans_base"]), t(case["R"]))


#: (kind, W, n_int, n_active): the answer layouts at narrow and odd widths,
#: a wide one, and config 3's width with about as many sink entries as
#: config 3's 100k checks give (2·B + 7)
ANSWER_CASES = [(k, W, 96, 64) for k in ANSWER_KINDS if k != "unowned" for W in (1, 3, 5, 64)] \
    + [("random", 4096, 4095, 3000), ("one-word-sinks", 4096, 4095, 3000)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,W,n_int,n_active", ANSWER_CASES)
def test_answer_pack_cuda_matches_plain(kind, W, n_int, n_active, cuda_device):
    """``keto_answer_pack``, ONE launch, against ``answer_pack_ref``, word for
    word, with and without a run's state."""
    case = random_answer_case(np.random.default_rng(W + len(kind)), kind, W, n_int=n_int,
                              n_active=n_active)
    args = _answer_inputs(case, cuda_device)
    state = torch.tensor([1, 7, 0], dtype=torch.int32, device=cuda_device)
    before = kernels.COUNTS["answer_pack"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernels.answer_pack_cuda(*args, state)
        got0 = kernels.answer_pack_cuda(*args, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.COUNTS["answer_pack"] - before == 2
    assert torch.equal(got, kernels.answer_pack_ref(*args, 7, True))
    assert torch.equal(got0, kernels.answer_pack_ref(*args, 0, False))
    if kind == "all-hit":
        assert int(got[W // 2]) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in sorted(CASES) if CASES[n].get("rows")]
                         + ["dup-seeds"])
def test_seed_and_run_count_the_frontier_bits(name, cuda_device):
    """``keto_seed`` and ``keto_check_run`` with a counter: it ends equal to
    popcount(R) after the run (mod 2^32) and to the plain versions' count;
    an entry seeded twice (in e1, and in e1 and e2) counts once. Without a
    counter the seeds and the run compute the same R."""
    buckets, entries, ov, kw = _case(**CASES["w64-overlay" if name == "dup-seeds" else name])
    S1, S2 = kw["sizes"][:2]
    if name == "dup-seeds":
        live = np.flatnonzero(entries[:S1] <= kw["n_int"])
        pads = np.flatnonzero(entries[:S1] > kw["n_int"])
        pads2 = 2 * S1 + np.flatnonzero(entries[2 * S1 : 2 * S1 + S2] > kw["n_int"])
        for dst, src in ((pads[0], live[0]), (pads[1], live[1]), (pads2[0], live[2])):
            off = S1 if dst < S1 else S2
            entries[dst], entries[dst + off] = entries[src], entries[src + S1]
    nb, ent, ovn, ovd = _torch_args(buckets, entries, ov, cuda_device)
    n_active, n_int, W = kw["n_active"], kw["n_int"], kw["sizes"][3] // 32
    pop = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    R, _ = kernels.seed_cuda(ent, kw["sizes"], n_int, W, pop=pop)
    R0, _ = kernels.seed_cuda(ent, kw["sizes"], n_int, W)
    want_pop = torch.zeros(1, dtype=torch.int32)
    Rr, _ = kernels.seed_ref(ent.cpu(), kw["sizes"], n_int, W, pop=want_pop)
    torch.cuda.synchronize()
    assert torch.equal(R.cpu(), Rr) and torch.equal(R0, R)
    assert pop.tolist() == want_pop.tolist()
    assert int(pop) & 0xFFFFFFFF == int(kernels._popcount(R).sum()) & 0xFFFFFFFF
    plan = kernels.bucket_runs(nb, kw["valid_rows"], src_rows=n_int + 1, W=W)
    loop = dict(it_cap=kw["it_cap"], block_iters=kw["block_iters"])
    P = kernels.pull_out(n_active + 1, W, n_active, kw["it_cap"], cuda_device)
    P0 = P.clone()
    ovl = kernels.RunOverlay.of(ovn, ovd, n_active)
    kernels.check_run_cuda(plan, R, P, ov=ovl, pop=pop, **loop)
    kernels.check_run_cuda(plan, R0, P0, ov=ovl, **loop)
    Pr = torch.zeros((n_active + 1, W), dtype=torch.int32)
    kernels.check_run_ref([b.cpu() for b in nb], kw["valid_rows"], Rr, Pr,
                          None if ovn is None else ovn.cpu(), None if ovd is None else ovd.cpu(),
                          pop=want_pop, **loop)
    torch.cuda.synchronize()
    assert torch.equal(R.cpu(), Rr) and torch.equal(R0, R)
    assert pop.tolist() == want_pop.tolist()
    assert int(pop) & 0xFFFFFFFF == int(kernels._popcount(R).sum()) & 0xFFFFFFFF


#: K9 layouts of the write path: (rows, ld, entries, duplicates, 1-D, in place)
SLOT_CASES = {
    "bucket-patch": (4096, 1, 64, False, False, False),
    "bucket-cap8": (512, 8, 200, False, False, False),
    "overlay-rows": (64, 8, 24, False, False, False),
    "overlay-dst": (64, 1, 24, False, True, False),
    "mirror-in-place": (3000, 64, 2000, False, False, True),
    "empty": (100, 4, 0, False, False, False),
    "duplicates": (200, 16, 500, True, False, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLOT_CASES))
def test_slot_set_cuda_matches_plain(name, cuda_device):
    n, ld, m, dup, one_d, in_place = SLOT_CASES[name]
    buf, r, c, v = random_slot_case(np.random.default_rng(len(name)), n, ld, m, dup=dup, one_d=one_d)
    a = torch.from_numpy(buf.copy()).to(cuda_device)
    b = torch.from_numpy(buf.copy()).to(cuda_device)
    got = kernels.slot_set_cuda(a, r, c, v, in_place=in_place)
    want = kernels.slot_set_ref(b, r, c, v, in_place=in_place)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if in_place:
        assert got.data_ptr() == a.data_ptr()
    else:
        assert np.array_equal(a.cpu().numpy(), buf), "a functional slot set wrote its target"


@pytest.mark.cuda
@pytest.mark.parametrize("in_place", [False, True])
def test_slot_set_many_cuda_matches_plain(in_place, cuda_device):
    """Every target of one call in ONE keto_slot_set launch: targets over
    many tiles (SLOT_TILE words a block), 1-D and 2-D, duplicates, an
    empty entry list, and tiles cut by the target's end."""
    rng = np.random.default_rng(9)
    shapes = [(40000, 1, 900, False, False), (3000, 64, 5000, False, False),
              (4097, 1, 40, True, True), (100, 4, 0, False, False), (1031, 3, 700, True, False)]
    cases = [random_slot_case(rng, n, ld, m, dup=dup, one_d=one_d)
             for n, ld, m, dup, one_d in shapes]
    got_in = [torch.from_numpy(c[0].copy()).to(cuda_device) for c in cases]
    want_in = [torch.from_numpy(c[0].copy()).to(cuda_device) for c in cases]
    before = kernels.COUNTS["slot_set"]
    got = kernels.slot_set_many_cuda([(g, *c[1:]) for g, c in zip(got_in, cases)],
                                     in_place=in_place)
    assert kernels.COUNTS["slot_set"] - before == 1
    want = kernels.slot_set_many_ref([(w, *c[1:]) for w, c in zip(want_in, cases)],
                                     in_place=in_place)
    torch.cuda.synchronize()
    for g, w, a, c in zip(got, want, got_in, cases):
        assert torch.equal(g, w)
        if in_place:
            assert g.data_ptr() == a.data_ptr()
        else:
            assert np.array_equal(a.cpu().numpy(), c[0]), "a functional slot set wrote its target"


@pytest.mark.cuda
def test_slot_set_cuda_raises_out_of_range(cuda_device):
    buf = torch.zeros((8, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="outside"):
        kernels.slot_set_cuda(buf, [1, 8], [0, 0], [5, 6])
    with pytest.raises(ValueError, match="outside"):
        kernels.slot_set_cuda(buf, [1], [4], [5])
    other = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    before = kernels.COUNTS["slot_set"]
    with pytest.raises(ValueError, match="outside"):
        kernels.slot_set_many_cuda([(other, [3], None, [7]), (buf, [2], [4], [5])],
                                   in_place=True)
    assert kernels.COUNTS["slot_set"] == before and not other.any() and not buf.any()
