"""The snapshot build's stable argsort (K8) against numpy and the JAX package.

- ``radix_argsort_ref`` (the plain version; the dispatcher on CPU tensors)
  equals ``np.argsort(kind="stable")`` and the JAX ``DeviceSorter`` on
  JAX-CPU over K8's layouts: empty, one key, all keys equal, negative keys,
  a length that is not a multiple of the tile, random int32, config 4's
  key range at a test's count, keys whose middle digit is constant, and
  the build's bucket keys;
- ``radix_pass_plan`` skips exactly the passes whose digit is constant, on
  every layout;
- the sign bias (negative keys order first) and stability are pinned on
  their own;
- the port's sorters (``DeviceSorter`` on the CPU, ``GovernedSorter`` with
  its size gate and counters) keep the reference's contract: int64 keys in
  int32 range sort as int32, a key outside raises ``OverflowError``, a
  failed device sort raises and counts;
- ``layout_snapshot`` through the port's sorter with ``min_size=0`` (so the
  radix path runs) is byte-identical to the host build and to
  ``keto_tpu``'s build on fuzz graphs.

The ``cuda`` tests hold the CUDA kernel against the plain version.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from keto_tpu_torch.check.random_layouts import SORT_CASES, sort_case_keys
from keto_tpu_torch.graph import sort_kernels
from keto_tpu_torch.graph.device_build import (
    DEFAULT_MIN_EDGES,
    DeviceSorter,
    GovernedSorter,
    HostSorter,
    estimate_sort_bytes,
)
from keto_tpu_torch.graph.sort_kernels import TILE, radix_argsort, radix_argsort_ref
from keto_tpu_torch.graph.snapshot import build_snapshot

from test_torch_snapshot import NAMESPACES, fuzz_case, jax_store, port_store, wild_ids


def _keys(case: str, rng: np.random.Generator) -> np.ndarray:
    return sort_case_keys(case, rng, tile=TILE)


K8_LAYOUTS = SORT_CASES


@pytest.mark.parametrize("case", K8_LAYOUTS)
def test_radix_ref_matches_numpy_and_jax(case):
    from keto_tpu.graph.device_build import DeviceSorter as JaxSorter

    keys = _keys(case, np.random.default_rng(K8_LAYOUTS.index(case)))
    got = radix_argsort_ref(torch.from_numpy(keys)).numpy()
    assert got.dtype == np.int32
    want = np.argsort(keys, kind="stable")
    assert np.array_equal(got, want)
    (jax_perm,) = JaxSorter().argsort_many([keys])
    assert np.array_equal(got.astype(np.int64), jax_perm)
    # the dispatcher takes the plain version on a CPU tensor
    assert np.array_equal(radix_argsort(torch.from_numpy(keys)).numpy(), got)


#: the passes ``radix_pass_plan`` runs on each layout: a pass whose digit is
#: the same for every key is skipped
K8_PLANS = {
    "empty": [], "one key": [], "all equal": [], "negative": [0, 1, 2, 3],
    "ragged tile": [0, 1], "random int32": [0, 1, 2, 3], "config-4 range": [0, 1, 2],
    "sparse digits": [0, 2, 3], "bucket keys": [0],
}


@pytest.mark.parametrize("case", K8_LAYOUTS)
def test_radix_pass_plan(case):
    keys = _keys(case, np.random.default_rng(K8_LAYOUTS.index(case)))
    hist = sort_kernels.radix_hist_ref(torch.from_numpy(keys))
    assert hist.shape == (sort_kernels.PASSES, sort_kernels.DIGITS)
    assert (hist.sum(1) == keys.size).all()
    assert sort_kernels.radix_pass_plan(hist) == K8_PLANS[case]
    # the plan reads the histograms as the card copies them back: int32
    assert sort_kernels.radix_pass_plan(hist.to(torch.int32).numpy()) == K8_PLANS[case]


def test_radix_kernel_bytes():
    """44 bytes a key with 3 passes run (the build's node ids), 60 with 4,
    12 with 1: the first pass reads no index, the last writes no key."""
    assert sort_kernels.kernel_bytes(10, 3) == 440
    assert sort_kernels.kernel_bytes(10, 4) == 600
    assert sort_kernels.kernel_bytes(10, 1) == 120
    assert sort_kernels.kernel_bytes(10, 0) == 40


def test_radix_argsort_many_matches_numpy_per_array():
    """The batch dispatcher on CPU tensors: one plain sort per array, every
    plan's shape among them (no pass, one pass, a skipped middle pass)."""
    rng = np.random.default_rng(9)
    arrays = [_keys(c, rng) for c in ("one key", "bucket keys", "sparse digits", "empty")]
    got = sort_kernels.radix_argsort_many([torch.from_numpy(a) for a in arrays])
    assert len(got) == len(arrays)
    for g, a in zip(got, arrays):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.argsort(a, kind="stable"))


def test_radix_sign_bias_orders_negative_keys_first():
    """The sign bit is flipped before the digits are read: without it every
    negative key (top bit set) would sort after every positive one."""
    keys = np.asarray([5, -1, 0, 2**31 - 1, -(2**31), -2, 1, -(2**31), 256, -256], np.int32)
    perm = radix_argsort_ref(torch.from_numpy(keys)).numpy()
    assert keys[perm].tolist() == sorted(keys.tolist())
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))


def test_radix_is_stable_across_tiles_and_digits():
    """Equal keys keep input order, across tile boundaries and when only a
    high digit differs."""
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 3, size=4 * TILE) << 24
    keys = (hi | (rng.integers(0, 2, size=4 * TILE) << 8)).astype(np.int32)
    perm = radix_argsort_ref(torch.from_numpy(keys)).numpy()
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))
    for v in np.unique(keys):
        pos = perm[keys[perm] == v]
        assert np.all(np.diff(pos) > 0)


def test_radix_ref_rejects_other_dtypes():
    with pytest.raises(ValueError):
        radix_argsort_ref(torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("sorter", ["device", "governed"])
def test_port_sorters_match_host_on_int64_keys(sorter):
    rng = np.random.default_rng(3)
    arrays = [rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64) for n in (0, 1, 3000)]
    arrays.append(rng.integers(0, 64, size=9000).astype(np.int64))
    s = DeviceSorter("cpu") if sorter == "device" else GovernedSorter("cpu", min_size=0)
    got = s.argsort_many(arrays)
    want = HostSorter().argsort_many(arrays)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)
    assert np.array_equal(s.argsort(arrays[2]), want[2])


@pytest.mark.parametrize("bad", [2**31, -(2**31) - 1])
def test_key_outside_int32_raises_like_jax(bad):
    from keto_tpu.graph.device_build import DeviceSorter as JaxSorter

    keys = np.asarray([0, bad, 1], np.int64)
    with pytest.raises(OverflowError):
        DeviceSorter("cpu").argsort(keys)
    with pytest.raises(OverflowError):
        JaxSorter().argsort(keys)


def test_governed_sorter_gate_and_counters():
    counts: dict = {}

    def count(name):
        counts[name] = counts.get(name, 0) + 1

    s = GovernedSorter("cpu", on_count=count)
    small = np.arange(DEFAULT_MIN_EDGES - 1)[::-1].copy()
    s.argsort_many([small, small[:10]])
    assert counts == {"device_build_host_dispatches": 1}
    big = np.arange(DEFAULT_MIN_EDGES)[::-1].copy()
    assert np.array_equal(s.argsort_many([small[:5], big])[1], np.argsort(big, kind="stable"))
    assert counts == {"device_build_host_dispatches": 1, "device_build_dispatches": 1}
    secs = s.take_seconds()
    assert secs["host"] > 0 and secs["device"] > 0
    assert s.take_seconds() == {"device": 0.0, "host": 0.0}


def test_failed_device_sort_raises_and_counts(monkeypatch):
    """No quiet host retry: the error reaches the caller and is counted."""
    counts: dict = {}
    s = GovernedSorter("cpu", min_size=0, on_count=lambda k: counts.__setitem__(k, counts.get(k, 0) + 1))

    def boom(arrays):
        raise RuntimeError("K8 launch failed")

    # the seam DeviceSorter calls, on the CPU and the card alike
    monkeypatch.setattr(sort_kernels, "radix_argsort_many", boom)
    with pytest.raises(RuntimeError, match="K8 launch failed"):
        s.argsort_many([np.arange(10)])
    assert counts == {"device_build_errors": 1}


def test_estimate_sort_bytes_matches_reference():
    from keto_tpu.graph.device_build import estimate_sort_bytes as jax_estimate

    for n_nodes, n_edges in ((0, 0), (5_205_000, 9_999_881), (17, 3)):
        assert estimate_sort_bytes(n_nodes, n_edges) == jax_estimate(n_nodes, n_edges)


def _assert_layout_equal(a, b):
    assert (a.orient, a.n_rows, a.n_active) == (b.orient, b.n_rows, b.n_active)
    assert a.order.tobytes() == b.order.tobytes() and a.dev2row.tobytes() == b.dev2row.tobytes()
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert (x.offset, x.n) == (y.offset, y.n)
        assert x.nbrs.dtype == y.nbrs.dtype and x.nbrs.tobytes() == y.nbrs.tobytes()


ARRAYS = ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices", "rev_indptr",
          "rev_indices")


def assert_builds_equal(a, b):
    for k in ("num_active", "num_int", "num_live", "n_peeled", "sink_base"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert (x.offset, x.n) == (y.offset, y.n) and x.nbrs.tobytes() == y.nbrs.tobytes()
    _assert_layout_equal(a.lay_fwd, b.lay_fwd)
    _assert_layout_equal(a.lay_rev, b.lay_rev)


@pytest.mark.parametrize("seed", range(6))
def test_build_through_the_radix_sorter_is_byte_identical(seed):
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    tuples, _ = fuzz_case(seed)
    w = wild_ids(NAMESPACES)
    rows, wm = port_store(NAMESPACES, tuples).snapshot_rows()
    counts: dict = {}
    sorter = GovernedSorter("cpu", min_size=0,
                            on_count=lambda k: counts.__setitem__(k, counts.get(k, 0) + 1))
    radix = build_snapshot(rows, wm, w, sorter=sorter)
    host = build_snapshot(rows, wm, w)
    ref = jax_build(*jax_store(NAMESPACES, tuples).snapshot_rows(), w)
    assert_builds_equal(radix, host)
    assert_builds_equal(radix, ref)
    # renumbering, the edge batch, the transposed CSR, two sorts per layout
    assert counts == {"device_build_dispatches": 7}


def test_multi_tile_build_through_the_radix_sorter():
    """A build whose edge arrays span several tiles (config 4's shape)."""
    from keto_tpu_torch import namespace as tns
    from keto_tpu_torch.persistence.memory import MemoryPersister
    from keto_tpu_torch.workloads import GITHUB_NAMESPACES, github_workload

    tuples, _ = github_workload(random.Random(4), 12_000)
    store = MemoryPersister(tns.MemoryManager(GITHUB_NAMESPACES))
    store.write_relation_tuples(*tuples)
    rows, wm = store.snapshot_rows()
    radix = build_snapshot(rows, wm, sorter=GovernedSorter("cpu", min_size=0))
    host = build_snapshot(rows, wm)
    assert radix.fwd_indices.size > 2 * TILE
    assert_builds_equal(radix, host)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the radix kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", K8_LAYOUTS)
def test_radix_cuda_matches_plain(case, cuda_device):
    keys = _keys(case, np.random.default_rng(K8_LAYOUTS.index(case)))
    t = torch.from_numpy(keys).to(cuda_device)
    got = sort_kernels.radix_argsort_cuda(t)
    want = radix_argsort_ref(t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), np.argsort(keys, kind="stable"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 10_000_000])
def test_radix_cuda_matches_plain_at_tile_edges_and_config4(n, cuda_device):
    """Keys in config 4's node-id range [0, 5.2M) (passes 0-2 run): one key,
    a tile less one, one tile, a tile and one, and the deep build's 10M."""
    keys = np.random.default_rng(n).integers(0, 5_200_000, size=n).astype(np.int32)
    t = torch.from_numpy(keys).to(cuda_device)
    got = sort_kernels.radix_argsort_cuda(t)
    want = radix_argsort_ref(t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), np.argsort(keys, kind="stable"))


@pytest.mark.cuda
def test_radix_many_cuda_matches_plain(cuda_device):
    """One batch: histograms, one synchronisation, then every array's passes."""
    rng = np.random.default_rng(13)
    arrays = [_keys(c, rng) for c in K8_LAYOUTS]
    before = dict(sort_kernels.COUNTS)
    got = sort_kernels.radix_argsort_many([torch.from_numpy(a).to(cuda_device) for a in arrays])
    torch.cuda.synchronize()
    for g, a in zip(got, arrays):
        assert np.array_equal(g.cpu().numpy(), np.argsort(a, kind="stable"))
    ran = sum(len(p) for c, p in K8_PLANS.items())
    assert sort_kernels.COUNTS["radix_pass"] - before["radix_pass"] == ran
    sorted_ = sum(1 for a in arrays if a.size)
    assert sort_kernels.COUNTS["radix_hist"] - before["radix_hist"] == sorted_
    assert (sort_kernels.COUNTS["radix_pass_skipped"] - before["radix_pass_skipped"]
            == 4 * sorted_ - ran)
