"""The list fixpoint (K5) against the JAX package's ``list_step``.

``list_step_ref`` (the plain version; the dispatcher on CPU tensors) must
equal ``keto_tpu.list.tpu_engine.list_step`` word for word on the whole
bitmap, run on the JAX package's own list layouts carried across with
``list_layout_arrays``, over every K5 layout: the base pull alone, an
overlay into active rows, an overlay into PASSIVE rows (rows with no base
neighbour, which the check step's overlay stage would miss), a chain that
``it_cap`` truncates, no active row but an overlay, and all 32 lanes (lane
31 is seeded in every case). The ``cuda`` tests hold the CUDA kernels
against the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch.check.random_layouts import (
    LIST_CASES,
    LIST_WIDE_CASES,
    list_case_inputs,
    list_case_tuples,
    random_list_layout,
)
from keto_tpu_torch.graph.carry import device_list_from_arrays, list_layout_arrays
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.list import kernels as lk

from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]


def _case(kind: str, seed: int = 0):
    """(JAX snapshot, port snapshot, orient, inputs) of one K5 layout."""
    from keto_tpu.graph.snapshot import build_snapshot as jax_build

    rng = np.random.default_rng(LIST_CASES.index(kind) * 10 + seed)
    tuples, orient = list_case_tuples(kind, rng)
    ref = jax_build(*jax_store(NS, tuples).snapshot_rows())
    mine = build_snapshot(*port_store(NS, tuples).snapshot_rows())
    lay = ref.lay_fwd if orient == "fwd" else ref.lay_rev
    inputs = list_case_inputs(kind, rng, lay.n_rows, lay.n_active)
    return ref, mine, orient, inputs


def _jax_list_step(arrays, meta, inputs):
    import jax.numpy as jnp
    from keto_tpu.list.tpu_engine import _list_kernel

    R0, ov_nbrs, ov_dst, it_cap, block_iters = inputs
    out = _list_kernel(
        tuple(jnp.asarray(a) for a in arrays),
        jnp.asarray(R0.view(np.uint32)),
        None if ov_nbrs is None else jnp.asarray(ov_nbrs),
        None if ov_dst is None else jnp.asarray(ov_dst),
        n_active=meta["n_active"],
        valid_rows=tuple(meta["n"]),
        it_cap=it_cap,
        block_iters=block_iters,
    )
    return np.asarray(out).view(np.int32)


def _port_list_step(dl, inputs, fn=lk.list_step):
    R0, ov_nbrs, ov_dst, it_cap, block_iters = inputs
    dev = dl.device
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return fn(dl.buckets, t(R0), t(ov_nbrs), t(ov_dst), n_active=dl.n_active,
              valid_rows=dl.valid_rows, it_cap=it_cap, block_iters=block_iters)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", LIST_CASES)
def test_list_step_ref_matches_jax(kind, seed):
    ref, mine, orient, inputs = _case(kind, seed)
    arrays, meta = list_layout_arrays(ref, orient)
    want = _jax_list_step(arrays, meta, inputs)
    got = _port_list_step(device_list_from_arrays(arrays, meta, "cpu"), inputs)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # the port's own layouts are the JAX package's, byte for byte
    a2, m2 = list_layout_arrays(mine, orient)
    assert [a.tobytes() for a in a2] == [a.tobytes() for a in arrays]
    assert m2["order"].tobytes() == meta["order"].tobytes() and m2["n"] == meta["n"]


def test_list_step_overlay_into_passive_row_matches_jax():
    """The trap: the list overlay reads the committed bitmap and may write a
    row past the active prefix; the changed flag must see that write. The
    case must actually reach a passive row for the test to mean anything."""
    ref, _, orient, inputs = _case("overlay-passive")
    arrays, meta = list_layout_arrays(ref, orient)
    R0, ov_nbrs, ov_dst, _, _ = inputs
    want = _jax_list_step(arrays, meta, inputs)
    passive = [int(d) for d in ov_dst if meta["n_active"] <= d < meta["n_rows"]]
    assert passive and any(int(want[d, 0]) != int(R0[d, 0]) for d in passive)
    got = _port_list_step(device_list_from_arrays(arrays, meta, "cpu"), inputs)
    assert np.array_equal(got.numpy(), want)


def test_list_step_truncation_matches_jax():
    """``it_cap`` is tested between blocks, so a truncated run stops with the
    reference's partial bitmap, not the fixpoint."""
    ref, _, orient, inputs = _case("chain-truncated")
    arrays, meta = list_layout_arrays(ref, orient)
    want = _jax_list_step(arrays, meta, inputs)
    full = _jax_list_step(arrays, meta, inputs[:3] + (meta["n_rows"] + 2, 8))
    assert not np.array_equal(want, full)
    got = _port_list_step(device_list_from_arrays(arrays, meta, "cpu"), inputs)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", range(len(LIST_WIDE_CASES)))
def test_list_step_ref_matches_jax_on_wide_layouts(case):
    """The kernel's random layouts (wide buckets, passive overlay rows,
    it_cap cuts inside a block) give the JAX package's bitmap too."""
    caps, rows, passive, K, it_cap, block_iters = LIST_WIDE_CASES[case]
    buckets, R0, ov, ov_dst = random_list_layout(np.random.default_rng(case), caps, rows,
                                                 passive, K)
    want = _jax_list_step(buckets, {"n_active": sum(rows), "n": list(rows)},
                          (R0, ov, ov_dst, it_cap, block_iters))
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = lk.list_step([t(b) for b in buckets], t(R0), t(ov), t(ov_dst), n_active=sum(rows),
                       valid_rows=rows, it_cap=it_cap, block_iters=block_iters)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, R0)


def test_idle_run_returns_r0_itself():
    ref, _, orient, inputs = _case("no-active-overlay")
    arrays, meta = list_layout_arrays(ref, orient)
    assert meta["n_active"] == 0 and not arrays
    R0 = torch.from_numpy(inputs[0].copy())
    out = lk.list_step([], R0, None, None, n_active=0, valid_rows=(), it_cap=4)
    assert out is R0


def test_list_layout_arrays_rejects_an_unknown_orientation():
    ref, _, _, _ = _case("bucket-only")
    with pytest.raises(ValueError):
        list_layout_arrays(ref, "sideways")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the list kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LIST_CASES)
def test_list_step_cuda_matches_plain(kind, cuda_device):
    from keto_tpu_torch.check.random_layouts import list_case_inputs as inputs_of

    rng = np.random.default_rng(LIST_CASES.index(kind))
    tuples, orient = list_case_tuples(kind, rng)
    snap = build_snapshot(*port_store(NS, tuples).snapshot_rows())
    arrays, meta = list_layout_arrays(snap, orient)
    inputs = inputs_of(kind, rng, meta["n_rows"], meta["n_active"])
    dl = device_list_from_arrays(arrays, meta, cuda_device)
    got = _port_list_step(dl, inputs, lk.list_step_cuda)
    want = _port_list_step(dl, inputs, lk.list_step_ref)
    torch.cuda.synchronize()
    assert torch.equal(got, want)



@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(LIST_WIDE_CASES)))
def test_list_fixpoint_cuda_matches_plain_on_wide_layouts(case, cuda_device):
    caps, rows, passive, K, it_cap, block_iters = LIST_WIDE_CASES[case]
    buckets, R0, ov, ov_dst = random_list_layout(np.random.default_rng(case), caps, rows,
                                                 passive, K)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    kw = dict(n_active=sum(rows), valid_rows=rows, it_cap=it_cap, block_iters=block_iters)
    before = lk.COUNTS["list_iters"]
    got = lk.list_step_cuda([t(b) for b in buckets], t(R0), t(ov), t(ov_dst), **kw)
    steps = lk.COUNTS["list_iters"] - before
    want = lk.list_step_ref([t(b) for b in buckets], t(R0), t(ov), t(ov_dst), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if caps == (1,):  # a chain longer than it_cap: cut where the block ends
        assert steps == -(-it_cap // block_iters) * block_iters
