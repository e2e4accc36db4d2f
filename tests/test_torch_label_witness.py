"""The label-witness step (K4) and ``witness_landmark`` against the JAX
package.

The port's ``label_step_witness`` (its plain version, on the CPU) must
equal the JAX ``label_step_witness`` word for word on random label rows
(the pad row, ``Wo`` < 32 and > 32, unequal widths, shuffled rows, pairs
with no common entry, a row pair whose every entry is common) and on the
JAX engine's own label arrays over every pair of interior rows; the port's
``LabelIndex.witness_landmark`` must name the same landmark as the
reference's on the same index; the dispatcher takes the plain version only
for CPU tensors. A ``cuda``-marked test holds ``label_step_witness_cuda``
against the plain version on the card and skips elsewhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.check.random_layouts import outside_rows, random_witness_case
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]

#: (seed, n, Wo, Wi, pairs, shuffled rows)
CASES = {
    "wo1-wi8": (0, 40, 1, 8, 300, False),
    "wo8-wi1-shuffled": (1, 40, 8, 1, 300, True),
    "wo32-wi64": (2, 60, 32, 64, 900, False),
    "wo64-wi32-shuffled": (3, 60, 64, 32, 900, True),
    "wo128-wi64": (4, 50, 128, 64, 1200, False),
    "wo64-wi128-shuffled": (5, 50, 64, 128, 1200, True),
    "wo128-wi1-many": (6, 200, 128, 1, 5000, True),
    "wo3-wi5": (7, 50, 3, 5, 700, False),
    "wo5-wi3-shuffled": (8, 50, 5, 3, 700, True),
    "wo33-wi65": (9, 60, 33, 65, 900, False),
    "wo65-wi33-shuffled": (10, 60, 65, 33, 900, True),
    "wo200-wi3-shuffled": (12, 40, 200, 3, 300, True),
}
#: the card's cases: CASES and the explain path's single pair (one warp)
CUDA_CASES = {**CASES, "wo8-wi2-one-pair": (11, 40, 8, 2, 1, False),
              "wo64-wi64-one-pair": (13, 40, 64, 64, 1, True)}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_witness(out_lab, in_lab, pa, pb) -> np.ndarray:
    import jax.numpy as jnp

    from keto_tpu.check.tpu_engine import label_step_witness

    return np.asarray(label_step_witness(jnp.asarray(out_lab), jnp.asarray(in_lab),
                                         jnp.asarray(pa), jnp.asarray(pb)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_witness_matches_jax_on_random_rows(name):
    seed, n, Wo, Wi, pairs, shuffle = CASES[name]
    rng = np.random.default_rng(seed)
    arrays = random_witness_case(rng, n, Wo, Wi, pairs, shuffle=shuffle)
    want = _jax_witness(*arrays)
    got = kernels.label_step_witness(*_t(*arrays)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (pairs,)
    assert np.array_equal(got, want), f"{np.count_nonzero(got != want)} words differ"
    # the fixed pairs: every entry common, no common entry, the pad row
    out_lab, in_lab = arrays[0], arrays[1]
    assert got[0] == out_lab[0][out_lab[0] >= 0].min()
    assert got[1] == -1 and got[2] == -1 and got[3] == -1 and got[5] == -1
    assert (got >= 0).any() and (got == -1).any()


def test_witness_of_no_pairs():
    out_lab, in_lab, _, _ = random_witness_case(np.random.default_rng(9), 10, 8, 8, 6)
    empty = np.zeros(0, np.int32)
    got = kernels.label_step_witness(*_t(out_lab, in_lab, empty, empty))
    assert got.shape == (0,) and got.dtype == torch.int32


def deep_rows(depth=6):
    """doc → c0 → … → c{depth-1} → users, a back edge keeping the chain
    active interior, and a side branch."""
    T = RelationTuple
    rows = [T("d", "doc", "view", SubjectSet("g", "c0", "m"))]
    for i in range(depth - 1):
        rows.append(T("g", f"c{i}", "m", SubjectSet("g", f"c{i + 1}", "m")))
    rows.append(T("g", f"c{depth - 1}", "m", SubjectSet("g", "c0", "m")))
    rows.append(T("g", "c2", "m", SubjectSet("g", "side", "m")))
    rows.append(T("g", "side", "m", SubjectSet("g", "leaf", "m")))
    rows += [T("g", f"c{depth - 1}", "m", SubjectID(u)) for u in ("alice", "bob")]
    rows.append(T("g", "leaf", "m", SubjectID("carol")))
    return rows


@pytest.mark.parametrize("max_width", [64, 2])
def test_witness_on_the_engines_own_labels(max_width):
    """Every interior pair on the reference engine's label arrays: the port's
    plain version equals JAX's, and the port's ``witness_landmark`` equals
    the reference's on the port engine's (byte-equal) index."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    rows = deep_rows()
    jp = jax_store(NS, rows)
    ref = TpuCheckEngine(jp, jp.namespaces, labels_max_width=max_width)
    pp = port_store(NS, rows)
    mine = TorchCheckEngine(pp, pp.namespaces, device="cpu", labels_max_width=max_width)
    try:
        ref.labels_settled()
        assert mine.labels_settled()
        r_idx, m_idx = ref.snapshot().labels, mine.snapshot().labels
        assert np.array_equal(r_idx.out_lab, m_idx.out_lab)
        assert np.array_equal(r_idx.in_lab, m_idx.in_lab)
        n = r_idx.n
        a, b = (x.ravel().astype(np.int32) for x in np.meshgrid(np.arange(n + 1), np.arange(n + 1)))
        want = _jax_witness(r_idx.out_lab, r_idx.in_lab, a, b)
        got = kernels.label_step_witness(*_t(m_idx.out_lab, m_idx.in_lab, a, b)).numpy()
        assert np.array_equal(got, want)
        assert (want >= 0).any()
        for x, y, w in zip(a.tolist(), b.tolist(), want.tolist()):
            lm = m_idx.witness_landmark(x, y)
            assert lm == r_idx.witness_landmark(x, y)
            assert lm == (None if w < 0 else w)
    finally:
        mine.close()
        ref.close()


def test_dispatch_takes_the_plain_version_only_for_cpu_tensors(monkeypatch):
    arrays = random_witness_case(np.random.default_rng(3), 20, 8, 8, 40)
    called = []
    monkeypatch.setattr(kernels, "label_step_witness_cuda",
                        lambda *a: called.append("cuda") or pytest.fail("kernel on CPU tensors"))
    got = kernels.label_step_witness(*_t(*arrays))
    assert not called and got.shape == (40,)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.label_step_witness(meta, meta, meta, meta)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on host tensors: it raises."""
    arrays = _t(*random_witness_case(np.random.default_rng(4), 20, 8, 8, 10))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.label_step_witness_cuda(*arrays)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_witness_cuda_matches_plain(name, cuda_device):
    """One keto_label_witness launch against the plain version; a bare
    launch into a sentinel-filled output (every word is written) and with
    pairs naming rows outside the label arrays (-1, as a pad pair)."""
    seed, n, Wo, Wi, pairs, shuffle = CUDA_CASES[name]
    rng = np.random.default_rng(seed)
    arrays = random_witness_case(rng, n, Wo, Wi, pairs, shuffle=shuffle)
    args = [t.to(cuda_device) for t in _t(*arrays)]
    before = kernels.COUNTS["label_witness"]
    got = kernels.label_step_witness_cuda(*args)
    want = kernels.label_step_witness_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and kernels.COUNTS["label_witness"] - before == 1
    out = torch.full_like(want, 0x5A5A5A5A)
    rc = kernels.label_witness_launch(kernels._lib(), *args, out, kernels._stream())
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(out, want)
    pa, plain_a = outside_rows(rng, arrays[2], n, max(1, pairs // 10))
    pb, plain_b = outside_rows(rng, arrays[3], n, max(1, pairs // 10))
    lab = args[:2]
    got = kernels.label_step_witness_cuda(*lab, *(t.to(cuda_device) for t in _t(pa, pb)))
    want = kernels.label_step_witness_ref(*lab, *(t.to(cuda_device) for t in _t(plain_a, plain_b)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
