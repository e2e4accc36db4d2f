"""The label step (K3) on the layouts its kernel is designed around, against
the JAX package, and the launch the CUDA wrapper makes.

- ``label_team``: the team width and OUT entries a lane for every OUT width
  from 1 to 256.
- ``random_label_case(sorted_queries=True)`` is the engine's order (live
  pairs ascending by query, pad pairs with query 0 after them), and
  ``exchanged=True`` the shape K10b hands K3 (``pa = pb = arange(P)`` over
  the exchanged rows); the port's ``label_step`` (its plain version, on the
  CPU) equals the JAX ``label_step`` word for word on both, at odd widths.
- ``label_step_launch`` and ``label_witness_launch`` pass the kernels'
  C signatures their team and entries a lane.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch import _build
from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import outside_rows, random_label_case


def test_label_team_covers_every_width():
    for Wo in range(1, 257):
        t, k = kernels.label_team(Wo)
        assert t in (1, 2, 4, 8, 16, 32), Wo
        assert t * k >= Wo, Wo
        if Wo <= 128:
            assert k <= 4, Wo
            # the narrowest team whose lanes hold the row 4 entries a lane
            assert t == 1 or 4 * (t // 2) < Wo, Wo
        else:
            assert t == 32 and k == -(-Wo // 32), Wo
        if Wo % 4 == 0:
            assert k >= 4, Wo  # a lane's entries are one 16-byte load


#: (seed, n, Wo, Wi, W, live pairs, exchanged)
SORTED_CASES = {
    "wo3-wi5": (10, 50, 3, 5, 8, 600, False),
    "wo5-wi3": (11, 50, 5, 3, 8, 600, False),
    "wo33-wi5": (12, 60, 33, 5, 64, 2500, False),
    "wo5-wi33": (13, 60, 5, 33, 64, 2500, False),
    "wo33-wi33": (14, 40, 33, 33, 1, 30, False),
    "wo65-wi3": (15, 40, 65, 3, 8, 500, False),
    "wo8-wi2-w64": (16, 300, 8, 2, 64, 6000, False),
    "k10b-wo3-wi5": (17, 50, 3, 5, 8, 600, True),
    "k10b-wo33-wi5": (18, 60, 33, 5, 64, 2500, True),
    "k10b-wo8-wi2": (19, 300, 8, 2, 64, 6000, True),
}


def _jax_label_step(out_lab, in_lab, entries, P, B) -> np.ndarray:
    import jax.numpy as jnp

    from keto_tpu.check.tpu_engine import label_step as jax_label_step

    return np.asarray(jax_label_step(jnp.asarray(out_lab), jnp.asarray(in_lab),
                                     jnp.asarray(entries), n_pairs=P, B=B))


def test_sorted_queries_give_the_engines_order():
    rng = np.random.default_rng(1)
    n, pairs = 70, 900
    out_lab, in_lab, entries, P, B = random_label_case(rng, n, 5, 3, 8, pairs,
                                                       sorted_queries=True)
    pa, pb, pq = entries[:P], entries[P : 2 * P], entries[2 * P :]
    assert P > pairs and np.all(np.diff(pq[:pairs]) >= 0)
    assert np.all(pq[pairs:] == 0) and np.all(pa[pairs:] == n) and np.all(pb[pairs:] == n)
    # the same pairs as the unsorted layout, reordered
    _, _, plain, _, _ = random_label_case(np.random.default_rng(1), n, 5, 3, 8, pairs)
    key = lambda e: sorted(zip(e[:P], e[P : 2 * P], e[2 * P :]))  # noqa: E731
    assert key(entries) == key(plain)


def test_exchanged_is_k10bs_shape():
    rng = np.random.default_rng(2)
    n, pairs = 40, 300
    o, i, e, P, B = random_label_case(rng, n, 3, 5, 8, pairs, exchanged=True)
    o0, i0, e0, _, _ = random_label_case(np.random.default_rng(2), n, 3, 5, 8, pairs)
    assert np.array_equal(e[:P], np.arange(P)) and np.array_equal(e[P : 2 * P], np.arange(P))
    assert np.array_equal(o, o0[e0[:P]]) and np.array_equal(i, i0[e0[P : 2 * P]])
    assert np.array_equal(e[2 * P :], e0[2 * P :])


@pytest.mark.parametrize("name", sorted(SORTED_CASES))
def test_label_step_matches_jax_in_the_engines_order(name):
    seed, n, Wo, Wi, W, pairs, exchanged = SORTED_CASES[name]
    out_lab, in_lab, entries, P, B = random_label_case(
        np.random.default_rng(seed), n, Wo, Wi, W, pairs, sorted_queries=True,
        exchanged=exchanged)
    want = _jax_label_step(out_lab, in_lab, entries, P, B)
    got = kernels.label_step(torch.from_numpy(out_lab), torch.from_numpy(in_lab),
                             torch.from_numpy(entries), n_pairs=P, B=B)
    got = got.numpy().view(np.uint32)
    assert got.shape == want.shape == (B // 32,)
    assert np.array_equal(got, want), f"{np.count_nonzero(got != want)} words differ"
    bits = np.unpackbits(want.view(np.uint8)).sum()
    assert 0 < bits < B, "the case must have both hits and misses"


def test_outside_rows_answer_as_pad_rows_in_jax():
    """A pair naming a row past the label arrays: the layout's plain copy
    moves it to the all-pad row, and the JAX step, which drops such a row
    as no hit, agrees with the plain copy's answer."""
    rng = np.random.default_rng(3)
    n = 60
    out_lab, in_lab, entries, P, B = random_label_case(rng, n, 5, 3, 8, 700)
    got, plain = outside_rows(rng, entries[: 2 * P], n, 40)
    assert np.count_nonzero((got < 0) | (got > n)) == 40 and np.all(plain[got != entries[: 2 * P]] == n)
    want = kernels.label_step(torch.from_numpy(out_lab), torch.from_numpy(in_lab),
                              torch.from_numpy(np.concatenate([plain, entries[2 * P :]])),
                              n_pairs=P, B=B)
    # JAX's gather clamps an index past the array to its last row (the pad
    # row); only rows past the end can be held against it
    past = np.where(got < 0, n, got)
    jax_got = _jax_label_step(out_lab, in_lab, np.concatenate([past, entries[2 * P :]]), P, B)
    assert np.array_equal(want.numpy().view(np.uint32), jax_got)


class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.mark.parametrize("Wo,Wi", [(1, 1), (3, 5), (8, 2), (33, 65), (128, 4), (200, 3)])
def test_launches_pass_the_team(Wo, Wi):
    """The bare launches give the C entry points every argument of their
    ctypes signature, the team and entries a lane from ``label_team``."""
    rng = np.random.default_rng(Wo + Wi)
    out_lab, in_lab, entries, P, B = random_label_case(rng, 20, Wo, Wi, 1, 40)
    o, i, e = (torch.from_numpy(a) for a in (out_lab, in_lab, entries))
    out = torch.zeros(B // 32, dtype=torch.int32)
    lib = _Lib()
    assert kernels.label_step_launch(lib, o, i, e, P, out, 0) == 0
    pa, pb = e[:P].clone(), e[P : 2 * P].clone()
    assert kernels.label_witness_launch(lib, o, i, pa, pb, torch.empty(P, dtype=torch.int32),
                                        0) == 0
    (n1, a1), (n2, a2) = lib.calls
    t, k = kernels.label_team(Wo)
    assert (n1, len(a1)) == ("keto_label_step", len(_build._SIGNATURES["keto_label_step"]))
    assert (n2, len(a2)) == ("keto_label_witness",
                             len(_build._SIGNATURES["keto_label_witness"]))
    assert a1[:7] == (o.data_ptr(), Wo, i.data_ptr(), Wi, 21, e.data_ptr(), P)
    assert a1[7:9] == (t, k) and a1[9] == out.data_ptr()
    assert a2[:8] == (o.data_ptr(), Wo, i.data_ptr(), Wi, 21, pa.data_ptr(), pb.data_ptr(), P)
    assert a2[8:10] == (t, k)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on host tensors: it raises."""
    out_lab, in_lab, entries, P, B = random_label_case(np.random.default_rng(5), 20, 3, 5, 1, 30)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.label_step_cuda(torch.from_numpy(out_lab), torch.from_numpy(in_lab),
                                torch.from_numpy(entries), n_pairs=P, B=B)
