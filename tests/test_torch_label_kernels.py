"""The label kernels (K3, K6, K7) on the card against their plain versions.

Every test needs a CUDA device (``cuda`` marker) and skips with a reason
elsewhere; on the card run
``python -m pytest tests/test_torch_label_kernels.py -m cuda --noconftest``.
This file imports no JAX: the machine with the card has none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import (
    outside_rows,
    random_covered_case,
    random_label_case,
    random_sweep_case,
)
from keto_tpu_torch.graph import label_kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("Wo,Wi", [(1, 1), (1, 32), (32, 1), (64, 64), (128, 32), (32, 128),
                                   (128, 128), (2, 8), (3, 3), (5, 5), (33, 33), (65, 65),
                                   (3, 65), (65, 3), (5, 33), (33, 5), (8, 2), (200, 3)])
@pytest.mark.parametrize("W", [1, 8, 64])
def test_label_step_cuda_matches_plain(Wo, Wi, W, cuda_device):
    """One keto_label_step launch against the plain version: teams of 1 to
    32 lanes, widths that take 16-byte loads and widths that do not, rows
    wider than a warp's 128 entries (chunks)."""
    rng = np.random.default_rng(Wo * 1000 + Wi * 10 + W)
    out_lab, in_lab, entries, P, B = random_label_case(rng, n=90, Wo=Wo, Wi=Wi, W=W,
                                                       pairs=3 * 32 * W + 7)
    args = (_t(out_lab, cuda_device), _t(in_lab, cuda_device), _t(entries, cuda_device))
    before = kernels.COUNTS["label_step"]
    got = kernels.label_step_cuda(*args, n_pairs=P, B=B)
    want = kernels.label_step_ref(*args, n_pairs=P, B=B)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and kernels.COUNTS["label_step"] - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sorted", "k10b", "outside"])
@pytest.mark.parametrize("Wo,Wi", [(3, 5), (5, 3), (8, 2), (33, 65), (65, 33), (64, 64)])
def test_label_step_cuda_layouts(layout, Wo, Wi, cuda_device):
    """The engine's order (live pairs by query, pads with query 0 after
    them: most of a warp's hits share an answer word), K10b's shape
    (``pa = pb = arange(P)`` over the exchanged rows) and pairs naming rows
    outside the label arrays (no hit, as a pad pair), against the plain
    version; the engine's order also from a bare launch, no host read."""
    rng = np.random.default_rng(Wo * 100 + Wi)
    n = 120
    out_lab, in_lab, entries, P, B = random_label_case(
        rng, n, Wo, Wi, 64, 5000, sorted_queries=layout != "outside", exchanged=layout == "k10b")
    plain = entries
    if layout == "outside":
        rows, plain_rows = outside_rows(rng, entries[: 2 * P], n, 300)
        entries = np.concatenate([rows, entries[2 * P :]])
        plain = np.concatenate([plain_rows, plain[2 * P :]])
    lab = (_t(out_lab, cuda_device), _t(in_lab, cuda_device))
    got = kernels.label_step_cuda(*lab, _t(entries, cuda_device), n_pairs=P, B=B)
    want = kernels.label_step_ref(*lab, _t(plain, cuda_device), n_pairs=P, B=B)
    bare = torch.zeros_like(want)
    rc = kernels.label_step_launch(kernels._lib(), *lab, _t(entries, cuda_device), P, bare,
                                   kernels._stream())
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(got, want) and torch.equal(bare, want)
    assert want.any() and not bool((want == -1).all())


def _sweep_budgets(run) -> list:
    """No budget, the run's own visits, one visit less, and half of them."""
    _, _, visits, _ = run(None)
    return [None, visits, visits - 1, visits // 2]


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("wt", [1, 2, 5])
@pytest.mark.parametrize("caps,rows", [((1, 2, 4), (30, 10, 5)), ((1, 4096), (40, 2)),
                                       ((8, 32, 64), (12, 6, 3)), ((1, 2, 16, 128), (300, 60, 9, 4))])
def test_sweep_cuda_matches_plain(caps, rows, wt, prune, cuda_device):
    """The whole sweep (one keto_sweep_run launch) against waves of the
    plain step: the stored bitmap, waves, visits and the dry flag, with
    groups of cap 32 and more (a warp a row) and wt past 4 (the warp's
    word chunks), at several budgets."""
    n = 400
    rng = np.random.default_rng(sum(caps) + wt)
    groups, _, X0, _, cov = random_sweep_case(rng, n, caps, rows, wt)
    out = {}
    for dev in ("cpu", cuda_device):
        g = label_kernels.EllGroups.from_groups(groups, dev)
        fn = label_kernels.sweep_ref if dev == "cpu" else label_kernels.sweep_cuda
        out[dev] = lambda b, g=g, fn=fn, dev=dev: fn(g, _t(X0, dev), _t(cov, dev), n_dst=n + 1,
                                                     prune_expansion=prune, budget=b)
    assert out["cpu"](None)[1] >= 2, "the case must run waves"
    for budget in _sweep_budgets(out["cpu"]):
        want = out["cpu"](budget)
        got = out[cuda_device](budget)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:], budget


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,lanes,wt,pad,own_width,extra", [
    (700, 64, 64, 2, -1, 0, 0), (700, 64, 32, 1, -2, 0, 0), (500, 8, 64, 2, -1, 0, 0),
    (700, 16, 1, 2, -2, 0, 13), (5000, 64, 33, 2, -1, 16, 0), (3001, 3, 64, 2, -2, 0, 7),
    (4000, 32, 64, 2, -1, 64, 3), (900, 12, 96, 3, -1, 0, 0), (800, 64, 160, 5, -2, 0, 0),
    (700, 4, 64, 2, -1, 0, 0), (700, 1, 64, 2, -2, 0, 5), (700, 8, 96, 3, -1, 0, 0),
    (700, 2, 96, 3, -2, 0, 0), (700, 1, 160, 5, -1, 0, 0),
])
def test_covered_cuda_matches_plain(rows, width, lanes, wt, pad, own_width, extra, cuda_device):
    """One keto_covered launch against the plain version: widths that take
    16-byte loads and widths that do not, narrow rows whose words outnumber
    the lanes their loads need, wt past 4 (two word blocks), output rows
    past the label rows, and one table reused (zero after each call). The
    bare launch writes into an output filled with a sentinel, so a word it
    misses shows."""
    rng = np.random.default_rng(rows + width + lanes)
    lab, own = random_covered_case(rng, rows, width, lanes, pad=pad, own_width=own_width)
    args = (_t(lab, cuda_device), _t(own, cuda_device))
    table = torch.zeros((rows, wt), dtype=torch.int32, device=cuda_device)
    want = label_kernels.covered_ref(*args, wt=wt, rows=rows + extra)
    for _ in range(2):
        before = kernels.COUNTS["covered"]
        got = label_kernels.covered_cuda(*args, wt=wt, rows=rows + extra, table=table)
        torch.cuda.synchronize()
        assert kernels.COUNTS["covered"] - before == 1
        assert torch.equal(got, want) and not table.any()
    out = torch.full_like(want, 0x5A5A5A5A)
    rc = label_kernels.covered_launch(label_kernels._lib(), *args, wt, table, out,
                                      label_kernels._stream())
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(out, want) and not table.any()
    assert want.any() and (lanes <= 32 * (wt - 1) or want[:, -1].any())
