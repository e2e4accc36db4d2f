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
                                   (128, 128), (2, 8)])
@pytest.mark.parametrize("W", [1, 8, 64])
def test_label_step_cuda_matches_plain(Wo, Wi, W, cuda_device):
    rng = np.random.default_rng(Wo * 1000 + Wi * 10 + W)
    out_lab, in_lab, entries, P, B = random_label_case(rng, n=90, Wo=Wo, Wi=Wi, W=W,
                                                       pairs=3 * 32 * W + 7)
    args = (_t(out_lab, cuda_device), _t(in_lab, cuda_device), _t(entries, cuda_device))
    got = kernels.label_step_cuda(*args, n_pairs=P, B=B)
    want = kernels.label_step_ref(*args, n_pairs=P, B=B)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("wt", [1, 2])
@pytest.mark.parametrize("caps,rows", [((1, 2, 4), (30, 10, 5)), ((1, 4096), (40, 2)), ((8,), (12,))])
def test_sweep_step_cuda_matches_plain(caps, rows, wt, prune, cuda_device):
    rng = np.random.default_rng(sum(caps) + wt)
    groups, V, X, S, cov = random_sweep_case(rng, 100, caps, rows, wt)
    g = label_kernels.EllGroups.from_groups(groups, cuda_device)
    outs = []
    for fn in (label_kernels.sweep_step_cuda, label_kernels.sweep_step_ref):
        outs.append(fn(g, _t(V, cuda_device), _t(X, cuda_device), _t(S, cuda_device),
                       _t(cov, cuda_device), prune_expansion=prune))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("width,u,wt", [(64, 4096, 2), (64, 300, 1), (8, 0, 2), (16, 1, 2),
                                        (64, 20000, 2)])
def test_covered_cuda_matches_plain(width, u, wt, cuda_device):
    rng = np.random.default_rng(width + u + wt)
    lab, U, masks = random_covered_case(rng, 700, width, u, wt)
    args = (_t(lab, cuda_device), _t(U, cuda_device), _t(masks, cuda_device))
    got = label_kernels.covered_cuda(*args)
    want = label_kernels.covered_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
