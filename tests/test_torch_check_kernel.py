"""Check kernels of the PyTorch port against the JAX reference, word for word.

``check_step_ref`` (keto_tpu_torch/check/kernels.py) must equal
``keto_tpu.check.tpu_engine.check_step`` on the whole ``uint32[W+2]``
output — decision bits, iteration count and truncation flag — over random
bucket layouts made with numpy from a seed; ``pull_ref`` must equal
``_pull``. Both run through the port's dispatchers, which take the plain
version for CPU tensors. The ``cuda`` tests hold the CUDA kernels against
the plain versions on the card and skip where there is none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.random_layouts import random_buckets, random_case


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
    [(1, (1, 2, 8), (9, 6, 3)), (8, (1, 2048), (17, 2)), (64, (4, 32), (5, 6))],
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_check_step_cuda_matches_plain(name, cuda_device):
    buckets, entries, ov, kw = _case(**CASES[name])
    args = _torch_args(buckets, entries, ov, cuda_device)
    got = kernels.check_step_cuda(*args, **kw)
    want = kernels.check_step_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
