"""The engine's slice width against the check kernels' 32-bit indices.

``TorchCheckEngine._slice_cap`` takes the widest query-word rung whose
bitmaps fit the workspace budget AND stay under the 2^31 words the check
kernels index (``pull_runs`` refuses more). A large budget on a large graph
narrows the slice instead of reaching that refusal; at the default budget
the cap is the budget's alone, as the reference's.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.check.pack import _WORD_WIDTHS

from test_torch_snapshot import port_store


@pytest.fixture
def engine_with():
    made = []

    def make(**kw):
        store = port_store([("g", 1)], [])
        eng = TorchCheckEngine(store, store.namespaces, device="cpu", labels_enabled=False, **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _stub(num_int: int, spec=None):
    return SimpleNamespace(num_int=num_int, shard_spec=spec)


def _budget_only(num_int: int, budget: int, max_batch: int) -> int:
    """The cap the budget alone gives (the rule before the 32-bit limit)."""
    w = next((w for w in reversed(_WORD_WIDTHS) if (num_int + 1) * 12 * w <= budget),
             _WORD_WIDTHS[0])
    return min(max_batch, 32 * w)


def test_a_large_budget_narrows_the_slice_to_what_the_kernels_index(engine_with):
    eng = engine_with(mem_budget_bytes=64 << 30)
    snap = _stub(600_000)
    W = eng._slice_cap(snap) // 32
    # the budget alone would take W = 4,096: 600,001 · 4,096 words ≥ 2^31
    assert _budget_only(600_000, 64 << 30, eng._max_batch) == 32 * 4096
    with pytest.raises(ValueError, match="32 bits"):
        kernels.pull_runs([], src_rows=600_001, W=4096)
    assert W == 2048
    plan = kernels.pull_runs([], src_rows=snap.num_int + 1, W=W)
    assert plan.n_rows == 0


def test_a_sharded_snapshot_counts_its_padded_slabs(engine_with):
    eng = engine_with(mem_budget_bytes=64 << 30)
    rows = (1 << 31) // 2048  # 2048 words a row reach 2^31 at this many rows
    spec = SimpleNamespace(n_shards=4, rows_per_shard=rows // 4)
    # unpadded the rows fit at W = 2,048 ... the shards' slabs do not
    assert eng._slice_cap(_stub(rows - 2)) // 32 == 2048
    W = eng._slice_cap(_stub(rows - 2, spec)) // 32
    assert W == 1024
    kernels.pull_runs([], src_rows=spec.n_shards * spec.rows_per_shard, W=W)


@pytest.mark.parametrize("num_int", [9_423, 123_949, 600_000])
def test_the_default_budget_keeps_its_cap(engine_with, num_int):
    """Config 3's and config 4's interior rows, and the large graph: at the
    default 10 GiB budget the cap is the budget's alone."""
    eng = engine_with()
    assert eng._mem_budget == 10 << 30
    got = eng._slice_cap(_stub(num_int))
    assert got == _budget_only(num_int, 10 << 30, eng._max_batch)
    kernels.pull_runs([], src_rows=num_int + 1, W=got // 32)
