"""Random check-kernel inputs with the engine's geometry, made from a numpy
generator, for holding a kernel against its plain version or against the
JAX reference (tests/test_torch_check_kernel.py, chip_smoke.py).

The layouts keep every invariant the engine's own inputs have: buckets
tile the active prefix and pad rows and slots with the sentinel ``n_int``
(the all-zero bitmap row); seed pairs are distinct — the reference
scatter-adds, which is OR only on disjoint bits — and padded with the
dropped row ``n_int+1``; every word's bit-31 query is seeded; the overlay
pads ``ov_dst`` with ``n_active``.
"""

from __future__ import annotations

import numpy as np


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def random_buckets(rng, n_int: int, caps, rows, chain: bool = False) -> list[np.ndarray]:
    """Degree buckets tiling the active prefix: bucket k has ``rows[k]``
    valid rows of degree cap ``caps[k]``, padded to a power of two. With
    ``chain``, row r pulls from row r-1 only: a path as deep as the prefix."""
    out, offset = [], 0
    for cap, n in zip(caps, rows):
        nb = np.full((_ceil_pow2(n), cap), n_int, np.int32)
        for i in range(n):
            if chain:
                nb[i, 0] = offset + i - 1 if offset + i else n_int
            else:
                fill = int(rng.integers(1, cap + 1))
                nb[i, :fill] = rng.integers(0, n_int + 1, size=fill)
        out.append(nb)
        offset += n
    return out


def random_case(rng, W, caps=(), rows=(), n_int=64, chain=False, overlay=False,
                it_cap=4096, block_iters=8):
    """``(buckets, entries, (ov_nbrs, ov_dst) | None, check_step kwargs)``
    for a batch of ``32·W`` queries."""
    B = 32 * W
    n_active = int(sum(rows))
    if n_active > n_int:
        raise ValueError("the active rows are a prefix of the interior rows")
    buckets = random_buckets(rng, n_int, caps, rows, chain)

    def pairs(n, pad, hi):
        keys = rng.choice(hi * B, size=min(n, hi * B), replace=False)
        r = np.concatenate([keys // B, np.full(pad - keys.size, n_int + 1)]).astype(np.int32)
        q = np.concatenate([keys % B, np.zeros(pad - keys.size)]).astype(np.int32)
        return r, q

    S1, S2, SA = B, 2 * B, B
    # chained layouts seed row 0 only, so every bit walks the whole path
    e1r, e1q = pairs(min(S1, 3 * W + 5), S1, 1 if chain else n_int)
    e1q[:W] = np.arange(W, dtype=np.int32) * 32 + 31
    e1r[:W] = rng.integers(0, 1 if chain else n_int, size=W)
    keep = np.unique((e1r.astype(np.int64) << 32) | e1q, return_index=True)[1]
    e1r[np.setdiff1d(np.arange(S1), keep)] = n_int + 1
    e2r, e2q = pairs(min(S2, 4 * W + 7), S2, n_int)
    n_ans = min(SA, 2 * W + 3)
    a_rows = np.concatenate([rng.integers(0, n_int + 1, size=n_ans), np.full(SA - n_ans, n_int)])
    a_q = np.concatenate([rng.integers(0, B, size=n_ans), np.zeros(SA - n_ans)])
    # some sink gathers read a seeded (row, query): their bit is set
    k = min(W, n_ans)
    a_rows[:k], a_q[:k] = e1r[:k], e1q[:k]
    targets = rng.integers(0, n_int + 1, size=B)
    # some targets are rows their own query seeded through e2: granted by
    # the one-hop term whatever the pull does
    live = e2r <= n_int
    targets[e2q[live][::2]] = e2r[live][::2]
    entries = np.concatenate([e1r, e1q, e2r, e2q, a_rows, a_q, targets]).astype(np.int32)
    ov = None
    if overlay and n_active:
        K, C = 6, 3
        ov_nbrs = rng.integers(0, n_int + 1, size=(K, C)).astype(np.int32)
        dst = rng.choice(n_active, size=min(K - 2, n_active), replace=False)
        ov_dst = np.full(K, n_active, np.int32)
        ov_dst[: dst.size] = dst
        ov = (ov_nbrs, ov_dst)
    kw = dict(sizes=(S1, S2, SA, B), n_active=n_active, n_int=n_int,
              valid_rows=tuple(int(r) for r in rows), it_cap=it_cap, block_iters=block_iters)
    return buckets, entries, ov, kw
