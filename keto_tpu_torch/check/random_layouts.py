"""Random kernel inputs with the engine's geometry, made from a numpy
generator, for holding a kernel against its plain version or against the
JAX reference (tests/test_torch_check_kernel.py,
tests/test_torch_label_kernels.py, chip_smoke.py).

The layouts keep every invariant the engine's own inputs have: buckets
tile the active prefix and pad rows and slots with the sentinel ``n_int``
(the all-zero bitmap row); seed pairs are distinct — the reference
scatter-adds, which is OR only on disjoint bits — and padded with the
dropped row ``n_int+1``; every word's bit-31 query is seeded; the overlay
pads ``ov_dst`` with ``n_active``. The label layouts keep the label
index's: OUT rows pad with -1 and IN rows with -2 after their entries,
row ``n`` is all padding, and pad pairs name row ``n`` for query 0; the
sweep groups write distinct ``dst`` rows and gather sentinel ``n`` (an
all-zero frontier row). The slot-set targets are a bucket, the overlay's
rows or dst vector, or a label mirror, with distinct slots unless asked
for duplicates. The covered cases (``random_covered_case``) pair label
rows padded with the other side's pad (all-pad rows among them) with the
lanes' own rows: an empty lane, an id shared by every other lane, the last
row's id. The witness cases (``random_witness_case``) add a row pair
whose every entry is common, a row with no common entry, the pad row on
either side and, when asked, rows in shuffled order. The answer cases
(``ANSWER_KINDS``, ``random_answer_case``) feed K2's and K10a's answer
kernels bitmaps and entries directly: random entries, a word whose 32
queries all hit, every sink entry in one word, passive and absent
targets, and (sharded) targets and sink rows that no shard owns. The
list fixpoint's cases (``LIST_CASES``) are tuple sets
whose snapshots give its layouts (``list_case_tuples``) plus seeds and an
overlay in the layout's row space (``list_case_inputs``): every case seeds
lane 31; overlay destinations are distinct and padded with ``n_rows + 1``,
holes point at the all-zero row ``n_rows``. The build sort's cases
(``SORT_CASES``, ``sort_case_keys``) are int32 key arrays.
"""

from __future__ import annotations

import numpy as np

#: what a sentinel-filled output holds where a kernel wrote nothing
SENTINEL = 0x5A5A5A5A


class RefusingLib:
    """A stand-in kernel library: the entry points named in ``refused``
    return cudaErrorInvalidConfiguration (9), every other one launches
    nothing and returns 0 — for holding a wrapper's failure path (it must
    raise and count the launch) without a card."""

    def __init__(self, *refused: str):
        self.refused = refused

    def __getattr__(self, name):
        return lambda *a: 9 if name in self.refused else 0


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


class _Bucket:
    """A degree bucket as ``make_shard_spec`` reads one."""

    def __init__(self, nbrs, n, offset):
        self.nbrs, self.n, self.offset = nbrs, n, offset


class _Layout:
    """A snapshot's bucket layout, as ``make_shard_spec`` reads one."""

    def __init__(self, buckets, n_int, n_active):
        self.buckets, self.num_int, self.num_active = buckets, n_int, n_active


def random_shard_case(rng, g: int, **case):
    """A ``random_case`` layout (``case`` its arguments) partitioned into
    ``g`` row-range shards by the port's routing: ``(single, sharded)``,
    ``single = (buckets, entries, ov, kw)`` as ``random_case`` returns it
    and ``sharded = (spec, entries int32[g, L], ov (int32[g, K, C],
    int32[g, K]) | None, kw)`` with ``kw`` the sharded program's ``sizes``,
    ``rps``, ``B``, ``it_cap`` and ``block_iters``. Rows that do not divide
    evenly leave the last shard short (or empty); overlay pad rows are
    owned by no shard."""
    from keto_tpu_torch.parallel.sharded import make_shard_spec, route_entries, route_overlay

    buckets, entries, ov, kw = random_case(rng, **case)
    offs = np.cumsum([0] + list(kw["valid_rows"]))
    layout = _Layout([_Bucket(nb, int(n), int(o)) for nb, n, o in
                      zip(buckets, kw["valid_rows"], offs)], kw["n_int"], kw["n_active"])
    spec = make_shard_spec(layout, g)
    S1, S2, SA, B = kw["sizes"]
    packed = np.split(entries, np.cumsum([S1, S1, S2, S2, SA, SA]))
    ent_sh, sizes = route_entries(spec, packed, B)
    ov_sh = None
    if ov is not None:
        ovn, ovd, _ = route_overlay(spec, ov[0], ov[1], kw["n_active"])
        ov_sh = (ovn, ovd)
    kw_sh = dict(sizes=sizes, rps=spec.rows_per_shard, B=B, it_cap=kw["it_cap"],
                 block_iters=kw["block_iters"])
    return (buckets, entries, ov, kw), (spec, ent_sh, ov_sh, kw_sh)


def _bits(rng, shape) -> np.ndarray:
    """Random uint32 words, as int32, with bit 31 set in a third of them."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape) < 0.33] |= np.uint32(1 << 31)
    return w.view(np.int32)


#: the layouts of ``random_answer_case``
ANSWER_KINDS = ("random", "all-hit", "one-word-sinks", "passive-absent", "unowned")


def random_answer_case(rng, kind: str, W: int, *, n_int: int = 96, n_active: int = 64,
                       g: int = 0, SA: int = 0) -> dict:
    """Inputs of the answer kernels for a batch of ``32·W`` queries, as
    numpy arrays: ``entries`` and ``sizes`` (e1/e2 hold padding only: the
    answer does not read them), bitmaps whose words have about a quarter of
    their bits set, and ``SA`` sink entries (default ``2·B + 7``, a ragged
    last tile). Unsharded (``g`` 0): ``P`` ``[n_active+1, W]`` (row
    ``n_active`` zero), ``ans_base`` and ``R`` ``[n_int+1, W]``, targets in
    ``[0, n_int]``. Sharded (``g`` shards of ``rps`` rows covering ``n_int +
    1``): the ``[g·rps, W]`` bitmaps and ``entries`` int32[g, L]; each query's
    target is a local row on one owner shard and the sentinel ``rps`` on the
    others; each shard's sink rows lie in ``[0, rps]`` with some past the
    slab (``rps + 1 ..``). ``kind``: ``random``; ``all-hit``, one answer word
    whose 32 targets all read a full word; ``one-word-sinks``, every sink
    entry in one answer word, half of them hits; ``passive-absent``, every
    target a passive row or the absent row ``n_int`` (unsharded) — the
    last shard's rows (sharded); ``unowned``, a third of the targets and
    sink rows owned by no shard (unsharded: as ``random``)."""
    if kind not in ANSWER_KINDS:
        raise ValueError(f"unknown answer layout {kind!r}")
    B = 32 * W
    SA = SA or 2 * B + 7
    S = 32

    def sparse(shape):
        return (_bits(rng, shape) & _bits(rng, shape)).astype(np.int32)

    def sinks(hi, k):
        rows = rng.integers(0, hi, size=k).astype(np.int32)
        qs = rng.integers(0, B, size=k).astype(np.int32)
        if kind == "one-word-sinks":
            qs = (32 * (W - 1) + rng.integers(0, 32, size=k)).astype(np.int32)
        return rows, qs

    pad = lambda row: [np.full(S, row, np.int32), np.zeros(S, np.int32)] * 2  # noqa: E731
    if not g:
        P = sparse((n_active + 1, W))
        P[n_active] = 0
        ans_base, R = sparse((n_int + 1, W)), sparse((n_int + 1, W))
        targets = rng.integers(0, n_int + 1, size=B).astype(np.int32)
        if kind == "passive-absent":
            targets = rng.integers(n_active, n_int + 1, size=B).astype(np.int32)
            targets[::5] = n_int
        a_rows, a_q = sinks(n_int + 1, SA)
        w0 = W // 2
        if kind == "all-hit":
            r = int(rng.integers(0, n_active))
            P[r, w0] = -1
            targets[32 * w0 : 32 * w0 + 32] = r
        if kind == "one-word-sinks":
            R[a_rows[::2], W - 1] = -1
        entries = np.concatenate(pad(n_int + 1) + [a_rows, a_q, targets]).astype(np.int32)
        return dict(entries=entries, sizes=(S, S, SA, B), n_active=n_active, P=P,
                    ans_base=ans_base, R=R)
    rps = -(-(n_int + 1) // g)
    P, ans_base, R = (sparse((g * rps, W)) for _ in range(3))
    owner = rng.integers(0, g, size=B)
    if kind == "passive-absent":
        owner[:] = g - 1
    if kind == "unowned":
        owner[rng.random(B) < 1 / 3] = -1
    local = rng.integers(0, rps, size=B).astype(np.int32)
    w0 = W // 2
    if kind == "all-hit":
        s0, r0 = int(rng.integers(0, g)), int(rng.integers(0, rps))
        P[s0 * rps + r0, w0] = -1
        owner[32 * w0 : 32 * w0 + 32], local[32 * w0 : 32 * w0 + 32] = s0, r0
    rows = []
    for s in range(g):
        targets = np.where(owner == s, local, rps).astype(np.int32)
        a_rows, a_q = sinks(rps, SA)
        if kind == "unowned":
            a_rows[rng.random(SA) < 1 / 3] = rps
        a_rows[::11] = rps + 1 + a_rows[::11]  # rows past the slab
        if kind == "one-word-sinks":
            own = a_rows[::2] < rps
            R[s * rps + a_rows[::2][own], W - 1] = -1
        rows.append(np.concatenate(pad(rps) + [a_rows, a_q, targets]))
    return dict(entries=np.stack(rows).astype(np.int32), sizes=(S, S, SA, B), rps=rps, P=P,
                ans_base=ans_base, R=R)


def random_label_rows(rng, n: int, width: int, pad: int, hi: int) -> np.ndarray:
    """int32[n+1, width]: per row a sorted set of distinct values in
    [0, hi) (some rows empty, some full), then ``pad``; row n all pad."""
    lab = np.full((n + 1, width), pad, np.int32)
    for r in range(n):
        k = int(rng.choice([0, 1, rng.integers(0, width + 1), width]))
        k = min(k, hi)
        if k:
            lab[r, :k] = np.sort(rng.choice(hi, size=k, replace=False))
    return lab


def random_label_case(rng, n: int, Wo: int, Wi: int, W: int, pairs: int, *,
                      sorted_queries: bool = False, exchanged: bool = False):
    """``(out_lab, in_lab, entries, n_pairs, B)`` for ``label_step``:
    ``pairs`` live pairs (several per query, every word's bit-31 query
    among them) padded to ``n_pairs`` with pad pairs, values drawn from a
    small range so hits and misses both occur. ``sorted_queries`` gives the
    engine's order: the live pairs ascending by query, the pad pairs (query
    0) after them. ``exchanged`` gives the shape K10b hands K3: the label
    arrays are the rows the pairs name, ``out_lab[pa]`` and ``in_lab[pb]``,
    and pair ``p`` reads row ``p`` of each (``pa = pb = arange(n_pairs)``)."""
    from keto_tpu_torch.check.pack import _entry_pad

    B = 32 * W
    hi = 2 * max(Wo, Wi)
    out_lab = random_label_rows(rng, n, Wo, -1, hi)
    in_lab = random_label_rows(rng, n, Wi, -2, hi)
    pa = rng.integers(0, n + 1, size=pairs)
    pb = rng.integers(0, n + 1, size=pairs)
    pq = rng.integers(0, B, size=pairs)
    k = min(W, pairs)
    pq[:k] = np.arange(k) * 32 + 31
    if sorted_queries:
        order = np.argsort(pq, kind="stable")
        pa, pb, pq = pa[order], pb[order], pq[order]
    P = _entry_pad(B, pairs)
    pad = P - pairs
    pa = np.concatenate([pa, np.full(pad, n)])
    pb = np.concatenate([pb, np.full(pad, n)])
    if exchanged:
        out_lab, in_lab = out_lab[pa], in_lab[pb]
        pa = pb = np.arange(P)
    entries = np.concatenate([pa, pb, pq, np.zeros(pad)])
    return out_lab, in_lab, entries.astype(np.int32), P, B


def outside_rows(rng, rows: np.ndarray, n: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """``(got, plain)`` for pair rows ``rows`` over label arrays of ``n + 1``
    rows: ``got`` a copy with ``k`` of them moved outside ``[0, n]`` (below
    0, or at ``n + 1`` and past), ``plain`` the same copy with those rows on
    the all-pad row ``n`` instead. A kernel's answer on ``got`` must equal
    the plain version's on ``plain``: a pair naming a row outside its
    arrays matches nothing, as a pair of pad rows."""
    got, plain = rows.copy(), rows.copy()
    at = rng.choice(rows.size, size=min(k, rows.size), replace=False)
    far = rng.integers(n + 1, 4 * (n + 1), size=at.size)
    got[at] = np.where(np.arange(at.size) % 2 == 0, -1 - far, far).astype(rows.dtype)
    plain[at] = n
    return got, plain


def random_witness_case(rng, n: int, Wo: int, Wi: int, pairs: int, *, shuffle: bool = False):
    """``(out_lab, in_lab, pa, pb)`` for ``label_step_witness``: label rows
    as ``random_label_case``'s, each row's slots permuted when ``shuffle``
    (the kernel may not rely on order), plus three fixed rows: OUT row 0
    and IN row 1 hold the same entries (every entry common), OUT row 2
    holds values no IN row has (no common entry). The first pairs are
    (0, 1), (2, 1), (2, r), the pad row ``n`` on either side; the rest
    are random over [0, n]."""
    hi = 2 * max(Wo, Wi)
    out_lab = random_label_rows(rng, n, Wo, -1, hi)
    in_lab = random_label_rows(rng, n, Wi, -2, hi)
    k = min(Wo, Wi)
    common = np.sort(rng.choice(hi, size=k, replace=False)).astype(np.int32)
    out_lab[0] = -1
    out_lab[0, :k] = common
    in_lab[1] = -2
    in_lab[1, :k] = common
    out_lab[2] = np.arange(hi, hi + Wo, dtype=np.int32)
    if shuffle:
        for lab in (out_lab, in_lab):
            for r in range(n + 1):
                lab[r] = lab[r, rng.permutation(lab.shape[1])]
    fixed_a = [0, 2, 2, n, 3 % n, n]
    fixed_b = [1, 1, int(rng.integers(0, n)), 1, n, n]
    m = max(0, pairs - len(fixed_a))
    pa = np.concatenate([fixed_a, rng.integers(0, n + 1, size=m)])[:pairs]
    pb = np.concatenate([fixed_b, rng.integers(0, n + 1, size=m)])[:pairs]
    return out_lab, in_lab, pa.astype(np.int32), pb.astype(np.int32)


def random_sweep_case(rng, n: int, caps, rows, wt: int):
    """``(groups, V, X, S, cov)`` for the frontier wave: ELL groups of
    ``rows[g]`` rows with degree cap ``caps[g]`` over distinct ``dst`` rows
    (the rest of [0, n) is in no group), and random int32[n+1, wt] bitmaps
    with the sentinel row n of X zero."""
    if sum(rows) > n:
        raise ValueError("dst rows are distinct interior rows")
    dst_all = rng.permutation(n)[: sum(rows)].astype(np.int32)
    groups, at = [], 0
    for cap, r in zip(caps, rows):
        nbrs = np.full((r, cap), n, np.int32)
        for i in range(r):
            fill = int(rng.integers(1, cap + 1))
            nbrs[i, :fill] = rng.integers(0, n + 1, size=fill)
        groups.append((nbrs, dst_all[at : at + r]))
        at += r
    V, X, S, cov = (_bits(rng, (n + 1, wt)) for _ in range(4))
    X[rng.random((n + 1, wt)) < 0.5] = 0
    V[rng.random((n + 1, wt)) < 0.3] = 0
    X[n] = 0
    return groups, V, X, S, cov


def random_covered_case(rng, rows: int, width: int, lanes: int, pad: int = -1,
                        own_width: int = 0, empty: bool = False):
    """``(lab, own)`` for the covered mask. ``lab`` int32[rows, width]: label
    rows over node ids in [0, rows), padded after their entries with the
    other side's pad (-2 for ``pad`` -1, else -1), full rows among them;
    every seventh row and the last all pads, the id rows-1 in row 1.
    ``own`` int32[lanes, own_width or width]: the lanes' own rows over a
    third of the ids (0..8 entries, lane 1 full), padded with ``pad``; one
    id in every other lane, rows-1 in the last lane, lane 0 empty when
    there are several; all ``pad`` with ``empty``."""
    other = -2 if pad == -1 else -1
    lab = rng.integers(0, rows, size=(rows, width)).astype(np.int32)
    k = rng.integers(0, width + 1, size=rows)
    k[rng.random(rows) < 0.2] = width
    lab[np.arange(width)[None, :] >= k[:, None]] = other
    lab[::7] = other
    lab[-1] = other
    if rows > 2:
        lab[1, 0] = rows - 1
    ow = own_width or width
    pool = rng.choice(rows, size=max(1, rows // 3), replace=False).astype(np.int32)
    own = pool[rng.integers(0, pool.size, size=(lanes, ow))]
    kk = rng.integers(0, min(ow, 8) + 1, size=lanes)
    if lanes > 1:
        kk[1] = ow
    own[np.arange(ow)[None, :] >= kk[:, None]] = pad
    own[::2, -1] = pool[0]
    own[-1, 0] = rows - 1
    if lanes > 1:
        own[0] = pad
    if empty:
        own[:] = pad
    return lab, own


def random_slot_case(rng, rows: int, ld: int, m: int, dup: bool = False, one_d: bool = False):
    """A slot-set target and its entries, as the write path makes them:
    ``(buf, rows, cols, vals)`` with ``buf`` int32 ``[rows, ld]`` (``[rows]``
    with ``one_d``, ``cols`` then None) and ``m`` entries at distinct slots
    (``m <= rows·ld``), or with ``dup`` about a quarter of them landing on
    slots already named, in a random order."""
    shape = (rows,) if one_d else (rows, ld)
    buf = rng.integers(-2, rows + 2, size=shape).astype(np.int32)
    width = 1 if one_d else ld
    flat = rng.choice(rows * width, size=m, replace=False) if m else np.zeros(0, np.int64)
    if dup and m > 1:
        k = max(1, m // 4)
        flat[rng.choice(m, size=k, replace=False)] = flat[rng.integers(0, m, size=k)]
    vals = rng.integers(-2, rows + 2, size=m).astype(np.int32)
    r, c = flat // width, flat % width
    return buf, r, None if one_d else c, vals


#: the list fixpoint's parity layouts: base pull only; an overlay into
#: active rows; an overlay into passive rows (no base neighbour); a chain
#: that ``it_cap`` truncates; no active row but an overlay; all 32 lanes
LIST_CASES = ("bucket-only", "overlay-active", "overlay-passive", "chain-truncated",
              "no-active-overlay", "lane-31")


def list_case_tuples(kind: str, rng) -> tuple[list, str]:
    """``(tuples, orient)`` for a ``LIST_CASES`` kind, over namespaces
    ``g`` and ``d``: every set has a user member (so no interior row peels),
    a static ``d`` doc points into the graph."""
    from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

    def T(ns, obj, sub):
        return RelationTuple(ns, obj, "m" if ns == "g" else "view", sub)

    tuples = []
    if kind == "chain-truncated":
        n = 30
        for i in range(n - 1):
            tuples.append(T("g", f"c{i}", SubjectSet("g", f"c{i + 1}", "m")))
        tuples.append(T("d", "doc", SubjectSet("g", "c0", "m")))
        names = [f"c{i}" for i in range(n)]
    elif kind == "no-active-overlay":
        names = ["a", "b", "c", "e"]
        for i, x in enumerate(names):
            tuples.append(T("d", f"doc{i}", SubjectSet("g", x, "m")))
    else:
        n = 48
        names = [f"n{i}" for i in range(n)]
        # the last 8 nodes get no interior in-edge: passive rows of "fwd"
        for _ in range(96):
            a, b = int(rng.integers(0, n)), int(rng.integers(0, n - 8))
            tuples.append(T("g", names[a], SubjectSet("g", names[b], "m")))
        for i in range(n - 8, n):
            tuples.append(T("d", f"doc{i}", SubjectSet("g", names[i], "m")))
    for i, x in enumerate(names):
        tuples.append(T("g", x, SubjectID(f"u{i % 7}")))
    orient = "rev" if kind in ("bucket-only", "lane-31") else "fwd"
    return tuples, orient


def list_case_inputs(kind: str, rng, n_rows: int, n_active: int):
    """``(R0, ov_nbrs, ov_dst, it_cap, block_iters)`` for a layout of
    ``n_rows`` rows, ``n_active`` of them bucket-covered: R0 int32
    ``[n_rows + 1, 1]`` (row ``n_rows`` zero), the overlay int32 ``[K, C]``
    and ``[K]`` or None."""
    R0 = np.zeros((n_rows + 1, 1), np.uint32)
    lanes = 32 if kind == "lane-31" else 4
    for q in list(range(lanes - 1)) + [31]:
        for r in rng.choice(n_rows, size=min(n_rows, 2), replace=False):
            R0[r, 0] |= np.uint32(1) << np.uint32(q)
    it_cap, block_iters = n_rows + 2, 8
    if kind == "chain-truncated":
        it_cap, block_iters = 5, 3
    ov_nbrs = ov_dst = None
    if kind in ("overlay-active", "overlay-passive", "no-active-overlay"):
        if kind == "overlay-active":
            dsts = rng.choice(n_active, size=min(n_active, 6), replace=False)
        else:  # passive rows: past the bucket-covered prefix
            dsts = rng.choice(np.arange(n_active, n_rows), size=min(n_rows - n_active, 3),
                              replace=False)
        K = _ceil_pow2(len(dsts) + 1)  # at least one padded destination
        C = 4
        ov_nbrs = np.full((K, C), n_rows, np.int32)
        ov_dst = np.full(K, n_rows + 1, np.int32)
        for i, d in enumerate(dsts):
            ov_dst[i] = d
            fill = int(rng.integers(1, C + 1))
            ov_nbrs[i, :fill] = rng.integers(0, n_rows, size=fill)
        if kind == "no-active-overlay":
            # a path through the overlay alone, so the fixpoint needs steps
            R0[:] = 0
            R0[0, 0] = np.uint32(1) | (np.uint32(1) << np.uint32(31))
            ov_dst[: n_rows - 1] = np.arange(1, n_rows)
            ov_nbrs[: n_rows - 1] = n_rows
            ov_nbrs[: n_rows - 1, 0] = np.arange(0, n_rows - 1)
    return R0.view(np.int32), ov_nbrs, ov_dst, it_cap, block_iters


#: the list fixpoint's random layouts: (caps, valid rows, passive rows,
#: overlay rows, it_cap, block_iters) — wide buckets (a warp a row in the
#: kernel), overlays into active and passive rows, it_cap cuts that are not
#: a multiple of block_iters (the last a chain longer than its it_cap)
LIST_WIDE_CASES = [
    ((1, 2, 64), (200, 50, 6), 40, 12, 10_000, 8),
    ((1, 4096), (300, 3), 20, 0, 10_000, 8),
    ((1, 32, 128), (120, 20, 4), 30, 9, 5, 3),
    ((1,), (90,), 10, 6, 7, 2),
]


def random_list_layout(rng, caps, rows, passive: int, K: int):
    """``(buckets, R0, ov_nbrs, ov_dst)`` for the list fixpoint: buckets
    tiling ``sum(rows)`` active rows (a chain when ``caps == (1,)``),
    ``passive`` rows past them, R0 int32 ``[n_rows + 1, 1]`` with bits 0, 1
    and 31 scattered (a chain's at its head only; row ``n_rows`` zero), and,
    when ``K``, an overlay of
    ``K`` distinct destinations (half of them passive) plus two padded
    ones, or None."""
    n_active = sum(rows)
    n_rows = n_active + passive
    chain = tuple(caps) == (1,)
    buckets = random_buckets(rng, n_rows, caps, rows, chain=chain)
    R0 = np.zeros((n_rows + 1, 1), np.uint32)
    if chain:  # seeded at its head only, so the walk takes one step a row
        R0[0, 0] = np.uint32(0x80000001)
    else:
        R0[:n_rows, 0] = (rng.integers(0, 2**32, size=n_rows, dtype=np.uint64)
                          & np.uint64(0x80000003))
    ov = ov_dst = None
    if K:
        dst = np.concatenate([rng.choice(np.arange(n_active, n_rows), size=K // 2, replace=False),
                              rng.choice(n_active, size=K - K // 2, replace=False)])
        ov = np.full((K + 2, 4), n_rows, np.int32)
        ov[:K] = rng.integers(0, n_rows + 1, size=(K, 4))
        ov_dst = np.concatenate([dst, [n_rows + 1, n_rows + 1]]).astype(np.int32)
    return buckets, R0.view(np.int32), ov, ov_dst


#: the build sort's parity layouts; "config-4 range" is 10M keys in
#: [0, 5.2M) at config 4's size (a node-id range of its edge arrays);
#: "sparse digits" mixes keys whose digit 1 is constant while digits 0, 2
#: and 3 vary (a skipped pass between passes that run); "bucket keys" are
#: the build's degree buckets (``ceil(log2(deg)) + 1``), only digit 0 varies
SORT_CASES = ("empty", "one key", "all equal", "negative", "ragged tile", "random int32",
              "config-4 range", "sparse digits", "bucket keys")


def sort_case_keys(kind: str, rng, tile: int = 4096,
                   big: tuple = (100_000, 5_200_000)) -> np.ndarray:
    """int32 keys of a ``SORT_CASES`` kind; ``big`` = (count, range) of the
    "config-4 range" case (by default config 4's range at a test's count)."""
    if kind == "empty":
        return np.zeros(0, np.int32)
    if kind == "one key":
        return np.asarray([-7], np.int32)
    if kind == "all equal":
        return np.full(3 * tile + 5, 42, np.int32)
    if kind == "negative":
        return rng.integers(-1000, 1000, size=5000).astype(np.int32)
    if kind == "ragged tile":
        return rng.integers(0, 300, size=2 * tile + 17).astype(np.int32)
    if kind == "random int32":
        return rng.integers(-(2**31), 2**31, size=3 * tile + 1, dtype=np.int64).astype(np.int32)
    if kind == "config-4 range":
        return rng.integers(0, big[1], size=big[0]).astype(np.int32)
    if kind == "sparse digits":
        values = np.asarray([0, 1, 1 << 24, -(1 << 16)], np.int32)
        return values[rng.integers(0, values.size, size=3 * tile + 123)]
    if kind == "bucket keys":
        return rng.integers(1, 25, size=2 * tile + 77).astype(np.int32)
    raise ValueError(kind)
