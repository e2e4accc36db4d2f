"""Host half of a check batch: pack resolved queries into kernel entries.

A copy of the JAX-free helpers in keto_tpu/check/tpu_engine.py (``:84``
and ``:439-807``): ``pack_chunk`` walks host-propagated starts (static and
peeled nodes) through the forward CSR with numpy and emits the seven
entry arrays the check kernels consume; ``pack_entries`` concatenates
them into the single int32 buffer shipped to the card in one copy. The
walk runs in C++ (check/native_pack.py, the reference's native/pack.cpp)
on every chunk ``walk_eligible`` takes, as in the reference; the numpy
walk is the contract and takes the rest. Both are byte-identical to the
JAX package's ``native=False`` path (tests/test_torch_snapshot.py,
tests/test_torch_native_pack.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from keto_tpu_torch.check import native_pack
from keto_tpu_torch.graph.snapshot import GraphSnapshot

# batch widths (in 32-query words) the engine runs; a request is padded up
# to the smallest fitting width so entry geometries stay few
_WORD_WIDTHS = (1, 8, 64, 256, 1024, 2048, 4096)


def pack_entries(
    packed, out: Optional[np.ndarray] = None
) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Concatenate pack_chunk's seven arrays into check_step's single
    int32 ``entries`` buffer + split sizes. ``out`` (an int32 buffer of
    exactly the total size, else ``ValueError``) receives the concatenation
    in place and is the buffer returned: a staging buffer that does not fit
    must never ship what it held before."""
    (e1r, e1q, e2r, e2q, ar, aq, targets) = packed
    arrays = [e1r, e1q, e2r, e2q, ar, aq, targets]
    sizes = (e1r.shape[0], e2r.shape[0], ar.shape[0], targets.shape[0])
    if out is None:
        return np.concatenate(arrays), sizes
    n = sum(a.shape[0] for a in arrays)
    if out.dtype != np.int32 or out.shape != (n,) or any(a.dtype != np.int32 for a in arrays):
        raise ValueError(
            f"pack_entries: out is {out.dtype}{list(out.shape)}, the entries "
            f"{[str(a.dtype) for a in arrays]} need int32[{n}]"
        )
    return np.concatenate(arrays, out=out), sizes



class _SortedSeen:
    """Sorted-key membership set with amortized O(log n) inserts: keys
    live in a list of sorted runs whose lengths form a (loosely)
    geometric sequence — an insert batch merges equal-or-smaller runs
    (each element participates in O(log n) merges total), replacing the
    ``np.insert``-into-one-array scheme whose per-hop O(n) memmove made
    a long walk quadratic. ``work`` counts elements moved by merges."""

    __slots__ = ("_runs", "work")

    def __init__(self):
        self._runs: list[np.ndarray] = []
        self.work = 0

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """bool mask: which of ``keys`` are present (any order)."""
        mask = np.zeros(keys.shape[0], dtype=bool)
        for run in self._runs:
            pos = np.clip(np.searchsorted(run, keys), 0, run.size - 1)
            mask |= run[pos] == keys
        return mask

    def add(self, ks: np.ndarray) -> None:
        """Insert a SORTED batch of keys not currently present."""
        if not ks.size:
            return
        run = ks
        while self._runs and self._runs[-1].size <= run.size:
            prev = self._runs.pop()
            merged = np.concatenate([prev, run])
            merged.sort(kind="stable")
            self.work += merged.size
            run = merged
        self._runs.append(run)


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _csr_gather(indptr: np.ndarray, indices: np.ndarray, nodes: np.ndarray):
    """(all out-neighbors of ``nodes`` concatenated, per-node counts)."""
    cnts = indptr[nodes + 1] - indptr[nodes]
    total = int(cnts.sum())
    if not total:
        return np.zeros(0, indices.dtype), cnts
    base = np.repeat(indptr[nodes], cnts)
    within = np.arange(total) - np.repeat(np.cumsum(cnts) - cnts, cnts)
    return indices[base + within], cnts


def _entry_pad(B: int, size: int) -> int:
    """Scatter/gather entry arrays pad to B·2^k — a couple of geometries per
    batch width, so chunks of one request hit the same jit cache entry."""
    sp = B
    while sp < size:
        sp *= 2
    return sp


def _pad_entries(rows_l, qs_l, B: int, drop_row: int):
    if rows_l:
        rows = np.concatenate(rows_l).astype(np.int32)
        qs = np.concatenate(qs_l).astype(np.int32)
    else:
        rows = np.zeros(0, np.int32)
        qs = np.zeros(0, np.int32)
    pad = _entry_pad(B, rows.size) - rows.size
    rows = np.concatenate([rows, np.full(pad, drop_row, np.int32)])
    qs = np.concatenate([qs, np.zeros(pad, np.int32)])
    return rows, qs


def walk_numpy(
    snap: GraphSnapshot, rows: np.ndarray, pq: np.ndarray, tgc: np.ndarray
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The numpy walk of host-propagated (row, query) pairs (int64)
    through the forward CSR, overlays included: the contract
    ``native_pack.pack_walk`` reproduces. Returns ``(seed_rows, seed_q,
    host_hits)``: the device seeds, (query, row)-deduplicated in first-
    occurrence order, and the host-decided grants (None when there are
    none). ``tgc``: each query's target row (-1 = none)."""
    ni = snap.num_int
    sb = snap.sink_base
    hits = np.zeros(tgc.shape[0], dtype=bool)
    # multi-hop frontier propagation, (query, row)-deduplicated. The
    # visited set lives in merged sorted runs (_SortedSeen) — membership
    # stays one searchsorted pass per run, and inserts amortize to
    # O(log n) instead of the O(n) np.insert memmove that made long walks
    # quadratic.
    seen = _SortedSeen()
    seed_rows: list = []
    seed_q: list = []
    while rows.size:
        key = (pq << 32) | rows
        _, first = np.unique(key, return_index=True)
        keep = np.sort(first)
        rows, pq, key = rows[keep], pq[keep], key[keep]
        fresh = ~seen.contains(key)
        rows, pq, key = rows[fresh], pq[fresh], key[fresh]
        if not rows.size:
            break
        seen.add(np.sort(key))
        nbrs, cnts = snap.out_neighbors_bulk(rows)
        if not nbrs.size:
            break
        gq = np.repeat(pq, cnts)
        nbrs = nbrs.astype(np.int64)
        # a traversed edge landing on the query's target decides it
        # ("reached via ≥ 1 edge" — real edges only). The -1 no-target
        # sentinel can never match a neighbor id.
        hit = nbrs == tgc[gq]
        if hit.any():
            hits[gq[hit]] = True
        m_seed = nbrs < ni
        if m_seed.any():
            seed_rows.append(nbrs[m_seed])
            seed_q.append(gq[m_seed])
        m_next = (nbrs >= ni) & (nbrs < sb)
        rows, pq = nbrs[m_next], gq[m_next]
    if not seed_rows:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), (hits if hits.any() else None)
    # global (query, row) dedup: e2 scatter-adds per-bit, so a row seeded
    # twice for one query would carry into the next bit
    srows = np.concatenate(seed_rows)
    sq = np.concatenate(seed_q)
    skey = (sq << 32) | srows
    _, sfirst = np.unique(skey, return_index=True)
    keep = np.sort(sfirst)
    return srows[keep], sq[keep], (hits if hits.any() else None)


def pack_chunk(
    snap: GraphSnapshot,
    sd: np.ndarray,
    tg: np.ndarray,
    multi: dict,
    i0: int,
    i1: int,
    force_W: Optional[int] = None,
    native: bool = True,
):
    """Pack queries ``[i0, i1)`` of a bulk-resolved batch into kernel
    arguments — vectorized numpy throughout (the host side of the hot path,
    replacing the reference's per-traversal-step SQL round trips).

    ``sd``/``tg``/``multi`` come from ``TorchCheckEngine._resolve_bulk``.
    Starts in the host-propagated classes (static, or peeled interior —
    see the peel note in graph/snapshot.py) expand here through
    the forward CSR, one vectorized gather per hop over the whole chunk's
    frontier: reached bitmap rows become device seeds (e2), reached
    query targets are decided on host, and reached peeled rows continue
    the frontier (the peeled subgraph is a DAG among base nodes; the
    per-(query, row) visited filter also ends cycles a delta overlay may
    close). Sink targets get answer-gather entries from the
    snapshot's sink reverse CSR. With ``native`` (the default) the walk
    and the sink gather run in one GIL-released C++ call each wherever
    ``native_pack.walk_eligible(snap)``; ``native_pack.COUNTERS`` counts
    each chunk's path. The output is the JAX package's pack_chunk's, byte
    for byte.

    Returns ``(packed, host_ans)`` where ``packed`` is ``(e1_rows, e1_q,
    e2_rows, e2_q, a_rows, a_q, targets)`` numpy arrays (None when no
    query has any device entry; pack_entries concatenates them into the
    kernel's single buffer) and ``host_ans`` is a bool[nq] of
    host-decided grants to OR into the device answers.
    """
    nq = i1 - i0
    W = force_W or next(w for w in _WORD_WIDTHS if 32 * w >= nq)
    B = 32 * W
    ni = snap.num_int
    sb = snap.sink_base
    nl = snap.num_live
    qi = np.arange(nq)
    tgc = tg[i0:i1]
    sdc = sd[i0:i1]
    host_ans = np.zeros(nq, dtype=bool)
    targets = np.full(B, ni, dtype=np.int32)
    targets[:nq] = np.where((tgc >= 0) & (tgc < ni), tgc, ni)

    e1: tuple[list, list] = ([], [])
    e2: tuple[list, list] = ([], [])
    m_int = (sdc >= 0) & (sdc < ni)
    if m_int.any():
        e1[0].append(sdc[m_int])
        e1[1].append(qi[m_int])
    # host-propagated starts: peeled interior, static and overlay nodes (an
    # overlay sink start has no out-edges and yields nothing). Base sink
    # starts [sb, nl) have no out-edges: nothing to seed.
    m_host = ((sdc >= ni) & (sdc < sb)) | (sdc >= nl)
    prop_rows = [sdc[m_host]] if m_host.any() else []
    prop_q = [qi[m_host]] if m_host.any() else []
    for i, (live, hostp) in multi.items():
        if not (i0 <= i < i1):
            continue
        li = i - i0
        if live.size:
            e1[0].append(live)
            e1[1].append(np.full(live.size, li, np.int64))
        if hostp.size:
            prop_rows.append(hostp)
            prop_q.append(np.full(hostp.size, li, np.int64))

    use_native = native and native_pack.walk_eligible(snap)
    native_pack.COUNTERS["native" if use_native else "numpy"] += 1
    if prop_rows:
        rows = np.concatenate(prop_rows).astype(np.int64)
        pq = np.concatenate(prop_q).astype(np.int64)
        # native: one GIL-released C++ call walks the whole frontier
        # (threaded CSR gathers, hash-set seen/seed dedup), bit-identical
        walk = native_pack.pack_walk if use_native else walk_numpy
        srows, sq, hits = walk(snap, rows, pq, tgc)
        if hits is not None:
            host_ans |= hits
        if srows.size:
            e2[0].append(srows)
            e2[1].append(sq)

    # answer-gather entries for sink targets of queries that have any start
    has_start = m_int | m_host
    for i in multi:
        if i0 <= i < i1:
            has_start[i - i0] = multi[i][0].size > 0 or multi[i][1].size > 0
    ans: tuple[list, list] = ([], [])
    m_sink_t = (tgc >= sb) & (tgc < nl)
    if snap.ov_sink_in:
        # overlay targets (ids >= n_base_nodes) and base sinks with overlay
        # in-edges both answer through sink_in_rows_bulk
        m_sink_t = m_sink_t | np.isin(tgc, np.fromiter(snap.ov_sink_in.keys(), np.int64))
    m_ans = has_start & m_sink_t
    if m_ans.any():
        if use_native:
            # overlay-free by eligibility: the native gather mirrors
            # sink_in_rows_bulk's plain-CSR arm off the GIL
            rows, cnts = native_pack.sink_gather(snap, tgc[m_ans])
        else:
            rows, cnts = snap.sink_in_rows_bulk(tgc[m_ans])
        if rows.size:
            ans[0].append(rows)
            ans[1].append(np.repeat(qi[m_ans], cnts).astype(np.int32))

    if not e1[0] and not e2[0]:
        return None, host_ans
    if ans[0]:
        a_rows = np.concatenate(ans[0]).astype(np.int32)
        a_q = np.concatenate(ans[1])
    else:
        a_rows = np.zeros(0, np.int32)
        a_q = np.zeros(0, np.int32)
    pad = _entry_pad(B, a_rows.size) - a_rows.size
    # answer padding: in-range all-zero row ni with query 0 — max(0) is a no-op
    a_rows = np.concatenate([a_rows, np.full(pad, ni, np.int32)])
    a_q = np.concatenate([a_q, np.zeros(pad, np.int32)])
    # seed padding row ni+1 is out of range for the [ni+1, W] bitmap → dropped
    return (
        _pad_entries(*e1, B, ni + 1) + _pad_entries(*e2, B, ni + 1)
        + (a_rows, a_q, targets),
        host_ans,
    )
