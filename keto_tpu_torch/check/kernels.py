"""The check path's device programs: the BFS pull (K1), the fixpoint step
(K2), the label intersection (K3), its witness (K4) and the slot set of
the write path (K9), each as a plain PyTorch version and a hand-written
CUDA kernel.

Source notes:

- ``pull`` replaces ``_pull`` (keto_tpu/check/tpu_engine.py:89): per degree
  bucket, gather ``R[nbrs]`` and OR-reduce over the bucket's degree; the
  bucket outputs concatenated are the active prefix. CUDA: ``keto_pull``
  in csrc/check_kernels.cu, ONE launch over every bucket (``PullRuns``, the
  host-side table of bucket runs): a team of lanes a row, 16-byte loads
  where the width allows, a neighbour id read by a team at once. Bound:
  bytes — it must read each bucket slot, each distinct source row once
  and write ``P``.
- ``check_step`` replaces ``check_step`` (tpu_engine.py:110, jitted at
  :257): the seed scatter (``keto_seed``), the whole guarded Jacobi loop in
  ONE cooperative launch (``keto_check_run``: per step K1's pull, the
  overlay OR and the commit between grid barriers, the guard on the card)
  and the answer gather + bit pack (``keto_answer_pack``: a warp owns an
  answer word, its 32 target decisions packed by one ballot; sink hits
  grouped by word, one atomic a distinct word a warp), with no host read
  in between. Bound: bytes — the seed and answer gathers touch a sector
  per entry; each step moves the pull's bytes and R and P once. The seeds
  and the run take an optional counter (``pop``): each adds the bits of R
  it newly sets (the sharded step's frontier-bit word).
- ``label_step`` replaces ``label_step`` (tpu_engine.py:310): per pair
  (a, b), ``any(out_lab[a][i] == in_lab[b][j])``, maxed into the owning
  query and packed to ``uint32[W]``. CUDA: ``keto_label_step`` in
  csrc/label_kernels.cu, ONE launch a call: a team of ``t`` lanes a pair
  (``label_team``: each lane holds up to 4 OUT entries in registers, so a
  warp compares 32/t pairs at once), a warp's 32 pairs read coalesced and
  handed to the teams by shuffle, two rounds of them at a time, 16-byte
  loads of both rows where the widths allow, every load of a row issued
  before its compares; the hits of a warp grouped by answer word, one
  ``atomicOr`` a distinct word. Bound: bytes at the route's widths — the pairs' entries once,
  each distinct label row they name once, the answer once — else the
  Wo·Wi int32 compares a pair.
- ``label_step_witness`` replaces ``label_step_witness`` (tpu_engine.py:352),
  the explain path's enrichment: per pair (a, b), the smallest
  ``out_lab[a]`` entry equal to some ``in_lab[b]`` entry, or -1. CUDA:
  ``keto_label_witness`` in csrc/label_kernels.cu, K3's compare core and
  tiling with a team minimum (xor shuffles within the team) in place of
  the "any", one coalesced store a warp's 32 pairs. Bound: as K3's; the
  explain path launches it with one pair, one warp, so a launch.
- ``slot_set_many`` replaces the XLA scatters ``buf.at[rows, cols].set(vals)``
  of ``_apply_ell_patch`` (tpu_engine.py:2542), ``_apply_overlay_delta``
  (:2665), ``_Mirror.flush_device`` (keto_tpu/graph/label_build.py:433)
  and the list site (keto_tpu/list/tpu_engine.py:337), every target of one
  call at once; ``slot_set`` is its one-target case. CUDA:
  ``keto_slot_set`` in csrc/patch_kernels.cu, ONE launch a call over every
  target: a block a tile of a functional target copies the tile (batches
  in flight keep gathering the old tensor) and writes the entries that
  fall in it; a block a tile of an in-place target's entries writes them.
  The host keeps the last entry per slot, in slot order, and checks every
  entry against its target before anything is uploaded (an out-of-range
  entry raises, every target untouched); one upload carries the
  descriptors and the entries (each block finds its own on the card), and
  no host read follows. Bound: bytes — a functional
  target is read and written once, each entry read once and written once;
  at the write path's sizes a launch's latency is larger.

The output is the reference's ``uint32[W+2]`` (held as int32): decision
bits, then the iteration count, then the truncation flag, equal word for
word. Each dispatcher runs the plain version only for tensors on the CPU
and the kernel for tensors on a CUDA device — never one in place of the
other. Every CUDA wrapper adds one to ``COUNTS[name]`` where it launches
its kernel, launches on the current stream and does not synchronise: the
guard of the fixpoint lives on the card, and the caller's read of the
output is the step's only host read. The run kernel also adds its steps
(pull phases) and halo copies into an int64 pair on the card
(``run_counts``), the counts no host read gives.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

#: per-CUDA-kernel launch counters (chip_smoke.py reads them); the label
#: build's kernels (keto_tpu_torch/graph/label_kernels.py), the build sort's
#: (keto_tpu_torch/graph/sort_kernels.py), the list fixpoint's
#: (keto_tpu_torch/list/kernels.py) and the sharded programs'
#: (keto_tpu_torch/parallel/sharded.py) count here too
COUNTS = {
    "seed": 0, "pull": 0, "check_run": 0, "answer_pack": 0,
    "label_step": 0, "label_witness": 0, "sweep_run": 0, "covered": 0, "slot_set": 0,
    "radix_hist": 0, "radix_pass": 0, "list_fixpoint": 0,
    "shard_answer": 0, "pair_rows": 0,
    # not kernels of their own: of the check runs, those with an overlay
    # pending (K2's overlay stage); whole radix sorts and the passes their
    # plans skipped; the waves the sweep runs ran; of the list fixpoint
    # launches, those with an overlay pending, and the steps every list
    # fixpoint ran
    "check_run_overlay": 0, "radix_sort": 0, "radix_pass_skipped": 0, "sweep_waves": 0,
    "list_fixpoint_overlay": 0, "list_iters": 0,
}
#: the kernels of the BFS route: a step is the seeds, one run and the answer
BFS_KERNELS = ("seed", "check_run", "answer_pack")

# cap on the [rows, chunk, W] gather intermediate of the plain pull
_DEGREE_CHUNK = 1024
_GATHER_ELEMS = 1 << 26
# cap on the [pairs, Wo, Wi] compare intermediate of the plain label step
_LABEL_PAIR_CHUNK = 2048


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# -- plain PyTorch versions ---------------------------------------------------


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction over ``dim`` (torch has none): pairwise halving."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        half = x.shape[0] // 2
        x = x[:half] | x[half:]
    return x[0]


def _gather_or(R: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """``OR_j R[nbrs[i, j]]`` per row i, in row and degree chunks."""
    n, cap = nbrs.shape
    W = R.shape[1]
    out = torch.zeros((n, W), dtype=R.dtype, device=R.device)
    chunk = min(cap, _DEGREE_CHUNK)
    rows = max(1, _GATHER_ELEMS // max(1, chunk * W))
    for r0 in range(0, n, rows):
        for c0 in range(0, cap, chunk):
            idx = nbrs[r0 : r0 + rows, c0 : c0 + chunk].long()
            out[r0 : r0 + rows] |= _or_reduce(R[idx], 1)
    return out


def pull_ref(
    bucket_nbrs: Sequence[torch.Tensor], valid_rows: Sequence[int], R: torch.Tensor
) -> torch.Tensor:
    """One BFS pull over the active rows: ``R`` int32[n_int+1, W] →
    int32[n_active, W], the concatenated per-bucket OR-reductions."""
    outs = [_gather_or(R, nb[:n]) for nb, n in zip(bucket_nbrs, valid_rows)]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _split(entries: torch.Tensor, sizes):
    S1, S2, SA, B = sizes
    parts = torch.split(entries, [S1, S1, S2, S2, SA, SA, B])
    return [p.long() for p in parts]


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words read as uint32 (int64 result)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def u32_to_i32(v: int) -> int:
    """``v`` mod 2^32 as the int32 word that holds it."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def count_into(pop: Optional[torch.Tensor], bits: int) -> None:
    """``pop[0] += bits`` as uint32 with wrap-around (an int32 word), as the
    kernels' ``atomicAdd`` into the frontier-bit counter; None counts
    nothing."""
    if pop is not None:
        pop[0] = u32_to_i32(int(pop[0]) + int(bits))


def seed_ref(entries, sizes, n_int: int, W: int, pop: Optional[torch.Tensor] = None):
    """``(R0, ans_base)``: e1/e2 query bits set in their rows; rows outside
    ``[0, n_int]`` are dropped. An OR, as ``keto_seed``'s atomicOr: on
    distinct (row, query) pairs, the engine's, it equals the reference's
    scatter-add, and an entry given twice sets its bit once. ``pop`` counts
    the bits of R0 the seeds set (each once)."""
    e1r, e1q, e2r, e2q, _, _, _ = _split(entries, sizes)
    dev = entries.device
    ans_base = torch.zeros((n_int + 1, W), dtype=torch.int32, device=dev)
    R0 = torch.zeros((n_int + 1, W), dtype=torch.int32, device=dev)
    for dst, rows, qs in ((ans_base, e2r, e2q), (R0, e1r, e1q)):
        keep = (rows >= 0) & (rows <= n_int)
        keys = torch.unique(rows[keep] * (32 * W) + qs[keep])
        rows, qs = keys // (32 * W), keys % (32 * W)
        bits = (torch.ones_like(qs) << (qs & 31)).to(torch.int32)
        dst.view(-1).index_put_((rows * W + (qs >> 5),), bits, accumulate=True)
    R0 |= ans_base
    count_into(pop, int(_popcount(R0).sum()))
    return R0, ans_base


def commit_ref(P: torch.Tensor, R: torch.Tensor, n_active: int, state: torch.Tensor,
               pop: Optional[torch.Tensor] = None) -> None:
    """``R[:n_active] |= P[:n_active]`` while ``state[0]`` (changed) is set,
    raising ``state[2]`` (step_changed) when a word grew; ``pop`` counts the
    bits the commit newly set."""
    if int(state[0]) == 0:
        return
    act = R[:n_active]
    nxt = act | P[:n_active]
    if bool((nxt != act).any()):
        state[2] = 1
        count_into(pop, int(_popcount(nxt & ~act).sum()))
    R[:n_active] = nxt


def close_ref(state: torch.Tensor) -> None:
    """End one guarded step: changed = step_changed, step_changed = 0,
    iters += 1 — only while changed is set."""
    if int(state[0]):
        state.copy_(torch.stack([state[2], state[1] + 1, torch.zeros_like(state[2])]))


def _pack_bits(hit: torch.Tensor) -> torch.Tensor:
    """int32 {0,1}[B] → int32[B/32]: bit q&31 of word q>>5."""
    lanes = torch.arange(32, dtype=torch.int32, device=hit.device)
    return _or_reduce(hit.view(-1, 32) << lanes, 1)


def answer_pack_ref(entries, sizes, n_active: int, P, ans_base, R, iters: int, truncated: bool):
    """Decisions from the fixpoint, packed, plus the two tail words."""
    _, _, _, _, a_rows, a_q, targets = _split(entries, sizes)
    B = sizes[3]
    dev = entries.device
    q = torch.arange(B, device=dev)
    # shift amounts stay int32 so the bitmaps never promote to int64
    words, bits = q >> 5, (q & 31).to(torch.int32)
    t_act = torch.where(targets < n_active, targets, torch.full_like(targets, n_active))
    a = P[t_act, words] | ans_base[targets, words]
    hit = (a >> bits) & 1
    vals = (R[a_rows, a_q >> 5] >> (a_q & 31).to(torch.int32)) & 1
    hit = hit.scatter_reduce(0, a_q, vals, reduce="amax")
    tail = torch.tensor([iters, int(truncated)], dtype=torch.int32, device=dev)
    return torch.cat([_pack_bits(hit), tail])


def overlay_or_ref(P, src, ov_nbrs, ov_dst, n_dst: int, base: int = 0) -> None:
    """The overlay stage in place: ``P[base + d] |= OR_c src[ov_nbrs[k, c]]``
    for each row k whose destination ``d = ov_dst[k]`` lies in ``[0,
    n_dst)`` (others are dropped)."""
    keep = (ov_dst >= 0) & (ov_dst < n_dst)
    if bool(keep.any()):
        P[base + ov_dst[keep].long()] |= _gather_or(src, ov_nbrs[keep])


def check_run_ref(
    bucket_nbrs: Sequence[torch.Tensor],
    valid_rows: Sequence[int],
    R: torch.Tensor,
    P: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    it_cap: int,
    block_iters: int = 8,
    pop: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``keto_check_run``'s plain version: the guarded Jacobi fixpoint of
    ``R`` (int32[n_int+1, W], in place), the pull of the last step run in
    ``P[:n_active]`` → the state int32[3] {changed at exit, steps run,
    step_changed}: per step the pull, the overlay OR (from the same ``R``),
    ``commit_ref`` and ``close_ref``, in blocks of ``block_iters`` steps
    whose guard is tested where a block begins. It runs a first step
    whatever it is given (the sharded program's loop has no "nothing to
    pull" guard; ``check_step_ref`` skips the run instead). ``pop`` counts
    the bits the commits newly set."""
    n_active = sum(int(n) for n in valid_rows)
    state = torch.tensor([1, 0, 0], dtype=torch.int32, device=R.device)
    while int(state[0]) and int(state[1]) < it_cap:
        for _ in range(block_iters):
            if not int(state[0]):  # a guarded step after convergence is a no-op
                break
            if n_active:
                P[:n_active] = pull_ref(bucket_nbrs, valid_rows, R)
            if ov_nbrs is not None:
                overlay_or_ref(P, R, ov_nbrs, ov_dst, n_active)
            commit_ref(P, R, n_active, state, pop)
            close_ref(state)
    return state


def check_step_ref(
    bucket_nbrs: Sequence[torch.Tensor],
    entries: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    sizes: tuple[int, int, int, int],
    n_active: int,
    n_int: int,
    valid_rows: Sequence[int],
    it_cap: int,
    block_iters: int = 8,
) -> torch.Tensor:
    """The reference check step in plain PyTorch → int32[W+2]: the seeds,
    the run (none without active rows or buckets) and the answer."""
    W = sizes[3] // 32
    R, ans_base = seed_ref(entries, sizes, n_int, W)
    # P's extra all-zero row is what passive and absent targets read
    P = torch.zeros((n_active + 1, W), dtype=torch.int32, device=entries.device)
    iters, truncated = 0, False
    if n_active and bucket_nbrs:
        state = check_run_ref(bucket_nbrs, valid_rows, R, P, ov_nbrs, ov_dst, it_cap=it_cap,
                              block_iters=block_iters)
        iters, truncated = int(state[1]), bool(state[0])
    return answer_pack_ref(entries, sizes, n_active, P, ans_base, R, iters, truncated)


def _label_parts(entries: torch.Tensor, n_pairs: int):
    P = n_pairs
    if entries.numel() != 3 * P:
        raise ValueError(f"entries of {entries.numel()} words do not hold {P} pairs")
    return entries[:P], entries[P : 2 * P], entries[2 * P :]


def label_step_ref(out_lab, in_lab, entries, *, n_pairs: int, B: int) -> torch.Tensor:
    """The reference label step in plain PyTorch → int32[B/32]: per pair
    (a, b), does OUT(a) share an entry with IN(b)? The distinct pads
    (-1 OUT, -2 IN) never compare equal. Pair hits max into their query
    (never add) and pack to one bit per query."""
    pa, pb, pq = (p.long() for p in _label_parts(entries, n_pairs))
    hits = []
    for c0 in range(0, n_pairs, _LABEL_PAIR_CHUNK):
        oa = out_lab[pa[c0 : c0 + _LABEL_PAIR_CHUNK]]  # [chunk, Wo]
        ib = in_lab[pb[c0 : c0 + _LABEL_PAIR_CHUNK]]  # [chunk, Wi]
        hits.append((oa[:, :, None] == ib[:, None, :]).flatten(1).any(1))
    hit = torch.cat(hits) if hits else torch.zeros(0, dtype=torch.bool, device=entries.device)
    ans = torch.zeros(B, dtype=torch.int32, device=entries.device)
    ans = ans.scatter_reduce(0, pq, hit.to(torch.int32), reduce="amax")
    return _pack_bits(ans)


def label_step_witness_ref(out_lab, in_lab, pa, pb) -> torch.Tensor:
    """The reference witness step in plain PyTorch → int32[P]: per pair
    (a, b), the smallest OUT(a) entry equal to some IN(b) entry, or -1
    when none is. The distinct pads keep pad slots (and the all-pad row)
    out of the minimum. The ``[P, Wo, Wi]`` compare runs in chunks of
    pairs, as ``label_step_ref``'s."""
    pa, pb = pa.long(), pb.long()
    big = torch.iinfo(torch.int32).max
    outs = []
    for c0 in range(0, pa.numel(), _LABEL_PAIR_CHUNK):
        oa = out_lab[pa[c0 : c0 + _LABEL_PAIR_CHUNK]]  # [chunk, Wo]
        ib = in_lab[pb[c0 : c0 + _LABEL_PAIR_CHUNK]]  # [chunk, Wi]
        entry_hit = (oa[:, :, None] == ib[:, None, :]).any(2)  # [chunk, Wo]
        lm = torch.where(entry_hit, oa, torch.full_like(oa, big)).amin(1)
        outs.append(torch.where(entry_hit.any(1), lm, torch.full_like(lm, -1)))
    if not outs:
        return torch.zeros(0, dtype=torch.int32, device=pa.device)
    return torch.cat(outs).to(torch.int32)


def _slot_entries(buf: torch.Tensor, rows, cols, vals):
    """Host entry arrays for a slot set on ``buf``: int64 rows/cols, int32
    vals, the 1-D case as column 0. Every entry is checked against the
    target (an entry outside it raises), then only the LAST entry per slot
    is kept, in slot order (row-major)."""
    rows = np.asarray(rows, np.int64).ravel()
    cols = np.zeros_like(rows) if cols is None else np.asarray(cols, np.int64).ravel()
    vals = np.asarray(vals, np.int64).ravel()
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError(f"slot set: {rows.size} rows, {cols.size} cols, {vals.size} vals")
    if buf.dim() not in (1, 2):
        raise ValueError(f"slot set: expected a 1-D or 2-D target, got {tuple(buf.shape)}")
    ld = 1 if buf.dim() == 1 else buf.shape[1]
    err = _slot_range_error(buf, rows, cols, ld)
    if err is not None:
        raise err
    if rows.size:
        _, last_rev = np.unique((rows * ld + cols)[::-1], return_index=True)
        keep = rows.size - 1 - last_rev
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    return rows, cols, vals.astype(np.int32), ld


def _slot_range_error(buf, rows, cols, ld) -> Optional[ValueError]:
    bad = (rows < 0) | (rows >= buf.shape[0]) | (cols < 0) | (cols >= ld)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        return ValueError(
            f"slot set: entry ({rows[i]}, {cols[i]}) lies outside a target of "
            f"{tuple(buf.shape)}"
        )
    return None


def _slot_plan(targets) -> list:
    """``_slot_entries`` of every ``(buf, rows, cols, vals)`` target, all
    checked before any is written."""
    return [(buf, *_slot_entries(buf, *ent)) for buf, *ent in targets]


def slot_set_many_ref(targets, *, in_place: bool = False) -> list:
    """K9 in plain PyTorch over ``[(buf, rows, cols, vals), ...]``: per
    target ``out = buf.clone(); out[rows, cols] = vals`` (``out`` is
    ``buf`` itself with ``in_place``), after the last-entry-per-slot dedup;
    an entry outside its target raises before any target is written."""
    outs = []
    for buf, rows, cols, vals, _ in _slot_plan(targets):
        out = buf if in_place else buf.clone()
        if rows.size:
            v = torch.from_numpy(vals).to(out.device)
            r = torch.from_numpy(rows).to(out.device)
            if out.dim() == 1:
                out[r] = v
            else:
                out[r, torch.from_numpy(cols).to(out.device)] = v
        outs.append(out)
    return outs


def slot_set_ref(buf: torch.Tensor, rows, cols, vals, *, in_place: bool = False) -> torch.Tensor:
    """K9 in plain PyTorch on one target (``slot_set_many_ref``'s one-target
    case)."""
    return slot_set_many_ref([(buf, rows, cols, vals)], in_place=in_place)[0]


# -- CUDA wrappers ------------------------------------------------------------


def _lib():
    from keto_tpu_torch import _build

    return _build.lib()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")


def _need(t: torch.Tensor, what: str, ndim: int) -> None:
    if t.device.type != "cuda" or t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous int32 CUDA tensor of {ndim} dims, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _need_rows(t: torch.Tensor, what: str, rows: int, W: int) -> None:
    _need(t, what, 2)
    if t.shape[0] < rows or t.shape[1] != W:
        raise ValueError(f"{what}: expected at least {rows} rows of {W} words, got {tuple(t.shape)}")


def _need_entries(entries: torch.Tensor, sizes) -> None:
    _need(entries, "entries", 1)
    S1, S2, SA, B = sizes
    if entries.numel() != 2 * (S1 + S2 + SA) + B or B % 32:
        raise ValueError(f"entries of {entries.numel()} words do not match sizes {tuple(sizes)}")


def _need_state(state: torch.Tensor) -> None:
    _need(state, "state", 1)
    if state.numel() != 3:
        raise ValueError("state: expected int32[3] {changed at exit, steps run, a third word}")


def _need_pop(pop: Optional[torch.Tensor], device) -> None:
    if pop is not None:
        _need(pop, "pop", 1)
        if pop.numel() < 1 or pop.device != device:
            raise ValueError(f"pop: expected an int32 counter on {device}, got "
                             f"{tuple(pop.shape)} on {pop.device}")


def seed_cuda(entries: torch.Tensor, sizes, n_int: int, W: int, *, R=None, ans_base=None,
              pop: Optional[torch.Tensor] = None):
    """``(R0, ans_base)`` via ``keto_seed``, into the given zeroed
    ``[n_int+1, W]`` buffers or new ones; with ``pop`` (an int32 on the
    card, read as uint32) the kernel adds the bits of R it newly sets into
    ``pop[0]``."""
    _need_entries(entries, sizes)
    S1, S2, _, _ = sizes
    if R is None:
        R = torch.zeros((n_int + 1, W), dtype=torch.int32, device=entries.device)
        ans_base = torch.zeros_like(R)
    for t, what in ((R, "R"), (ans_base, "ans_base")):
        _need_rows(t, what, n_int + 1, W)
    _need_pop(pop, R.device)
    COUNTS["seed"] += 1
    _check(_lib().keto_seed(entries.data_ptr(), S1, S2, n_int, W, R.data_ptr(),
                            ans_base.data_ptr(), _ptr(pop), _stream()), "keto_seed")
    return R, ans_base


#: the bucket runs one ``keto_pull`` or ``keto_check_run`` launch takes
MAX_RUNS = 64
#: the check kernels index in 32 bits: every array they take holds fewer words
INDEX_LIMIT = 2**31


@dataclass(frozen=True)
class PullRuns:
    """The table of bucket runs of one pull, made on the host: run r
    gathers the first ``rows[r]`` rows of ``nbrs[r]`` (int32 ``[≥ rows,
    cap]``, neighbour ids = rows of the source bitmap) into the output rows
    ``out[r] ..``; the runs tile the output rows ``[0, n_rows)`` in order.
    Runs of no row are left out."""

    nbrs: tuple
    rows: tuple
    out: tuple
    n_rows: int

    def args(self) -> tuple:
        """The kernels' host arrays: ``(ptrs, rows, caps, outs, n)``."""
        n = len(self.nbrs)
        return ((ctypes.c_int64 * MAX_RUNS)(*[t.data_ptr() for t in self.nbrs]),
                (ctypes.c_int32 * MAX_RUNS)(*self.rows),
                (ctypes.c_int32 * MAX_RUNS)(*[t.shape[1] for t in self.nbrs]),
                (ctypes.c_int32 * MAX_RUNS)(*self.out), n)


def pull_runs(runs, *, src_rows: int, W: int) -> PullRuns:
    """``PullRuns`` of ``[(nbrs, rows, first output row), ...]``; raises on a
    table the kernels do not take: more than ``MAX_RUNS`` runs, a matrix
    that is not 2-D int32 with ``rows`` rows and a cap of at least 1, runs
    that do not tile their output rows in order (a ragged layout), or a
    source bitmap, output or matrix of 2^31 words or more (the kernels
    index in 32 bits)."""
    nbrs, rows, out = [], [], []
    at = 0
    for nb, k, first in runs:
        k, first = int(k), int(first)
        if nb.dtype != torch.int32 or nb.dim() != 2 or not nb.is_contiguous() or nb.shape[1] < 1:
            raise ValueError(f"bucket nbrs: expected a contiguous int32 [rows, cap >= 1] matrix, "
                             f"got {nb.dtype} {tuple(nb.shape)}")
        if not 0 <= k <= nb.shape[0]:
            raise ValueError(f"a bucket of {nb.shape[0]} rows cannot hold {k} valid rows")
        if nb.numel() >= INDEX_LIMIT:
            raise ValueError(f"bucket nbrs {tuple(nb.shape)}: the kernels index in 32 bits")
        if not k:
            continue
        if first != at:
            raise ValueError(f"a bucket run at output row {first} after {at} rows: the runs "
                             "must tile their output rows in order")
        nbrs.append(nb)
        rows.append(k)
        out.append(first)
        at += k
    if len(nbrs) > MAX_RUNS:
        raise ValueError(f"{len(nbrs)} bucket runs: the kernels' table holds {MAX_RUNS}")
    if max(src_rows, at + 1) * W >= INDEX_LIMIT:
        raise ValueError(f"bitmaps of {max(src_rows, at + 1)} rows of {W} words: the kernels "
                         "index in 32 bits")
    return PullRuns(tuple(nbrs), tuple(rows), tuple(out), at)


def bucket_runs(bucket_nbrs, valid_rows, *, src_rows: int, W: int) -> PullRuns:
    """The unsharded table: one run a degree bucket, the buckets tiling the
    active prefix in order."""
    offs = np.cumsum([0, *[int(n) for n in valid_rows]])
    return pull_runs(zip(bucket_nbrs, valid_rows, offs), src_rows=src_rows, W=W)


def pull_launch(lib, plan: PullRuns, R: torch.Tensor, P: torch.Tensor, stream: int) -> int:
    """``keto_pull`` of ``plan`` from ``R`` into ``P``; returns the error
    code (the bare launch ``pull_cuda`` checks and counts)."""
    return lib.keto_pull(*plan.args(), R.data_ptr(), P.data_ptr(), R.shape[1], stream)


def pull_cuda(
    bucket_nbrs: Sequence[torch.Tensor],
    valid_rows: Sequence[int],
    R: torch.Tensor,
    *,
    P: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One pull via ONE ``keto_pull`` launch over every bucket → ``P``
    int32[n_active, W] (a new tensor, or the given ``P`` of at least
    n_active rows; every word of its first n_active rows is written)."""
    _need(R, "R", 2)
    W = R.shape[1]
    plan = bucket_runs(bucket_nbrs, valid_rows, src_rows=R.shape[0], W=W)
    for nb in plan.nbrs:
        _need(nb, "bucket nbrs", 2)
    if P is None:
        P = torch.empty((plan.n_rows, W), dtype=torch.int32, device=R.device)
    _need_rows(P, "P", plan.n_rows, W)
    if P.numel() >= INDEX_LIMIT:
        raise ValueError(f"P {tuple(P.shape)}: the kernels index in 32 bits")
    if plan.n_rows:
        COUNTS["pull"] += 1
        _check(pull_launch(_lib(), plan, R, P, _stream()), "keto_pull")
    return P


@dataclass(frozen=True)
class RunOverlay:
    """The overlay stage of one run: row k of ``nbrs`` (int32 ``[rows,
    C]``) ORs into output row ``(k // per) * stride + dst[k]``, dropped
    unless ``0 <= dst[k] < n_dst``. Unsharded ``per = rows``, ``stride =
    0``, ``n_dst = n_active``; sharded ``per = K`` rows a shard, ``stride =
    rps``, ``n_dst = rps``."""

    nbrs: torch.Tensor
    dst: torch.Tensor
    per: int
    stride: int
    n_dst: int

    @classmethod
    def of(cls, ov_nbrs, ov_dst, n_dst: int, stride: int = 0) -> Optional["RunOverlay"]:
        """The stage of ``[g, K, C]``/``[g, K]`` (or ``[K, C]``/``[K]``)
        overlay arrays; None where there is no overlay row."""
        if ov_nbrs is None or not ov_nbrs.shape[-2]:
            return None
        _need(ov_nbrs, "ov_nbrs", ov_nbrs.dim())
        _need(ov_dst, "ov_dst", ov_dst.dim())
        if ov_nbrs.shape[:-1] != ov_dst.shape or ov_nbrs.dim() not in (2, 3):
            raise ValueError("ov_dst must name one destination row per ov_nbrs row")
        if ov_nbrs.numel() >= INDEX_LIMIT:
            raise ValueError(f"ov_nbrs {tuple(ov_nbrs.shape)}: the kernels index in 32 bits")
        return cls(ov_nbrs, ov_dst, ov_nbrs.shape[-2], stride, n_dst)


#: stamps a step of a measured run: begun, halo done, pull done, overlay
#: done, committed (``keto_check_run``'s ``stamps``)
RUN_STAMPS = 5


def run_launch(lib, plan: PullRuns, R, P, ctl, *, G=None, ov: Optional[RunOverlay] = None,
               it_cap: int, block_iters: int, counts=None, stamps=None, pop=None,
               stream: int) -> int:
    """``keto_check_run`` of ``plan`` on ``R`` and ``P`` (with ``G``, the
    sharded run: a halo copy of R's rows into G each step, the pulls from
    G); returns the error code (the bare launch ``check_run_cuda`` checks
    and counts). ``ctl`` is int32[3], zeroed. ``stamps`` (int64 ``[steps,
    RUN_STAMPS]`` on the card, for measurement only) takes the card's
    nanosecond clock at each phase boundary of the first ``steps`` steps.
    ``pop`` (an int32 on the card) takes the bits the commits newly set."""
    C = 0 if ov is None else ov.nbrs.shape[-1]
    rows = 0 if ov is None else ov.nbrs.numel() // C
    return lib.keto_check_run(
        *plan.args(), _ptr(None if ov is None else ov.nbrs), _ptr(None if ov is None else ov.dst),
        rows, C, 1 if ov is None else ov.per, 0 if ov is None else ov.stride,
        0 if ov is None else ov.n_dst, R.data_ptr(), _ptr(G), 0 if G is None else G.shape[0],
        P.data_ptr(), plan.n_rows, R.shape[1], min(int(it_cap), INDEX_LIMIT - 1), int(block_iters),
        ctl.data_ptr(), _ptr(counts), _ptr(stamps), 0 if stamps is None else stamps.shape[0],
        _ptr(pop), stream)


#: per device (a tensor's own ``device``, index set), the int64[2] {steps,
#: halo copies} every run adds to
_RUN_COUNTS: dict = {}
_RUN_COUNTS_LOCK = threading.Lock()


def _run_counter(device: torch.device) -> torch.Tensor:
    counter = _RUN_COUNTS.get(device)
    if counter is None:
        with _RUN_COUNTS_LOCK:
            if device not in _RUN_COUNTS:
                _RUN_COUNTS[device] = torch.zeros(2, dtype=torch.int64, device=device)
            counter = _RUN_COUNTS[device]
    return counter


def run_counts(device="cuda") -> tuple:
    """``(steps, halo copies)`` the runs on ``device`` made since the last
    ``reset_run_counts`` (a host read: for the smoke and tests, never on
    the path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    steps, copies = _run_counter(dev).tolist()
    return steps, copies


def reset_run_counts() -> None:
    with _RUN_COUNTS_LOCK:
        for t in _RUN_COUNTS.values():
            t.zero_()


def check_run_cuda(plan: PullRuns, R: torch.Tensor, P: torch.Tensor, *, G=None,
                   ov: Optional[RunOverlay] = None, it_cap: int,
                   block_iters: int = 8, pop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The guarded fixpoint via ONE ``keto_check_run`` launch: ``R`` in
    place, the pull of the last step run in ``P``'s run rows → the device
    state int32[3] {changed at exit, steps run, last changed step + 1}
    (not read here). With ``pop`` (an int32 on the card) the commits add
    the bits they newly set into ``pop[0]``."""
    _need(R, "R", 2)
    W = R.shape[1]
    _need_rows(P, "P", plan.n_rows + 1 if G is None else plan.n_rows, W)
    if G is not None:
        _need_rows(G, "G", R.shape[0], W)
    for nb in plan.nbrs:
        _need(nb, "bucket nbrs", 2)
    for t, what in ((R, "R"), (P, "P")):
        if t.numel() >= INDEX_LIMIT:
            raise ValueError(f"{what} {tuple(t.shape)}: the kernels index in 32 bits")
    if block_iters < 1:
        raise ValueError(f"block_iters must be at least 1, got {block_iters}")
    _need_pop(pop, R.device)
    ctl = torch.zeros(3, dtype=torch.int32, device=R.device)
    COUNTS["check_run"] += 1
    if ov is not None:
        COUNTS["check_run_overlay"] += 1
    _check(run_launch(_lib(), plan, R, P, ctl, G=G, ov=ov, it_cap=it_cap,
                      block_iters=block_iters, counts=_run_counter(R.device), pop=pop,
                      stream=_stream()),
           "keto_check_run")
    return ctl


def pull_out(rows: int, W: int, n_active: int, it_cap: int, device) -> torch.Tensor:
    """A run's ``P`` (``[rows, W]``): rows past the active prefix zero, the
    prefix left for the run to write — unless no step can run (``it_cap``
    below 1), when the answer reads it as the reference's all-zero ``p0``."""
    if it_cap < 1:
        return torch.zeros((rows, W), dtype=torch.int32, device=device)
    P = torch.empty((rows, W), dtype=torch.int32, device=device)
    P[n_active:].zero_()
    return P


def answer_pack_cuda(entries, sizes, n_active: int, P, ans_base, R, state) -> torch.Tensor:
    """int32[W+2] via ONE ``keto_answer_pack`` launch (no host read);
    ``state`` None means iters = 0 and not truncated."""
    _need_entries(entries, sizes)
    S1, S2, SA, B = sizes
    W = B // 32
    _need_rows(P, "P", n_active + 1, W)  # row n_active is the all-zero row
    _need_rows(ans_base, "ans_base", 1, W)
    _need_rows(R, "R", 1, W)
    if state is not None:
        _need_state(state)
    out = torch.zeros(W + 2, dtype=torch.int32, device=entries.device)
    COUNTS["answer_pack"] += 1
    _check(_lib().keto_answer_pack(entries.data_ptr(), S1, S2, SA, B, n_active,
                                   P.data_ptr(), ans_base.data_ptr(), R.data_ptr(), W,
                                   _ptr(state), out.data_ptr(), _stream()), "keto_answer_pack")
    return out


def check_step_cuda(
    bucket_nbrs: Sequence[torch.Tensor],
    entries: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    sizes: tuple[int, int, int, int],
    n_active: int,
    n_int: int,
    valid_rows: Sequence[int],
    it_cap: int,
    block_iters: int = 8,
) -> torch.Tensor:
    """The check step on the card → int32[W+2] (device tensor, not
    synchronised): the seeds, ONE ``keto_check_run`` launch (none without
    active rows or buckets) and the answer, with no host read."""
    W = sizes[3] // 32
    R, ans_base = seed_cuda(entries, sizes, n_int, W)
    P = pull_out(n_active + 1, W, n_active, it_cap, entries.device)
    state = None
    if n_active and bucket_nbrs:
        plan = bucket_runs(bucket_nbrs, valid_rows, src_rows=n_int + 1, W=W)
        if plan.n_rows != n_active:
            raise ValueError(f"buckets cover {plan.n_rows} rows, n_active is {n_active}")
        state = check_run_cuda(plan, R, P, ov=RunOverlay.of(ov_nbrs, ov_dst, n_active),
                               it_cap=it_cap, block_iters=block_iters)
    return answer_pack_cuda(entries, sizes, n_active, P, ans_base, R, state)


def label_team(Wo: int) -> tuple[int, int]:
    """``(t, k)`` for the label kernels at OUT width ``Wo``: ``t`` lanes a
    pair (a power of two, at most a warp) and ``k`` OUT entries a lane,
    ``t·k >= Wo``. Up to 128 entries ``k <= 4`` (held in registers, ``t``
    the narrowest team that does it); a wider row takes a whole warp and
    ``k = ceil(Wo / 32)``, compared in chunks of 128. Where ``Wo % 4 ==
    0``, ``k`` is at least 4, so that a lane's entries are one 16-byte
    load."""
    Wo = max(1, int(Wo))
    t = 1
    while t < 32 and 4 * t < Wo:
        t *= 2
    k = -(-Wo // t)
    if Wo % 4 == 0:
        k = max(k, 4)
    return t, k


def _need_labels(out_lab, in_lab) -> None:
    _need(out_lab, "out_lab", 2)
    _need(in_lab, "in_lab", 2)
    if out_lab.shape[0] != in_lab.shape[0]:
        raise ValueError(f"label arrays of {out_lab.shape[0]} and {in_lab.shape[0]} rows: "
                         "expected equal row counts")


def label_step_launch(lib, out_lab, in_lab, entries, n_pairs: int, out, stream: int) -> int:
    """``keto_label_step`` of ``n_pairs`` pairs into the zeroed ``out``;
    returns the error code (the bare launch ``label_step_cuda`` checks and
    counts)."""
    team, k = label_team(out_lab.shape[1])
    return lib.keto_label_step(out_lab.data_ptr(), out_lab.shape[1], in_lab.data_ptr(),
                               in_lab.shape[1], out_lab.shape[0], entries.data_ptr(), n_pairs,
                               team, k, out.data_ptr(), stream)


def label_witness_launch(lib, out_lab, in_lab, pa, pb, out, stream: int) -> int:
    """``keto_label_witness`` of the pairs ``(pa, pb)`` into ``out`` (every
    word written); returns the error code (the bare launch
    ``label_step_witness_cuda`` checks and counts)."""
    team, k = label_team(out_lab.shape[1])
    return lib.keto_label_witness(out_lab.data_ptr(), out_lab.shape[1], in_lab.data_ptr(),
                                  in_lab.shape[1], out_lab.shape[0], pa.data_ptr(), pb.data_ptr(),
                                  pa.numel(), team, k, out.data_ptr(), stream)


def label_step_cuda(out_lab, in_lab, entries, *, n_pairs: int, B: int) -> torch.Tensor:
    """int32[B/32] via ONE ``keto_label_step`` launch (device tensor, not
    synchronised, no host read)."""
    _need(entries, "entries", 1)
    _label_parts(entries, n_pairs)
    _need_labels(out_lab, in_lab)
    if B % 32:
        raise ValueError(f"B={B}: expected a multiple of 32")
    out = torch.zeros(B // 32, dtype=torch.int32, device=entries.device)
    if n_pairs:
        COUNTS["label_step"] += 1
        _check(label_step_launch(_lib(), out_lab, in_lab, entries, n_pairs, out, _stream()),
               "keto_label_step")
    return out


def label_step_witness_cuda(out_lab, in_lab, pa, pb) -> torch.Tensor:
    """int32[P] via ONE ``keto_label_witness`` launch (device tensor, not
    synchronised, no host read)."""
    _need(pa, "pa", 1)
    _need(pb, "pb", 1)
    _need_labels(out_lab, in_lab)
    if pa.numel() != pb.numel():
        raise ValueError(f"{pa.numel()} and {pb.numel()} pair rows: expected equal counts")
    out = torch.empty(pa.numel(), dtype=torch.int32, device=pa.device)
    if pa.numel():
        COUNTS["label_witness"] += 1
        _check(label_witness_launch(_lib(), out_lab, in_lab, pa, pb, out, _stream()),
               "keto_label_witness")
    return out


#: words of a functional target one ``keto_slot_set`` block copies and
#: patches, and entries of an in-place target one block writes (a multiple
#: of 4: the copy moves 16 bytes a thread)
SLOT_TILE = 4096


@dataclass
class SlotPlan:
    """One ``keto_slot_set`` launch, made on the host: the outputs (new
    tensors, or the targets themselves in place) and one int32 buffer of
    ``n_targets`` int64 descriptors ``(out, src or 0, words, first entry,
    end entry, first block)``, then the ``n_entries`` slot keys (a word of
    their target, ascending within it) and their values."""

    outs: list
    words: np.ndarray
    n_targets: int
    n_blocks: int
    n_entries: int


def slot_set_plan(targets, *, in_place: bool = False) -> SlotPlan:
    """The launch of one slot set over every target; raises, with every
    target untouched, on a target the kernel does not take or an entry
    outside its target. A functional target gets a block for each
    ``SLOT_TILE`` of its words (the copy), an in-place one a block for each
    ``SLOT_TILE`` of its entries."""
    targets = list(targets)
    if in_place and len({t[0].data_ptr() for t in targets}) < len(targets):
        raise ValueError("slot set: in-place targets must not share storage")
    outs, desc, keys, vals = [], [], [], []
    at = blocks = 0
    for buf, rows, cols, v in targets:
        if buf.dtype != torch.int32 or not buf.is_contiguous():
            raise ValueError(f"buf: expected a contiguous int32 tensor, got {buf.dtype} "
                             f"{tuple(buf.shape)}")
        n = buf.numel()
        if n >= 2**31:
            raise ValueError(f"slot set: a target of {n} words: the kernel indexes one in 32 "
                             "bits")
        rows, cols, v, ld = _slot_entries(buf, rows, cols, v)
        out = buf if in_place else torch.empty_like(buf)
        outs.append(out)
        m = rows.size
        desc.append((out.data_ptr(), 0 if in_place else buf.data_ptr(), n, at, at + m, blocks))
        keys.append((rows * ld + cols).astype(np.int32))
        vals.append(v)
        at += m
        blocks += -(-(m if in_place else n) // SLOT_TILE)
    words = np.concatenate([np.array(desc, np.int64).reshape(-1).view(np.int32), *keys, *vals])
    return SlotPlan(outs, words, len(desc), blocks, at)


def slot_set_launch(lib, plan: SlotPlan, words: torch.Tensor, stream: int) -> int:
    """``keto_slot_set`` on ``plan`` with its words on the card; returns the
    error code (the bare launch ``slot_set_many_cuda`` checks and counts)."""
    return lib.keto_slot_set(words.data_ptr(), plan.n_targets, plan.n_blocks, plan.n_entries,
                             SLOT_TILE, stream)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device``; on a CUDA device with no host sync: staged in
    pinned host memory (PyTorch's caching host allocator holds the block
    until the copy has run) and copied on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def slot_set_many_cuda(targets, *, in_place: bool = False) -> list:
    """K9 over every target via ONE ``keto_slot_set`` launch: the host
    plan (range check, dedup, descriptors), one upload, the launch, no host
    read. Returns the outputs in order."""
    targets = list(targets)
    for buf, *_ in targets:
        if buf.device.type != "cuda":
            raise ValueError(f"buf: expected a CUDA tensor, got one on {buf.device}")
    plan = slot_set_plan(targets, in_place=in_place)
    if plan.n_blocks:
        words = _upload(plan.words, plan.outs[0].device)
        COUNTS["slot_set"] += 1
        _check(slot_set_launch(_lib(), plan, words, _stream()), "keto_slot_set")
    return plan.outs


def slot_set_cuda(buf: torch.Tensor, rows, cols, vals, *, in_place: bool = False) -> torch.Tensor:
    """K9 via ``keto_slot_set`` on one target (``slot_set_many_cuda``'s
    one-target case)."""
    return slot_set_many_cuda([(buf, rows, cols, vals)], in_place=in_place)[0]


# -- dispatchers ----------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def pull(bucket_nbrs, valid_rows, R: torch.Tensor) -> torch.Tensor:
    """K1: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(R):
        return pull_ref(bucket_nbrs, valid_rows, R)
    return pull_cuda(bucket_nbrs, valid_rows, R)


def check_step(bucket_nbrs, entries: torch.Tensor, ov_nbrs=None, ov_dst=None, **kw) -> torch.Tensor:
    """K2: the plain version for CPU tensors, the kernels for CUDA tensors."""
    if _on_cpu(entries):
        return check_step_ref(bucket_nbrs, entries, ov_nbrs, ov_dst, **kw)
    return check_step_cuda(bucket_nbrs, entries, ov_nbrs, ov_dst, **kw)


def label_step(out_lab, in_lab, entries: torch.Tensor, *, n_pairs: int, B: int) -> torch.Tensor:
    """K3: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(entries):
        return label_step_ref(out_lab, in_lab, entries, n_pairs=n_pairs, B=B)
    return label_step_cuda(out_lab, in_lab, entries, n_pairs=n_pairs, B=B)


def label_step_witness(out_lab, in_lab, pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """K4: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(pa):
        return label_step_witness_ref(out_lab, in_lab, pa, pb)
    return label_step_witness_cuda(out_lab, in_lab, pa, pb)


def slot_set(buf: torch.Tensor, rows, cols, vals, *, in_place: bool = False) -> torch.Tensor:
    """K9: ``buf[rows, cols] = vals`` (``cols`` None for a 1-D ``buf``) on a
    copy, or on ``buf`` itself with ``in_place``; the plain version for a
    CPU tensor, the kernel for a CUDA tensor. Host entry arrays."""
    if _on_cpu(buf):
        return slot_set_ref(buf, rows, cols, vals, in_place=in_place)
    return slot_set_cuda(buf, rows, cols, vals, in_place=in_place)


def slot_set_many(targets, *, in_place: bool = False) -> list:
    """K9 over ``[(buf, rows, cols, vals), ...]``, every entry checked
    before any target is written. CUDA targets: one launch for all of
    them. CPU targets: one ``slot_set`` per target after the check, so
    that the one-target dispatcher stays the seam where a fault injected
    into the slot set reaches every site on the CPU."""
    targets = list(targets)
    if targets and _on_cpu(targets[0][0]):
        _slot_plan(targets)
        return [slot_set(*t, in_place=in_place) for t in targets]
    return slot_set_many_cuda(targets, in_place=in_place)
