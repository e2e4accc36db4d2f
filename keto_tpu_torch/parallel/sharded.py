"""Row-range sharded serving on one card: the routing, the halo exchange and
the three sharded device programs (K10).

The counterpart of keto_tpu/parallel/sharded.py. The interior bitmap rows
``[0, num_int]`` are partitioned into contiguous **row-range shards** along
the mesh's ``graph`` axis (``shard_row_ranges``, the one assignment of
keto_tpu_torch/graph/device_build.py): shard ``s`` owns rows
``[s·rps, (s+1)·rps)``. Each shard's slice of a degree bucket is a dense ELL
matrix gathered exactly like the single-device kernel's, scattered into the
shard's local slab rows; query slices are replicated (the ``data`` axis is
1).

The host routing is a copy of the reference's, byte for byte in
behaviour: ``ShardSpec``/``make_shard_spec`` (:80-166), ``_route_rows``/
``route_entries`` (:169-226), ``route_overlay`` (:229-256),
``route_labels`` (:259-285), ``halo_bytes_per_round`` (:288-291),
``route_label_ell`` (:294-324), ``_entry_pad`` and ``_ceil_pow2``. A local
row at ``rps`` or beyond is the "not owned / padding" sentinel everywhere:
scatters drop it and gathers read it as zero.

The programs, each a plain PyTorch version (for CPU tensors) and the
hand-written kernels (for CUDA tensors; csrc/shard_kernels.cu plus K1/K2/K3
entry points):

- ``check_step`` replaces ``sharded_check_step`` (:327-470), K10a: per hop,
  the halo all-gather of every shard's ``[rps, W]`` frontier slab into one
  gathered bitmap, each shard's local pull from it, ``nxt = R | p``, and
  the psum of the changed flag; the same ``block_iters``/``it_cap`` loop as
  K2. Then every shard answers the targets and sink rows it owns,
  OR-combined into ``uint32[W+3]``: the decision bits, ``iters``,
  ``truncated`` and the frontier-bit population (a uint32 psum that wraps,
  as the reference's). CUDA: per shard ``keto_seed`` (with ``n_int = rps -
  1``, so the sentinel ``rps`` drops) into its slab of one ``[g·rps, W]``
  bitmap, then K2's ``keto_check_run`` ONCE over every shard — per hop that
  runs a halo phase copying every slab into the gathered bitmap, the pull
  of every shard's bucket runs from it, the overlay in ``dst`` mode
  (``n_dst = rps``), the commit and the changed flag every shard raises
  (that is the psum), between grid barriers, the guard on the card — and
  ONE ``keto_shard_answer`` over every shard, with no host read in
  between. The frontier-bit word is counted where its bits are set: the
  seeds and the run's commits add the bits of R they newly set into it
  (``pop``), so nothing reads R again for the popcount. Each shard's slice
  of a bucket is a contiguous run of rows (``make_shard_spec``) written in
  place each step that runs, so the pull of the last step run survives as
  the answer's ``p_fix``. The halo copies a step equal its ``iters``.
- ``label_step`` replaces ``sharded_label_step`` (:473-534), K10b: the
  one-shot pair-row exchange — per side, the psum over shards of "the
  owned pair row, else 0", which is a gather from the owning stripe (0 for
  a row no shard owns) — then K3's compare and pack on the exchanged rows,
  ``uint32[W]``. CUDA: one ``keto_pair_gather`` per side, then
  ``keto_label_step``.
- ``label_sweep`` replaces the sweep loop over ``sharded_label_sweep_step``
  (:559-628), K10c: per wave, the halo all-gather of the frontier slabs,
  then each shard's K6 wave from the gathered bitmap into its local rows
  (``dst`` sentinel ``rps`` dropped), ``active`` and ``visits`` summed over
  the shards, until a wave is inactive or a visit budget runs dry. CUDA:
  K6's ``keto_sweep_run`` over every shard's routed groups at once
  (``sweep_ell_groups``; keto_tpu_torch/graph/label_kernels.py), one
  launch a sweep, the halo copy a phase of each wave between two grid
  barriers; the plain version is ``label_kernels.sweep_ref`` over the
  same table and slabs, whose wave (``sweep_step_into_ref`` over the
  gathered bitmap) is the reference's program word for word.

**Jacobi across shards.** Every pull of a hop reads the gathered copy, taken
before any shard commits, so no shard's commit feeds another shard's pull
in the same hop, and ``iters`` equals the reference's.

The collectives of the plain versions live in one place
(``all_gather_rows``, ``psum``, ``or_combine``) and count the bytes they
move in ``COLLECTIVE_BYTES``. On one card the all-gather is a copy of
every shard slab into the gathered bitmap — a phase of the run kernel in
K10a and K10c (K10a's copies are counted on the card,
``kernels.run_counts``) — and the reductions are kernels of every shard
accumulating into one buffer. ``halo_bytes_per_round`` keeps the
reference's definition (the bytes one device RECEIVES per exchange,
``(g-1)·rps·W·4``); the copy on one card moves ``g·rps·W·4``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.kernels import COUNTS, _check, _gather_or, _lib, _need, _on_cpu, _stream
from keto_tpu_torch.graph import label_kernels
from keto_tpu_torch.graph.device_build import shard_row_ranges
from keto_tpu_torch.graph.labels import IN_PAD, OUT_PAD
from keto_tpu_torch.x.device import same_device

#: bytes and calls of each collective (chip_smoke.py reads them)
COLLECTIVE_BYTES = {"all_gather": 0, "psum": 0, "or_combine": 0}
COLLECTIVE_CALLS = {"all_gather": 0, "psum": 0, "or_combine": 0}


def reset_collective_counts() -> None:
    for d in (COLLECTIVE_BYTES, COLLECTIVE_CALLS):
        for k in d:
            d[k] = 0


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _entry_pad(B: int, size: int) -> int:
    """Entry arrays pad to B·2^k (the single-device path's geometry rule)."""
    sp = max(1, B)
    while sp < size:
        sp *= 2
    return sp


# -- host routing (numpy) -------------------------------------------------------


@dataclass
class ShardSpec:
    """Host-side description of one snapshot's row-range partitioning,
    built once per uploaded snapshot: what a dispatch needs to route seeds,
    targets and answer gathers to their owning shard, and what a delta needs
    to route ELL patches (``patch_pos``) to the stacked array slot that owns
    the patched bucket row."""

    n_shards: int
    rows_per_shard: int  # bitmap slab rows per shard (covers num_int+1)
    n_int: int
    n_active: int
    #: per bucket: stacked per-shard gather matrices int32[g, rb, cap]
    #: (sentinel n_int = the global all-zero bitmap row) and their local
    #: scatter rows int32[g, rb] (sentinel rows_per_shard = dropped)
    nbrs_sh: tuple
    dst_sh: tuple
    #: per bucket: int64[g] first bucket-local row owned by each shard
    #: (clipped into [0, bucket.n]) — the patch-routing origin
    bucket_lo: tuple
    #: device bytes of each shard's OWNED (unpadded) bucket rows
    owned_bucket_bytes: list

    def patch_pos(self, bucket_offset: int, bi: int, row: int) -> tuple:
        """(shard, stacked-row) owning bucket ``bi``'s local ``row``."""
        g_row = bucket_offset + row
        s = min(g_row // self.rows_per_shard, self.n_shards - 1)
        return s, row - int(self.bucket_lo[bi][s])

    def padded_bucket_bytes(self) -> int:
        """Total device bytes of the stacked bucket arrays as uploaded."""
        return sum(int(a.nbytes) for a in self.nbrs_sh) + sum(int(a.nbytes) for a in self.dst_sh)


def make_shard_spec(snap, n_shards: int) -> ShardSpec:
    """Partition ``snap``'s buckets into ``n_shards`` row-range shards.
    Shard ``s`` owns bitmap rows ``[s*rps, (s+1)*rps)``, ``rps`` covering
    ``num_int + 1`` rows (the +1 is the all-zero sentinel row). Each
    bucket's member rows are contiguous in device-id order, so a shard's
    slice of a bucket is a contiguous row range — sliced, padded to a shared
    pow2 row count (sentinel gather rows, dropped scatter rows) and stacked
    along a leading shard axis."""
    g = max(1, int(n_shards))
    ranges = shard_row_ranges(snap.num_int + 1, g)
    rps = ranges[0][1] - ranges[0][0] if ranges[0][1] > ranges[0][0] else 1
    sentinel = np.int32(snap.num_int)
    nbrs_sh: list = []
    dst_sh: list = []
    bucket_lo: list = []
    owned = [0] * g
    for b in snap.buckets:
        nbrs = np.asarray(b.nbrs)
        cap = nbrs.shape[1]
        lo = np.clip([s * rps - b.offset for s in range(g)], 0, b.n)
        hi = np.clip([(s + 1) * rps - b.offset for s in range(g)], 0, b.n)
        rb = _ceil_pow2(int(np.max(hi - lo)) or 1)
        sb = np.full((g, rb, cap), sentinel, np.int32)
        db = np.full((g, rb), rps, np.int32)
        for s in range(g):
            l, h = int(lo[s]), int(hi[s])
            k = h - l
            if k <= 0:
                continue
            sb[s, :k] = nbrs[l:h]
            db[s, :k] = (b.offset + np.arange(l, h)) - s * rps
            owned[s] += k * cap * 4
        nbrs_sh.append(np.ascontiguousarray(sb))
        dst_sh.append(np.ascontiguousarray(db))
        bucket_lo.append(lo.astype(np.int64))
    return ShardSpec(
        n_shards=g,
        rows_per_shard=rps,
        n_int=snap.num_int,
        n_active=snap.num_active,
        nbrs_sh=tuple(nbrs_sh),
        dst_sh=tuple(dst_sh),
        bucket_lo=tuple(bucket_lo),
        owned_bucket_bytes=owned,
    )


def _route_rows(rows: np.ndarray, qs: np.ndarray, g: int, rps: int, drop_row: int, B: int):
    """Route (row, query) entry pairs to their owning shard: stacked
    ``int32[g, P]`` local rows (sentinel ``rps`` = not owned / padding) and
    their queries. ``drop_row`` marks the input's padding sentinel."""
    rows = np.asarray(rows, np.int64)
    qs = np.asarray(qs, np.int64)
    valid = rows != drop_row
    owner = np.minimum(np.where(valid, rows // rps, 0), g - 1)
    counts = np.bincount(owner[valid], minlength=g)
    P = _entry_pad(B, int(counts.max()) if counts.size else 0)
    out_r = np.full((g, P), rps, np.int32)
    out_q = np.zeros((g, P), np.int32)
    for s in range(g):
        sel = valid & (owner == s)
        k = int(np.count_nonzero(sel))
        if k:
            out_r[s, :k] = rows[sel] - s * rps
            out_q[s, :k] = qs[sel]
    return out_r, out_q, P


def route_entries(spec: ShardSpec, packed, B: int, out=None, out_alloc=None):
    """Split ``pack_chunk``'s seven arrays by row ownership into one stacked
    ``int32[g, L]`` entry buffer plus the static sizes ``(S1, S2, SA, B)``.
    Seeds scatter into the owner's slab, answer gathers read the owner's
    fixpoint rows, targets become per-shard local rows with a not-owned
    sentinel: every shard receives the full query axis but only its own
    rows. ``out`` (an int32 ``[g, L]`` buffer) or ``out_alloc`` (a ``shape
    -> buffer | None`` allocator: the engine's staging pool) receives the
    concatenation in place."""
    (e1r, e1q, e2r, e2q, ar, aq, targets) = packed
    g, rps, ni = spec.n_shards, spec.rows_per_shard, spec.n_int
    r1, q1, S1 = _route_rows(e1r, e1q, g, rps, ni + 1, B)
    r2, q2, S2 = _route_rows(e2r, e2q, g, rps, ni + 1, B)
    ra, qa, SA = _route_rows(ar, aq, g, rps, ni, B)
    t = np.asarray(targets, np.int64)
    t_sh = np.full((g, t.shape[0]), rps, np.int32)
    for s in range(g):
        own = (t >= s * rps) & (t < (s + 1) * rps)
        t_sh[s, own] = (t[own] - s * rps).astype(np.int32)
    parts = [r1, q1, r2, q2, ra, qa, t_sh]
    if out is None and out_alloc is not None:
        L = sum(p.shape[1] for p in parts)
        out = out_alloc((g, L))
    if out is not None and out.shape == (g, sum(p.shape[1] for p in parts)):
        entries = np.concatenate(parts, axis=1, out=out)
    else:
        entries = np.concatenate(parts, axis=1)
    return np.ascontiguousarray(entries), (S1, S2, SA, t.shape[0])


def route_overlay(spec: ShardSpec, nbrs: np.ndarray, dst: np.ndarray, num_active: int):
    """Route the overlay-ELL gather matrix by destination-row ownership:
    stacked ``int32[g, K, C]`` neighbour matrices (sentinel n_int) and
    ``int32[g, K]`` local destination rows (sentinel rps = dropped)."""
    g, rps = spec.n_shards, spec.rows_per_shard
    dst = np.asarray(dst, np.int64)
    valid = dst < num_active
    owner = np.minimum(np.where(valid, dst // rps, 0), g - 1)
    counts = np.bincount(owner[valid], minlength=g)
    K = _ceil_pow2(int(counts.max()) if counts.size else 0)
    C = nbrs.shape[1]
    out_n = np.full((g, K, C), spec.n_int, np.int32)
    out_d = np.full((g, K), rps, np.int32)
    owned_bytes = [0] * g
    for s in range(g):
        sel = valid & (owner == s)
        k = int(np.count_nonzero(sel))
        if k:
            out_n[s, :k] = nbrs[sel]
            out_d[s, :k] = (dst[sel] - s * rps).astype(np.int32)
            owned_bytes[s] = k * (C + 1) * 4
    return np.ascontiguousarray(out_n), np.ascontiguousarray(out_d), owned_bytes


def route_labels(out_lab: np.ndarray, in_lab: np.ndarray, n_shards: int):
    """Stack the label arrays into per-shard row stripes ``int32[g, rl, W]``
    padded with each side's own pad (a padded row can never witness an
    intersection). Returns ``(out_sh, in_sh, rl, owned_bytes)``."""
    g = max(1, int(n_shards))
    n_rows = out_lab.shape[0]
    ranges = shard_row_ranges(n_rows, g)
    rl = ranges[0][1] - ranges[0][0] if ranges[0][1] > ranges[0][0] else 1
    out_sh = np.full((g, rl, out_lab.shape[1]), OUT_PAD, np.int32)
    in_sh = np.full((g, rl, in_lab.shape[1]), IN_PAD, np.int32)
    owned = [0] * g
    for s, (lo, hi) in enumerate(ranges):
        k = hi - lo
        if k <= 0:
            continue
        out_sh[s, :k] = out_lab[lo:hi]
        in_sh[s, :k] = in_lab[lo:hi]
        owned[s] = k * (out_lab.shape[1] + in_lab.shape[1]) * 4
    return np.ascontiguousarray(out_sh), np.ascontiguousarray(in_sh), rl, owned


def halo_bytes_per_round(spec: ShardSpec, W: int) -> int:
    """Frontier-slab bytes one device RECEIVES per halo exchange: the other
    ``g-1`` shards' ``[rows_per_shard, W]`` uint32 slabs."""
    return (spec.n_shards - 1) * spec.rows_per_shard * W * 4


def route_label_ell(groups, n: int, n_shards: int, rps: int):
    """Route the label builder's pull-ELL groups (``build_ell_groups``:
    global neighbour ids with gather sentinel ``n``, global destination
    rows) by destination-row ownership — the same row ranges that stripe
    the serving label arrays and bucket slabs. Returns per group
    ``(int32[g, rb, cap] nbrs, int32[g, rb] local dst)`` with scatter
    sentinel ``rps`` (dropped) and gather ids left GLOBAL: the sweep
    gathers from the halo-exchanged full bitmap."""
    g = max(1, int(n_shards))
    routed = []
    for nbrs, dst in groups:
        dst64 = np.asarray(dst, np.int64)
        owner = np.minimum(dst64 // rps, g - 1)
        counts = np.bincount(owner, minlength=g)
        rb = _ceil_pow2(int(counts.max()) if counts.size else 0) or 1
        cap = nbrs.shape[1]
        sb = np.full((g, rb, cap), np.int32(n), np.int32)
        db = np.full((g, rb), np.int32(rps), np.int32)
        for s in range(g):
            sel = owner == s
            k = int(np.count_nonzero(sel))
            if k:
                sb[s, :k] = nbrs[sel]
                db[s, :k] = (dst64[sel] - s * rps).astype(np.int32)
        routed.append((np.ascontiguousarray(sb), np.ascontiguousarray(db)))
    return routed


# -- device layouts ----------------------------------------------------------------


@dataclass(frozen=True)
class ShardedBuckets:
    """The stacked bucket arrays on a device, plus each shard's row run per
    bucket: ``runs[b][s] = (first local row, owned rows)`` — the rows
    ``dst[b][s, :k]``, which ``make_shard_spec`` lays out contiguously."""

    nbrs: tuple  # int32 [g, rb, cap] per bucket
    dst: tuple  # int32 [g, rb] per bucket
    runs: tuple

    @classmethod
    def from_spec(cls, spec: ShardSpec, device) -> "ShardedBuckets":
        rps = spec.rows_per_shard
        runs = []
        for db in spec.dst_sh:
            per = []
            for s in range(db.shape[0]):
                k = int(np.count_nonzero(db[s] < rps))
                first = int(db[s, 0]) if k else 0
                if k and not (np.array_equal(db[s, :k], first + np.arange(k))
                              and (db[s, k:] >= rps).all()):
                    raise ValueError(f"shard {s}'s bucket rows are not one contiguous run")
                per.append((first, k))
            runs.append(tuple(per))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)  # noqa: E731
        return cls(nbrs=tuple(t(a) for a in spec.nbrs_sh), dst=tuple(t(a) for a in spec.dst_sh),
                   runs=tuple(runs))


def sweep_ell_groups(routed, rps: int, device) -> label_kernels.EllGroups:
    """Every shard's routed label-build ELL groups (``route_label_ell``) in
    one table for the sharded sweep: shard s's groups (global gather ids,
    local ``dst`` rows with the dropped sentinel ``rps``) carry the base row
    ``s·rps``."""
    g = routed[0][0].shape[0] if routed else 1
    groups = [(sb[s], db[s]) for s in range(g) for sb, db in routed]
    bases = [s * rps for s in range(g) for _ in routed]
    return label_kernels.EllGroups.from_groups(groups, device, bases=bases)


def _mesh_shards(mesh, g: int, device: torch.device) -> None:
    if mesh is None:
        return
    if mesh.graph != g:
        raise ValueError(f"a mesh of {mesh.graph} shards cannot run {g} stacked shards")
    if not same_device(mesh.device, device):
        raise ValueError(f"the mesh lives on {mesh.device}, the arrays on {device}")


# -- collectives ---------------------------------------------------------------------


def _note(kind: str, nbytes: int) -> None:
    COLLECTIVE_CALLS[kind] += 1
    COLLECTIVE_BYTES[kind] += int(nbytes)


def all_gather_rows(slabs: Sequence[torch.Tensor], out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The halo exchange: each shard's ``[rps, w]`` slab copied into its row
    range of one gathered ``[g·rps, w]`` bitmap (``copy_``, a device copy on
    the card). The gathered bitmap is a copy, never a view of the live
    slabs: the pulls of a hop read it while shards commit."""
    g = len(slabs)
    rps, w = slabs[0].shape
    if out is None:
        out = torch.empty((g * rps, w), dtype=slabs[0].dtype, device=slabs[0].device)
    for s, slab in enumerate(slabs):
        out[s * rps : (s + 1) * rps].copy_(slab)
    _note("all_gather", g * rps * w * slabs[0].element_size())
    return out


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over shards with int32 wrap-around (the reference's psum)."""
    total = torch.stack([p.to(torch.int64) for p in parts]).sum(0)
    _note("psum", sum(p.numel() * p.element_size() for p in parts))
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


def or_combine(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bitwise OR over shards (the reference's all_gather + OR-reduce of the
    packed answers)."""
    out = parts[0].clone()
    for p in parts[1:]:
        out |= p
    _note("or_combine", sum(p.numel() * p.element_size() for p in parts))
    return out


# -- K10a: the sharded BFS fixpoint ---------------------------------------------------


def _pull_shard_ref(Rfull, buckets: ShardedBuckets, s: int, rps: int, ov) -> torch.Tensor:
    """One shard's local pull from the gathered bitmap into its ``[rps, W]``
    rows: every bucket's owned rows, then the overlay OR; scatters to a
    local row at ``rps`` or beyond are dropped."""
    p = torch.zeros((rps, Rfull.shape[1]), dtype=Rfull.dtype, device=Rfull.device)
    for nb, d in zip(buckets.nbrs, buckets.dst):
        keep = d[s] < rps
        if bool(keep.any()):
            p[d[s][keep].long()] = _gather_or(Rfull, nb[s][keep])
    if ov is not None:
        kernels.overlay_or_ref(p, Rfull, ov[0][s], ov[1][s], rps)
    return p


def shard_answer_ref(entries, sizes, P, ans_base, R, rps: int, iters: int, truncated: bool,
                     pop: int) -> torch.Tensor:
    """K10a's answer in plain PyTorch (``keto_shard_answer``'s contract) →
    int32[W+3]: every shard's owned targets' and sink gathers' bits
    (``entries`` int32[g, L]; ``P``, ``ans_base`` and ``R`` the ``[g·rps,
    W]`` bitmaps, shard s's slab at rows ``[s·rps, (s+1)·rps)``), OR-combined
    across the shards, then ``iters``, ``truncated`` and ``pop``, the
    frontier-bit word the seeds and the run counted. Non-owned rows (``>=
    rps``) contribute 0."""
    g = entries.shape[0]
    B = sizes[3]
    dev = entries.device
    q = torch.arange(B, device=dev)
    # shift amounts stay int32 so the bitmaps never promote to int64
    words, bits = q >> 5, (q & 31).to(torch.int32)
    parts = []
    for s in range(g):
        _, _, _, _, a_rows, a_q, targets = kernels._split(entries[s], sizes)
        Ps, As, Rs = (x[s * rps : (s + 1) * rps] for x in (P, ans_base, R))
        own_t = targets < rps
        tc = torch.clamp(targets, max=rps - 1)
        a = torch.where(own_t, Ps[tc, words] | As[tc, words], torch.zeros_like(Ps[tc, words]))
        hit = (a >> bits) & 1
        own_a = a_rows < rps
        ac = torch.clamp(a_rows, max=rps - 1)
        v = (Rs[ac, a_q >> 5] >> (a_q & 31).to(torch.int32)) & 1
        hit = hit.scatter_reduce(0, a_q, torch.where(own_a, v, torch.zeros_like(v)), reduce="amax")
        parts.append(kernels._pack_bits(hit))
    tail = torch.tensor([iters, int(truncated), kernels.u32_to_i32(pop)], dtype=torch.int32,
                        device=dev)
    return torch.cat([or_combine(parts), tail])


def check_step_ref(
    mesh,
    buckets: ShardedBuckets,
    entries: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    sizes: tuple,
    rps: int,
    B: int,
    it_cap: int,
    block_iters: int = 8,
) -> torch.Tensor:
    """K10a in plain PyTorch → int32[W+3] (see the module docstring). Each
    shard counts its frontier bits as the kernels do, the seeds' and then
    every commit's newly set bits, and the counts are psummed."""
    g = entries.shape[0]
    _mesh_shards(mesh, g, entries.device)
    W = B // 32
    ov = None if ov_nbrs is None else (ov_nbrs, ov_dst)
    pops = [torch.zeros(1, dtype=torch.int32, device=entries.device) for _ in range(g)]
    seeded = [kernels.seed_ref(entries[s], sizes, rps - 1, W, pop=pops[s]) for s in range(g)]
    R = [r for r, _ in seeded]
    ans_base = [a for _, a in seeded]
    p = [torch.zeros((rps, W), dtype=torch.int32, device=entries.device) for _ in range(g)]
    # the reference's loop has no "nothing to pull" guard: it always runs
    changed, iters = True, 0
    while changed and iters < it_cap:
        for _ in range(block_iters):
            if not changed:  # a guarded step after convergence is a no-op
                break
            Rfull = all_gather_rows(R)
            p = [_pull_shard_ref(Rfull, buckets, s, rps, ov) for s in range(g)]
            grew = []
            for s in range(g):
                nxt = R[s] | p[s]
                kernels.count_into(pops[s], int(kernels._popcount(nxt & ~R[s]).sum()))
                grew.append(torch.tensor([int(bool((nxt != R[s]).any()))], dtype=torch.int32))
                R[s] = nxt
            changed = bool(psum(grew)[0] > 0)
            iters += 1
    # the counts add as int32 words with wrap-around: a uint32 psum
    pop = int(psum(pops)[0]) & 0xFFFFFFFF
    return shard_answer_ref(entries, sizes, torch.cat(p), torch.cat(ans_base), torch.cat(R), rps,
                            iters, changed, pop)


def shard_answer_cuda(entries, sizes, P, ans_base, R, rps: int, state, out) -> None:
    """K10a's answer via ONE ``keto_shard_answer`` launch over every shard:
    the owned bits OR-ed into ``out[0:W]`` and ``iters``/``truncated`` into
    ``out[W:W+2]`` of the shared ``out`` int32[W+3], whose ``out[W+2]``
    already holds the frontier bits the seeds and the run counted.
    ``entries`` is int32[g, L]; ``P``, ``ans_base`` and ``R`` the ``[g·rps,
    W]`` bitmaps."""
    _need(entries, "entries", 2)
    g = entries.shape[0]
    kernels._need_entries(entries[0], sizes)
    S1, S2, SA, B = sizes
    W = B // 32
    for t, what in ((P, "P"), (ans_base, "ans_base"), (R, "R")):
        kernels._need_rows(t, what, g * rps, W)
    kernels._need_state(state)
    _need(out, "out", 1)
    if out.numel() != W + 3:
        raise ValueError(f"out: expected int32[{W + 3}], got {tuple(out.shape)}")
    COUNTS["shard_answer"] += 1
    _check(_lib().keto_shard_answer(entries.data_ptr(), entries.shape[1], g, S1, S2, SA, B, rps,
                                    P.data_ptr(), ans_base.data_ptr(), R.data_ptr(), W,
                                    state.data_ptr(), out.data_ptr(), _stream()),
           "keto_shard_answer")
    _note("or_combine", g * (W + 3) * 4)


def shard_runs(buckets: ShardedBuckets, g: int, rps: int, W: int) -> kernels.PullRuns:
    """The run table of every shard's bucket runs, shard by shard (global
    output rows ``s·rps + first``): together they tile the active prefix."""
    runs = [(nb[s], k, s * rps + first) for s in range(g)
            for nb, per in zip(buckets.nbrs, buckets.runs) for first, k in (per[s],)]
    return kernels.pull_runs(runs, src_rows=g * rps, W=W)


def shard_run_ref(plan: kernels.PullRuns, R, P, ov_nbrs=None, ov_dst=None, *, rps: int,
                  it_cap: int, block_iters: int = 8, pop=None) -> torch.Tensor:
    """``keto_check_run``'s plain version over every shard: ``check_run_ref``
    on the global rows of ``shard_runs``' table (``R`` and ``P`` the
    ``[g·rps, W]`` bitmaps), the overlay's local destinations made global
    (a row no shard owns drops) → the state int32[3]; ``pop`` counts the
    bits the commits newly set."""
    ovn = ovd = None
    if ov_nbrs is not None:
        g = ov_nbrs.shape[0]
        base = torch.arange(g, device=ov_dst.device)[:, None] * rps
        ovd = torch.where(ov_dst < rps, ov_dst + base, torch.full_like(ov_dst, g * rps)).reshape(-1)
        ovn = ov_nbrs.reshape(-1, ov_nbrs.shape[-1])
    return kernels.check_run_ref(list(plan.nbrs), plan.rows, R, P, ovn, ovd, it_cap=it_cap,
                                 block_iters=block_iters, pop=pop)


def fixpoint_cuda(
    mesh,
    buckets: ShardedBuckets,
    entries: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    sizes: tuple,
    rps: int,
    B: int,
    it_cap: int,
    block_iters: int = 8,
):
    """K10a's seeds and guarded fixpoint on the card, ONE ``keto_check_run``
    launch over every shard: the ``[g·rps, W]`` bitmaps ``R`` (the
    fixpoint), ``P`` (the last pull) and ``ans_base`` (the one-hop term),
    shard s's slab at rows ``[s·rps, (s+1)·rps)``, the device ``state``
    int32[3] {changed at exit, iters, a third word}, and the step's output
    int32[W+3], zeroed but for ``out[W+2]``: the frontier bits that the
    seeds and the run counted as they set them."""
    _need(entries, "entries", 2)
    g = entries.shape[0]
    _mesh_shards(mesh, g, entries.device)
    for nb, d in zip(buckets.nbrs, buckets.dst):
        _need(nb, "bucket nbrs", 3)
        _need(d, "bucket dst", 2)
        if nb.shape[0] != g or d.shape[0] != g:
            raise ValueError(f"stacked buckets of {nb.shape[0]} shards, entries of {g}")
    if ov_nbrs is not None:
        _need(ov_nbrs, "ov_nbrs", 3)
        _need(ov_dst, "ov_dst", 2)
        if ov_nbrs.shape[:2] != ov_dst.shape or ov_nbrs.shape[0] != g:
            raise ValueError("ov_dst must name one destination row per ov_nbrs row and shard")
    W = B // 32
    dev = entries.device
    plan = shard_runs(buckets, g, rps, W)
    out = torch.zeros(W + 3, dtype=torch.int32, device=dev)
    pop = out[W + 2 :]
    R = torch.zeros((g * rps, W), dtype=torch.int32, device=dev)
    ans_base = torch.zeros_like(R)
    for s in range(g):
        kernels.seed_cuda(entries[s], sizes, rps - 1, W, R=R[s * rps : (s + 1) * rps],
                          ans_base=ans_base[s * rps : (s + 1) * rps], pop=pop)
    P = kernels.pull_out(g * rps, W, plan.n_rows, it_cap, dev)
    G = torch.empty_like(R)
    # the reference's loop has no "nothing to pull" guard: it always runs
    state = kernels.check_run_cuda(plan, R, P, G=G,
                                   ov=kernels.RunOverlay.of(ov_nbrs, ov_dst, rps, rps),
                                   it_cap=it_cap, block_iters=block_iters, pop=pop)
    return R, P, ans_base, state, out


def check_step_cuda(mesh, buckets: ShardedBuckets, entries: torch.Tensor, ov_nbrs=None,
                    ov_dst=None, *, sizes: tuple, rps: int, B: int, it_cap: int,
                    block_iters: int = 8) -> torch.Tensor:
    """K10a on the card → int32[W+3] (device tensor, not synchronised):
    the seeds, one run over every shard, then ONE answer launch over every
    shard into the output that holds the counted frontier bits."""
    R, P, ans_base, state, out = fixpoint_cuda(mesh, buckets, entries, ov_nbrs, ov_dst,
                                               sizes=sizes, rps=rps, B=B, it_cap=it_cap,
                                               block_iters=block_iters)
    shard_answer_cuda(entries, sizes, P, ans_base, R, rps, state, out)
    return out


def check_step(mesh, buckets, entries: torch.Tensor, ov_nbrs=None, ov_dst=None, **kw) -> torch.Tensor:
    """K10a: the plain version for CPU tensors, the kernels for CUDA tensors."""
    if _on_cpu(entries):
        return check_step_ref(mesh, buckets, entries, ov_nbrs, ov_dst, **kw)
    return check_step_cuda(mesh, buckets, entries, ov_nbrs, ov_dst, **kw)


# -- K10b: the sharded label intersection ---------------------------------------------


def pair_rows_ref(lab_sh: torch.Tensor, rows: torch.Tensor, rl: int) -> torch.Tensor:
    """The pair-row exchange of one side in plain PyTorch → int32
    ``[P, w]``: the sum over shards of "the owned row, else 0" (int32
    wrap-around), the reference's psum. Exactly one shard owns each row of
    ``[0, g·rl)``; any other row (negative, or at or past ``g·rl``) gives 0."""
    g, _, w = lab_sh.shape
    acc = torch.zeros((rows.numel(), w), dtype=torch.int64, device=rows.device)
    for s in range(g):
        local = rows.long() - s * rl
        own = (local >= 0) & (local < rl)
        acc += torch.where(own[:, None], lab_sh[s][local.clamp(0, rl - 1)].to(torch.int64), 0)
    return ((acc + 2**31) % 2**32 - 2**31).to(torch.int32)


def pair_rows_cuda(lab_sh: torch.Tensor, rows: torch.Tensor, rl: int) -> torch.Tensor:
    """The pair-row exchange of one side via one ``keto_pair_gather``
    launch → int32 ``[P, w]`` (every word written by the kernel)."""
    _need(lab_sh, "lab_sh", 3)
    _need(rows, "rows", 1)
    g, rows_per, w = lab_sh.shape
    if rows_per != rl:
        raise ValueError(f"lab_sh: {rows_per} rows a stripe, expected rl={rl}")
    out = torch.empty((rows.numel(), w), dtype=torch.int32, device=rows.device)
    if rows.numel():
        COUNTS["pair_rows"] += 1
        _check(_lib().keto_pair_gather(lab_sh.data_ptr(), rl, g, w, rows.data_ptr(), rows.numel(),
                                       out.data_ptr(), _stream()), "keto_pair_gather")
    return out


def _exchange(gather, lab_sh, rows: torch.Tensor, rl: int) -> torch.Tensor:
    out = gather(lab_sh, rows, rl)
    _note("psum", lab_sh.shape[0] * out.numel() * 4)
    return out


def exchange_pair_rows(lab_sh, rows: torch.Tensor, rl: int) -> torch.Tensor:
    """The one-shot pair-row exchange of one side → ``[P, w]``: pair ``p``
    gets the row ``rows[p]`` of the shard that owns it, 0 where no shard
    does (the reference's psum over shards, whose bytes it notes). The plain
    version for CPU tensors, one kernel launch for CUDA tensors."""
    return _exchange(pair_rows_ref if _on_cpu(rows) else pair_rows_cuda, lab_sh, rows, rl)


def _label_step(mesh, out_sh, in_sh, entries, n_pairs, B, rl, gather, step):
    g = out_sh.shape[0]
    _mesh_shards(mesh, g, entries.device)
    if in_sh.shape[0] != g or out_sh.shape[1] != rl or in_sh.shape[1] != rl:
        raise ValueError(f"label stripes {tuple(out_sh.shape)} / {tuple(in_sh.shape)}, rl={rl}")
    pa, pb, pq = kernels._label_parts(entries, n_pairs)
    oa = _exchange(gather, out_sh, pa, rl)
    ib = _exchange(gather, in_sh, pb, rl)
    ar = torch.arange(n_pairs, dtype=torch.int32, device=entries.device)
    return step(oa, ib, torch.cat([ar, ar, pq]), n_pairs=n_pairs, B=B)


def label_step_ref(mesh, out_sh, in_sh, entries, *, n_pairs: int, B: int, rl: int):
    """K10b in plain PyTorch → int32[W]."""
    return _label_step(mesh, out_sh, in_sh, entries, n_pairs, B, rl, pair_rows_ref,
                       kernels.label_step_ref)


def label_step_cuda(mesh, out_sh, in_sh, entries, *, n_pairs: int, B: int, rl: int):
    """K10b on the card → int32[W]: one ``keto_pair_gather`` per side, then
    ``keto_label_step``."""
    return _label_step(mesh, out_sh, in_sh, entries, n_pairs, B, rl, pair_rows_cuda,
                       kernels.label_step_cuda)


def label_step(mesh, out_sh, in_sh, entries: torch.Tensor, *, n_pairs: int, B: int, rl: int):
    """K10b → int32[W]: the pair-row exchange of both sides, then K3's
    compare and pack on the exchanged rows (pair ``p`` reads row ``p`` of
    each side). Plain for CPU tensors, the kernels for CUDA tensors."""
    if _on_cpu(entries):
        return label_step_ref(mesh, out_sh, in_sh, entries, n_pairs=n_pairs, B=B, rl=rl)
    return label_step_cuda(mesh, out_sh, in_sh, entries, n_pairs=n_pairs, B=B, rl=rl)


# -- K10c: the sharded label-build wave ------------------------------------------------


def label_sweep(mesh, groups: label_kernels.EllGroups, X0: torch.Tensor, cov: torch.Tensor, *,
                rps: int, prune_expansion: bool = True, budget: Optional[int] = None):
    """K10c, one orientation's sharded sweep → ``(S, waves, visits, dry)``
    as ``label_kernels.sweep``: ``X0`` and ``cov`` are the ``[g·rps, wt]``
    bitmaps, shard s's slab at rows ``[s·rps, (s+1)·rps)``; ``groups`` is
    ``sweep_ell_groups``'s table. Every wave run counts one halo
    all-gather of the slabs and one psum of the wave's {active, visits}, as
    the reference's program moves them. The plain version for CPU tensors,
    one ``keto_sweep_run`` launch for CUDA tensors."""
    g = X0.shape[0] // rps
    _mesh_shards(mesh, g, X0.device)
    if X0.shape[0] != g * rps:
        raise ValueError(f"X0: {X0.shape[0]} rows is not a whole number of {rps}-row slabs")
    out = label_kernels.sweep(groups, X0, cov, n_dst=rps, shards=g,
                              prune_expansion=prune_expansion, budget=budget)
    for _ in range(out[1]):
        _note("all_gather", g * rps * X0.shape[1] * X0.element_size())
        _note("psum", 2 * 4 * g)
    return out
