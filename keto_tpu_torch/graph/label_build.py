"""Device-side 2-hop label construction: landmark BFS as batched frontier
sweeps on one GPU.

A port of the single-device build of keto_tpu/graph/label_build.py.
``build_labels`` (keto_tpu_torch/graph/labels.py) runs one Python BFS per
landmark; this module runs a batch of ``batch`` landmark BFSs at once as a
bit-packed ``int32[n+1, batch/32]`` frontier, one orientation's waves to
their fixpoint per call of ``sweep`` (K6, keto_tpu_torch/graph/label_kernels.py;
on the card one launch and one host read a sweep): forward sweeps
pull along the interior in-neighbour rows, backward sweeps along the
transposed rows, and PLL **expansion pruning is a per-wave ANDNOT** against
the batch's ``covered`` rows — the pairs the labels built so far already
certify, computed once per batch and orientation by ``covered`` (K7).

Entry-set identity with ``build_labels`` is the contract. Intra-batch
interference — an earlier-ranked member whose fresh labels would have
pruned a later member's sequential BFS — is read from the sweep output
(lane i stored at lane j's landmark row) and resolved by **prefix
acceptance**: the longest interference-free rank prefix commits and the
rest re-runs in the next batch. Width caps, ok flags and per-row entry
order replay on the host in rank order (``_Mirror``), exactly as the
sequential build applies them. Landmarks stream in rank batches with no
landmark cap; ``min_gain`` stops the stream when the marginal entries per
landmark fall below it.

``device_patch_labels`` (keto_tpu/graph/label_build.py:630) is the
incremental patch of an overlay compaction on the same machinery: the
exact ``labels.patch_labels`` semantics, each folded edge's resume
landmarks run as bit-packed lanes with ``prune_expansion=False``. The
mirror's stores reach the device label arrays through K9
(``slot_set_many``, in place, as the reference's mirror updates its
arrays: both sides in one call, one launch a flush).

``_ShardedSweeper`` (keto_tpu/graph/label_build.py:284-365) runs the same
waves over the row-range shards of a ``ShardMesh``
(keto_tpu_torch/parallel/): the ELL groups are routed by destination row
(``route_label_ell``, the rows the serving label stripes use), the frontier
slabs halo-exchange once per wave and each shard runs its part of the wave
(K10c, ``label_sweep``: every shard's waves in the same one launch a sweep).
OR is OR on any layout, so the stored entry
set equals ``_Sweeper``'s. ``mesh=`` with ``shard_count > 1`` selects it,
as in the reference (:553-554, :665-666).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.graph import label_kernels
from keto_tpu_torch.graph.device_build import shard_row_ranges
from keto_tpu_torch.graph.labels import IN_PAD, OUT_PAD, LabelIndex, interior_adjacency, landmark_order

#: default landmark lanes per sweep batch (one int32 word pair of frontier
#: state per node); must be a multiple of 32
DEFAULT_BATCH = 64

#: device builds below this interior-edge count lose to launch + transfer
#: overhead; callers compare against the snapshot's ELL edge slots
DEFAULT_MIN_EDGES = 65536


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


# -- interior ELL groups ------------------------------------------------------


def build_ell_groups(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Degree-bucketed dense gather groups for one pull orientation:
    ``[(nbrs int32[rows, cap], dst int32[rows]), ...]`` with pow2 caps and
    gather sentinel ``n`` (the always-zero bitmap row). Derived from the
    same CSRs as ``interior_adjacency`` so the sweeps and the host build
    walk the identical edge universe."""
    deg = np.diff(indptr)
    groups = []
    if n == 0:
        return groups
    nz = np.nonzero(deg > 0)[0]
    if not nz.size:
        return groups
    bucket_of = np.ceil(np.log2(np.maximum(deg[nz], 1))).astype(np.int64)
    for b in np.unique(bucket_of):
        rows = nz[bucket_of == b]
        cap = 1 << int(b)
        nbrs = np.full((rows.size, cap), np.int32(n), np.int32)
        lens = deg[rows]
        offs = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
        nbrs[np.repeat(np.arange(rows.size), lens), offs] = indices[
            np.repeat(indptr[rows], lens) + offs
        ]
        groups.append((np.ascontiguousarray(nbrs), rows.astype(np.int32)))
    return groups


def estimate_build_bytes(n: int, max_width: int, batch: int = DEFAULT_BATCH) -> int:
    """Transient device bytes one sweep batch holds live: frontier /
    visited / stored / covered bitmaps for both orientations plus the
    full-width resident label arrays the covered kernel reads."""
    wt = max(1, batch // 32)
    bitmaps = 6 * (n + 1) * wt * 4
    labels = 2 * (n + 1) * max(1, max_width) * 4
    return bitmaps + labels


def _compute_covered(lab_d: torch.Tensor, own_rows_host: np.ndarray, lanes: int, wt: int, pad,
                     *, rows: Optional[int] = None, table: Optional[torch.Tensor] = None):
    """Covered bitmap ``int32[rows, wt]`` for one orientation (``rows``
    defaults to ``lab_d``'s n+1; a sharded sweep's g·rps rows have a zero
    tail): the bits of the batch lanes whose own pre-batch label row (host
    mirror rows) shares an entry with each row of ``lab_d``, via ``covered``
    (K7). The own rows are checked here, with numpy: an entry that is
    neither ``pad`` nor a row of ``lab_d`` raises. No own entry at all gives
    zeros without a launch; else one upload of the rows as they are and,
    on the card, ``keto_covered`` and no host read. ``table`` is a zero
    ``int32[n+1, wt]`` reused across calls (fresh when None)."""
    own = np.ascontiguousarray(own_rows_host[:lanes], np.int32)
    n1 = int(lab_d.shape[0])
    live = own != pad
    bad = live & ((own < 0) | (own >= n1))
    if bad.any():
        j, k = (int(x[0]) for x in np.nonzero(bad))
        raise ValueError(f"covered: lane {j}'s own entry {int(own[j, k])} is neither the pad "
                         f"{pad} nor a row of a {n1}-row label array")
    rows = n1 if rows is None else rows
    if not live.any():
        return torch.zeros((rows, wt), dtype=torch.int32, device=lab_d.device)
    return label_kernels.covered(lab_d, kernels._upload(own, lab_d.device), wt=wt, rows=rows,
                                 table=table)


def _seed_bitmap(rows, n: int, wt: int, n_rows: int) -> np.ndarray:
    """``int32[n_rows, wt]``: lane j's bit at row ``rows[j]`` when it is a
    node (``-1`` marks a dead lane); rows past ``n + 1`` are padding."""
    V0 = np.zeros((n_rows, wt), np.uint32)
    for j, u in enumerate(np.asarray(rows, np.int64).tolist()):
        if 0 <= u < n:
            V0[u, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    return V0.view(np.int32)


class _Sweeper:
    """Runs batched frontier sweeps on one device. ``seconds`` sums the host
    clock of the sweeps' seed uploads (``upload``) and of their runs from
    the call to the host read that brings the stored bitmap home
    (``sweep``)."""

    backend = "device"

    def __init__(self, fwd_groups, bwd_groups, n: int, device):
        self.n = n
        self.device = torch.device(device)
        self._fwd, self._bwd = self._groups(fwd_groups), self._groups(bwd_groups)
        self.seconds = {"upload": 0.0, "sweep": 0.0}
        self.sweeps = 0
        self.waves = 0

    def _groups(self, groups):
        return label_kernels.EllGroups.from_groups(groups, self.device)

    def _rows(self) -> int:
        return self.n + 1

    def _run(self, groups, X0, cov, prune_expansion, budget):
        return label_kernels.sweep(groups, X0, cov, n_dst=self.n + 1,
                                   prune_expansion=prune_expansion, budget=budget)

    def sweep(
        self,
        forward: bool,
        seeds: np.ndarray,
        cov: torch.Tensor,
        wt: int,
        *,
        prune_expansion: bool = True,
        budget: Optional[list] = None,
        start_rows: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Run one orientation's waves to the fixpoint; returns the stored
        bitmap ``uint32[n+1, wt]`` on the host, or None when ``budget`` (a
        mutable ``[remaining visits]``) runs dry. ``cov`` is the covered
        mask of the sweeper's ``_rows()`` rows. Lane j starts at
        ``seeds[j]`` (-1 for a dead lane), or at ``start_rows[j]`` when
        given (a patch resumes mid-graph; stores still belong to lane j's
        landmark). Each wave's visits are subtracted from the budget after
        the wave, the crossing wave included, as the reference's loop. On
        the card the call makes one launch and one host read, after the
        seed bitmap's synchronous upload."""
        t0 = time.monotonic()
        rows = seeds if start_rows is None else start_rows
        X0 = torch.from_numpy(_seed_bitmap(rows, self.n, wt, self._rows())).to(self.device)
        t1 = time.monotonic()
        S, waves, visits, dry = self._run(self._fwd if forward else self._bwd, X0, cov,
                                          prune_expansion, None if budget is None else budget[0])
        self.seconds["upload"] += t1 - t0
        self.seconds["sweep"] += time.monotonic() - t1
        self.sweeps += 1
        self.waves += waves
        if budget is not None:
            budget[0] -= visits
        if dry:
            return None
        return S[: self.n + 1].numpy().view(np.uint32)


class _ShardedSweeper(_Sweeper):
    """The sweeps over a mesh's row-range shards: frontier slabs sharded by
    the serving path's row ownership, one halo exchange per wave (K10c),
    every shard's waves in the same run. Stores the same bitmaps as
    ``_Sweeper``. Its covered masks hold its g·rps rows (``_rows()``), the
    tail past n+1 zero: K7 writes them so."""

    backend = "sharded"

    def __init__(self, fwd_groups, bwd_groups, n: int, mesh, n_shards: int, device):
        self._mesh = mesh
        self._g = max(1, int(n_shards))
        ranges = shard_row_ranges(n + 1, self._g)
        self._rps = ranges[0][1] - ranges[0][0] if ranges[0][1] > ranges[0][0] else 1
        super().__init__(fwd_groups, bwd_groups, n, device)

    def _groups(self, groups):
        from keto_tpu_torch.parallel import sharded as shard_mod

        routed = shard_mod.route_label_ell(groups, self.n, self._g, self._rps)
        return shard_mod.sweep_ell_groups(routed, self._rps, self.device)

    def _rows(self) -> int:
        return self._g * self._rps

    def _run(self, groups, X0, cov, prune_expansion, budget):
        from keto_tpu_torch.parallel import sharded as shard_mod

        return shard_mod.label_sweep(self._mesh, groups, X0, cov, rps=self._rps,
                                     prune_expansion=prune_expansion, budget=budget)


def _make_sweeper(fwd_groups, bwd_groups, n: int, device, mesh, shard_count: int):
    """``_ShardedSweeper`` for a mesh of more than one shard, else
    ``_Sweeper`` (keto_tpu/graph/label_build.py:553-556)."""
    if mesh is not None and int(shard_count) > 1:
        return _ShardedSweeper(fwd_groups, bwd_groups, n, mesh, shard_count, device)
    return _Sweeper(fwd_groups, bwd_groups, n, device)


# -- host-side finalize state -------------------------------------------------


class _Mirror:
    """Host mirror of the evolving label arrays plus their device twins:
    stores apply here in exact sequential (rank) order — width caps, ok
    flags, per-row entry order — and the deltas scatter onto the device
    arrays the next batch's covered kernel reads. The device rows are in
    append order, not sorted; ``finalize`` sorts."""

    def __init__(self, n: int, max_width: int, device, out0=None, in0=None):
        self.n = n
        self.max_width = max_width
        W = max(1, max_width)
        self.out_h = np.full((n + 1, W), OUT_PAD, np.int32)
        self.in_h = np.full((n + 1, W), IN_PAD, np.int32)
        # a patch starts from an index's rows: pow2-padded, entries sorted
        # at the front, so columns past max_width are all pad
        if out0 is not None:
            span = min(W, out0.shape[1])
            self.out_h[: n + 1, :span] = out0[: n + 1, :span]
        if in0 is not None:
            span = min(W, in0.shape[1])
            self.in_h[: n + 1, :span] = in0[: n + 1, :span]
        self.out_w = np.count_nonzero(self.out_h[:n] != OUT_PAD, axis=1).astype(np.int32)
        self.in_w = np.count_nonzero(self.in_h[:n] != IN_PAD, axis=1).astype(np.int32)
        self.out_ok = np.ones(n, bool)
        self.in_ok = np.ones(n, bool)
        self.out_d = torch.from_numpy(self.out_h.copy()).to(device)
        self.in_d = torch.from_numpy(self.in_h.copy()).to(device)
        self._pending: dict[str, list] = {"out": [], "in": []}
        self.flushes = 0
        self.flush_s = 0.0

    def store(self, side: str, nodes: np.ndarray, v: int) -> int:
        """Append landmark ``v`` at ``nodes`` on one side, width-capped; a
        full row trips its ok flag instead of lying (the sequential
        semantics). Returns the number actually stored."""
        nodes = np.asarray(nodes, np.int64)
        if not nodes.size:
            return 0
        h, w, ok, pend = (
            (self.out_h, self.out_w, self.out_ok, self._pending["out"])
            if side == "out"
            else (self.in_h, self.in_w, self.in_ok, self._pending["in"])
        )
        fits = w[nodes] < self.max_width
        good = nodes[fits]
        ok[nodes[~fits]] = False
        if good.size:
            cols = w[good].astype(np.int64)
            h[good, cols] = np.int32(v)
            w[good] += 1
            pend.append((good, cols, np.full(good.size, v, np.int32)))
        return int(good.size)

    def flush_device(self) -> None:
        """Scatter pending host stores onto the device label arrays in
        place: K9 (``slot_set_many``), both sides in one call, so one
        launch a flush on the card. ``flushes`` counts the calls that
        wrote, ``flush_s`` their host clock."""
        t0 = time.monotonic()
        targets = []
        for side, dev in (("out", self.out_d), ("in", self.in_d)):
            pend = self._pending[side]
            if pend:
                targets.append((dev, *(np.concatenate([p[i] for p in pend]) for i in range(3))))
                self._pending[side] = []
        if targets:
            kernels.slot_set_many(targets, in_place=True)
            self.flushes += 1
            self.flush_s += time.monotonic() - t0

    def row(self, side: str, u: int) -> np.ndarray:
        h = self.out_h if side == "out" else self.in_h
        w = self.out_w if side == "out" else self.in_w
        return h[u, : w[u]] if u < self.n else h[u, :0]

    def finalize(self, processed: np.ndarray, n_landmarks: int, backend: str) -> LabelIndex:
        """Pack the mirrors into the padded, sorted device layout —
        byte-identical to ``labels._finalize`` over the same sets."""

        def pack(h, w, pad):
            wmax = int(w.max()) if self.n else 0
            Wp = _ceil_pow2(max(1, wmax))
            out = np.full((self.n + 1, Wp), pad, np.int32)
            if self.n:
                span = min(Wp, h.shape[1])
                tmp = h[: self.n, :span].copy()
                big = np.int32(2**31 - 1)
                tmp[tmp == pad] = big
                tmp.sort(axis=1)
                tmp[tmp == big] = pad
                out[: self.n, :span] = tmp
            return out

        return LabelIndex(
            n=self.n,
            out_lab=pack(self.out_h, self.out_w, OUT_PAD),
            in_lab=pack(self.in_h, self.in_w, IN_PAD),
            processed=processed,
            out_ok=self.out_ok,
            in_ok=self.in_ok,
            max_width=self.max_width,
            n_landmarks=n_landmarks,
            n_entries=int(self.out_w.sum() + self.in_w.sum()),
            backend=backend,
        )


def _lane_nodes(S: Optional[np.ndarray], nz: Optional[np.ndarray], j: int):
    """Node ids where lane ``j``'s bit is set in the stored bitmap."""
    if S is None or nz is None or not nz.size:
        return np.zeros(0, np.int64)
    hit = (S[nz, j // 32] >> np.uint32(j % 32)) & np.uint32(1)
    return nz[hit.astype(bool)]


def _lane_int(S_rows: np.ndarray, j: int, wt: int) -> int:
    """Lane bitmask at one landmark row as a Python int."""
    v = 0
    for w in range(wt):
        v |= int(S_rows[j, w]) << (32 * w)
    return v


@dataclass
class BuildInfo:
    """What the batched build did."""

    batches: int = 0
    dispatches: int = 0
    landmarks: int = 0
    #: "" | "min_gain" | "cap" — why the landmark stream stopped early
    truncated: str = ""
    sweep_entries: int = 0
    restarts: int = 0  # lanes re-run due to intra-batch interference
    build_ms: float = 0.0
    gain_history: list = field(default_factory=list)
    #: the sweeps run and their waves; the host-clock split of build_ms: the
    #: sweeps' seed uploads, the sweeps from the call to the host read that
    #: brings the stored bitmap home, the covered masks (K7: the own rows'
    #: check and upload, the launch) and the mirror's flushes onto the
    #: device arrays (K9, ``flushes`` of them); the rest is the host mirror
    #: and finalize
    sweeps: int = 0
    waves: int = 0
    upload_s: float = 0.0
    sweep_s: float = 0.0
    covered_s: float = 0.0
    flush_s: float = 0.0
    flushes: int = 0


# -- the batched build --------------------------------------------------------


def device_build_labels(
    snap,
    max_width: int = 64,
    landmarks: int = 0,
    *,
    min_gain: float = 0.0,
    batch: int = DEFAULT_BATCH,
    device: Union[str, torch.device] = "cuda",
    mesh=None,
    shard_count: int = 0,
) -> tuple[LabelIndex, BuildInfo]:
    """Construct the 2-hop index for ``snap`` with batched sweeps on
    ``device`` (over ``mesh``'s shards when ``shard_count > 1``);
    entry-set identical to ``build_labels(snap, max_width, landmarks=K)``
    where K is the number of landmarks actually processed
    (``landmarks == 0`` streams ALL interior nodes, subject only to the
    ``min_gain`` early exit)."""
    t0 = time.monotonic()
    n = snap.num_int
    info = BuildInfo()
    out_ip, out_ix, in_ip, in_ix = interior_adjacency(snap)
    order = landmark_order(out_ip, in_ip, n)
    K = n if landmarks <= 0 else min(int(landmarks), n)
    batch = max(32, (int(batch) // 32) * 32)
    wt = batch // 32

    # forward sweeps pull along in-neighbour rows (reach FROM the landmark,
    # the check kernel's orientation); backward sweeps the transposed rows
    sweeper = _make_sweeper(build_ell_groups(in_ip, in_ix, n),
                            build_ell_groups(out_ip, out_ix, n), n, device, mesh, shard_count)
    mirror = _Mirror(n, max_width, sweeper.device)
    cov_rows = sweeper._rows()
    table = torch.zeros((n + 1, wt), dtype=torch.int32, device=sweeper.device)
    processed = np.zeros(n, bool)
    pos = 0
    while pos < K:
        lanes = min(batch, K - pos)
        v_batch = order[pos : pos + lanes].astype(np.int64)
        seeds = np.full(batch, -1, np.int64)
        seeds[:lanes] = v_batch
        mirror.flush_device()
        # covered masks: certification against the FROZEN pre-batch label
        # arrays (the pruning ANDNOT of every wave of this batch)
        tc = time.monotonic()
        cov_f = _compute_covered(mirror.in_d, mirror.out_h[v_batch], lanes, wt, OUT_PAD,
                                 rows=cov_rows, table=table)
        cov_b = _compute_covered(mirror.out_d, mirror.in_h[v_batch], lanes, wt, IN_PAD,
                                 rows=cov_rows, table=table)
        info.covered_s += time.monotonic() - tc
        S_f = sweeper.sweep(True, seeds, cov_f, wt)
        S_b = sweeper.sweep(False, seeds, cov_b, wt)
        info.dispatches += 2
        info.batches += 1
        nz_f = np.nonzero(S_f[:n].any(axis=1))[0]
        nz_b = np.nonzero(S_b[:n].any(axis=1))[0]
        # intra-batch interference: lane i stored at lane j's landmark row
        # (either orientation) means sequential processing of j would have
        # seen i's fresh labels — accept the clean prefix
        rows_f = S_f[v_batch]
        rows_b = S_b[v_batch]
        jstar = lanes
        for j in range(lanes):
            if (_lane_int(rows_f, j, wt) | _lane_int(rows_b, j, wt)) & ((1 << j) - 1):
                jstar = j
                break
        if jstar == 0:
            raise AssertionError("lane 0 can never interfere with itself")
        info.restarts += lanes - jstar
        swept = 0
        for j in range(jstar):
            v = int(v_batch[j])
            # self entries first — reach0(v, v) must hit, the sequential
            # build's invariant (labels.build_labels)
            mirror.store("out", np.array([v]), v)
            mirror.store("in", np.array([v]), v)
            swept += mirror.store("in", _lane_nodes(S_f, nz_f, j), v)
            swept += mirror.store("out", _lane_nodes(S_b, nz_b, j), v)
            processed[v] = True
        info.sweep_entries += swept
        pos += jstar
        info.landmarks = pos
        gain = swept / max(1, jstar) / max(1, n)
        info.gain_history.append(round(gain, 9))
        if min_gain > 0.0 and gain < min_gain and pos < K:
            info.truncated = "min_gain"
            break

    if not info.truncated and K < n:
        info.truncated = "cap"
    idx = mirror.finalize(processed, pos, sweeper.backend)
    idx.build_ms = (time.monotonic() - t0) * 1e3
    info.build_ms = idx.build_ms
    info.landmarks = pos
    info.sweeps, info.waves = sweeper.sweeps, sweeper.waves
    info.upload_s, info.sweep_s = sweeper.seconds["upload"], sweeper.seconds["sweep"]
    info.flush_s, info.flushes = mirror.flush_s, mirror.flushes
    return idx, info


# -- incremental patch through the device path --------------------------------


def device_patch_labels(
    idx: LabelIndex,
    snap,
    added_edges,
    visit_budget: int = 65536,
    *,
    batch: int = DEFAULT_BATCH,
    device: Union[str, torch.device] = "cuda",
    mesh=None,
    shard_count: int = 0,
) -> Optional[LabelIndex]:
    """Incremental-PLL edge insertion through the batched sweeps: the exact
    ``labels.patch_labels`` semantics (per-edge landmark resumption, no
    expansion pruning, stores certified against the evolving sets) with
    each edge's resume list run as bit-packed lanes. Interference between
    lanes is static here — a resume landmark's own label row is frozen for
    the whole loop — so the list splits into clean groups up front. None
    when the caller must rebuild (the host patch's contract): truncated
    endpoint labels, a dry budget, a universe mismatch. The budget counts
    newly visited (node, landmark) pairs like the host walk, though the
    abort point may differ near the boundary."""
    t0 = time.monotonic()
    n = snap.num_int
    if idx.n != n:
        return None
    added = [(int(a), int(b)) for a, b in added_edges]
    for a, b in added:
        if not (0 <= a < n and 0 <= b < n):
            return None
        if not (idx.in_ok[a] and idx.out_ok[b]):
            return None

    out_ip, out_ix, in_ip, in_ix = interior_adjacency(snap)
    sweeper = _make_sweeper(build_ell_groups(in_ip, in_ix, n),
                            build_ell_groups(out_ip, out_ix, n), n, device, mesh, shard_count)
    mirror = _Mirror(n, idx.max_width, sweeper.device, out0=idx.out_lab, in0=idx.in_lab)
    mirror.out_ok = idx.out_ok.copy()
    mirror.in_ok = idx.in_ok.copy()
    batch = max(32, (int(batch) // 32) * 32)
    wt = batch // 32
    budget = [int(visit_budget)]
    cov_rows = sweeper._rows()
    table = torch.zeros((n + 1, wt), dtype=torch.int32, device=sweeper.device)

    def lane_groups(lms: list[int], own_side: str) -> list[list[int]]:
        """Split the ordered resume list into clean prefix groups: lane j
        joins the open group only when no earlier member of the group
        appears in j's own (frozen) label row."""
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_set: set = set()
        for lm in lms:
            own = set(int(x) for x in mirror.row(own_side, lm))
            if cur_set & own or len(cur) >= batch:
                groups.append(cur)
                cur, cur_set = [], set()
            cur.append(lm)
            cur_set.add(lm)
        if cur:
            groups.append(cur)
        return groups

    def run_side(forward: bool, resume_at: int, store_at: int, lms: list[int]) -> bool:
        """One direction of one edge: every landmark in ``lms`` stores at
        ``store_at`` (certified against the current sets) and resumes its
        walk at ``resume_at``. False when the budget runs dry."""
        own_side, write_side = ("out", "in") if forward else ("in", "out")
        pad = OUT_PAD if forward else IN_PAD
        for group in lane_groups(lms, own_side):
            mirror.flush_device()
            lanes = len(group)
            own_rows = np.full((lanes, mirror.max_width), pad, np.int32)
            for j, lm in enumerate(group):
                r = mirror.row(own_side, lm)
                own_rows[j, : r.size] = r
            cov = _compute_covered(mirror.in_d if forward else mirror.out_d, own_rows, lanes,
                                   wt, pad, rows=cov_rows, table=table)
            seeds = np.full(batch, -1, np.int64)
            seeds[:lanes] = group
            starts = np.full(batch, -1, np.int64)
            starts[:lanes] = resume_at
            S = sweeper.sweep(forward, seeds, cov, wt, prune_expansion=False, budget=budget,
                              start_rows=starts)
            if S is None:
                return False
            nz = np.nonzero(S[:n].any(axis=1))[0]
            for j, lm in enumerate(group):
                # the explicit store at the edge endpoint runs before the
                # resumed walk's, certified against the live sets — exactly
                # patch_labels' _store
                own = set(int(x) for x in mirror.row(own_side, lm))
                write_row = set(int(x) for x in mirror.row(write_side, store_at))
                if not (own & write_row):
                    mirror.store(write_side, np.array([store_at]), lm)
                # the covered mask was computed against the group-entry
                # sets; stores by earlier lanes of this group cannot
                # certify (the clean-group invariant), so it is exact
                mirror.store(write_side, _lane_nodes(S, nz, j), lm)
        return True

    for a, b in added:
        if not run_side(True, b, b, sorted(int(x) for x in mirror.row("in", a))):
            return None
        if not run_side(False, a, a, sorted(int(x) for x in mirror.row("out", b))):
            return None

    new = mirror.finalize(idx.processed.copy(), idx.n_landmarks, "device")
    new.build_ms = (time.monotonic() - t0) * 1e3
    return new
