"""The device label build's programs: the frontier sweep (K6, with K10c's
per-shard wave) and the covered mask (K7), each as a plain PyTorch version
and a hand-written CUDA kernel.

Source notes:

- ``sweep`` replaces one orientation's sweep of
  keto_tpu/graph/label_build.py: the waves of ``_sweep_step().step``
  (:150) run until ``active`` is false (the loop at :269-281), and, on a
  mesh, the waves of ``sharded_label_sweep_step``
  (keto_tpu/parallel/sharded.py:559, K10c). One wave of a batch of
  landmark BFSs, bit-packed ``wt`` words per node: gather-OR of ``X`` over
  every ELL group into the group's ``dst`` rows, then ``N = P & ~V``,
  ``store = N & ~cov``, ``V |= N``, ``X' = store`` (or ``N`` without
  expansion pruning), ``S |= store``; the wave is active when ``X'`` has a
  bit and its visits are ``popcount(N)``. With a visit budget, each wave's
  visits are subtracted after it runs (the crossing wave counted) and the
  run stops, dry, when the remainder falls below 0. CUDA:
  ``keto_sweep_run`` in csrc/label_kernels.cu, the whole run in ONE
  cooperative launch (waves between grid barriers, the stop test on the
  device) and ONE host read of the stored bitmap and the run's
  {waves, visits, dry} words. Bound: bytes — per wave the gather reads one
  ``X`` word per ELL slot and per word; the sum over the run's waves.
- ``covered`` replaces ``_covered_fn().covered`` (label_build.py:183)
  with the table ``_compute_covered`` builds for it (:193-221): per node
  row, the OR of the lane bits of the batch lanes whose own row shares a
  non-pad entry with the row. The lane masks sit in a dense table
  ``int32[T, wt]`` indexed by node id (T = the label array's rows), so
  nothing is sorted and nothing is searched. CUDA: ``keto_covered``,
  three stream-ordered launches a call (the table's lane bits; the
  covered pass, a group of lanes a row and one table gather an entry; the
  table's slots cleared again), no host read. Bound: bytes — one read of
  the label array and the own rows, one write of the output; the table
  stays in L2.
- ``sweep_step_ref`` and ``sweep_step_into_ref`` are one wave in plain
  PyTorch (the reference's ``_sweep_step().step`` word for word);
  ``sweep_ref`` runs them wave after wave with the same stop test and
  budget as the kernel. ``sweep_step_into_ref`` writes into caller-owned
  ``X2`` and ``state`` and adds into ``state``; each group writes its
  ``dst`` rows below a drop bound ``n_dst`` from its base row, so over a
  sharded table (every shard's slab of ``rps`` rows, ``X`` the gathered
  bitmap in global rows) one call is one wave of the reference's
  ``sharded_label_sweep_step``.

The ELL groups are held flattened (``EllGroups``): one int32 slot array,
one ``dst`` array and a small descriptor table, so a run is one launch
over every group. A sharded layout puts every shard's routed groups in one
table, each group with the base row of its shard (``s·rps``); the plain
version walks the same groups one by one, as the reference.

Bits are int32 in torch and uint32 in CUDA. Launch counts go into the
shared ``COUNTS`` of keto_tpu_torch/check/kernels.py: ``sweep_run`` per
launch, ``sweep_waves`` for the waves the runs ran.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from keto_tpu_torch.check.kernels import (
    COUNTS,
    _check,
    _gather_or,
    _lib,
    _need,
    _on_cpu,
    _or_reduce,
    _popcount,
    _stream,
)

#: row chunk of the plain covered mask (bounds its [rows, width, wt] gather)
_COVER_CHUNK = 1 << 16


#: the kernel's descriptor table holds at most this many groups
MAX_GROUPS = 256
#: groups of at least this degree cap give each row a warp in the kernel
WIDE_CAP = 32


@dataclass(frozen=True)
class EllGroups:
    """One pull orientation's degree-bucketed gather groups on a device:
    group g has ``rows[g]`` rows of ``caps[g]`` slots at
    ``slots[offs[g]:]`` (row-major) and writes rows
    ``bases[g] + dst[starts[g]:starts[g]+rows[g]]`` (the base is 0
    unsharded, ``s·rps`` for shard s's routed groups). ``desc`` is the
    kernel's copy of ``(start, rows, cap, off, base)`` per group, int32
    [G, 5]."""

    slots: torch.Tensor  # int32 [Σ rows·cap], sentinel n = the all-zero row
    dst: torch.Tensor  # int32 [Σ rows], distinct across all groups of one base
    desc: torch.Tensor  # int32 [G, 5]
    caps: tuple
    rows: tuple
    starts: tuple
    offs: tuple
    bases: tuple

    @property
    def n_rows(self) -> int:
        return int(sum(self.rows))

    @classmethod
    def from_groups(cls, groups, device, bases=None) -> "EllGroups":
        """From ``build_ell_groups``'s ``[(nbrs[rows, cap], dst[rows])]``,
        with ``bases[g]`` the base row of group g (all 0 when None)."""
        caps = [int(nb.shape[1]) for nb, _ in groups]
        rows = [int(nb.shape[0]) for nb, _ in groups]
        bases = [0] * len(groups) if bases is None else [int(b) for b in bases]
        starts = np.cumsum([0] + rows)[:-1].tolist()
        offs = np.cumsum([0] + [r * c for r, c in zip(rows, caps)])[:-1].tolist()
        desc = np.array([starts, rows, caps, offs, bases], np.int64).T.reshape(-1, 5)
        slots = [np.ascontiguousarray(nb, np.int32).ravel() for nb, _ in groups]
        dst = [np.asarray(d, np.int32) for _, d in groups]
        if int(sum(s.size for s in slots)) >= 2**31:
            raise ValueError("ELL slots past 2^31: the sweep kernel indexes them in 32 bits")
        dev = torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        return cls(
            slots=t(np.concatenate(slots) if slots else np.zeros(0, np.int32)),
            dst=t(np.concatenate(dst) if dst else np.zeros(0, np.int32)),
            desc=t(desc.astype(np.int32)), caps=tuple(caps), rows=tuple(rows),
            starts=tuple(starts), offs=tuple(offs), bases=tuple(bases),
        )

    def group(self, g: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(nbrs[rows, cap], dst[rows])`` views of group ``g``."""
        r, c, s, o = self.rows[g], self.caps[g], self.starts[g], self.offs[g]
        return self.slots[o : o + r * c].view(r, c), self.dst[s : s + r]


# -- plain PyTorch versions -----------------------------------------------------


def sweep_step_into_ref(groups: EllGroups, X, V, S, cov, X2, state, *,
                        n_dst: Optional[int] = None, prune_expansion: bool = True) -> None:
    """One wave in plain PyTorch into ``X2`` (zeroed) and ``state``: gathers
    from ``X`` (its own row count), updates ``V`` and ``S`` in place, sets
    ``state[0]`` when the wave is active and adds its ``visits`` into
    ``state[1]`` (int32 wrap-around). Group g writes rows
    ``bases[g] + d`` for its ``dst`` rows ``d`` in ``[0, n_dst)`` and drops
    the rest (``n_dst`` defaults to ``V``'s rows): sharded, every shard's
    slab in one call."""
    P = torch.zeros_like(V)
    n_dst = V.shape[0] if n_dst is None else n_dst
    for g in range(len(groups.rows)):
        nb, d = groups.group(g)
        keep = (d >= 0) & (d < n_dst)
        if bool(keep.any()):
            P[groups.bases[g] + d[keep].long()] = _gather_or(X, nb[keep])
    N = P & ~V
    store = N & ~cov
    V |= N
    X2.copy_(store if prune_expansion else N)
    S |= store
    if bool((X2 != 0).any()):
        state[0] = 1
    state[1] = (int(state[1]) + int(_popcount(N).sum()) + 2**31) % 2**32 - 2**31


def sweep_step_ref(groups: EllGroups, V, X, S, cov, *, prune_expansion: bool = True):
    """One wave in plain PyTorch → ``(V, X2, S, state)``; ``V`` and ``S``
    are updated in place, ``state`` is int32[2] {active, visits}."""
    X2 = torch.zeros_like(V)
    state = torch.zeros(2, dtype=torch.int32, device=V.device)
    sweep_step_into_ref(groups, X, V, S, cov, X2, state, prune_expansion=prune_expansion)
    return V, X2, S, state


def sweep_ref(groups: EllGroups, X0, cov, *, n_dst: int, shards: int = 1,
              prune_expansion: bool = True, budget: Optional[int] = None):
    """The whole sweep in plain PyTorch: waves of ``sweep_step_into_ref``
    from the seeded frontier ``X0`` (also the first visited set) until a
    wave is inactive, or until the visits exceed ``budget`` (the crossing
    wave counted). ``X0`` and ``cov`` hold ``shards·n_dst`` rows; shard s's
    groups (base ``s·n_dst``) write its slab of ``n_dst`` rows and every
    wave gathers from the whole frontier, as the halo-exchanged bitmap.
    Returns ``(S, waves, visits, dry)`` with ``S`` the stored bitmap on the
    host (int32). Each wave's visits come from its int32 state word."""
    if X0.shape[0] != shards * n_dst or cov.shape != X0.shape:
        raise ValueError(f"X0 {tuple(X0.shape)} and cov {tuple(cov.shape)}: expected "
                         f"{shards}·{n_dst} rows")
    V, X, S = X0.clone(), X0.clone(), torch.zeros_like(X0)
    waves = visits = 0
    dry = False
    while groups.rows:
        X2 = torch.zeros_like(V)
        state = torch.zeros(2, dtype=torch.int32, device=V.device)
        sweep_step_into_ref(groups, X, V, S, cov, X2, state, n_dst=n_dst,
                            prune_expansion=prune_expansion)
        active, wave_visits = state.tolist()
        waves += 1
        visits += wave_visits
        if budget is not None and visits > budget:
            dry = True
            break
        if not active:
            break
        X = X2
    return S.cpu(), waves, visits, dry


def _lane_bit(j: int) -> int:
    """Lane ``j``'s bit in its int32 word."""
    b = 1 << (j % 32)
    return b - (1 << 32) if b >= 1 << 31 else b


def covered_ref(lab: torch.Tensor, own: torch.Tensor, *, wt: int, rows: Optional[int] = None,
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``int32[rows, wt]`` (``rows`` defaults to ``lab``'s T rows; rows past
    T are 0): per row of ``lab``, the OR of lane j's bit over the lanes j
    whose own row (``own[j]``) shares an entry in [0, T) with it. The same
    three phases as the kernel: the lane bits into the dense table
    ``int32[T, wt]`` (one indexed OR a lane), the gather, in row chunks,
    and the table cleared (``table`` zero on entry and on return; a fresh
    one when None)."""
    T = lab.shape[0]
    rows = T if rows is None else rows
    if table is None:
        table = torch.zeros((T, wt), dtype=torch.int32, device=lab.device)
    live = []
    for j in range(own.shape[0]):
        v = own[j]
        v = v[(v >= 0) & (v < T)].long()
        table[v, j // 32] |= _lane_bit(j)
        live.append((v, j // 32))
    out = torch.zeros((rows, wt), dtype=torch.int32, device=lab.device)
    for r0 in range(0, T, _COVER_CHUNK):
        part = lab[r0 : r0 + _COVER_CHUNK]
        hit = (part >= 0) & (part < T)
        m = table[torch.where(hit, part, torch.zeros_like(part)).long()]
        m = torch.where(hit[..., None], m, torch.zeros((), dtype=m.dtype, device=lab.device))
        out[r0 : r0 + part.shape[0]] = _or_reduce(m, 1)
    for v, w in live:
        table[v, w] = 0
    return out


# -- CUDA wrappers ----------------------------------------------------------------


def sweep_cuda(groups: EllGroups, X0, cov, *, n_dst: int, shards: int = 1,
               prune_expansion: bool = True, budget: Optional[int] = None):
    """The whole sweep via ONE ``keto_sweep_run`` launch and ONE host read
    → ``(S, waves, visits, dry)`` as ``sweep_ref``. Sharded
    (``shards > 1``), the run copies every shard's frontier slab into the
    gathered bitmap between waves (the halo all-gather). ``X0`` is not
    modified."""
    _need(X0, "X0", 2)
    _need(cov, "cov", 2)
    rows, wt = X0.shape
    if rows != shards * n_dst or cov.shape != X0.shape:
        raise ValueError(f"X0 {tuple(X0.shape)} and cov {tuple(cov.shape)}: expected "
                         f"{shards}·{n_dst} rows")
    for t, what in ((groups.slots, "slots"), (groups.dst, "dst"), (groups.desc, "desc")):
        _need(t, what, 1 if what != "desc" else 2)
    if rows * wt >= 2**31:
        raise ValueError(f"{rows}·{wt} bitmap words: the sweep kernel indexes them in 32 bits")
    G = len(groups.rows)
    if G > MAX_GROUPS:
        raise ValueError(f"{G} ELL groups: the sweep kernel's table holds {MAX_GROUPS}")
    if not G:
        return torch.zeros((rows, wt), dtype=torch.int32), 0, 0, False
    state = sweep_state(X0)
    COUNTS["sweep_run"] += 1
    _check(sweep_launch(_lib(), groups, state, cov, n_dst=n_dst, halo=shards > 1,
                        prune_expansion=prune_expansion, budget=budget, stream=_stream()),
           "keto_sweep_run")
    buf, at = state[3], state[4]
    host = buf.cpu()
    waves, visits, dry, over = host[at:].view(torch.int64)[4:8].tolist()
    if over:
        raise RuntimeError("keto_sweep_run passed its wave cap: the sweep did not converge")
    COUNTS["sweep_waves"] += waves
    return host[: rows * wt].view(rows, wt), waves, visits, bool(dry)


def sweep_state(X0: torch.Tensor) -> tuple:
    """One run's device buffers: the frontier (a copy of ``X0``: the halo
    phase rewrites it), the visited set, the two frontier buffers (zeroed)
    and one int32 buffer holding the stored bitmap and, at offset ``at``,
    the run's int64 control words (zeroed), so one copy brings both home.
    ``(X, V, Xab, buf, at)``."""
    rows, wt = X0.shape
    words = rows * wt
    at = words + (words & 1)
    Xab = torch.zeros((2, rows, wt), dtype=torch.int32, device=X0.device)
    buf = torch.zeros(at + 16, dtype=torch.int32, device=X0.device)
    return X0.clone(), X0.clone(), Xab, buf, at


def sweep_launch(lib, groups: EllGroups, state: tuple, cov, *, n_dst: int, halo: bool,
                 prune_expansion: bool, budget: Optional[int], stream: int) -> int:
    """``keto_sweep_run`` on ``sweep_state``'s buffers; returns its error
    code (the bare launch ``sweep_cuda`` checks, counts and reads)."""
    X, V, Xab, buf, at = state
    rows, wt = X.shape
    work = sum(r * (WIDE_CAP if c >= WIDE_CAP else wt) for r, c in zip(groups.rows, groups.caps))
    if halo:
        work = max(work, rows * wt)
    return lib.keto_sweep_run(
        groups.slots.data_ptr(), groups.dst.data_ptr(), groups.desc.data_ptr(), len(groups.rows),
        wt, n_dst, rows * wt, int(halo), X.data_ptr(), Xab[0].data_ptr(),
        None if halo else Xab[1].data_ptr(), V.data_ptr(), buf.data_ptr(), cov.data_ptr(),
        int(prune_expansion), int(budget is not None), 0 if budget is None else int(budget),
        buf[at:].data_ptr(), work, stream)


def covered_launch(lib, lab: torch.Tensor, own: torch.Tensor, wt: int, table: torch.Tensor,
                   out: torch.Tensor, stream: int) -> int:
    """``keto_covered`` into ``out`` (its rows the output's); returns the
    error code (the bare launch ``covered_cuda`` checks and counts). The
    row loads are 16 bytes where the width and ``lab``'s address allow."""
    width = lab.shape[1]
    vec = 4 if width % 4 == 0 and lab.data_ptr() % 16 == 0 else 1
    return lib.keto_covered(lab.data_ptr(), lab.shape[0], width, own.data_ptr(), own.shape[0],
                            own.shape[1], wt, table.data_ptr(), out.data_ptr(), out.shape[0],
                            vec, stream)


def covered_cuda(lab: torch.Tensor, own: torch.Tensor, *, wt: int, rows: Optional[int] = None,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``int32[rows, wt]`` via ``keto_covered`` (its three launches, one
    count) and no host read, as ``covered_ref``; ``table`` (``int32[T,
    wt]`` on the card, zero) is reused across calls when given, and left
    zero."""
    _need(lab, "lab", 2)
    _need(own, "own", 2)
    T = lab.shape[0]
    rows = T if rows is None else rows
    lanes = own.shape[0]
    if table is None:
        table = torch.zeros((T, wt), dtype=torch.int32, device=lab.device)
    _need(table, "table", 2)
    if tuple(table.shape) != (T, wt) or not 1 <= lanes <= 32 * wt or not own.shape[1] \
            or rows < T:
        raise ValueError(f"covered: lab {tuple(lab.shape)}, own {tuple(own.shape)}, table "
                         f"{tuple(table.shape)}, wt {wt}, {rows} rows: expected a [T, wt] table, "
                         "1..32·wt own rows and at least T output rows")
    if rows >= 2**31:
        raise ValueError(f"covered: {rows} rows: the kernel takes row counts in 32 bits")
    out = torch.empty((rows, wt), dtype=torch.int32, device=lab.device)
    COUNTS["covered"] += 1
    _check(covered_launch(_lib(), lab, own, wt, table, out, _stream()), "keto_covered")
    return out


# -- dispatchers --------------------------------------------------------------------


def sweep(groups: EllGroups, X0, cov, *, n_dst: int, shards: int = 1,
          prune_expansion: bool = True, budget: Optional[int] = None):
    """K6 (K10c with ``shards > 1``), one orientation's whole sweep →
    ``(S, waves, visits, dry)``: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    fn = sweep_ref if _on_cpu(X0) else sweep_cuda
    return fn(groups, X0, cov, n_dst=n_dst, shards=shards, prune_expansion=prune_expansion,
              budget=budget)


def covered(lab: torch.Tensor, own: torch.Tensor, *, wt: int, rows: Optional[int] = None,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: the plain version for CPU tensors, the kernel for CUDA tensors."""
    fn = covered_ref if _on_cpu(lab) else covered_cuda
    return fn(lab, own, wt=wt, rows=rows, table=table)
