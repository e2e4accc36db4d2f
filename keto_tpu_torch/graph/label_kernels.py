"""The device label build's programs: the frontier wave (K6) and the
covered mask (K7), each as a plain PyTorch version and a hand-written CUDA
kernel.

Source notes:

- ``sweep_step`` replaces ``_sweep_step().step``
  (keto_tpu/graph/label_build.py:150): one frontier wave of a batch of
  landmark BFSs, bit-packed ``wt`` words per node. Gather-OR of ``X`` over
  every ELL group into the group's ``dst`` rows, then ``N = P & ~V``,
  ``store = N & ~cov``, ``V |= N``, ``X2 = store`` (or ``N`` without
  expansion pruning), ``S |= store``; plus ``active = any(X2 != 0)`` and
  ``visits = popcount(N)``. CUDA: ``keto_sweep_step`` in
  csrc/label_kernels.cu, one thread per (group row, word) over all groups
  in ONE launch. Bound: bytes — the gather reads one ``X`` word per ELL
  slot and per word.
- ``covered`` replaces ``_covered_fn().covered`` (label_build.py:183):
  per node row, OR of the lane masks of the label entries found in the
  sorted value table ``U``. CUDA: ``keto_covered``, one thread per row
  with ``U`` and the masks in shared memory. Bound: bytes — one read of
  every label entry.
- ``sweep_step_into`` is the same wave into caller-owned ``X2`` and
  ``state``, dropping a ``dst`` outside ``V``'s rows and adding into
  ``state``. The sharded build (``sharded_label_sweep_step``,
  keto_tpu/parallel/sharded.py:559; K10c) calls it once per shard: ``X``
  is the halo-exchanged bitmap in global rows, ``V``/``S``/``cov``/``X2``
  the shard's local ``[rps, wt]`` rows (so the routing's ``rps`` sentinel
  is dropped), and every shard adds into one state pair. It launches the
  same ``keto_sweep_step``; the program around it (the halo exchange, the
  shards) is keto_tpu_torch/parallel/sharded.py.

The ELL groups are held flattened (``EllGroups``): one int32 slot array,
one ``dst`` array and a small descriptor table, so a wave is one launch;
the plain version walks the same groups one by one, as the reference.

``sweep_step`` updates ``V`` and ``S`` IN PLACE (both versions: the caller
drops the old arrays, as the reference rebinds them) and returns a fresh
frontier ``X2``, so every gather of the wave reads the old ``X`` (Jacobi,
as the reference). ``X`` must not alias ``V`` or ``S``. The wave's
``active`` flag and ``visits`` count come back as one int32[2] device
tensor, which the caller reads once per wave. Launch counts go into the
shared ``COUNTS`` of keto_tpu_torch/check/kernels.py.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    _stream,
)

#: row chunk of the plain covered mask (bounds its [rows, width, wt] gather)
_COVER_CHUNK = 1 << 16


@dataclass(frozen=True)
class EllGroups:
    """One pull orientation's degree-bucketed gather groups on a device:
    group g has ``rows[g]`` rows of ``caps[g]`` slots at
    ``slots[offs[g]:]`` (row-major) and writes rows
    ``dst[starts[g]:starts[g]+rows[g]]``. ``desc`` is the device copy of
    ``(start, cap, off)`` per group, int64[G, 3], for the kernel."""

    slots: torch.Tensor  # int32 [Σ rows·cap], sentinel n = the all-zero row
    dst: torch.Tensor  # int32 [Σ rows], distinct across all groups
    desc: torch.Tensor  # int64 [G, 3]
    caps: tuple
    rows: tuple
    starts: tuple
    offs: tuple

    @property
    def n_rows(self) -> int:
        return int(sum(self.rows))

    @classmethod
    def from_groups(cls, groups, device) -> "EllGroups":
        """From ``build_ell_groups``'s ``[(nbrs[rows, cap], dst[rows])]``."""
        caps = [int(nb.shape[1]) for nb, _ in groups]
        rows = [int(nb.shape[0]) for nb, _ in groups]
        starts = np.cumsum([0] + rows)[:-1].tolist()
        offs = np.cumsum([0] + [r * c for r, c in zip(rows, caps)])[:-1].tolist()
        desc = np.array([starts, caps, offs], np.int64).T.reshape(-1, 3)
        slots = [np.ascontiguousarray(nb, np.int32).ravel() for nb, _ in groups]
        dst = [np.asarray(d, np.int32) for _, d in groups]
        dev = torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        return cls(
            slots=t(np.concatenate(slots) if slots else np.zeros(0, np.int32)),
            dst=t(np.concatenate(dst) if dst else np.zeros(0, np.int32)),
            desc=t(desc), caps=tuple(caps), rows=tuple(rows),
            starts=tuple(starts), offs=tuple(offs),
        )

    def group(self, g: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(nbrs[rows, cap], dst[rows])`` views of group ``g``."""
        r, c, s, o = self.rows[g], self.caps[g], self.starts[g], self.offs[g]
        return self.slots[o : o + r * c].view(r, c), self.dst[s : s + r]


# -- plain PyTorch versions -----------------------------------------------------


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words read as uint32 (int64 result)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def sweep_step_into_ref(groups: EllGroups, X, V, S, cov, X2, state, *,
                        prune_expansion: bool = True) -> None:
    """One wave in plain PyTorch into ``X2`` (zeroed) and ``state``: gathers
    from ``X`` (its own row count), updates ``V`` and ``S`` in place, drops
    a group ``dst`` outside ``V``'s rows, sets ``state[0]`` when the wave
    is active and adds its ``visits`` into ``state[1]`` (int32
    wrap-around)."""
    P = torch.zeros_like(V)
    n_dst = V.shape[0]
    for g in range(len(groups.rows)):
        nb, d = groups.group(g)
        keep = (d >= 0) & (d < n_dst)
        if bool(keep.any()):
            P[d[keep].long()] = _gather_or(X, nb[keep])
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


def covered_ref(lab: torch.Tensor, U: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """``int32[rows, wt]``: per row, the OR of ``masks[k]`` over the row's
    entries equal to ``U[k]`` (a left searchsorted plus an equality test,
    as the reference), in row chunks."""
    rows, wt = lab.shape[0], masks.shape[1]
    out = torch.zeros((rows, wt), dtype=torch.int32, device=lab.device)
    if U.numel() == 0:
        return out
    last = U.numel() - 1
    for r0 in range(0, rows, _COVER_CHUNK):
        part = lab[r0 : r0 + _COVER_CHUNK]
        idx = torch.searchsorted(U, part).clamp_(max=last)
        found = U[idx] == part
        m = torch.where(found[..., None], masks[idx], torch.zeros((), dtype=masks.dtype, device=lab.device))
        out[r0 : r0 + _COVER_CHUNK] = _or_reduce(m, 1)
    return out


# -- CUDA wrappers ----------------------------------------------------------------


def sweep_step_into_cuda(groups: EllGroups, X, V, S, cov, X2, state, *,
                         prune_expansion: bool = True) -> None:
    """One wave via ``keto_sweep_step`` (one launch over every group) into
    ``X2`` and ``state``: ``X`` int32[rows, wt], ``V``/``S``/``cov``/``X2``
    int32[n_dst, wt] with ``n_dst`` the kernel's drop bound."""
    _need(X, "X", 2)
    for t, what in ((V, "V"), (S, "S"), (cov, "cov"), (X2, "X2")):
        _need(t, what, 2)
        if t.shape != (V.shape[0], X.shape[1]):
            raise ValueError(f"{what}: expected {(V.shape[0], X.shape[1])}, got {tuple(t.shape)}")
    for t, what in ((groups.slots, "slots"), (groups.dst, "dst")):
        _need(t, what, 1)
    _need(state, "state", 1)
    if X.data_ptr() in (V.data_ptr(), S.data_ptr(), X2.data_ptr()) \
            or X2.data_ptr() in (V.data_ptr(), S.data_ptr()):
        raise ValueError("X and X2 must not alias each other, V or S: the wave reads the old frontier")
    if groups.rows:
        COUNTS["sweep_step"] += 1
        _check(_lib().keto_sweep_step(
            groups.slots.data_ptr(), groups.dst.data_ptr(), groups.desc.data_ptr(),
            len(groups.rows), groups.n_rows, X.data_ptr(), V.data_ptr(), S.data_ptr(),
            cov.data_ptr(), X2.data_ptr(), X.shape[1], V.shape[0], int(prune_expansion),
            state.data_ptr(), _stream()), "keto_sweep_step")


def sweep_step_cuda(groups: EllGroups, V, X, S, cov, *, prune_expansion: bool = True):
    """One wave via ``keto_sweep_step`` (one launch over every group)."""
    if X.shape != V.shape:
        raise ValueError(f"X: expected {tuple(V.shape)}, got {tuple(X.shape)}")
    X2 = torch.zeros_like(V)
    state = torch.zeros(2, dtype=torch.int32, device=V.device)
    sweep_step_into_cuda(groups, X, V, S, cov, X2, state, prune_expansion=prune_expansion)
    return V, X2, S, state


def covered_cuda(lab: torch.Tensor, U: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """``int32[rows, wt]`` via ``keto_covered``: ONE launch covers every
    row (the reference's ``_COVER_CHUNK`` split only bounds an intermediate
    array that the kernel does not have)."""
    _need(lab, "lab", 2)
    _need(U, "U", 1)
    _need(masks, "masks", 2)
    if masks.shape[0] != U.numel():
        raise ValueError(f"masks: expected {U.numel()} rows, got {tuple(masks.shape)}")
    rows, wt = lab.shape[0], masks.shape[1]
    out = torch.zeros((rows, wt), dtype=torch.int32, device=lab.device)
    if rows:
        COUNTS["covered"] += 1
        _check(_lib().keto_covered(lab.data_ptr(), rows, lab.shape[1], U.data_ptr(), U.numel(),
                                   masks.data_ptr(), wt, out.data_ptr(), _stream()),
               "keto_covered")
    return out


# -- dispatchers --------------------------------------------------------------------


def sweep_step(groups: EllGroups, V, X, S, cov, *, prune_expansion: bool = True):
    """K6: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(V):
        return sweep_step_ref(groups, V, X, S, cov, prune_expansion=prune_expansion)
    return sweep_step_cuda(groups, V, X, S, cov, prune_expansion=prune_expansion)


def sweep_step_into(groups: EllGroups, X, V, S, cov, X2, state, *,
                    prune_expansion: bool = True) -> None:
    """K6 into caller-owned ``X2``/``state`` (K10c's per-shard wave): the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(V):
        sweep_step_into_ref(groups, X, V, S, cov, X2, state, prune_expansion=prune_expansion)
    else:
        sweep_step_into_cuda(groups, X, V, S, cov, X2, state, prune_expansion=prune_expansion)


def covered(lab: torch.Tensor, U: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """K7: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if _on_cpu(lab):
        return covered_ref(lab, U, masks)
    return covered_cuda(lab, U, masks)
