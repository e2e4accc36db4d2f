"""The list fixpoint (K5) as a plain PyTorch version and a hand-written CUDA
kernel.

Source notes:

- ``list_step`` replaces ``list_step`` (keto_tpu/list/tpu_engine.py:76,
  jitted at :114): the reachability fixpoint over one ``ListLayout``, up
  to 32 listings bit-packed in one uint32 word per row. Each step keeps the
  reference's order exactly: the bucket pull ``P = pull(R)`` over the
  active prefix, ``Rn[:n_active] = R[:n_active] | P``, then the overlay —
  ``ovo[k] = OR_c Rn[ov_nbrs[k, c]]`` read from the committed ``Rn``, and
  ``Rn[ov_dst[k]] |= ovo[k]`` with a destination outside the bitmap
  dropped (the padding ``dst = n_rows + 1``) — and the changed flag over
  every row. An overlay destination may be a passive row (no base
  neighbour), which the check step's overlay stage (K2, ORed into the
  pull) would miss. The loop is the reference's ``lax.while_loop``: the
  guard ``changed and it < it_cap`` is tested between blocks of
  ``block_iters`` guarded steps, and a step after convergence is a no-op.
  CUDA: ``keto_list_fixpoint`` (csrc/list_kernels.cu), the whole run in ONE
  cooperative launch — the steps' phases between grid barriers, the guard
  on the device — and ONE host read of its {steps, result buffer} words.
  Bound: bytes — per step the bucket matrices, the gathered rows of R and
  the active prefix.

``ov_dst`` entries other than padding are distinct (the engine groups the
overlay by destination row). Bits are int32 in torch and uint32 in CUDA.
Both versions return the whole fixpoint bitmap ``int32[n_rows + 1, 1]``.
A run with nothing to iterate (no active rows or no buckets, and no
overlay) returns ``R0`` itself and launches nothing. Launch counts go
into the shared ``COUNTS`` of keto_tpu_torch/check/kernels.py:
``list_fixpoint`` per launch, ``list_fixpoint_overlay`` for the launches
with an overlay pending and ``list_iters`` for the steps they ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.kernels import COUNTS, _check, _gather_or, _lib, _need, _on_cpu, _stream


def _idle(bucket_nbrs, n_active: int, ov_nbrs) -> bool:
    return (n_active == 0 or not bucket_nbrs) and ov_nbrs is None


def list_step_ref(
    bucket_nbrs: Sequence[torch.Tensor],
    R0: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    n_active: int,
    valid_rows: Sequence[int],
    it_cap: int,
    block_iters: int = 8,
) -> torch.Tensor:
    """The reference list step in plain PyTorch → int32[n_rows + 1, 1]."""
    if _idle(bucket_nbrs, n_active, ov_nbrs):
        return R0
    R = R0.clone()
    changed, it = True, 0
    while changed and it < it_cap:
        for _ in range(block_iters):
            if not changed:  # a guarded step after convergence is a no-op
                break
            Rn = R.clone()
            if bucket_nbrs and n_active:
                Rn[:n_active] |= kernels.pull_ref(bucket_nbrs, valid_rows, R)
            if ov_nbrs is not None:
                ovo = _gather_or(Rn, ov_nbrs)  # from the committed Rn
                keep = (ov_dst >= 0) & (ov_dst < Rn.shape[0])
                d = ov_dst[keep].long()
                Rn[d] |= ovo[keep]
            changed = bool((Rn != R).any())
            R = Rn
            it += 1
    return R


#: the kernel's bucket table holds at most this many degree buckets
MAX_BUCKETS = 32


def list_step_cuda(
    bucket_nbrs: Sequence[torch.Tensor],
    R0: torch.Tensor,
    ov_nbrs: Optional[torch.Tensor] = None,
    ov_dst: Optional[torch.Tensor] = None,
    *,
    n_active: int,
    valid_rows: Sequence[int],
    it_cap: int,
    block_iters: int = 8,
) -> torch.Tensor:
    """The list step on the card via one ``keto_list_fixpoint`` launch →
    int32[n_rows + 1, 1] (device tensor)."""
    _need(R0, "R0", 2)
    if R0.shape[1] != 1:
        raise ValueError(f"R0: expected one word per row, got {tuple(R0.shape)}")
    if _idle(bucket_nbrs, n_active, ov_nbrs):
        return R0
    pull = bool(bucket_nbrs) and n_active > 0
    buckets = list(zip(bucket_nbrs, valid_rows)) if pull else []
    if pull and sum(int(n) for n in valid_rows) != n_active:
        raise ValueError(f"buckets cover {sum(valid_rows)} rows, n_active is {n_active}")
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"{len(buckets)} degree buckets: the kernel's table holds {MAX_BUCKETS}")
    for nb, n in buckets:
        _need(nb, "bucket nbrs", 2)
        if nb.shape[0] < int(n) or nb.numel() >= 2**31:
            raise ValueError(f"bucket nbrs {tuple(nb.shape)} for {n} valid rows")
    if R0.shape[0] >= 2**31:
        raise ValueError(f"R0: {R0.shape[0]} rows past the kernel's 32-bit index")
    K = 0
    if ov_nbrs is not None:
        _need(ov_nbrs, "ov_nbrs", 2)
        _need(ov_dst, "ov_dst", 1)
        if ov_dst.numel() != ov_nbrs.shape[0]:
            raise ValueError("ov_dst must name one destination row per ov_nbrs row")
        K = ov_nbrs.shape[0]
        if K and ov_nbrs.numel() >= 2**31:
            raise ValueError(f"ov_nbrs {tuple(ov_nbrs.shape)} past the kernel's 32-bit index")
    state = fixpoint_state(R0, pull, K)
    COUNTS["list_fixpoint"] += 1
    if K:
        COUNTS["list_fixpoint_overlay"] += 1
    _check(fixpoint_launch(_lib(), buckets, state, ov_nbrs if K else None, ov_dst, it_cap,
                           block_iters, _stream()), "keto_list_fixpoint")
    Ra, Rb, _, ctl = state
    _, iters, in_b, _ = ctl.tolist()
    COUNTS["list_iters"] += iters
    return Rb if in_b else Ra


def fixpoint_state(R0: torch.Tensor, pull: bool, K: int) -> tuple:
    """One run's device buffers: the two bitmaps (copies of ``R0``; one
    buffer without the pull), the overlay's gathered words and the int32
    control words (zeroed). ``(Ra, Rb, ovo, ctl)``."""
    Ra = R0.clone()
    Rb = R0.clone() if pull else Ra
    ovo = torch.empty(max(K, 1), dtype=torch.int32, device=R0.device)
    # {last changed step + 1, steps, result in Rb, changed at exit}
    ctl = torch.zeros(4, dtype=torch.int32, device=R0.device)
    return Ra, Rb, ovo, ctl


def fixpoint_launch(lib, buckets, state: tuple, ov_nbrs, ov_dst, it_cap: int, block_iters: int,
                    stream: int) -> int:
    """``keto_list_fixpoint`` on ``fixpoint_state``'s buffers over
    ``buckets`` (``[(nbrs, valid rows)]``, empty without the pull); returns
    its error code (the bare launch ``list_step_cuda`` checks, counts and
    reads)."""
    Ra, Rb, ovo, ctl = state
    K, C = (0, 0) if ov_nbrs is None else ov_nbrs.shape
    ptrs = (ctypes.c_int64 * MAX_BUCKETS)(*[b.data_ptr() for b, _ in buckets])
    rows = (ctypes.c_int32 * MAX_BUCKETS)(*[int(n) for _, n in buckets])
    caps = (ctypes.c_int32 * MAX_BUCKETS)(*[b.shape[1] for b, _ in buckets])
    return lib.keto_list_fixpoint(
        ptrs, rows, caps, len(buckets), Ra.data_ptr(), Rb.data_ptr(),
        None if not K else ov_nbrs.data_ptr(), K, C, None if not K else ov_dst.data_ptr(),
        ovo.data_ptr(), Ra.shape[0], min(int(it_cap), 2**31 - 1), int(block_iters),
        ctl.data_ptr(), stream)


def list_step(bucket_nbrs, R0: torch.Tensor, ov_nbrs=None, ov_dst=None, **kw) -> torch.Tensor:
    """K5: the plain version for CPU tensors, the kernels for CUDA tensors."""
    if _on_cpu(R0):
        return list_step_ref(bucket_nbrs, R0, ov_nbrs, ov_dst, **kw)
    return list_step_cuda(bucket_nbrs, R0, ov_nbrs, ov_dst, **kw)
