"""The list fixpoint (K5) as a plain PyTorch version and hand-written CUDA
kernels.

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
  pull) would miss. CUDA: ``keto_pull`` (K1) at W = 1 and ``keto_commit``
  (csrc/check_kernels.cu) for the base stage; for the overlay ``keto_pull``
  again, gathering into a separate ``ovo[K]``, and ``keto_list_scatter``
  (csrc/list_kernels.cu); then ``keto_close``; the loop is driven from the host in blocks of
  ``block_iters`` guarded steps with one read of the device guard
  ``{changed, iters, step_changed}`` per block, as K2's. Bound: bytes — per
  step the bucket matrices, the gathered rows of R, and P.

``ov_dst`` entries other than padding are distinct (the engine groups the
overlay by destination row). Bits are int32 in torch and uint32 in CUDA.
Both versions return the whole fixpoint bitmap ``int32[n_rows + 1, 1]``.
A run with nothing to iterate (no active rows or no buckets, and no
overlay) returns ``R0`` itself and launches nothing. Launch counts go
into the shared ``COUNTS`` of keto_tpu_torch/check/kernels.py:
``list_gather``/``list_scatter`` per launch, ``list_step`` per fixpoint
run that launched kernels and ``list_iters`` for the steps it ran.
"""

from __future__ import annotations

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


def list_gather_cuda(ov_nbrs: torch.Tensor, R: torch.Tensor, ovo: torch.Tensor, state) -> None:
    """``ovo[k] = OR_c R[ov_nbrs[k, c]]`` via ``keto_pull`` (K1) at W = 1
    with no destination rows: row k lands at ``ovo[k]``."""
    K = ov_nbrs.shape[0]
    COUNTS["list_gather"] += 1
    _check(_lib().keto_pull(ov_nbrs.data_ptr(), K, ov_nbrs.shape[1], None, 0, K, R.data_ptr(),
                            ovo.data_ptr(), 1, state.data_ptr(), _stream()), "keto_pull")


def list_scatter_cuda(ov_dst: torch.Tensor, ovo: torch.Tensor, R: torch.Tensor, state) -> None:
    """``R[ov_dst[k]] |= ovo[k]`` (destinations outside R dropped) via
    ``keto_list_scatter``; sets ``state[2]`` when a word grew."""
    COUNTS["list_scatter"] += 1
    _check(_lib().keto_list_scatter(ov_dst.data_ptr(), ov_dst.shape[0], ovo.data_ptr(),
                                    R.data_ptr(), R.shape[0], state.data_ptr(), _stream()),
           "keto_list_scatter")


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
    """The list step on the card → int32[n_rows + 1, 1] (device tensor)."""
    _need(R0, "R0", 2)
    if R0.shape[1] != 1:
        raise ValueError(f"R0: expected one word per row, got {tuple(R0.shape)}")
    if _idle(bucket_nbrs, n_active, ov_nbrs):
        return R0
    pull = bool(bucket_nbrs) and n_active > 0
    if pull and sum(int(n) for n in valid_rows) != n_active:
        raise ValueError(f"buckets cover {sum(valid_rows)} rows, n_active is {n_active}")
    if ov_nbrs is not None:
        _need(ov_nbrs, "ov_nbrs", 2)
        _need(ov_dst, "ov_dst", 1)
        if ov_dst.numel() != ov_nbrs.shape[0]:
            raise ValueError("ov_dst must name one destination row per ov_nbrs row")
        ovo = torch.empty(ov_nbrs.shape[0], dtype=torch.int32, device=R0.device)
    R = R0.clone()
    P = torch.empty((max(n_active, 1), 1), dtype=torch.int32, device=R0.device)
    # {changed, iters, step_changed}
    state = torch.tensor([1, 0, 0], dtype=torch.int32, device=R0.device)
    COUNTS["list_step"] += 1
    changed, iters = True, 0
    while changed and iters < it_cap:
        for _ in range(block_iters):
            if pull:
                kernels.pull_cuda(bucket_nbrs, valid_rows, R, P=P, state=state)
                kernels.commit_cuda(P, R, n_active, state)
            if ov_nbrs is not None:
                list_gather_cuda(ov_nbrs, R, ovo, state)
                list_scatter_cuda(ov_dst, ovo, R, state)
            kernels.close_cuda(state)
        changed, iters = (int(v) for v in state[:2].tolist())
    COUNTS["list_iters"] += iters
    return R


def list_step(bucket_nbrs, R0: torch.Tensor, ov_nbrs=None, ov_dst=None, **kw) -> torch.Tensor:
    """K5: the plain version for CPU tensors, the kernels for CUDA tensors."""
    if _on_cpu(R0):
        return list_step_ref(bucket_nbrs, R0, ov_nbrs, ov_dst, **kw)
    return list_step_cuda(bucket_nbrs, R0, ov_nbrs, ov_dst, **kw)
