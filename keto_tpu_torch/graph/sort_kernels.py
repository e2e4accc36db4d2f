"""The snapshot build's stable argsort (K8) as a plain PyTorch version and
a hand-written CUDA kernel.

Source notes:

- ``radix_argsort`` replaces ``_sort_fn(n).many``
  (keto_tpu/graph/device_build.py:54, ``jnp.argsort(k, stable=True)`` per
  key array at :66): the stable argsort of an int32 key array, equal to
  ``np.argsort(kind="stable")``. CUDA: ``keto_radix_hist``,
  ``keto_radix_scan`` and ``keto_radix_scatter`` in csrc/sort_kernels.cu,
  a least-significant-digit radix sort of (key, index) pairs, 8-bit digits
  over 4 passes, the sign bit flipped so negative keys order first; per
  pass a digit histogram per tile, an exclusive scan of the histograms in
  digit-major order and a stable scatter that ranks keys inside each tile
  by warp order and ``__match_any_sync`` peers. Bound: bytes — 20 bytes per
  key per pass (the histogram's key read; the scatter's key and index reads
  and writes), 80 per key for the sort.
- ``radix_argsort_ref`` runs the same passes in tensor code: the per-tile
  digit histogram, its exclusive scan in digit-major order, and the stable
  scatter (a key's slot is its digit's start in its tile plus the number of
  earlier keys of the tile with the same digit). The CPU tests hold it
  against numpy and the JAX sorter, so the algorithm itself — digit order,
  sign bias, stability — is tested, not only the contract.

Both return the permutation as an int32 tensor on the keys' device. The
dispatcher takes the plain version for a CPU tensor and the kernel for a
CUDA tensor. Launch counts go into the shared ``COUNTS`` of
keto_tpu_torch/check/kernels.py (``radix_sort`` counts whole sorts).
"""

from __future__ import annotations

import torch

from keto_tpu_torch.check.kernels import COUNTS, _check, _lib, _need, _on_cpu, _stream

#: keys per tile (csrc/sort_kernels.cu kTile: 256 threads x 16 keys)
TILE = 4096
DIGIT_BITS = 8
PASSES = 4
DIGITS = 1 << DIGIT_BITS


def _digits(keys: torch.Tensor, p: int) -> torch.Tensor:
    """int64 digit ``p`` of every key read as uint32 with its sign bit
    flipped (``key ^ 0x80000000``, which is ``key + 2**31`` for int32)."""
    u = keys.to(torch.int64) + (1 << 31)
    return (u >> (DIGIT_BITS * p)) & (DIGITS - 1)


def radix_argsort_ref(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of int32 ``keys`` → int32 permutation, by the kernel's
    passes in plain PyTorch."""
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError(f"keys: expected int32 [n], got {keys.dtype} {tuple(keys.shape)}")
    n = keys.numel()
    dev = keys.device
    k = keys
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if n == 0:
        return idx
    n_tiles = -(-n // TILE)
    tile_of = torch.arange(n, device=dev) // TILE
    for p in range(PASSES):
        d = _digits(k, p)
        # per-tile digit counts, digit-major: hist[d * n_tiles + tile]
        cell = d * n_tiles + tile_of
        hist = torch.bincount(cell, minlength=DIGITS * n_tiles)
        start = torch.cumsum(hist, 0) - hist  # exclusive, digit-major
        # rank inside the tile among equal digits: the running count of the
        # digit minus its count before the tile
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        for v in torch.unique(d).tolist():
            m = d == v
            run = torch.cumsum(m.to(torch.int64), 0) - 1
            before_tile = start[v * n_tiles + tile_of[m]] - start[v * n_tiles]
            rank[m] = run[m] - before_tile
        pos = start[cell] + rank
        k2 = torch.empty_like(k)
        i2 = torch.empty_like(idx)
        k2[pos] = k
        i2[pos] = idx
        k, idx = k2, i2
    return idx


def radix_argsort_cuda(keys: torch.Tensor) -> torch.Tensor:
    """K8 on the card: 4 passes of ``keto_radix_hist``, ``keto_radix_scan``
    and ``keto_radix_scatter`` on the current stream (not synchronised).
    Scratch: two ping-pong (key, index) buffers and the histograms."""
    _need(keys, "keys", 1)
    n = keys.numel()
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    lib, stream = _lib(), _stream()
    if lib.keto_radix_tile() != TILE:
        raise RuntimeError("csrc/sort_kernels.cu and sort_kernels.TILE disagree on the tile")
    n_tiles = -(-n // TILE)
    hist = torch.empty(DIGITS * n_tiles, dtype=torch.int32, device=keys.device)
    totals = torch.empty(DIGITS, dtype=torch.int32, device=keys.device)
    # ping-pong buffers: pass p writes buffer p % 2, so the last (odd) pass
    # lands in `out`; the first pass reads the caller's keys and the identity
    kbuf = (torch.empty_like(keys), torch.empty_like(keys))
    ibuf = (torch.empty_like(out), out)
    src_k, src_i = keys, None
    COUNTS["radix_sort"] += 1
    for p in range(PASSES):
        dst_k, dst_i = kbuf[p % 2], ibuf[p % 2]
        shift = DIGIT_BITS * p
        COUNTS["radix_hist"] += 1
        _check(lib.keto_radix_hist(src_k.data_ptr(), n, shift, hist.data_ptr(), stream),
               "keto_radix_hist")
        COUNTS["radix_scan"] += 1
        _check(lib.keto_radix_scan(hist.data_ptr(), n, totals.data_ptr(), stream),
               "keto_radix_scan")
        COUNTS["radix_scatter"] += 1
        _check(lib.keto_radix_scatter(src_k.data_ptr(),
                                      None if src_i is None else src_i.data_ptr(), n, shift,
                                      hist.data_ptr(), totals.data_ptr(), dst_k.data_ptr(),
                                      dst_i.data_ptr(), stream), "keto_radix_scatter")
        src_k, src_i = dst_k, dst_i
    return out


def radix_argsort(keys: torch.Tensor) -> torch.Tensor:
    """K8: the plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if _on_cpu(keys):
        return radix_argsort_ref(keys)
    return radix_argsort_cuda(keys)
