"""The snapshot build's stable argsort (K8) as a plain PyTorch version and
a hand-written CUDA kernel.

Source notes:

- ``radix_argsort`` replaces ``_sort_fn(n).many``
  (keto_tpu/graph/device_build.py:54, ``jnp.argsort(k, stable=True)`` per
  key array at :66): the stable argsort of an int32 key array, equal to
  ``np.argsort(kind="stable")``. CUDA: ``keto_radix_hist`` and
  ``keto_radix_pass`` in csrc/sort_kernels.cu, a least-significant-digit
  radix sort of (key, index) pairs, 8-bit digits, the sign bit flipped so
  negative keys order first. One histogram launch reads every key once for
  all four digit histograms; ``radix_pass_plan`` skips every pass whose
  digit is the same for every key (a stable pass over a constant digit is
  the identity); each pass that runs is one launch in the onesweep pattern:
  a tile ranks its keys stably in shared memory (warp order and
  ``__match_any_sync`` peers), finds its output slots by a decoupled
  look-back over the earlier tiles' digit counts, and writes the ranked
  pairs out of shared memory in digit order. Bound: bytes — the
  histogram's 4 per key; per pass the key read, the index read (not on the
  first pass run), the index write and the key write (not on the last);
  ``kernel_bytes`` counts them.
- ``radix_argsort_ref`` runs the same passes in tensor code: the global
  digit histograms, the same pass plan, and per pass the stable scatter (a
  key's slot is its digit's global start, plus the digit's counts in the
  earlier tiles — the numbers the look-back yields — plus the number of
  earlier keys of its tile with the same digit). The CPU tests hold it
  against numpy and the JAX sorter, so the algorithm itself — digit order,
  sign bias, stability, the skipped passes — is tested, not only the
  contract.

Both return the permutation as an int32 tensor on the keys' device. The
dispatchers take the plain version for a CPU tensor and the kernel for a
CUDA tensor. Launch counts go into the shared ``COUNTS`` of
keto_tpu_torch/check/kernels.py (``radix_hist`` and ``radix_pass``
launches; ``radix_pass_skipped`` passes the plan left out; ``radix_sort``
counts whole sorts).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from keto_tpu_torch.check.kernels import COUNTS, _check, _lib, _need, _on_cpu, _stream

#: keys per tile (csrc/sort_kernels.cu kTile: 256 threads x 16 keys)
TILE = 4096
DIGIT_BITS = 8
PASSES = 4
DIGITS = 1 << DIGIT_BITS
#: the status words pack a 30-bit count beside their flag
MAX_KEYS = 1 << 30


def _digits(keys: torch.Tensor, p: int) -> torch.Tensor:
    """int64 digit ``p`` of every key read as uint32 with its sign bit
    flipped (``key ^ 0x80000000``, which is ``key + 2**31`` for int32)."""
    u = keys.to(torch.int64) + (1 << 31)
    return (u >> (DIGIT_BITS * p)) & (DIGITS - 1)


def radix_hist_ref(keys: torch.Tensor) -> torch.Tensor:
    """int64 ``[PASSES, DIGITS]``: how many keys hold each digit in each
    pass, what ``keto_radix_hist`` adds up."""
    return torch.stack([torch.bincount(_digits(keys, p), minlength=DIGITS) for p in range(PASSES)])


def radix_pass_plan(hist) -> list:
    """The passes a stable LSD sort must run, from the ``[PASSES, DIGITS]``
    digit histograms: those with more than one non-zero digit. A pass whose
    digit is constant is the identity, so skipping it is exact."""
    h = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    digits_seen = np.count_nonzero(h.reshape(PASSES, DIGITS), axis=1)
    return [p for p in range(PASSES) if digits_seen[p] > 1]


def kernel_bytes(n: int, passes: int) -> int:
    """Bytes the kernels move to sort ``n`` keys in ``passes`` passes: the
    histogram's key read, then per pass 16 bytes a key less the first
    pass's index read and the last pass's key write."""
    return n * (4 + 16 * passes - (8 if passes else 0))


def radix_argsort_ref(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of int32 ``keys`` → int32 permutation, by the kernel's
    passes in plain PyTorch."""
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError(f"keys: expected int32 [n], got {keys.dtype} {tuple(keys.shape)}")
    n = keys.numel()
    dev = keys.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if n == 0:
        return idx
    hist = radix_hist_ref(keys)
    n_tiles = -(-n // TILE)
    tile_of = torch.arange(n, device=dev) // TILE
    k = keys
    for p in radix_pass_plan(hist):
        d = _digits(k, p)
        # per-tile digit counts [n_tiles, DIGITS]; the digit's global start
        # plus its counts in the earlier tiles: what the look-back yields
        count = torch.bincount(tile_of * DIGITS + d, minlength=n_tiles * DIGITS)
        count = count.view(n_tiles, DIGITS)
        earlier = torch.cumsum(count, 0) - count
        base = (torch.cumsum(hist[p], 0) - hist[p])[None, :] + earlier
        # rank inside the tile among equal digits: the digit's running count
        # minus its count in the earlier tiles
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        for v in torch.unique(d).tolist():
            m = d == v
            run = torch.cumsum(m.to(torch.int64), 0) - 1
            rank[m] = run[m] - earlier[tile_of[m], v]
        pos = base[tile_of, d] + rank
        k2 = torch.empty_like(k)
        i2 = torch.empty_like(idx)
        k2[pos] = k
        i2[pos] = idx
        k, idx = k2, i2
    return idx


class _Scratch:
    """One sort's buffers on the card, allocated before the plan is known:
    the permutation, the ping-pong (key, index) buffers of up to four
    passes, every pass's status words and tile counter (zeroed), and the
    pointers each pass takes, so that nothing but launches waits on the
    plan."""

    def __init__(self, keys: torch.Tensor, hist: torch.Tensor):
        n, dev = keys.numel(), keys.device
        self.n = n
        self.out = torch.empty(n, dtype=torch.int32, device=dev)
        self._bufs = (torch.empty_like(self.out), torch.empty_like(keys), torch.empty_like(keys))
        words = -(-n // TILE) * DIGITS
        self._flags = torch.zeros(PASSES * (words + 1), dtype=torch.int32, device=dev)
        flags = self._flags.data_ptr()
        self.keys = keys.data_ptr()
        self.out_ptr = self.out.data_ptr()
        self.tmp_idx = self._bufs[0].data_ptr()
        self.tmp_keys = (self._bufs[1].data_ptr(), self._bufs[2].data_ptr())
        self.status = [flags + 4 * words * j for j in range(PASSES)]
        self.counters = [flags + 4 * (PASSES * words + j) for j in range(PASSES)]
        self.hist = [hist.data_ptr() + 4 * DIGITS * p for p in range(PASSES)]


def _passes_cuda(lib, stream, sc: _Scratch, plan: list) -> torch.Tensor:
    """Enqueue ``keto_radix_pass`` for every pass of ``plan``."""
    COUNTS["radix_sort"] += 1
    COUNTS["radix_pass_skipped"] += PASSES - len(plan)
    if not plan:
        return torch.arange(sc.n, dtype=torch.int32, device=sc.out.device, out=sc.out)
    m = len(plan)
    # ping-pong: the index lands in `out` on the last pass, whatever m is;
    # the first pass reads the identity, the last writes no keys
    src_k, src_i = sc.keys, None
    for j, p in enumerate(plan):
        dst_i = sc.out_ptr if (m - 1 - j) % 2 == 0 else sc.tmp_idx
        dst_k = None if j == m - 1 else sc.tmp_keys[j % 2]
        COUNTS["radix_pass"] += 1
        _check(lib.keto_radix_pass(src_k, src_i, sc.n, DIGIT_BITS * p, sc.hist[p], sc.status[j],
                                   sc.counters[j], dst_k, dst_i, stream), "keto_radix_pass")
        src_k, src_i = dst_k, dst_i
    return sc.out


def radix_argsort_many_cuda(arrays: Sequence[torch.Tensor]) -> list:
    """K8 on the card for a batch of key arrays: every array's
    ``keto_radix_hist`` and scratch first, the histograms copied back in one
    synchronisation, then every array's passes on the current stream (not
    synchronised)."""
    for keys in arrays:
        _need(keys, "keys", 1)
        if keys.numel() >= MAX_KEYS:
            raise ValueError(f"keys: {keys.numel()} keys, the kernel sorts fewer than {MAX_KEYS}")
    if not arrays:
        return []
    lib, stream = _lib(), _stream()
    if lib.keto_radix_tile() != TILE:
        raise RuntimeError("csrc/sort_kernels.cu and sort_kernels.TILE disagree on the tile")
    hist = torch.zeros((len(arrays), PASSES, DIGITS), dtype=torch.int32, device=arrays[0].device)
    for keys, h in zip(arrays, hist):
        if keys.numel():
            COUNTS["radix_hist"] += 1
            _check(lib.keto_radix_hist(keys.data_ptr(), keys.numel(), h.data_ptr(), stream),
                   "keto_radix_hist")
    scratch = [_Scratch(keys, h) if keys.numel() else None for keys, h in zip(arrays, hist)]
    host = torch.empty(hist.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(hist, non_blocking=True)
    torch.cuda.current_stream(hist.device).synchronize()
    return [torch.empty(0, dtype=torch.int32, device=keys.device) if sc is None
            else _passes_cuda(lib, stream, sc, radix_pass_plan(hp))
            for keys, hp, sc in zip(arrays, host.numpy(), scratch)]


def radix_argsort_cuda(keys: torch.Tensor) -> torch.Tensor:
    """K8 on the card for one key array (``radix_argsort_many_cuda``)."""
    return radix_argsort_many_cuda([keys])[0]


def radix_argsort(keys: torch.Tensor) -> torch.Tensor:
    """K8: the plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if _on_cpu(keys):
        return radix_argsort_ref(keys)
    return radix_argsort_cuda(keys)


def radix_argsort_many(arrays: Sequence[torch.Tensor]) -> list:
    """K8 over a batch: ``radix_argsort`` per array on the CPU, one batch of
    launches with one synchronisation on the card."""
    if all(_on_cpu(k) for k in arrays):
        return [radix_argsort(k) for k in arrays]
    return radix_argsort_many_cuda(arrays)
