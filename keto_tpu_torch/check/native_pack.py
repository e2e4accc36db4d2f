"""ctypes binding for the native pack walk.

A copy of keto_tpu/check/native_pack.py over the port's own copy of the
C++ (``keto_tpu_torch/native/pack.cpp``, byte for byte the reference's
``native/pack.cpp``), built with g++ at first use by
``keto_tpu_torch._build.host_lib``. ``pack_chunk``'s host walk — frontier
expansion of host-propagated starts through the forward CSR, (query, row)
seen/seed dedup, target-hit grants, and the sink answer gather — runs
here as one GIL-released C++ call, so the resolve and pack of one slice
overlap the device work of the one before instead of fighting the GIL.
The numpy walk in check/pack.py stays the contract (bit-identical
output, held against this one in tests/test_torch_native_pack.py) and
takes the chunks this walk may not.

**Eligibility** (``walk_eligible``): the walk reads ONLY the base
forward/sink CSRs, so any overlay state that would change what
``out_neighbors_bulk``/``sink_in_rows_bulk`` return routes the chunk to
numpy: host out-adjacency (``ov_out``), tombstones (``ov_removed``), or
overlay sink in-edges (``ov_sink_in``). Interior overlay-ELL edges are
device-side and do not affect the host walk, so the common
insert-only-delta serving state keeps the native path.

Unlike the reference, a failed build or load raises, and no environment
variable turns the walk off (``pack_chunk(native=False)`` and the
engine's ``native_pack_enabled=False`` pin numpy for comparisons).
``COUNTERS`` counts which path packed each chunk.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from keto_tpu_torch import _build

#: chunks packed per path since process start ("numpy" counts the chunks
#: ``walk_eligible`` refused and those packed with ``native=False``)
COUNTERS = {"native": 0, "numpy": 0}


def walk_eligible(snap) -> bool:
    """True when the native walk would read exactly what the numpy walk
    reads: base CSRs present, no host-visible overlay adjacency, no
    tombstones, no overlay sink in-edges."""
    return (
        snap.fwd_indptr is not None
        and snap.fwd_indices is not None
        and not snap.ov_out
        and not snap.ov_sink_in
        and (snap.ov_removed is None or snap.ov_removed.size == 0)
    )


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_walk(
    snap, rows: np.ndarray, pq: np.ndarray, tgc: np.ndarray
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Run the frontier walk natively. ``rows``/``pq`` are the initial
    host-propagated (row, query) pairs (int64), ``tgc`` the per-query
    target rows (int64, -1 = none). Returns ``(seed_rows, seed_q,
    host_hits)``: the globally (query, row)-deduplicated device seeds in
    first-occurrence order and the host-decided grants (None when there
    are none), bit-identical to the numpy walk by contract."""
    lib = _build.host_lib()
    indptr = np.ascontiguousarray(snap.fwd_indptr, np.int64)
    indices = np.ascontiguousarray(snap.fwd_indices, np.int32)
    rows = np.ascontiguousarray(rows, np.int64)
    pq = np.ascontiguousarray(pq, np.int64)
    tgc = np.ascontiguousarray(tgc, np.int64)
    nq = tgc.shape[0]
    h = lib.keto_pack_walk(
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        snap.n_base_nodes,
        snap.num_int,
        snap.sink_base,
        _ptr(rows, ctypes.c_int64),
        _ptr(pq, ctypes.c_int64),
        rows.shape[0],
        _ptr(tgc, ctypes.c_int64),
        nq,
        0,
    )
    try:
        n = lib.keto_pack_n_seeds(h)
        seed_rows = np.empty(n, np.int64)
        seed_q = np.empty(n, np.int64)
        hits = np.zeros(nq, np.uint8)
        lib.keto_pack_fetch(
            h,
            _ptr(seed_rows, ctypes.c_int64),
            _ptr(seed_q, ctypes.c_int64),
            _ptr(hits, ctypes.c_uint8),
        )
    finally:
        lib.keto_pack_free(h)
    return seed_rows, seed_q, (hits.view(bool) if hits.any() else None)


def sink_gather(snap, sinks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Native twin of the overlay-free arm of ``sink_in_rows_bulk``:
    ``(concatenated interior in-neighbor rows, per-target counts)`` for
    sink-class device ids ``sinks``."""
    lib = _build.host_lib()
    indptr = np.ascontiguousarray(snap.sink_indptr, np.int64)
    indices = np.ascontiguousarray(snap.sink_indices, np.int32)
    local = np.ascontiguousarray(np.asarray(sinks, np.int64) - snap.sink_base)
    n = local.shape[0]
    h = lib.keto_sink_gather(
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(local, ctypes.c_int64),
        n,
    )
    try:
        total = lib.keto_gather_n(h)
        rows = np.empty(total, np.int32)
        cnts = np.empty(n, np.int64)
        lib.keto_gather_fetch(h, _ptr(rows, ctypes.c_int32), _ptr(cnts, ctypes.c_int64))
    finally:
        lib.keto_gather_free(h)
    return rows, cnts
