"""The state carried across batches: the device-resident snapshot graph.

``device_graph_from_arrays`` takes plain numpy arrays and ints — each degree
bucket's ``nbrs`` matrix and valid-row count ``n``, plus ``num_int``,
``num_active``, ``num_live`` and ``sink_base`` — and places the buckets on
``device``. The engine uploads every snapshot through it; the tests feed it
the arrays of a ``keto_tpu`` snapshot, so both packages run on identical
layouts (``snapshot_arrays`` reads either package's snapshot).

The reverse-query layouts cross the same way: ``list_layout_arrays`` reads
one orientation's ``ListLayout`` of either package into numpy arrays, and
``device_list_from_arrays`` places its bucket matrices on ``device`` (the
list engine's upload; the tests run K5 on the JAX package's own layouts).

Every host array crosses through ``host_tensor``: a snapshot reloaded from
the cache (keto_tpu_torch/graph/snapcache.py) maps its arrays read-only,
and such an array is copied once on the host first, so a CPU tensor never
aliases read-only pages that an in-place update would fault on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence, Union

import numpy as np
import torch


def host_tensor(a, dtype, device, copy: bool = False) -> torch.Tensor:
    """``a`` as a contiguous ``dtype`` tensor on ``device``. A read-only
    array (a cache reload's memory map) is copied on the host first;
    ``copy`` makes the result its own storage on the CPU too."""
    a = np.ascontiguousarray(a, dtype)
    if not a.flags.writeable:
        a, copy = a.copy(), False
    return torch.from_numpy(a).to(device, copy=copy)


@dataclass(frozen=True)
class DeviceGraph:
    """Bucket matrices on the device plus the geometry the kernels need."""

    buckets: tuple  # int32 [n_pad, cap] tensors, contiguous on `device`
    valid_rows: tuple  # int per bucket; the buckets tile [0, num_active)
    num_int: int
    num_active: int
    num_live: int
    sink_base: int
    device: torch.device


def snapshot_arrays(snap: Any) -> tuple[list[np.ndarray], dict]:
    """``(arrays, meta)`` of any snapshot with ``buckets`` (``.nbrs``, ``.n``)
    and the four counts — this package's or keto_tpu's ``GraphSnapshot``."""
    arrays = [np.asarray(b.nbrs) for b in snap.buckets]
    meta = {
        "n": [int(b.n) for b in snap.buckets],
        "num_int": int(snap.num_int),
        "num_active": int(snap.num_active),
        "num_live": int(snap.num_live),
        "sink_base": int(snap.sink_base),
    }
    return arrays, meta


def device_graph_from_arrays(
    arrays: Sequence[np.ndarray], meta: Mapping[str, Any], device: Union[str, torch.device]
) -> DeviceGraph:
    """Upload the bucket matrices (int32, one copy each) and check that
    they tile the active prefix."""
    n = tuple(int(v) for v in meta["n"])
    if len(n) != len(arrays):
        raise ValueError(f"{len(arrays)} bucket matrices but {len(n)} row counts")
    if sum(n) != int(meta["num_active"]):
        raise ValueError(
            f"buckets cover {sum(n)} rows, num_active is {meta['num_active']}"
        )
    dev = torch.device(device)
    buckets = tuple(host_tensor(a, np.int32, dev) for a in arrays)
    return DeviceGraph(
        buckets=buckets,
        valid_rows=n,
        num_int=int(meta["num_int"]),
        num_active=int(meta["num_active"]),
        num_live=int(meta["num_live"]),
        sink_base=int(meta["sink_base"]),
        device=dev,
    )


@dataclass(frozen=True)
class DeviceList:
    """One orientation's list-layout bucket matrices on the device plus the
    geometry the list fixpoint needs."""

    buckets: tuple  # int32 [n_pad, cap] tensors of row indices, sentinel n_rows
    valid_rows: tuple  # int per bucket; the buckets tile [0, n_active)
    n_rows: int
    n_active: int
    device: torch.device


def list_layout_arrays(snap: Any, orient: str) -> tuple[list[np.ndarray], dict]:
    """``(arrays, meta)`` of the ``orient`` ("fwd" or "rev") ``ListLayout``
    of any snapshot — this package's or keto_tpu's: each bucket's ``nbrs``,
    and ``n`` per bucket, ``n_rows``, ``n_active``, ``order``, ``dev2row``."""
    if orient not in ("fwd", "rev"):
        raise ValueError(f"orient must be 'fwd' or 'rev', got {orient!r}")
    lay = snap.lay_fwd if orient == "fwd" else snap.lay_rev
    arrays = [np.asarray(b.nbrs) for b in lay.buckets]
    meta = {
        "n": [int(b.n) for b in lay.buckets],
        "n_rows": int(lay.n_rows),
        "n_active": int(lay.n_active),
        "order": np.asarray(lay.order, np.int64),
        "dev2row": np.asarray(lay.dev2row, np.int64),
    }
    return arrays, meta


def device_list_from_arrays(
    arrays: Sequence[np.ndarray], meta: Mapping[str, Any], device: Union[str, torch.device]
) -> DeviceList:
    """Upload one orientation's bucket matrices (int32, one copy each) and
    check that they tile the active prefix."""
    n = tuple(int(v) for v in meta["n"])
    if len(n) != len(arrays):
        raise ValueError(f"{len(arrays)} bucket matrices but {len(n)} row counts")
    if sum(n) != int(meta["n_active"]):
        raise ValueError(f"buckets cover {sum(n)} rows, n_active is {meta['n_active']}")
    dev = torch.device(device)
    # always a copy, on the CPU too: the list engine patches its upload in
    # place, and the host arrays belong to the snapshot (and its deltas)
    buckets = tuple(host_tensor(a, np.int32, dev, copy=True) for a in arrays)
    return DeviceList(buckets=buckets, valid_rows=n, n_rows=int(meta["n_rows"]),
                      n_active=int(meta["n_active"]), device=dev)
