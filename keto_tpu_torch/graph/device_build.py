"""Device-side snapshot construction: the build's stable sorts on the card.

A copy of keto_tpu/graph/device_build.py:1-196, :198-212
(``shard_row_ranges``) and :215-221. Building a 10M-tuple snapshot runs
several O(E log E) host sorts over edge-scale arrays: the device-id
renumbering, the ELL edge grouping, the forward CSR, the sink reverse
CSR, the transposed CSR and both reverse-query list layouts
(keto_tpu_torch/graph/snapshot.py). They all go through one **sorter
seam**:

- ``HostSorter`` — ``np.argsort(kind="stable")``, the bit-exactness oracle;
- ``DeviceSorter`` — the same stable argsort as K8, the hand-written radix
  sort of keto_tpu_torch/graph/sort_kernels.py (its plain version for a CPU
  device), one batch of sorts per call on the current stream.

**Bit-identity is the contract.** Every key the build sorts is integral and
fits int32, and a stable sort of integer keys is unique, so the device's
permutation equals the host's; the tests hold every derived snapshot array
byte for byte against the host build and the JAX package's.

``GovernedSorter`` is the engine's policy (keto_tpu/graph/device_build.py:
143-193): an argsort batch whose largest array is below ``min_size`` sorts
on the host (a host dispatch), anything larger on the device, its
transient (``16 · size`` bytes an array) planned against the engine's
device-memory governor with ``evict=False`` and registered under the
``build`` tag for the dispatch. A refused plan sorts on the host and
counts ``device_build_skipped`` (the permutations are equal: a build never
pushes serving state off the card). A failed device sort raises to the
caller and counts ``device_build_errors``: the reference's quiet host retry
of a failed sort is not ported. ``estimate_sort_bytes`` sizes a full
build's sort transient for the engine's ``build_info``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from keto_tpu_torch.graph import sort_kernels

#: device builds below this edge count are not worth the dispatch and
#: transfer; the gate compares the largest array of a batch
DEFAULT_MIN_EDGES = 65536


class HostSorter:
    """The numpy stable-argsort backend."""

    def argsort(self, keys: np.ndarray) -> np.ndarray:
        return np.argsort(keys, kind="stable").astype(np.int64, copy=False)

    def argsort_many(self, arrays: Sequence[np.ndarray]) -> list:
        return [self.argsort(a) for a in arrays]


class DeviceSorter:
    """Stable argsorts on ``device`` through K8.

    Keys are downcast to int32 before upload: every build key fits int32 by
    construction, and sorting the int32 copies gives the identical
    permutation. A key outside int32 raises ``OverflowError`` instead of
    corrupting."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)

    @staticmethod
    def _prep(keys: np.ndarray) -> np.ndarray:
        a = np.asarray(keys)
        if a.dtype != np.int32:
            if a.size and (int(a.min()) < -(2**31) or int(a.max()) >= 2**31):
                raise OverflowError("build sort key outside int32 range")
            a = a.astype(np.int32)
        return np.ascontiguousarray(a)

    def argsort(self, keys: np.ndarray) -> np.ndarray:
        return self.argsort_many([keys])[0]

    def argsort_many(self, arrays: Sequence[np.ndarray]) -> list:
        """One K8 sort per array as one batch (on the card: every array's
        histogram, one synchronisation for the pass plans, then every
        array's passes, all before the first copy back); int64 numpy
        permutations."""
        keys = [torch.from_numpy(self._prep(a)).to(self.device) for a in arrays]
        perms = sort_kernels.radix_argsort_many(keys)
        return [p.cpu().numpy().astype(np.int64) for p in perms]


_HOST = HostSorter()


def host_sorter() -> HostSorter:
    return _HOST


def estimate_sort_bytes(n_nodes: int, n_edges: int) -> int:
    """Transient device bytes a full build's sorts peak at, as the reference
    sizes them: keys, indices and sorted outputs for the largest concurrent
    batch (3 edge-scale sorts) plus the node-scale renumbering sort."""
    per_edge_sort = 4 * 4  # key in, iota, sorted key, sorted iota
    return 3 * per_edge_sort * max(1, n_edges) + per_edge_sort * max(1, n_nodes)


class GovernedSorter:
    """The engine's build-sort policy: a batch runs on the device when its
    largest array reaches ``min_size`` and ``hbm`` (an ``HbmGovernor``, or
    None) plans its transient without evicting, else on the host.
    ``on_count(name)`` receives ``device_build_dispatches``,
    ``device_build_host_dispatches``, ``device_build_skipped`` and
    ``device_build_errors``. ``seconds`` accumulates the sort time by
    backend (``take_seconds`` reads and clears it)."""

    def __init__(
        self,
        device: Union[str, torch.device],
        *,
        hbm=None,
        min_size: int = DEFAULT_MIN_EDGES,
        on_count: Optional[Callable[[str], None]] = None,
    ):
        self._dev = DeviceSorter(device)
        self._host = host_sorter()
        self._hbm = hbm
        self._min_size = int(min_size)
        self._on_count = on_count
        self._lock = threading.Lock()
        self.seconds = {"device": 0.0, "host": 0.0}

    def _count(self, name: str) -> None:
        if self._on_count is not None:
            self._on_count(name)

    def _add(self, backend: str, dt: float) -> None:
        with self._lock:
            self.seconds[backend] += dt

    def take_seconds(self) -> dict:
        """The sort seconds by backend since the last call; resets them."""
        with self._lock:
            out, self.seconds = self.seconds, {"device": 0.0, "host": 0.0}
        return out

    def argsort(self, keys: np.ndarray) -> np.ndarray:
        return self.argsort_many([keys])[0]

    def argsort_many(self, arrays: Sequence[np.ndarray]) -> list:
        arrays = [np.asarray(a) for a in arrays]
        t0 = time.monotonic()
        if max((a.size for a in arrays), default=0) < self._min_size:
            out = self._host.argsort_many(arrays)
            self._add("host", time.monotonic() - t0)
            self._count("device_build_host_dispatches")
            return out
        gov = self._hbm
        if gov is not None:
            need = sum(16 * a.size for a in arrays)
            if not gov.plan(need, what="device build transient", evict=False):
                # memory pressure: the build yields, serving state stays
                out = self._host.argsort_many(arrays)
                self._add("host", time.monotonic() - t0)
                self._count("device_build_skipped")
                return out
            gov.register("build", need)
        try:
            out = self._dev.argsort_many(arrays)
        except Exception:
            self._count("device_build_errors")
            raise
        finally:
            if gov is not None:
                gov.release("build")
        self._add("device", time.monotonic() - t0)
        self._count("device_build_dispatches")
        return out


def shard_row_ranges(n_rows: int, n_shards: int) -> list:
    """Contiguous ``[lo, hi)`` row ranges assigning ``n_rows`` rows to
    ``n_shards`` equal slabs of ``ceil(n_rows / n_shards)`` rows each (the
    last may be short, or empty). The one shard assignment of the sharded
    serving mode: keto_tpu_torch/parallel/sharded.py partitions the bitmap,
    bucket and label rows with it at upload time, and the sharded label
    build routes its sweep rows with it."""
    n_shards = max(1, int(n_shards))
    rps = -(-max(1, int(n_rows)) // n_shards)  # ceil div; >= 1
    return [
        (min(s * rps, n_rows), min((s + 1) * rps, n_rows))
        for s in range(n_shards)
    ]
