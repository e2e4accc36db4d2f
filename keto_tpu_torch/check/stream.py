"""The streaming check pipeline's scheduler and entry staging.

Copies of two pieces of keto_tpu/check/tpu_engine.py, their logic unchanged:

- ``StreamSliceController`` (tpu_engine.py:810-1043): the service-time-aware
  slice scheduler — the width ladder (``32·_WORD_WIDTHS``), the per-route
  cost model fit from each landed slice's ``(width, route, bfs_steps,
  entries, service_ms)``, ``cap()`` (the next slice's width),
  ``entry_budget()`` (the pre-dispatch split bound ``_dispatch_slices``
  applies) and the tail guard.
- ``_StagingPool`` (tpu_engine.py:460-556): reusable int32 host buffers for
  a slice's packed entry arrays, keyed by exact element count and handed
  out on lease. Here a buffer is a host tensor, pinned
  (``pin_memory=True``) when the engine runs on ``cuda``, so the entries go
  to the card by a ``non_blocking`` copy; plain on the CPU. A lease is
  released only once the slice that shipped it has landed (or its stream
  is abandoned): re-leasing it earlier would let the next slice's entries
  overwrite a copy still in flight, with no error anywhere.

The pool reports its byte total through ``on_change`` and can be dropped
whole (``drop()``): the device-memory governor's ``staging`` rung
(keto_tpu_torch/driver/hbm.py) does that first on its ladder, as the
reference's does. Its bytes are pinned host memory, so the governor keeps
them apart from the card's budget. ``acquire(plan=)`` returns None when
``plan`` refuses a new buffer; the engine then ships that slice from a
plain per-slice host tensor.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

import torch

from keto_tpu_torch.check.pack import _WORD_WIDTHS


class StreamSliceController:
    """Service-time-aware slice scheduler for the streaming pipeline.

    The memory-derived ``_slice_cap`` optimizes pure throughput — the
    widest bitmap the workspace budget allows. A slice's service time is
    route-shaped: label slices finish fast while a BFS slice of the same
    width pays tens of hops, so one reactive width shared by all routes
    lets an occasional deep slice blow the p99/p50 spread. The controller
    keeps a **predicted-service-time model** fit online from the
    per-slice ``(width, route, bfs_steps, entries, service_ms)`` the
    stream records, and schedules with it three ways:

    - **width planning** (``cap()``): the widest ladder width
      (``32·_WORD_WIDTHS``) whose PREDICTED service time stays at or below
      ``target_ms``, pessimistic over the routes seen recently — one slow
      BFS observation narrows the next slices at once. The reactive
      narrow-fast / re-widen-slow ladder walk stays underneath as a safety
      net for cost regimes the model has not seen;
    - **pre-dispatch splitting** (``entry_budget()``): the model's
      ms-per-device-entry estimate turns ``target_ms`` into a device entry
      budget, and ``_dispatch_slices`` splits a predicted-slow chunk
      (wildcard fan-out, deep host walks) into sub-slices BEFORE dispatch,
      so the ready-order window interleaves them with fast slices;
    - **tail guard**: the observed p99/p50 ratio of recent slices is
      checked against ``tail_ratio`` and a multiplicative guard scales
      both the planned width and the entry budget down while the tail is
      blown, recovering gradually.

    ``floor`` bounds narrowing so a latency spike cannot collapse
    throughput.
    """

    #: widen when observed ms < WIDEN_FRAC · target, ``patience`` times in a row
    WIDEN_FRAC = 0.5
    #: narrow when observed ms > NARROW_FRAC · target
    NARROW_FRAC = 1.25
    #: a route binds the pessimistic prediction for this many slices
    #: after it was last observed
    ROUTE_RECENCY = 64
    #: recompute the tail guard every this many observations
    TAIL_EVERY = 32

    def __init__(
        self,
        target_ms: float = 40.0,
        floor: int = 2048,
        patience: int = 2,
        tail_ratio: float = 5.0,
    ):
        self._ladder = [32 * w for w in _WORD_WIDTHS]
        self.target_ms = float(target_ms)
        self.tail_ratio = float(tail_ratio)
        self._lo = next(
            (i for i, c in enumerate(self._ladder) if c >= floor),
            len(self._ladder) - 1,
        )
        self._patience = patience
        self._lock = threading.Lock()
        # start two rungs under the top: wide enough that a fast link is
        # near peak throughput from slice one, narrow enough that the
        # first observations on a slow link land near the target
        self._i = max(self._lo, len(self._ladder) - 3)
        self._good = 0
        self._ewma_ms_per_q: Optional[float] = None
        #: per-route cost model: route → {per_q, per_entry, bfs_steps,
        #: last_seen} (EWMAs; last_seen is a slice counter)
        self._routes: dict[str, dict] = {}
        self._slices = 0
        self._ring: collections.deque = collections.deque(maxlen=256)
        self._guard = 1.0
        self._tail_p50 = 0.0
        self._tail_p99 = 0.0

    def _recent_locked(self):
        horizon = self._slices - self.ROUTE_RECENCY
        return [
            st for st in self._routes.values() if st["last_seen"] >= horizon
        ]

    def _model_cap_locked(self) -> Optional[int]:
        """Widest ladder width whose predicted service time (pessimistic
        per-query cost over recently seen routes, scaled by the tail
        guard) fits the target; None before any observation."""
        recent = self._recent_locked()
        per_q = max((st["per_q"] for st in recent), default=None)
        if per_q is None or per_q <= 0:
            return None
        limit = self.target_ms * self._guard / per_q
        want = self._ladder[self._lo]
        for c in self._ladder:
            if c <= limit:
                want = max(want, c)
        return want

    def cap(self) -> int:
        """Per-slice query cap for the NEXT slice: the reactive ladder
        rung bounded by the model's predicted-service-time width (always
        a compiled ladder width)."""
        with self._lock:
            cap = self._ladder[self._i]
            m = self._model_cap_locked()
            return cap if m is None else max(self._ladder[self._lo], min(cap, m))

    def entry_budget(self) -> Optional[int]:
        """Device entries one sub-chunk may carry before its predicted
        service time overshoots the target — the pre-dispatch split
        bound ``_dispatch_slices`` applies. None before the model has an
        entry-cost estimate."""
        with self._lock:
            recent = self._recent_locked()
            per_e = max(
                (st["per_entry"] for st in recent if st["per_entry"] > 0),
                default=None,
            )
            if per_e is None:
                return None
            return max(256, int(self.target_ms * self._guard / per_e))

    def observe(
        self,
        nq: int,
        ms: float,
        route: str = "bfs",
        bfs_steps: int = 0,
        entries: Optional[int] = None,
    ) -> None:
        """Feed one slice's service time: dispatch→ready when the pipeline
        ran dry, ready→ready interval when saturated. ``route``/
        ``bfs_steps``/``entries`` (from the stream's per-slice info) fit
        the per-route model; plain ``observe(nq, ms)`` still steers the
        reactive ladder alone."""
        if nq <= 0:
            return
        per_q = ms / nq
        with self._lock:
            self._slices += 1
            st = self._routes.get(route)
            if st is None:
                st = {"per_q": per_q, "per_entry": 0.0, "bfs_steps": 0.0,
                      "last_seen": 0, "n": 0}
                self._routes[route] = st
            else:
                # asymmetric EWMA: a slowdown bumps the predicted cost
                # HARD (the very next cap()/entry_budget() narrows —
                # that is the tail control), while a speedup also decays
                # fast so a cleared spike doesn't pin throughput low
                old = st["per_q"]
                st["per_q"] = (
                    0.5 * old + 0.5 * per_q
                    if per_q >= old
                    else 0.3 * old + 0.7 * per_q
                )
            if entries:
                pe = ms / max(1, entries)
                old = st["per_entry"]
                if old <= 0:
                    st["per_entry"] = pe
                else:
                    st["per_entry"] = (
                        0.5 * old + 0.5 * pe
                        if pe >= old
                        else 0.3 * old + 0.7 * pe
                    )
            st["bfs_steps"] = 0.7 * st["bfs_steps"] + 0.3 * float(bfs_steps)
            st["last_seen"] = self._slices
            st["n"] += 1
            self._ring.append(ms)
            if self._slices % self.TAIL_EVERY == 0:
                self._retune_tail_locked()
            e = self._ewma_ms_per_q
            self._ewma_ms_per_q = per_q if e is None else 0.7 * e + 0.3 * per_q
            cap = self._ladder[self._i]
            if ms > self.NARROW_FRAC * self.target_ms:
                want = self._lo
                for k in range(self._i, self._lo - 1, -1):
                    if self._ladder[k] * per_q <= self.target_ms:
                        want = k
                        break
                self._i = min(self._i, max(self._lo, want))
                self._good = 0
            elif ms < self.WIDEN_FRAC * self.target_ms and nq >= cap:
                self._good += 1
                if self._good >= self._patience and self._i + 1 < len(self._ladder):
                    self._i += 1
                    self._good = 0
            else:
                self._good = 0

    def _retune_tail_locked(self) -> None:
        vals = sorted(self._ring)
        if len(vals) < 8:
            return
        self._tail_p50 = vals[len(vals) // 2]
        self._tail_p99 = vals[min(len(vals) - 1, int(len(vals) * 0.99))]
        blown = (
            self._tail_p50 > 0
            and self._tail_p99 > self.tail_ratio * self._tail_p50
            and self._tail_p99 > self.target_ms
        )
        if blown:
            self._guard = max(0.25, self._guard * 0.5)
        else:
            self._guard = min(1.0, self._guard * 1.1)

    def snapshot(self) -> dict:
        """Controller state for introspection."""
        with self._lock:
            return {
                "cap": self._ladder[self._i],
                "target_ms": self.target_ms,
                "ewma_ms_per_query": self._ewma_ms_per_q,
                "model_cap": self._model_cap_locked(),
                "tail_ratio": self.tail_ratio,
                "tail_guard": self._guard,
                "tail_p50_ms": round(self._tail_p50, 3),
                "tail_p99_ms": round(self._tail_p99, 3),
                "routes": {
                    r: {
                        "per_q_ms": round(st["per_q"], 6),
                        "per_entry_ms": round(st["per_entry"], 6),
                        "bfs_steps": round(st["bfs_steps"], 2),
                        "slices": st["n"],
                    }
                    for r, st in self._routes.items()
                },
            }


class _StagingPool:
    """Reusable int32 host staging buffers for the packed entry arrays,
    keyed by exact element count (entry geometries are pow2-padded, so a
    serving process sees a handful of distinct sizes per width rung).

    ``acquire`` hands a buffer out ON LEASE; the engine ``release``s it
    only after the slice that shipped it has LANDED (its output fetched):
    the H2D copy from a pinned buffer runs asynchronously, and on the CPU
    the kernel's input IS the buffer, so writing the next slice's entries
    into it any earlier could corrupt an in-flight slice.
    tests/test_torch_stream.py fuzzes that contract.

    ``on_change(bytes)`` receives the pool's byte total (free + leased)
    whenever it moves, always outside the pool's lock; ``drop()`` forgets
    every buffer, and a lease handed out before it is not taken back in
    on release."""

    #: free buffers kept per distinct size
    MAX_FREE_PER_SIZE = 8

    def __init__(self, pin: bool = False, on_change: Optional[Callable[[int], None]] = None):
        self._pin = bool(pin)
        self._on_change = on_change
        self._lock = threading.Lock()  # guards: _free, _bytes, _leased, _owned
        self._free: dict[int, list] = {}
        self._bytes = 0  # free + leased
        self._leased = 0
        self._owned: set = set()  # data pointers of the buffers this pool made

    def _notify(self, nbytes: int) -> None:
        # outside self._lock: the callback takes the governor's lock, and
        # the governor's staging rung calls drop() while holding it
        cb = self._on_change
        if cb is not None:
            cb(nbytes)

    def acquire(self, n: int, plan: Optional[Callable[[int], bool]] = None):
        """An int32 host tensor of exactly ``n`` elements, leased; None when
        a new buffer would be needed and ``plan`` (bytes -> bool) refuses
        it."""
        with self._lock:
            free = self._free.get(n)
            if free:
                self._leased += 1
                return free.pop()
        if plan is not None and not plan(4 * n):
            return None
        buf = torch.empty(n, dtype=torch.int32, pin_memory=self._pin)
        with self._lock:
            self._owned.add(buf.data_ptr())
            self._bytes += 4 * n
            self._leased += 1
            total = self._bytes
        self._notify(total)
        return buf

    def release(self, buf: torch.Tensor) -> None:
        total = None
        with self._lock:
            if buf.data_ptr() not in self._owned:
                return  # leased before a drop(): the pool no longer holds it
            self._leased = max(0, self._leased - 1)
            free = self._free.setdefault(buf.shape[0], [])
            if len(free) < self.MAX_FREE_PER_SIZE:
                free.append(buf)
            else:
                self._owned.discard(buf.data_ptr())
                self._bytes = max(0, self._bytes - 4 * buf.shape[0])
                total = self._bytes
        if total is not None:
            self._notify(total)

    def drop(self) -> int:
        """Evict: forget every buffer, free and leased (outstanding leases
        are not taken back). Returns the bytes the pool held."""
        with self._lock:
            freed = self._bytes
            self._free.clear()
            self._owned.clear()
            self._bytes = 0
            self._leased = 0
        self._notify(0)
        return freed

    def snapshot(self) -> dict:
        """Bytes held (free and leased), leased and free buffer counts."""
        with self._lock:
            return {
                "bytes": self._bytes,
                "leased": self._leased,
                "free_buffers": sum(len(v) for v in self._free.values()),
                "sizes": sorted(self._free),
                "pinned": self._pin,
            }
