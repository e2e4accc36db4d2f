"""Per-request timelines: a copy of keto_tpu/x/timeline.py, where one slow
check spent its time.

Every stage a check passes through stamps its ``Timeline``: arrival, the
admission verdict, the lane queue wait (pack), dispatch, each device slice
it rode (width, BFS steps, route, service time; halo rounds and bytes
sharded), land and deliver. A finished timeline is

- kept in a bounded ring plus a top-K-slowest set, read at
  ``GET /debug/requests`` (keto_tpu_torch/servers/rest.py), filterable by
  trace id, snaptoken and tenant;
- summarized into the response's ``Server-Timing`` header, so the caller
  sees the breakdown without a server-side query.

A stamp is one ``perf_counter`` read and one append onto a bounded list (no
lock); the ring and top-K bookkeeping runs once per request at ``finish``,
under one lock. A recorder built with ``enabled=False`` returns ``None``
from ``begin`` and every stamp site is a ``None`` test.

Left out against the reference, with their readers (ROADMAP A6): the
tracer's child spans (``set_tracer``, ``_emit_spans``) and the
``/metrics`` stage histogram (``attach_stage_histogram``, ``_mirror``).
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Iterator, Optional

#: canonical stage names, in pipeline order (attrs ride the device stage:
#: width / bfs_steps / route / service_ms, and halo_rounds / halo_bytes)
STAGES = (
    "arrival",    # request decoded, correlation ids bound (timeline birth)
    "admit",      # passed the admission window / lane-capacity door
    "shed",       # refused at the door instead (terminal with admit)
    "cache_hit",  # answered from the replica check cache (no dispatch)
    "pack",       # taken off its lane into a dispatch round
    "dispatch",   # handed to the engine's streaming pipeline
    "device",     # one device slice landed (repeats per slice; carries attrs)
    "land",       # every tuple of the request has its decision
    "expand",     # expand tree built (host; carries the depth)
    "explain",    # witness reconstructed + verified (carries route/verified)
    "deliver",    # response handed back to the serving layer
)

#: cap on the stamps one timeline holds: a wide batch riding many
#: sub-slices must not grow an unbounded list (the flag records the drop)
MAX_STAMPS = 48

_current_tl: ContextVar[Optional["Timeline"]] = ContextVar(
    "keto_tpu_torch_timeline", default=None
)


def current_timeline() -> Optional["Timeline"]:
    """The timeline bound to the current request context, or None: the
    seam the batcher stamps through without a recorder handle."""
    return _current_tl.get()


class Timeline:
    """One request's stage stamps. ``stamp`` is the hot path: a
    perf_counter read and a list append; attrs allocate only when given."""

    __slots__ = (
        "kind", "surface", "trace_id", "parent_span_id", "request_id",
        "tenant", "status", "snaptoken", "start_unix", "_t0", "stamps",
        "truncated", "total_ms",
    )

    def __init__(
        self,
        kind: str,
        trace_id: str = "",
        request_id: str = "",
        surface: str = "http",
        parent_span_id: str = "",
        tenant: str = "",
    ):
        self.kind = kind
        self.surface = surface
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.request_id = request_id
        self.tenant = tenant
        self.status: Any = None
        self.snaptoken: Optional[str] = None
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        #: [(stage, seconds-since-arrival, attrs-or-None), ...]
        self.stamps: list[tuple[str, float, Optional[dict]]] = []
        self.truncated = False
        self.total_ms: float = 0.0

    def stamp(self, stage: str, **attrs) -> None:
        if len(self.stamps) >= MAX_STAMPS:
            self.truncated = True
            return
        self.stamps.append((stage, time.perf_counter() - self._t0, attrs or None))

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def to_json(self) -> dict:
        """The /debug/requests rendering."""
        return {
            "kind": self.kind,
            "surface": self.surface,
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "tenant": self.tenant,
            "status": self.status,
            "snaptoken": self.snaptoken,
            "start_unix": round(self.start_unix, 6),
            "total_ms": round(self.total_ms, 3),
            "truncated": self.truncated,
            "stages": [
                {
                    "stage": stage,
                    "t_ms": round(t * 1e3, 3),
                    **({"attrs": attrs} if attrs else {}),
                }
                for stage, t, attrs in self.stamps
            ],
        }


class TimelineRecorder:
    """Bounded ring + top-K-slowest of finished request timelines.

    The per-request path (``begin``/``stamp``) takes no lock: a timeline
    belongs to its request until ``finish``, which does the ring, heap and
    counter bookkeeping under one lock, once per request."""

    def __init__(self, capacity: int = 512, top_k: int = 32, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = max(16, int(capacity))
        self.top_k = max(1, int(top_k))
        self._lock = threading.Lock()  # guards: _ring, _slow, _seq, finished_by_surface
        self._ring: deque[Timeline] = deque(maxlen=self.capacity)
        # min-heap of (total_ms, seq, timeline): the root is the FASTEST of
        # the keep-set, evicted when a slower one arrives
        self._slow: list[tuple[float, int, Timeline]] = []
        self._seq = 0
        #: finished timelines per surface
        self.finished_by_surface: dict[str, int] = {}

    # -- request lifecycle ----------------------------------------------------

    def begin(
        self,
        kind: str,
        trace_id: str = "",
        request_id: str = "",
        surface: str = "http",
        tenant: str = "",
        parent_span_id: str = "",
    ) -> Optional[Timeline]:
        """A new timeline with its arrival stamp, or None when disabled."""
        if not self.enabled:
            return None
        tl = Timeline(kind, trace_id=trace_id, request_id=request_id, surface=surface,
                      parent_span_id=parent_span_id, tenant=tenant)
        tl.stamp("arrival")
        return tl

    @contextlib.contextmanager
    def activate(self, tl: Optional[Timeline]) -> Iterator[None]:
        """Bind ``tl`` as the current request timeline for the block (what
        ``current_timeline()`` resolves to)."""
        if tl is None:
            yield
            return
        token = _current_tl.set(tl)
        try:
            yield
        finally:
            _current_tl.reset(token)

    def finish(self, tl: Optional[Timeline], status: Any = None,
               snaptoken: Optional[str] = None) -> None:
        """Seal ``tl``: deliver stamp, ring + top-K insertion. Accepts None
        so call sites stay unconditional."""
        if tl is None:
            return
        tl.stamp("deliver")
        tl.status = status
        tl.snaptoken = str(snaptoken) if snaptoken is not None else None
        tl.total_ms = tl.stamps[-1][1] * 1e3
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._ring.append(tl)
            if len(self._slow) < self.top_k:
                heapq.heappush(self._slow, (tl.total_ms, seq, tl))
            elif tl.total_ms > self._slow[0][0]:
                heapq.heapreplace(self._slow, (tl.total_ms, seq, tl))
            self.finished_by_surface[tl.surface] = self.finished_by_surface.get(tl.surface, 0) + 1

    # -- export ---------------------------------------------------------------

    @staticmethod
    def _segments(tl: Timeline) -> list[tuple[str, float]]:
        """(stage, duration_s) per consecutive stamp pair — the time
        attributed to reaching each stage — with repeated stages (the device
        slices of one batch) summed."""
        out: dict[str, float] = {}
        for i in range(1, len(tl.stamps)):
            stage = tl.stamps[i][0]
            out[stage] = out.get(stage, 0.0) + (tl.stamps[i][1] - tl.stamps[i - 1][1])
        return list(out.items())

    def server_timing(self, tl: Timeline) -> str:
        """The W3C ``Server-Timing`` header value: one ``<stage>;dur=<ms>``
        entry per stage segment plus the total."""
        parts = [f"{stage};dur={dur * 1e3:.2f}" for stage, dur in self._segments(tl)]
        parts.append(f"total;dur={tl.total_ms:.2f}")
        return ", ".join(parts)

    def snapshot(
        self,
        recent: int = 50,
        slowest: int = 20,
        trace_id: Optional[str] = None,
        snaptoken: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> dict:
        """The /debug/requests body: newest-first recent timelines and the
        top-K slowest, filtered by trace id / snaptoken / tenant."""
        with self._lock:
            ring = list(self._ring)
            slow = sorted(self._slow, key=lambda e: -e[0])
            finished = dict(self.finished_by_surface)

        def keep(tl: Timeline) -> bool:
            if trace_id and tl.trace_id != trace_id:
                return False
            if snaptoken and tl.snaptoken != str(snaptoken):
                return False
            if tenant and tl.tenant != tenant:
                return False
            return True

        recent_out = [tl.to_json() for tl in reversed(ring) if keep(tl)]
        slow_out = [tl.to_json() for _, _, tl in slow if keep(tl)]
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "finished": finished,
            "recent": recent_out[: max(0, int(recent))],
            "slowest": slow_out[: max(0, int(slowest))],
        }


__all__ = ["STAGES", "MAX_STAMPS", "Timeline", "TimelineRecorder", "current_timeline"]
