"""The full snapshot build: scan → intern → layout (a copy of
keto_tpu/graph/stream_build.py).

``full_build`` is the engine's only full-build path. It takes the first of
three paths that applies, in the reference's order:

1. ``columns``: the store's sorted column bundle (``snapshot_columns``,
   valid right after a bulk load) through ``native_intern_columns``: no
   row objects at all;
2. ``stream``: the chunked scan (``snapshot_scan``) when the store prefers
   it; each chunk feeds the native stream builder (``ingest.cpp``'s
   ``stream_build_*``), whose worker pool interns chunk *k* while the scan
   fetches chunk *k+1*, and the chunk-order merge gives the serial build's
   ids;
3. ``rows``: ``snapshot_rows`` in one shot, interned by
   ``snapshot.build_snapshot``.

All three give the same snapshot. ``BuildProgress.path`` names the path a
build took (``python`` where a ``stream`` build's chunk could not be framed
and its chunks were replayed through ``IncrementalInterner``, or where a
``rows`` build's strings defeat both native encodings), and
``graph.native.COUNTERS`` counts every intern by path.

``BuildProgress`` records the phases and their seconds (``intern``,
``device_build`` and, on the stream path, ``scan``); ``pct()`` and the live
phase feed the engine's ``health()`` (the STARTING detail of
``/health/ready``); ``snapshot()``, the ``build_<phase>`` durations of its
``stats`` and the histogram ``attach_histogram`` gives feed the
``keto_build_*`` families (keto_tpu_torch/driver/observability.py).
``read_retry`` wraps each store read; its
default calls the read once (the reference's retry policy behind
``_read_store`` comes with ROADMAP A4). A store failure mid-scan aborts the
in-flight native builder before the exception leaves ``_scan_and_intern``,
so a retry starts from fresh state.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

from keto_tpu_torch import _build
from keto_tpu_torch.graph import native
from keto_tpu_torch.graph.interner import IncrementalInterner
from keto_tpu_torch.graph.snapshot import GraphSnapshot, build_snapshot, layout_snapshot

#: default rows per scan chunk (``serve.build_chunk_rows``, the engine's
#: ``build_chunk_rows``): large enough that the per-chunk overheads (pack,
#: enqueue, shard tables) amortize, small enough that the intern pool stays
#: busy while the scan fetches the next chunk
DEFAULT_CHUNK_ROWS = 262144


#: the full build's phases, in order (the ``keto_build_phase`` gauge's
#: labels beside ``idle``)
PHASES = ("scan", "intern", "device_build", "labels", "cache_save")

#: each full-build phase's share of ``BuildProgress.pct`` (the reference's)
_PCT_WEIGHTS = {
    "scan": 0.35, "intern": 0.25, "device_build": 0.30,
    "labels": 0.10, "cache_save": 0.0,
}


class BuildProgress:
    """Thread-safe phase and progress tracker for snapshot builds.

    The row and edge counters add up across builds; the phase and the
    per-phase durations describe the build in flight (or the last one).
    ``path`` names the path the last build took (``full_build``). Each
    phase's seconds also go to ``stats`` (a ``MaintenanceStats``, as
    ``build_<phase>``) and to the histogram ``attach_histogram`` gives
    (keto_tpu/graph/stream_build.py:62-200)."""

    def __init__(self, stats=None):
        self._lock = threading.Lock()
        self._phase = "idle"
        self._rows = 0
        self._edges = 0
        self._durations: dict[str, float] = {}
        self._path = ""
        self._hist = None
        self._stats = stats  # MaintenanceStats or None

    def attach_histogram(self, histogram) -> None:
        """Mirror phase durations into ``histogram`` (anything with
        ``observe((phase,), seconds)``)."""
        self._hist = histogram

    # -- build lifecycle -----------------------------------------------------

    def start(self) -> None:
        """A new full build begins: reset the per-build view (the counters
        keep counting)."""
        with self._lock:
            self._durations = {}
            self._phase = "scan"
            self._path = ""

    def finish(self) -> None:
        with self._lock:
            self._phase = "idle"

    @contextlib.contextmanager
    def phase(self, name: str):
        """Run one pipeline phase: sets the live phase and records its
        duration on exit."""
        with self._lock:
            self._phase = name
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self.observe(name, time.monotonic() - t0)
            with self._lock:
                self._phase = "idle"

    def set_phase(self, name: str) -> None:
        with self._lock:
            self._phase = name

    def set_path(self, name: str) -> None:
        with self._lock:
            self._path = name

    def observe(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to phase ``name`` (additive: the streaming scan
        splits one interleaved loop into fetch time and intern time)."""
        s = max(0.0, float(seconds))
        with self._lock:
            self._durations[name] = self._durations.get(name, 0.0) + s
        hist = self._hist
        if hist is not None:
            hist.observe((name,), s)
        if self._stats is not None:
            self._stats.observe_ms(f"build_{name}", s * 1e3)

    def add_rows(self, n: int) -> None:
        with self._lock:
            self._rows += int(n)

    def add_edges(self, n: int) -> None:
        with self._lock:
            self._edges += int(n)

    # -- read side -----------------------------------------------------------

    @property
    def rows_ingested(self) -> int:
        with self._lock:
            return self._rows

    @property
    def edges_ingested(self) -> int:
        with self._lock:
            return self._edges

    @property
    def current_phase(self) -> str:
        with self._lock:
            return self._phase

    @property
    def path(self) -> str:
        with self._lock:
            return self._path

    def pct(self) -> float:
        """Coarse completion estimate of the build in flight
        (keto_tpu/graph/stream_build.py:159-171), for the health machine's
        STARTING detail: finished phases count their full weight, the live
        phase half of its."""
        with self._lock:
            phase = self._phase
            done = set(self._durations)
        if phase == "idle":
            return 1.0 if done else 0.0
        got = sum(_PCT_WEIGHTS.get(p, 0.0) for p in done if p != phase)
        got += 0.5 * _PCT_WEIGHTS.get(phase, 0.0)
        return round(min(0.99, got), 3)

    def durations(self) -> dict:
        """Per-phase seconds of the current or last build."""
        with self._lock:
            return dict(self._durations)

    def snapshot(self) -> dict:
        pct = self.pct()
        with self._lock:
            return {
                "phase": self._phase,
                "pct": pct,
                "rows_ingested": self._rows,
                "edges_ingested": self._edges,
                "durations_s": {k: round(v, 3) for k, v in self._durations.items()},
            }


def _scan_and_intern(store, wild_ns_ids, progress, chunk_rows):
    """One streaming scan+intern attempt: returns ``(interned, watermark,
    path)``. Raises on a store failure with the in-flight native builder
    aborted, so a retry starts from fresh state."""
    state = {
        "native": native.NativeStreamBuilder.create(wild_ns_ids),
        "py": None,
        "rows": [],  # the chunks, kept to replay if the native stream dies
        "intern_s": 0.0,
    }

    def replay():
        it = IncrementalInterner(wild_ns_ids)
        for c in state["rows"]:
            it.add_rows(c)
        state["rows"] = []
        native.COUNTERS["stream_replays"] += 1
        return it

    def on_chunk(chunk):
        t0 = time.monotonic()
        nb = state["native"]
        if nb is not None:
            state["rows"].append(chunk)
            if not nb.feed(chunk):
                # the native stream died (a framing rejection): replay the
                # chunks so far through the Python interner, same ids
                state["native"] = None
                state["py"] = replay()
        else:
            state["py"].add_rows(chunk)
        state["intern_s"] += time.monotonic() - t0
        progress.add_rows(len(chunk))

    progress.set_phase("scan")
    t_scan = time.monotonic()
    try:
        wm = store.snapshot_scan(on_chunk, chunk_rows=chunk_rows)
    except BaseException:
        if state["native"] is not None:
            state["native"].abort()
        raise
    scan_wall = time.monotonic() - t_scan

    progress.set_phase("intern")
    t0 = time.monotonic()
    path = "python"
    if state["native"] is not None:
        g = state["native"].finish()
        if g is None:
            g = replay().finish()
        else:
            native.COUNTERS["stream"] += 1
            path = "stream"
    else:
        g = state["py"].finish()
    state["intern_s"] += time.monotonic() - t0

    # the fetch time is the scan's wall minus what on_chunk spent packing
    # and feeding; the intern phase is that plus the merge. The native
    # pool's work overlaps the fetches, so scan + intern may pass the wall.
    in_scan_intern = min(state["intern_s"], scan_wall)
    progress.observe("scan", scan_wall - in_scan_intern)
    progress.observe("intern", state["intern_s"])
    return g, wm, path


def full_build(
    store,
    wild_ns_ids=frozenset(),
    *,
    peel_seed_cap: float = 4.0,
    sorter=None,
    progress: Optional[BuildProgress] = None,
    read_retry: Optional[Callable] = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
) -> GraphSnapshot:
    """A full snapshot of ``store`` at its current watermark, through the
    first path that applies (the module docstring): the column bundle, the
    streaming scan when the store prefers it, then ``snapshot_rows``. All
    three give the same snapshot. ``read_retry(fn)`` wraps each store read
    (identity by default). ``progress.path`` says which path ran."""
    prog = progress if progress is not None else BuildProgress()
    read_retry = read_retry or (lambda fn, *a: fn(*a))
    prog.start()
    try:
        # 1) the column bundle
        cols_fn = getattr(store, "snapshot_columns", None)
        if cols_fn is not None:
            wm = store.watermark()
            columns = cols_fn(wm)
            if columns is not None:
                with prog.phase("intern"):
                    g = native.native_intern_columns(_build.host_lib(), columns, wild_ns_ids)
                if g is not None:
                    prog.add_rows(int(columns["ns"].shape[0]))
                    prog.set_path("columns")
                    return layout_snapshot(g, wm, wild_ns_ids, peel_seed_cap=peel_seed_cap,
                                           sorter=sorter, progress=prog)

        # 2) the streaming scan and intern
        scan_fn = getattr(store, "snapshot_scan", None)
        if scan_fn is not None and getattr(store, "scan_chunks_preferred", True):
            g, wm, path = read_retry(lambda: _scan_and_intern(store, wild_ns_ids, prog,
                                                              chunk_rows))
            prog.set_path(path)
            return layout_snapshot(g, wm, wild_ns_ids, peel_seed_cap=peel_seed_cap,
                                   sorter=sorter, progress=prog)

        # 3) snapshot_rows in one shot
        with prog.phase("scan"):
            rows, wm = read_retry(store.snapshot_rows)
        snap = build_snapshot(rows, wm, wild_ns_ids, peel_seed_cap=peel_seed_cap, sorter=sorter,
                              progress=prog)
        prog.set_path("rows" if isinstance(snap.interned, native.NativeInterned) else "python")
        return snap
    finally:
        prog.finish()
