"""Batched check engine: 2-hop labels and multi-source bit-packed BFS on one GPU.

The core of ``TpuCheckEngine`` (keto_tpu/check/tpu_engine.py:1045), on two
routes. The **label route** (the default, as in the reference) answers
every label-certifiable query with ONE intersection step (``label_step``)
over a 2-hop label index built per snapshot (keto_tpu_torch/graph/labels.py
on the host, keto_tpu_torch/graph/label_build.py on the card past
``labels_device_min_edges`` ELL slots), and sends the rest to the **BFS
route** as a compacted sub-batch. On the BFS route up to 32·W queries
share one ``int32[num_int+1, W]`` reached
bitmap (bit ``q%32`` of word ``q//32`` in row ``v`` = "query q reached node
v"), a pull step ORs each active row's interior in-neighbours, the loop
runs to the reachability fixpoint, and the answer for query q is its target
bit of the fixpoint's pull plus the host-propagated one-hop term — "reached
via ≥ 1 edge", the reference's rule that a subject only matches via an
actual tuple. The device programs are keto_tpu_torch/check/kernels.py.

Decision parity with the reference engine (reference
internal/check/engine.go): an unknown namespace is denied, not an error;
empty namespace/object/relation fields wildcard the start expansion while
subject matching stays literal; an empty relation in a subject set never
fabricates a transitive grant.

Writes (tpu_engine.py:1394-1490, :2054-2760). A watermark advance applies
as a **delta overlay** on the immutable snapshot (keto_tpu_torch/graph/
overlay.py): inserts extend it, deletes become tombstones, in milliseconds
and without re-interning. Tombstoned iterated edges patch their device
bucket slots and overlay-ELL edges land in the resident ``[K, C]`` overlay
gather matrix through K9 (``slot_set_many``: every target of one update in
one launch), copy-on-write, so a batch that captured the old snapshot
keeps gathering the old tensors. A supervised
background pass folds the overlay into the base layout
(keto_tpu_torch/graph/compaction.py) once it passes
``overlay_edge_budget`` edges or has been quiet for ``compact_after_s``,
segment by segment (``fold_segment_edges``), and patches the 2-hop label
index on the card (``device_patch_labels``); only the touched buckets
re-upload. A full rebuild happens only where ``apply_delta`` or
``compact_snapshot`` cannot express the shape (a class change, a delete in
a wildcard graph, a change of namespace config), or where the store's
logs no longer reach back. While an overlay edge touches the interior
subgraph (``lab_dirty``) every check takes the BFS route, which ORs the
overlay into every pull.

Freshness: ``snapshot()`` is read-your-writes, ``snapshot(at_least=w)``
serves any snapshot at or past ``w``, and ``snapshot_serving()`` (the
batcher's default) catches up through a delta synchronously and serves the
current snapshot only while a full rebuild or a fold holds the refresh
lock. Label installs take a separate short lock, never the refresh lock.

Build sorts. With ``device_build_enabled`` (the default, as in the
reference, tpu_engine.py:1106, :1375-1384) the full build and the fold run
their edge-scale stable sorts through a ``GovernedSorter``
(keto_tpu_torch/graph/device_build.py): K8 on the card past
``DEFAULT_MIN_EDGES`` keys, the host below it. ``build_info`` records the
last full build's seconds, its sort seconds by backend and
``build_sort_bytes``; the counters ``device_build_dispatches``,
``device_build_host_dispatches``, ``device_build_skipped`` (a batch whose
transient the governor refused, sorted on the host) and
``device_build_errors`` count the sorter's batches. A failed device sort
raises.

Full builds (tpu_engine.py:2185-2200) go through
``stream_build.full_build`` only: the store's column bundle after a bulk
load, the chunked scan when the store prefers it, else ``snapshot_rows``
(keto_tpu_torch/graph/stream_build.py); ``build_progress`` times their
phases.

Streaming (tpu_engine.py:3718-4069). ``batch_check_stream`` keeps up to
16 slices in flight: the host resolves and packs slice k+2 while k+1 runs
on the card, each slice's entries go up from a pinned staging buffer
leased until the slice lands (keto_tpu_torch/check/stream.py), each
slice's output comes home by its own ``non_blocking`` copy and event, and
slices land in READY order (``ordered=False`` yields ``(offset,
decisions[, info])`` as each lands, naming its route: ``host``, ``label``,
``hybrid`` or ``bfs``). Widths and pre-dispatch splits follow the
``StreamSliceController``. ``batch_check_with_token`` dispatches every
slice before it lands any, and lands each the same way (``_land_slice``),
where the reference fetches a whole batch in one copy. ``label_witness_info``
names the landmark of a label-route grant for the explain path through
``label_step_witness`` (K4).

Sharded serving (tpu_engine.py:1188-1205, keto_tpu_torch/parallel/). With
``mesh=`` a ``ShardMesh`` of ``g`` shards the engine partitions the bucket,
bitmap and label rows into row-range shards (``make_shard_spec``) and runs
the sharded programs (K10): the BFS route through ``check_step``, the
label route through ``label_step``, the label build and patch through the
sharded sweeper. Overlays are re-routed per shard on every delta (never
scattered into a resident pack), ELL patches land on the owning shard's
slot of the stacked arrays (K9), and each sharded slice feeds the counters
``shard_halo_rounds``, ``shard_halo_bytes`` and ``shard_frontier_bits``
and the stream's per-slice ``halo_rounds``/``halo_bytes``. Decisions are
bit-identical to the single-device engine's. A failed sharded dispatch
raises and counts ``shard_dispatch_failures``; nothing falls back to the
unsharded kernels. Explain names a sharded engine's landmark from the host
index, as the reference does (tpu_engine.py:3836).

The shadow audit (tpu_engine.py:1818-1900). With ``audit_sample_rate`` >
0 a random sample of the decisions the batch path and each landed stream
slice answered is queued (at most 4,096 pending) and re-checked on a
supervised background thread against the CPU oracle
(keto_tpu_torch/check/engine.py) over the store; a sample whose snaptoken
no longer equals the store's watermark is skipped and counted
(``audit_skipped_stale``), a disagreement counted (``audit_mismatches``)
with both witnesses kept in ``audit_divergences``, and ``health()``
reports it, which the health machine reads as DEGRADED. It never answers
a request: it is an alarm off the serving path, not a fallback.

The device-memory governor (tpu_engine.py:1298-1346, :1594-1810,
keto_tpu_torch/driver/hbm.py). ``self.hbm`` keeps a ledger of every tensor
the engine places on the card — ``snapshot`` (the buckets), ``overlay``,
``labels``, ``warmup``, the list engine's ``reverse`` and the build's
transient ``build`` — against ``hbm_budget_bytes`` (0: the card's memory
less 8%). Every refresh, fold and label upload is planned first
(``_plan_or_refuse``): an over-budget plan walks the eviction ladder —
``staging`` (the pinned host staging pool, which costs the card nothing
and so never makes room: it keeps the reference's place and name),
``labels`` (checks take the BFS route, decisions unchanged),
``reverse`` (listings run on the host lister, equal answers),
``warm-ladder`` (narrower slice widths, the allocator's cache emptied),
``overlay-budget`` (a smaller overlay, folded) — and with every rung spent
the refresh is refused: the current snapshot serves stale, ``health()``
reports ``memory_pressure`` and ``refusals`` counts it; a cold engine
with nothing to serve uploads over budget (``forced_allocs``). A
successful refresh walks back up the ladder (``maybe_restore``). Every
upload and every slice dispatch runs under ``_guard_alloc``: a
``torch.OutOfMemoryError`` evicts one rung and retries once
(``oom_events``, ``oom_recoveries``); a second one, or one with the ladder
spent, raises to the caller — a batch fails every rider, a refresh is a
supervised failure and the current snapshot serves stale. There is no CPU
fallback: the reference's escalation into one (tpu_engine.py:1781-1800,
:1977) is not ported, and ``health()["degraded"]`` is always False.
``warm_compile()`` runs one empty slice a width to load each kernel's
module and leave its workspace in the caching allocator, skipping the
widths the budget cannot hold. ``health()`` and ``staleness_s()``
(tpu_engine.py:1528-1582) feed keto_tpu_torch/driver/health.py.

The snapshot cache (tpu_engine.py:2449-2540, keto_tpu_torch/graph/
snapcache.py). With ``snapshot_cache_dir`` the first refresh reloads the
newest cache at or below the store's watermark (its list layouts
re-derived through the build sorter, K8 on the card), uploads its buckets
(striped per shard when sharded, from either kind of save) and its labels
without a build (dropped with ``labels_enabled=False``; a cache without
labels starts the label build), and catches up through the delta path.
A cache whose wildcard namespaces differ from the configuration's is not
used. Every overlay-free install kicks a save on the supervised ``cache``
worker; ``save_snapshot_cache()`` saves at once. A corrupt cache is
quarantined and an unreadable one passed over, as in the reference, but
any other reload error — a failed K8 launch or upload — raises and
counts ``cache_load_failures``, where the reference retries it for 2 s
and then rebuilds (tpu_engine.py:2461-2470). Store reads on the refresh
path (``changes_since`` and the full build's scans) go through
``_read_store``: the store's own errors (an ``OSError``: a dropped
connection, a timeout, an I/O error) retry with jittered backoff for up
to ``refresh_retry_max_wait_s`` (counted in ``refresh_read_retries``);
any other error, of the port's own code, of torch or of CUDA, raises at
once.

Kept against the reference engine: bucket upload, the label build
overlapped on a background thread and installed only onto the exact
snapshot it was built for, host resolution, the label router, slicing, the
exact truncation re-run ladder and the
grow-only ``block_iters`` retune. Not here: shards on several cards, the
GSPMD mode and the multi-process lockstep (and with it the governor's
deterministic mode), the fault-injection seams (ROADMAP A10) and any CPU
fallback.
A device error raises; a failed label
build, background refresh, fold or device label patch is counted and
raised by the next check (and by ``labels_settled()`` and
``maintenance_settled()``), where the reference would serve stale, rebuild
or retry on the host.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import random
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check import kernels
from keto_tpu_torch.check.stream import StreamSliceController, _StagingPool
from keto_tpu_torch.driver.hbm import HbmGovernor, MemoryPressure, is_resource_exhausted
from keto_tpu_torch.check.pack import (
    _WORD_WIDTHS,
    _ceil_pow2,
    _entry_pad,
    pack_chunk,
    pack_entries,
)
from keto_tpu_torch.graph import label_build, snapcache
from keto_tpu_torch.graph.carry import device_graph_from_arrays, host_tensor, snapshot_arrays
from keto_tpu_torch.graph.compaction import compact_snapshot
from keto_tpu_torch.graph.device_build import GovernedSorter, estimate_sort_bytes
from keto_tpu_torch.graph.labels import build_labels, patch_labels
from keto_tpu_torch.graph.overlay import apply_delta, overlay_device_bytes
from keto_tpu_torch.graph.snapshot import WILDCARD, GraphSnapshot
from keto_tpu_torch.graph.stream_build import DEFAULT_CHUNK_ROWS, BuildProgress, full_build
from keto_tpu_torch.parallel import sharded as shard_mod
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.device import resolve_device, same_device
from keto_tpu_torch.x.errors import ErrNamespaceUnknown
from keto_tpu_torch.x.retry import retry_call
from keto_tpu_torch.x.supervise import SupervisedTask
from keto_tpu_torch.x.telemetry import DurationStats, MaintenanceStats

_log = logging.getLogger("keto_tpu_torch.check")


#: distinct-from-None cache sentinel for namespace resolution
_UNSET = object()
#: wildcard-namespace marker in the native resolve's namespace cache
_WILD = object()
#: native-format record whose result is overwritten on the Python side
_PLACEHOLDER = b"0\x1f\x1f\x1f1\x1f\x1f\x1f\x1e"


class _DeviceOut:
    """One kernel output (``int32`` words on the engine's device) and its
    copy home. ``copy_to_host_async`` issues a ``non_blocking`` copy into a
    pinned host tensor on the current stream, right behind the slice's
    kernels, and records an event; ``is_ready`` queries the event;
    ``words`` waits for it and returns the words as uint32. On the CPU the
    output is its own host copy, ready at once."""

    __slots__ = ("dev", "_host", "_event")

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self._host: Optional[torch.Tensor] = None
        self._event = None

    @property
    def shape(self):
        return self.dev.shape

    def copy_to_host_async(self) -> None:
        if self._host is not None:
            return
        if self.dev.device.type != "cuda":
            self._host = self.dev
            return
        host = torch.empty(self.dev.shape, dtype=self.dev.dtype, pin_memory=True)
        host.copy_(self.dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._host, self._event = host, event

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def words(self) -> np.ndarray:
        self.copy_to_host_async()
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().view(np.uint32)


class _HybridSlice:
    """Device output(s) of one label-routed slice: the label kernel's
    packed bits for the whole slice (None when every query fell back),
    plus — when some queries fell back — a BFS sub-batch output and the
    slice positions it answers. Lands like a ``_DeviceOut``."""

    __slots__ = ("label_dev", "bfs_dev", "bfs_pos")

    def __init__(self, label_dev, bfs_dev=None, bfs_pos=None):
        self.label_dev = label_dev
        self.bfs_dev = bfs_dev
        self.bfs_pos = bfs_pos

    def parts(self) -> list:
        return [p for p in (self.label_dev, self.bfs_dev) if p is not None]

    def copy_to_host_async(self) -> None:
        for p in self.parts():
            p.copy_to_host_async()

    def is_ready(self) -> bool:
        return all(p.is_ready() for p in self.parts())


class _ShardedSlice:
    """Device output of one sharded BFS dispatch (tpu_engine.py:417-430):
    the packed ``uint32[W+3]`` output of K10a (decision bits, iterations,
    truncation, frontier-bit population) and the halo bytes of one round,
    which the landing turns into the ``shard_*`` counters. Lands like a
    ``_DeviceOut``."""

    __slots__ = ("out", "halo_bytes_per_round")

    def __init__(self, out: _DeviceOut, halo_bytes_per_round: int):
        self.out = out
        self.halo_bytes_per_round = int(halo_bytes_per_round)

    def copy_to_host_async(self) -> None:
        self.out.copy_to_host_async()

    def is_ready(self) -> bool:
        return self.out.is_ready()

    def words(self) -> np.ndarray:
        return self.out.words()


def _halo_bytes_of(dev) -> Optional[int]:
    """The halo bytes per round of a slice's sharded BFS part, or None."""
    if isinstance(dev, _HybridSlice):
        dev = dev.bfs_dev
    return dev.halo_bytes_per_round if isinstance(dev, _ShardedSlice) else None


def _route_of(dev) -> str:
    """The route of a landed slice, named as the reference's ``land()``
    names it: ``host`` (no device part), ``label`` (the label step alone),
    ``hybrid`` (label-routed with a BFS sub-batch), else ``bfs``."""
    if dev is None:
        return "host"
    if isinstance(dev, _HybridSlice):
        return "label" if dev.bfs_dev is None else "hybrid"
    return "bfs"


class TorchCheckEngine:
    """Check engine answering batched queries on the device graph.

    ``store`` must expose ``snapshot_rows() -> (rows, watermark)``,
    ``watermark()`` and ``changes_since(watermark)``, and may expose
    ``snapshot_columns(watermark)`` and ``snapshot_scan(on_chunk, chunk_rows)``
    (keto_tpu_torch/persistence/memory.py); ``namespaces``
    is a namespace.Manager or a zero-arg callable returning the current one.
    ``device`` defaults to ``cuda`` and must be named ``"cpu"`` to run the
    plain PyTorch path on the host. The overlay knobs and their defaults
    are the reference's (tpu_engine.py:1086-1092); the stream runs with the
    reference's default window, and its controller with
    ``stream_slice_target_ms`` (40 ms a slice) and ``stream_tail_ratio``
    (5). ``audit_sample_rate`` (0: off) samples decisions into the shadow
    audit. ``mesh`` (a ``ShardMesh`` on the engine's device) selects the
    sharded mode. ``snapshot_cache_dir`` (None: off) keeps the snapshot
    cache there; ``refresh_retry_max_wait_s`` bounds the retries of a
    failing store read on the refresh path. ``hbm_budget_bytes`` (0: auto,
    the card's memory less 8%) is the device-memory governor's budget.
    ``staging_enabled`` (the reference's ``serve.staging_enabled``) leases
    each slice's entry buffer from the pinned staging pool; False ships
    every slice from a buffer of its own. ``build_chunk_rows``
    (``serve.build_chunk_rows``) is the streaming build's scan chunk.
    """

    #: the stream yields per-slice route info (``with_info=True``)
    STREAM_INFO = True
    #: slices a stream keeps in flight (the reference's default depth)
    _DISPATCH_WINDOW = 16

    def __init__(
        self,
        store,
        namespaces,
        *,
        device: Optional[Union[str, torch.device]] = None,
        it_cap: int = 4096,
        max_batch: int = 32 * _WORD_WIDTHS[-1],
        mem_budget_bytes: int = 10 << 30,
        peel_seed_cap: float = 4.0,
        labels_enabled: bool = True,
        labels_max_width: int = 64,
        labels_landmarks: int = 0,
        labels_device_build: bool = True,
        labels_min_gain: float = 0.0,
        labels_batch: int = 64,
        labels_device_min_edges: int = label_build.DEFAULT_MIN_EDGES,
        overlay_edge_budget: int = 4096,
        fold_segment_edges: int = 2048,
        compact_after_s: float = 5.0,
        sync_rebuild_budget_s: float = 0.25,
        device_build_enabled: bool = True,
        native_pack_enabled: bool = True,
        stream_slice_target_ms: float = 40.0,
        stream_tail_ratio: float = 5.0,
        audit_sample_rate: float = 0.0,
        mesh=None,
        snapshot_cache_dir: Optional[str] = None,
        refresh_retry_max_wait_s: float = 2.0,
        hbm_budget_bytes: int = 0,
        staging_enabled: bool = True,
        build_chunk_rows: int = DEFAULT_CHUNK_ROWS,
    ):
        if it_cap < 1:
            raise ValueError("it_cap must be >= 1 (the answer pull needs one step)")
        self.device = resolve_device(device)
        # the explicit sharded mode (keto_tpu_torch/parallel/sharded.py): the
        # bucket, bitmap and label rows partition into row-range shards over
        # the mesh's graph axis, all on this engine's device
        self._mesh = mesh
        self._sharded = mesh is not None
        self._shard_count = int(mesh.graph) if mesh is not None else 0
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"the mesh lives on {mesh.device}, the engine on {self.device}")
        self._store = store
        if isinstance(namespaces, namespace_pkg.Manager):
            self._nm: Callable[[], namespace_pkg.Manager] = lambda: namespaces
        else:
            self._nm = namespaces
        self._it_cap = it_cap
        self._build_chunk_rows = max(1, int(build_chunk_rows))
        self._max_batch = max_batch
        # bound on the BFS workspace (~3 W-wide bitmaps over interior rows):
        # huge graphs narrow the batch width instead of overshooting memory
        self._mem_budget = mem_budget_bytes
        self._peel_seed_cap = peel_seed_cap
        # the native pack walk (check/native_pack.py) on every chunk
        # walk_eligible takes; False pins the numpy walk (tpu_engine.py:1149)
        self._native_pack = bool(native_pack_enabled)
        # pulls per convergence observation, grown to the workload's depth
        self._block_iters = 8
        # the streaming pipeline (tpu_engine.py:1129-1153): the width
        # controller shared by every stream so a serving process stays
        # converged, and the per-slice service times that the controller
        # and chip_smoke.py both read
        self.stream_ctrl = StreamSliceController(
            target_ms=stream_slice_target_ms, tail_ratio=stream_tail_ratio
        )
        self.stream_slice_stats = DurationStats()
        #: BFS iteration counts of every slice that ran the fixpoint (steps)
        self.bfs_steps_stats = DurationStats()
        #: per-route slice service times and slice/query counts (route =
        #: label | hybrid | bfs | host), recorded as each slice lands
        self._route_stats: dict[str, DurationStats] = {}
        self._route_slices: collections.Counter = collections.Counter()
        self._route_queries: collections.Counter = collections.Counter()
        # guards the route breakdown above and the label-invalidation latch
        self._counter_lock = threading.Lock()
        # the refresh lock: deltas, folds and full rebuilds hold it. Installs
        # (the snapshot swap, a label index landing) take the short
        # _swap_lock instead, so the serving path's non-blocking try on the
        # refresh lock fails only while a rebuild or a fold runs
        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._snapshot: Optional[GraphSnapshot] = None
        # delta overlays and their background fold (tpu_engine.py:1223-1297)
        self._max_overlay_edges = int(overlay_edge_budget)
        self._fold_segment_edges = max(1, int(fold_segment_edges))
        self._compact_after_s = float(compact_after_s)
        self._sync_rebuild_budget_s = float(sync_rebuild_budget_s)
        #: seconds the last full rebuild took (snapshot_serving rebuilds
        #: inline only while this stays within sync_rebuild_budget_s)
        self._last_full_build_s = 0.0
        self._overlay_born: Optional[float] = None
        # log-structured fold: the last overlay-free snapshot and the delta
        # segments (base id, watermark, ops) applied on top of it since
        self._fold_base: Optional[GraphSnapshot] = None
        self._seg_log: list = []
        self._pending_seg = None
        # host mirror of the resident overlay pack ([K, C] gather matrix,
        # dst vector, slot map, per-row fill): later deltas scatter into it
        # with K9 instead of re-packing; dropped whenever it may disagree
        # with the device
        self._ov_pack: Optional[dict] = None
        self._label_blocked_snap: Optional[int] = None
        self._refresh_force_full = False
        #: every count, gauge and duration of the snapshot lifecycle
        #: (tpu_engine.py:1232-1236): the route and maintenance counters,
        #: counted where the reference counts them — label_checks,
        #: label_fallbacks, label_builds, label_device_builds; delta_applies,
        #: overlay_device_applies, full_rebuilds, compactions, fold_runs,
        #: label_patches, label_patch_aborts, label_rebuilds,
        #: label_invalidations, label_build_truncated_<reason>; the supervised
        #: passes' refresh_failures, cache_save_failures and audit_failures;
        #: and the failures the port raises where the reference falls back:
        #: compaction_failures, label_patch_failures, witness_errors (a failed
        #: K4 launch in label_witness_info), shard_dispatch_failures (a failed
        #: sharded dispatch); the shadow audit's audit_checks,
        #: audit_mismatches and audit_skipped_stale (always present in
        #: ``counters()``); the resolved batches by path,
        #: resolve_native_batches (the C++ bulk resolve) and
        #: resolve_python_batches (the host loop: a separator byte in a
        #: query, or a snapshot interned in Python); slice_splits, the
        #: sub-chunks past the first that chunks whose entries passed their
        #: budget were split into; and, sharded, shard_halo_rounds,
        #: shard_halo_bytes and shard_frontier_bits; the snapshot cache's
        #: cache_loads, cache_saves, cache_quarantined, cache_reload_retries
        #: (an unreadable cache directory) and cache_load_failures (a reload
        #: that raised); refresh_read_retries; the governor's hbm_evictions,
        #: hbm_refusals, hbm_restores, hbm_forced_allocs, oom_events and
        #: oom_recoveries; the build sorter's device_build_* counts;
        #: label_device_build_skipped; health_transitions. Gauges:
        #: overlay_edges, overlay_budget, label_coverage, label_entries,
        #: label_dirty_nodes, label_build_landmarks(_total), label_build_entries,
        #: label_build_batches, memory_pressure, warm_widths_skipped,
        #: shard_count, the governor's hbm_* and health_state. Durations (ms):
        #: full_rebuild, compaction, fold, label_patch, label_build,
        #: label_build_device, cache_reload, cache_save and build_<phase>.
        self.maintenance = MaintenanceStats()
        self.maintenance.set_gauge("overlay_budget", self._max_overlay_edges)
        self.maintenance.set_gauge("overlay_edges", 0)
        #: the exception of the last failed background refresh pass, raised
        #: by the next check and by maintenance_settled()
        self._maintenance_error: Optional[Exception] = None
        self._refresh_task = SupervisedTask(
            "refresh", self._refresh_pass, on_error=self._note_maintenance_error,
            stats=self.maintenance, quiet=lambda e: isinstance(e, MemoryPressure),
        )
        # a failing store read on the refresh path retries for this long
        self._refresh_retry_max_wait_s = float(refresh_retry_max_wait_s)
        # the snapshot cache (keto_tpu_torch/graph/snapcache.py): the newest
        # overlay-free snapshot waits here for the supervised save pass
        self._cache_dir = snapshot_cache_dir or None
        self._cache_pending: Optional[GraphSnapshot] = None
        self._cache_task = SupervisedTask(
            "cache-save", self._cache_save_pass, stats=self.maintenance,
        )
        #: the last cache reload: its seconds, bytes (the segments read),
        #: path and watermark, and whether it carried labels
        self.last_cache_load: Optional[dict] = None
        #: the last cache save: its seconds by part (snapcache.save_snapshot's
        #: timings), bytes and path
        self.last_cache_save: Optional[dict] = None
        # the shadow audit (tpu_engine.py:1349-1366): the fraction of live
        # decisions re-checked on the CPU oracle, off the serving path
        self.audit_sample_rate = max(0.0, float(audit_sample_rate))
        self._audit_rng = random.Random(0xA0D17)
        self._audit_pending: collections.deque = collections.deque(maxlen=4096)
        self._audit_oracle = None
        #: evidence of the last shadow-audit divergences (both witnesses)
        self.audit_divergences: collections.deque = collections.deque(maxlen=8)
        self._audit_task = SupervisedTask("audit", self._audit_pass, stats=self.maintenance)
        #: what the last compaction did: seconds (the label patch or build
        #: included), the label outcome, the label patch's or build's ms,
        #: the touched buckets and their bytes
        self.last_compaction: Optional[dict] = None
        # 2-hop labels: built per snapshot, served as the one-step route;
        # BFS answers what the labels cannot certify. The knobs and their
        # defaults are the reference's (tpu_engine.py:1097-1168)
        self._labels_enabled = bool(labels_enabled)
        self._labels_max_width = int(labels_max_width)
        self._labels_landmarks = int(labels_landmarks)
        self._labels_device_build = bool(labels_device_build)
        self._labels_min_gain = float(labels_min_gain)
        self._labels_batch = int(labels_batch)
        self._labels_device_min_edges = int(labels_device_min_edges)
        self._label_build_thread: Optional[threading.Thread] = None
        #: the exception of the last background label build, raised by the
        #: next check and by labels_settled() (never a quiet BFS fallback)
        self._label_build_error: Optional[Exception] = None
        #: transient device bytes of the last device label build (planned
        #: against the governor under the ``build`` tag)
        self.label_build_bytes = 0
        #: BuildInfo of the last device label build
        self.label_build_info: Optional[label_build.BuildInfo] = None
        # the device-memory governor (tpu_engine.py:1298-1346): the ledger,
        # plan before upload and the eviction ladder; its counters and
        # gauges land in the engine's maintenance stats
        self.hbm = HbmGovernor(
            budget_bytes=int(hbm_budget_bytes), device=self.device, stats=self.maintenance,
        )
        if self._sharded:
            # per-shard ledger: the mesh-wide plan binds on the hottest shard
            self.hbm.set_shard_count(self._shard_count)
            self.maintenance.set_gauge("shard_count", self._shard_count)
        # the list engine's hooks behind the reverse rung (attach_reverse_rung)
        self._reverse_evict_cb: Optional[Callable[[], int]] = None
        self._reverse_restore_cb: Optional[Callable[[], None]] = None
        # entry staging: host buffers (pinned on the card) leased until the
        # slice that shipped them lands; its bytes are host memory, reported
        # to the governor apart from the card's budget
        self._staging_enabled = bool(staging_enabled)
        self._staging_suspended = False
        self._staging = _StagingPool(
            pin=self.device.type == "cuda",
            on_change=lambda b: self.hbm.set_host_bytes("staging", b),
        )
        self.hbm.attach_rungs([
            ("staging", self._evict_staging, self._restore_staging),
            ("labels", self._evict_labels, self._restore_labels),
            ("reverse", self._evict_reverse, self._restore_reverse),
            ("warm-ladder", self._evict_warm_ladder, self._restore_warm_ladder),
            ("overlay-budget", self._evict_overlay_budget, self._restore_overlay_budget),
        ])
        # ladder state the rungs flip
        self._labels_suspended = False
        self._width_trim = 0
        self._configured_overlay_budget = self._max_overlay_edges
        self._memory_pressure = False
        self._last_label_bytes = 0
        self._last_warm_bytes = 0
        #: the widest slice width (queries) ``warm_compile`` warmed, 0: none,
        #: and the widths its last call skipped as over budget
        self.warmup = 0
        self.warm_widths_skipped = 0
        # the snapshot a refresh is uploading, until it installs
        self._installing: Optional[GraphSnapshot] = None
        # staleness clock for the health machine: the monotonic instant the
        # serving snapshot was first seen behind the store's watermark
        self._behind_since: Optional[float] = None
        # the build's stable sorts: K8 on the card past the size gate, each
        # batch's transient planned against the governor (device_build_
        # dispatches, device_build_host_dispatches, device_build_skipped,
        # device_build_errors count its batches), numpy's without the knob
        self._build_sorter = (
            GovernedSorter(self.device, hbm=self.hbm, on_count=self._incr)
            if device_build_enabled else None
        )
        #: the full builds' phases and path (keto_tpu_torch/graph/stream_build.py)
        self.build_progress = BuildProgress(stats=self.maintenance)
        #: the last full build: seconds, its interning seconds (intern_s),
        #: sort seconds by backend, the transient sort bytes the reference
        #: plans (build_sort_bytes), its path (columns, stream, rows or
        #: python) and its phases' seconds (phases_s)
        self.build_info: Optional[dict] = None

    @property
    def shard_count(self) -> int:
        """Graph shards of the sharded mode (0 = not sharded)."""
        return self._shard_count

    # -- snapshot lifecycle --------------------------------------------------

    def snapshot(self, at_least: Optional[int] = None) -> GraphSnapshot:
        """Device snapshot current with the store's watermark.

        - ``at_least=None``: read-your-writes — blocks until the snapshot
          reflects every acknowledged write (a delta overlay in the common
          case, a full rebuild where the delta cannot express the change);
        - ``at_least=w``: any snapshot with id >= ``w`` serves at once; when
          the store has moved on, a background refresh is kicked.
        """
        snap = self._snapshot
        if snap is not None and snap.snapshot_id == self._store.watermark():
            self._maybe_kick_compaction(snap)
            return snap
        if at_least is not None and snap is not None and snap.snapshot_id >= at_least:
            self._refresh_task.kick()
            return snap
        with self._lock:
            return self._refresh_locked()

    def snapshot_serving(self) -> GraphSnapshot:
        """Serving-path snapshot (tpu_engine.py:1426): never stalls the read
        plane on an expensive rebuild or a fold.

        - the store has not moved → the current snapshot;
        - the watermark advanced and a delta applies → synchronous catch-up
          (milliseconds: effectively read-your-writes);
        - only a full rebuild reaches the watermark → done inline when the
          last one was cheap (<= ``sync_rebuild_budget_s``), else the current
          snapshot serves while the background refresh catches up. The same
          holds while a rebuild or a fold holds the refresh lock.

        A refresh the device-memory governor refused (``MemoryPressure``),
        or one whose upload ran out of card memory past its one retry,
        serves the current snapshot stale, counted in
        ``refresh_failures``, while the background refresh retries. Any
        other refresh error raises (the reference serves stale on every
        error).
        """
        snap = self._snapshot
        if snap is None or self._last_full_build_s <= self._sync_rebuild_budget_s:
            try:
                return self.snapshot()
            except Exception as e:
                if snap is None or not self._serves_stale(e):
                    raise
                self._incr("refresh_failures")
                self._refresh_task.kick()
                return self._snapshot
        if snap.snapshot_id >= self._store.watermark():
            self._maybe_kick_compaction(snap)
            return snap
        if self._lock.acquire(blocking=False):
            try:
                try:
                    got = self._refresh_locked(delta_only=True)
                except Exception as e:
                    self._incr("refresh_failures")
                    if not self._serves_stale(e):
                        raise
                    got = None
                if got is not None:
                    if self._overlay_edge_count(got) > self._max_overlay_edges:
                        # serve fresh now; the background pass folds it
                        self._refresh_task.kick()
                    return got
            finally:
                self._lock.release()
        # rebuild territory, or a rebuild or fold holds the lock
        self._refresh_task.kick()
        return self._snapshot

    def _snapshot_for(self, at_least: Optional[int], mode: str) -> GraphSnapshot:
        if at_least is not None:
            return self.snapshot(at_least=at_least)
        if mode == "serving":
            return self.snapshot_serving()
        if mode != "latest":
            raise ValueError(f"unknown consistency mode {mode!r}")
        return self.snapshot()

    def _maybe_kick_compaction(self, snap: GraphSnapshot) -> None:
        """Fold an overlay that has been quiet for ``compact_after_s``, off
        the serving path."""
        born = self._overlay_born
        if snap.has_overlay and born is not None and time.monotonic() - born > self._compact_after_s:
            self._refresh_force_full = True
            self._refresh_task.kick()

    @staticmethod
    def _serves_stale(e: BaseException) -> bool:
        """A refresh error after which the current snapshot serves stale:
        the governor's refusal, or a card OOM that survived its retry."""
        return isinstance(e, MemoryPressure) or is_resource_exhausted(e)

    def _note_maintenance_error(self, e: Exception) -> None:
        # the supervisor counts it (refresh_failures)
        if not self._serves_stale(e):
            self._maintenance_error = e

    def _refresh_pass(self) -> None:
        """One supervised background pass: catch up to the watermark and
        fold the overlay when it is over budget (or, forced, quiet)."""
        force_full, self._refresh_force_full = self._refresh_force_full, False
        try:
            with self._lock:
                self._refresh_locked(force_full=force_full, maintenance=True)
        except Exception:
            if force_full:
                self._refresh_force_full = True  # the retry still owes the fold
            raise

    def maintenance_settled(self, fold: bool = False, timeout: Optional[float] = None) -> GraphSnapshot:
        """Block until the background refresh is idle (after kicking a fold
        of the pending overlay when ``fold``) and any label build has
        installed; raise the error of a failed pass. Returns the serving
        snapshot. Tests and ``chip_smoke.py`` use it; serving never needs
        it."""
        if fold:
            self._refresh_force_full = True
            self._refresh_task.kick()
        if not self._refresh_task.wait_idle(timeout):
            raise TimeoutError("the background refresh did not settle")
        self._label_build_wait()
        self._raise_errors()
        return self._snapshot

    def close(self) -> None:
        """Stop the background refresh, audit and cache-save workers."""
        self._refresh_task.stop()
        self._audit_task.stop()
        self._cache_task.stop()

    # -- health (keto_tpu_torch/driver/health.py reads this surface) -----------

    def staleness_s(self) -> float:
        """Seconds the serving snapshot has been behind the store watermark
        (tpu_engine.py:1528-1548): 0.0 while current, or before the first
        build. Observing a gap also kicks the background refresh, so a
        health poll is itself a self-healing probe."""
        snap = self._snapshot
        if snap is None:
            return 0.0
        try:
            wm = self._store.watermark()
        except Exception:
            wm = None  # store unreadable: keep (or start) the behind clock
        now = time.monotonic()
        if wm is not None and snap.snapshot_id >= wm:
            self._behind_since = None
            return 0.0
        # one read: the refresh pass clears the clock when it catches up
        since = self._behind_since
        if since is None:
            since = self._behind_since = now
        self._refresh_task.kick()
        return now - since

    def health(self) -> dict:
        """Live inputs for the health state machine (tpu_engine.py:1550-1582):
        snapshot presence and staleness, the maintenance workers' liveness
        and crash counts, the governor's pressure flag and figures, the
        shadow audit's counts and the build's progress. ``degraded`` is
        always False: no CPU fallback engine ever serves."""
        rt = self._refresh_task
        c = self.counters()
        return {
            "has_snapshot": self._snapshot is not None,
            "staleness_s": self.staleness_s(),
            "maintenance_alive": (
                rt.alive() and self._cache_task.alive() and self._audit_task.alive()
            ),
            "refresh_failures": rt.crashes,
            "refresh_consecutive_failures": rt.consecutive_failures,
            "refresh_last_error": rt.last_error,
            "degraded": False,
            "memory_pressure": self._memory_pressure,
            "hbm_resident_bytes": self.hbm.resident_bytes(),
            "hbm_budget_bytes": self.hbm.budget_bytes,
            "hbm_rung": self.hbm.rung_depth,
            "audit_checks": c["audit_checks"],
            "audit_mismatches": c["audit_mismatches"],
            "build_phase": self.build_progress.current_phase,
            "build_pct": self.build_progress.pct(),
            "build_rows_ingested": self.build_progress.rows_ingested,
        }

    # -- the device-memory governor (keto_tpu_torch/driver/hbm.py) -----------

    def _plan_or_refuse(self, what: str, need: int, per_shard=None) -> None:
        """Plan ``need`` device bytes before an upload (tpu_engine.py:
        1596-1618). The governor walks the eviction ladder until it fits;
        with every rung spent the refresh is REFUSED (``MemoryPressure``:
        the current snapshot serves stale) — unless there is no snapshot
        at all (cold boot: nothing to serve, so the upload proceeds over
        budget and is counted in ``forced_allocs``). ``per_shard`` holds
        the plan against each shard's slice of the budget too."""
        if self.hbm.plan(need, what=what, per_shard=per_shard):
            return
        if self._snapshot is None:
            self.hbm.note_forced(what, need)
            return
        self.hbm.note_refused()
        self._memory_pressure = True
        self.maintenance.set_gauge("memory_pressure", 1)
        raise MemoryPressure(
            f"device memory budget refused {what}: need {need} bytes with "
            f"{self.hbm.resident_bytes()} resident of {self.hbm.budget_bytes} "
            "budgeted and every eviction rung spent — serving the current snapshot stale"
        )

    def _guard_alloc(self, what: str, fn):
        """Run one upload or dispatch seam with OOM containment
        (tpu_engine.py:1620-1652): a classified out-of-memory error evicts
        one ladder rung and retries ONCE; a second one, or one with the
        ladder spent, raises to the caller. There is no CPU fallback."""
        try:
            return fn()
        except Exception as e:
            if not is_resource_exhausted(e):
                raise
            self.hbm.note_oom(what)
            rung = self.hbm.evict_one(reason=f"oom at {what}")
            if rung is None:
                raise
            _log.warning("device OOM at %s: evicted rung %r, retrying once", what, rung)
        out = fn()
        self.hbm.note_oom_recovered()
        return out

    def _restore_plan_bytes(self) -> int:
        """Bytes a full walk back up the ladder would re-place on the card
        — the ``planned`` margin ``maybe_restore`` holds against, so the
        ladder does not oscillate."""
        est = 0
        if self._labels_suspended:
            est += self._last_label_bytes
        if self._width_trim:
            est += self._last_warm_bytes
        return est

    def _after_refresh(self) -> None:
        """A refresh reached the watermark within budget: pressure (if any)
        has cleared and the ladder may walk back up."""
        self._behind_since = None
        if self._memory_pressure:
            self._memory_pressure = False
            self.maintenance.set_gauge("memory_pressure", 0)
        self.hbm.maybe_restore(planned=self._restore_plan_bytes())

    def attach_reverse_rung(self, evict: Callable[[], int], restore: Callable[[], None]) -> None:
        """The list engine's hooks behind the ``reverse`` rung (eviction
        drops the list layouts' device arrays; listings run on the host
        lister). Called once at list-engine construction."""
        self._reverse_evict_cb = evict
        self._reverse_restore_cb = restore

    def _evict_reverse(self) -> int:
        cb = self._reverse_evict_cb
        return int(cb()) if cb is not None else 0

    def _restore_reverse(self) -> None:
        cb = self._reverse_restore_cb
        if cb is not None:
            cb()

    def _evict_staging(self) -> int:
        """Rung 0 — drop the pinned staging pool; slices then ship their
        entries from plain per-slice host tensors. It frees host memory
        only, so it returns 0 card bytes."""
        self._staging_suspended = True
        self._staging.drop()
        return 0

    def _restore_staging(self) -> None:
        self._staging_suspended = False  # the pool refills as slices dispatch

    def _stage_acquire(self, n: int) -> torch.Tensor:
        """An ``n``-element int32 host buffer for a slice's entries: leased
        from the pool, or — while the staging rung is evicted — a plain
        per-slice tensor, which the pool does not take back on release."""
        buf = None
        if self._staging_enabled:
            buf = self._staging.acquire(n, plan=lambda b: not self._staging_suspended)
        if buf is None:
            buf = torch.empty(n, dtype=torch.int32)
        return buf

    def _evict_labels(self) -> int:
        """Rung 1 — drop the label arrays: coverage loss only (checks take
        the BFS route with the same decisions)."""
        self._labels_suspended = True
        freed = self.hbm.release("labels")
        self._last_label_bytes = max(self._last_label_bytes, freed)
        for snap in (self._snapshot, self._installing):
            if snap is not None:
                snap.device_labels = None
                snap.device_shard_labels = None
                snap.labels = None
        self.maintenance.set_gauge("label_coverage", 0.0)
        self.maintenance.set_gauge("label_entries", 0)
        return freed

    def _restore_labels(self) -> None:
        self._labels_suspended = False
        # the next refresh pass rebuilds and uploads the index
        self._refresh_task.kick()

    def _evict_warm_ladder(self) -> int:
        """Rung 3 — trim the slice widths to the ladder's lower rungs and
        hand the caching allocator's free blocks back to the driver:
        wide-slice throughput falls, decisions do not change."""
        self._width_trim = max(self._width_trim, len(_WORD_WIDTHS) - 4)
        freed = self.hbm.release("warmup")
        self._last_warm_bytes = max(self._last_warm_bytes, freed)
        self.warmup = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return freed

    def _restore_warm_ladder(self) -> None:
        self._width_trim = 0

    def _evict_overlay_budget(self) -> int:
        """Rung 4 (last) — shrink the overlay edge budget so pending deltas
        fold into the base layout (the fold retires the overlay's device
        arrays and keeps future overlays small)."""
        self._max_overlay_edges = max(64, self._configured_overlay_budget // 8)
        self.maintenance.set_gauge("overlay_budget", self._max_overlay_edges)
        snap = self._snapshot
        freed = 0
        if snap is not None and snap.has_overlay:
            freed = overlay_device_bytes(snap)  # retired when the fold lands
            self._refresh_force_full = True
            self._refresh_task.kick()
        return freed

    def _restore_overlay_budget(self) -> None:
        self._max_overlay_edges = self._configured_overlay_budget
        self.maintenance.set_gauge("overlay_budget", self._max_overlay_edges)

    def _word_widths(self) -> tuple:
        """The slice-width ladder in service: ``_WORD_WIDTHS``, or its lower
        rungs while the warm-ladder rung is evicted (never fewer than two)."""
        n = len(_WORD_WIDTHS) - self._width_trim
        return _WORD_WIDTHS[: max(2, n)]

    def hbm_ledger_bytes(self) -> dict:
        """The bytes of the tensors each ledger tag names, summed from the
        tensors themselves (``nbytes``) — what the ledger must equal:
        ``snapshot`` (the buckets), ``overlay``, ``labels``; ``reverse``
        is the list engine's (``SnapshotListEngine.device_bytes``)."""
        snap = self._snapshot
        out = {"snapshot": 0, "overlay": 0, "labels": 0}
        if snap is None:
            return out
        if self._sharded:
            dev = snap.device_shards
            if dev is not None:
                out["snapshot"] = sum(int(t.nbytes) for t in dev.nbrs + dev.dst)
            ov = snap.device_shard_overlay
            lab = snap.device_shard_labels
            lab = lab[:2] if lab is not None else None
        else:
            if snap.device is not None:
                out["snapshot"] = sum(int(t.nbytes) for t in snap.device.buckets)
            ov = snap.device_overlay
            lab = snap.device_labels
        if ov is not None:
            out["overlay"] = sum(int(t.nbytes) for t in ov)
        if lab is not None:
            out["labels"] = sum(int(t.nbytes) for t in lab)
        return out

    def _refresh_locked(
        self, force_full: bool = False, delta_only: bool = False, maintenance: bool = False
    ) -> Optional[GraphSnapshot]:
        """Bring the snapshot to the current watermark (caller holds the
        refresh lock): a delta overlay when possible; an overlay past the
        edge budget (or, with ``force_full``, any) folds into the base
        layout by segment — on the background pass (``maintenance``) only;
        a full rebuild is the last resort, for shapes the overlay or the
        fold cannot express. With ``delta_only`` returns None instead of
        rebuilding (the serving path). The first refresh of an engine with a
        snapshot cache reloads the cache, then catches up from it."""
        snap = self._snapshot
        wm = self._store.watermark()
        if snap is None and self._cache_dir is not None and not delta_only:
            snap = self._load_cache_locked(wm)
        needs_fold = (
            snap is not None
            and snap.has_overlay
            and maintenance
            and self._overlay_edge_count(snap) > self._max_overlay_edges
        )
        if (
            snap is not None
            and snap.snapshot_id == wm
            and not (force_full and snap.has_overlay)
            and not needs_fold
        ):
            self._behind_since = None
            if maintenance and not delta_only:
                # an already-current engine has no install step: the
                # background pass is where the ladder walks back up once
                # pressure clears, and where labels the ladder dropped are
                # built again after their rung restores
                self.hbm.maybe_restore(planned=self._restore_plan_bytes())
                if not snap.has_overlay and snap.labels is None:
                    self._restart_label_build(snap)
            return snap
        wild_ns_ids = frozenset(n.id for n in self._nm().namespaces() if n.name == "")
        new = None
        if snap is not None:
            new = self._try_delta(snap, wild_ns_ids)
            if new is not None:
                # segment log for the background fold
                seg, self._pending_seg = self._pending_seg, None
                if seg is not None and (seg[2] or seg[0] != seg[1]):
                    self._seg_log.append(seg)
                if len(self._seg_log) > 4096:
                    # a runaway log: the next fold runs as one compaction
                    self._fold_base, self._seg_log = None, []
                self._incr("delta_applies")
                n_ov = self._overlay_edge_count(new)
                self.maintenance.set_gauge("overlay_edges", n_ov)
                over = force_full or n_ov > self._max_overlay_edges
                if over and new.has_overlay and not delta_only:
                    if not maintenance:
                        # never fold on a caller's thread
                        self._refresh_task.kick()
                    else:
                        try:
                            folded = self._fold_locked(new, full=force_full)
                        except Exception:
                            self._incr("compaction_failures")
                            raise
                        # None: the overlay's shape needs a real re-layout
                        new = folded
        rebuilt = new is None
        if rebuilt:
            if delta_only:
                return None
            t0 = time.monotonic()
            self._take_sort_seconds()
            new = full_build(
                self._store, wild_ns_ids,
                peel_seed_cap=self._peel_seed_cap,
                sorter=self._build_sorter,
                progress=self.build_progress,
                read_retry=self._read_store,
                chunk_rows=self._build_chunk_rows,
            )
            sort_s = self._take_sort_seconds()
            self._upload_buckets(new)
            self._ov_pack = None
            self._last_full_build_s = time.monotonic() - t0
            phases = self.build_progress.durations()
            self.build_info = {
                "seconds": self._last_full_build_s,
                "intern_s": phases.get("intern", 0.0),
                "sort_s": sort_s,
                "build_sort_bytes": estimate_sort_bytes(new.n_nodes, new.n_edges),
                "path": self.build_progress.path,
                "phases_s": phases,
            }
            self._incr("full_rebuilds")
            self.maintenance.observe_ms("full_rebuild", self._last_full_build_s * 1e3)
        # the snapshot being installed: a labels eviction during its uploads
        # drops its labels too (a delta carries its base's device arrays)
        self._installing = new
        try:
            self._apply_ell_patch(new)
            self._upload_overlay(new)
            if self._labels_suspended:
                new.labels = None
                new.device_labels = None
                new.device_shard_labels = None
            with self._swap_lock:
                self._snapshot = new
        finally:
            self._installing = None
        self._after_refresh()
        if new.has_overlay:
            if self._overlay_born is None:
                self._overlay_born = time.monotonic()
            if maintenance and self._overlay_edge_count(new) > self._max_overlay_edges:
                self._refresh_task.kick()  # a bounded fold left more to fold
        else:
            # an overlay-free install is the new fold base
            self._fold_base, self._seg_log = new, []
            self._overlay_born = None
            self.maintenance.set_gauge("overlay_edges", 0)
        if rebuilt:
            # the label build overlaps serving: BFS answers until it installs
            self._start_label_build(new)
        if not new.has_overlay:
            # after the label build has started: the save joins it
            self._kick_cache_save(new)
        return new

    def _read_store(self, fn, *args):
        """A store read on the refresh path (tpu_engine.py:1507-1524): the
        store's own errors (``OSError``) retry with jittered backoff for up
        to ``refresh_retry_max_wait_s`` (each retry counted in
        ``refresh_read_retries``), then the last one raises and fails the
        pass. Any other error raises at once: the reference retries every
        error, which would retry a fault of the interner, torch or CUDA."""
        return retry_call(
            lambda: fn(*args),
            max_wait_s=self._refresh_retry_max_wait_s,
            base_s=0.05,
            max_s=0.5,
            retryable=lambda e: isinstance(e, OSError),
            on_retry=lambda e, d: self._incr("refresh_read_retries"),
        )

    # -- the snapshot cache (tpu_engine.py:2447-2540) ---------------------------

    def _load_cache_locked(self, store_wm: int) -> Optional[GraphSnapshot]:
        """Cold start: reload the newest usable cache at or below
        ``store_wm`` and install it; the caller then catches up through the
        delta path. None when no cache fits (none at or below the
        watermark, every one corrupt or unreadable, or its wildcard
        namespaces differ from the configuration's). An unreadable cache
        directory retries for 2 s (``cache_reload_retries``); any other
        error raises, counted in ``cache_load_failures``."""
        t0 = time.monotonic()
        loaded: dict = {}
        try:
            snap = retry_call(
                lambda: snapcache.load_latest(
                    self._cache_dir, max_watermark=store_wm, stats=self.maintenance,
                    sorter=self._build_sorter, loaded=loaded,
                ),
                max_wait_s=2.0,
                base_s=0.05,
                max_s=0.5,
                retryable=lambda e: isinstance(e, OSError),
                on_retry=lambda e, d: self._incr("cache_reload_retries"),
            )
            if snap is None:
                return None
            wild_now = frozenset(n.id for n in self._nm().namespaces() if n.name == "")
            if snap.wild_ns_ids != wild_now:
                return None  # the namespace config changed: the expansion differs
            self._upload_buckets(snap)
            if snap.labels is not None and (not self._labels_enabled or self._labels_suspended):
                snap.labels = None  # cached labels ignored when disabled or evicted
            if snap.labels is not None:
                self._place_labels(snap)
        except Exception:
            self._incr("cache_load_failures")
            raise
        self._ov_pack = None
        with self._swap_lock:
            self._snapshot = snap
        if snap.labels is None:
            self._start_label_build(snap)
        self._incr("cache_loads")
        self.maintenance.observe_ms("cache_reload", (time.monotonic() - t0) * 1e3)
        self.last_cache_load = {
            "seconds": time.monotonic() - t0, "bytes": loaded.get("bytes"),
            "path": loaded.get("path"), "watermark": int(snap.snapshot_id),
            "labels": snap.labels is not None,
        }
        _log.info("snapshot cache reloaded: %s", self.last_cache_load)
        return snap

    def _kick_cache_save(self, snap: GraphSnapshot) -> None:
        """Persist an overlay-free snapshot on the supervised ``cache-save``
        worker (a failed pass counts ``cache_save_failures`` and retries);
        kicks coalesce, so only the newest pending snapshot is saved."""
        if self._cache_dir is None or snap.has_overlay:
            return
        self._cache_pending = snap
        self._cache_task.kick()

    def _cache_save_pass(self) -> None:
        """One supervised cache-save pass (the SupervisedTask target)."""
        snap = self._cache_pending
        if snap is None:
            return
        self._save_cache(snap)
        if self._cache_pending is snap:
            self._cache_pending = None

    def _save_cache(self, snap: GraphSnapshot) -> Optional[str]:
        timings: dict = {}
        t0 = time.monotonic()
        with self.build_progress.phase("cache_save"):
            path = snapcache.save_snapshot(
                snap, self._cache_dir, shards=max(1, self._shard_count),
                labels_wait=self._label_build_wait, timings=timings,
            )
        if path is not None:
            self._incr("cache_saves")
            self.maintenance.observe_ms("cache_save", (time.monotonic() - t0) * 1e3)
            if timings:  # empty when this watermark's cache was already there
                self.last_cache_save = {**timings, "path": path,
                                        "watermark": int(snap.snapshot_id)}
        return path

    def save_snapshot_cache(self) -> Optional[str]:
        """Persist the current snapshot at once (its label build joined);
        returns the cache path, or None when there is no cache directory or
        the snapshot is not cacheable (a pending overlay)."""
        if self._cache_dir is None:
            return None
        return self._save_cache(self.snapshot())

    def cache_settled(self, timeout: Optional[float] = None) -> bool:
        """Block until the supervised cache-save worker is idle (tests and
        ``chip_smoke.py``). Returns False on timeout."""
        return self._cache_task.wait_idle(timeout)

    def _take_sort_seconds(self) -> dict:
        """The build sorter's seconds by backend since the last call."""
        if self._build_sorter is None:
            return {"device": 0.0, "host": 0.0}
        return self._build_sorter.take_seconds()

    def _overlay_edge_count(self, snap: GraphSnapshot) -> int:
        """Overlay occupancy: pending delta edges plus tombstones (what the
        budget compares)."""
        n = 0
        if snap.ov_ell is not None:
            n += int(snap.ov_ell.shape[0])
        if snap.ov_removed is not None:
            n += int(snap.ov_removed.size)
        if snap.ov_out:
            n += sum(int(np.asarray(v).size) for v in snap.ov_out.values())
        if snap.ov_sink_in:
            n += sum(int(np.asarray(v).size) for v in snap.ov_sink_in.values())
        return n

    def _try_delta(self, base: GraphSnapshot, wild_ns_ids) -> Optional[GraphSnapshot]:
        """Apply the watermark advance as an overlay. None when the store
        cannot produce a delta (its logs no longer reach back), the delta
        needs a class change, or the overlay would pass the hard cap."""
        got = self._read_store(self._store.changes_since, base.snapshot_id)
        if got is None:
            return None
        ops, new_wm = got
        n_ov = len(ops) + (base.ov_ell.shape[0] if base.ov_ell is not None else 0)
        if base.ov_removed is not None:
            n_ov += int(base.ov_removed.size)
        # hard cap: past it a delta's merge costs more than a rebuild; the
        # budget below it is a fold trigger, not a bail
        if n_ov > max(4 * self._max_overlay_edges, 65536):
            return None
        got = apply_delta(base, ops, new_wm, wild_ns_ids)
        if got is not None:
            self._pending_seg = (int(base.snapshot_id), int(new_wm), list(ops))
        return got

    def _compact_locked(self, snap: GraphSnapshot) -> Optional[GraphSnapshot]:
        """Fold ``snap``'s overlay into its base layout (caller holds the
        refresh lock). Only the touched buckets re-upload; everything else
        is reused. None when the overlay needs a full rebuild."""
        t0 = time.monotonic()
        self._ov_pack = None  # the compacted snapshot starts a new overlay
        # pending bucket patches first: untouched device buckets are reused,
        # which is sound only when they agree with the host arrays
        self._apply_ell_patch(snap)
        self._take_sort_seconds()
        got = compact_snapshot(snap, sorter=self._build_sorter, label_patcher=self._label_patcher)
        sort_s = self._take_sort_seconds()
        if got is None:
            return None
        new = got.snapshot
        g = snap.device
        if g is None:
            # the sharded mode re-partitions the compacted layout in full
            self._upload_buckets(new)
        else:
            # old and new copies of every touched bucket are co-resident
            # while batches in flight gather the old ones: plan the
            # re-upload like any other swap before placing it
            self._plan_or_refuse("compaction bucket re-upload", got.touched_bytes)
            bufs = list(g.buckets)
            for bi in got.touched_buckets:
                bufs[bi] = self._guard_alloc(
                    "compaction-upload",
                    lambda b=new.buckets[bi]: host_tensor(b.nbrs, np.int32, self.device),
                )
            new.device = dataclasses.replace(g, buckets=tuple(bufs), num_live=new.num_live)
            self.hbm.register("snapshot", sum(int(t.nbytes) for t in bufs))
        if got.labels == "patched":
            self._incr("label_patches")
            self.maintenance.observe_ms("label_patch", new.labels.build_ms)
        elif got.labels == "patch_abort":
            self._incr("label_patch_aborts")
            self._incr("label_rebuilds")
        elif got.labels == "rebuild":
            self._incr("label_rebuilds")
        if self._labels_enabled and not self._labels_suspended and new.labels is None:
            # as the reference's _ensure_labels: the fold (a background pass)
            # builds the index its compacted base needs before installing
            new.labels = self._build_label_index(new)
            self._incr("label_builds")
            self.maintenance.observe_ms("label_build", new.labels.build_ms)
        if new.labels is not None and self._labels_dev(new) is None:
            self._place_labels(new)
        self._incr("compactions")
        self.maintenance.observe_ms("compaction", (time.monotonic() - t0) * 1e3)
        self.last_compaction = {
            "seconds": time.monotonic() - t0,
            "labels": got.labels,
            "label_ms": new.labels.build_ms if new.labels is not None else None,
            "touched_buckets": len(got.touched_buckets),
            "touched_bytes": got.touched_bytes,
            "sort_s": sort_s,
        }
        _log.info("overlay compacted: %s", self.last_compaction)
        return new

    def _fold_locked(self, snap: GraphSnapshot, full: bool = False) -> Optional[GraphSnapshot]:
        """Log-structured fold (caller holds the refresh lock): replay the
        OLDEST delta segments onto the last overlay-free base, compact just
        those, then re-apply the rest — a pass costs about
        ``fold_segment_edges`` of work however large the overlay grew. With
        ``full`` every segment folds. Returns the refreshed snapshot (which
        may still carry the newest segments' overlay), or None when the
        shape needs a full rebuild."""
        t0 = time.monotonic()
        fb, log = self._fold_base, self._seg_log
        # continuity: the log must replay fb → snap exactly; otherwise fold
        # everything at once
        intact = (
            fb is not None
            and log
            and log[0][0] == fb.snapshot_id
            and log[-1][1] == snap.snapshot_id
            and all(log[i][1] == log[i + 1][0] for i in range(len(log) - 1))
        )
        if not intact:
            got = self._compact_locked(snap)
            if got is not None and not got.has_overlay:
                self._fold_base, self._seg_log = got, []
            return got
        if full:
            take = len(log)
        else:
            take, tot = 0, 0
            while take < len(log) and (
                take == 0 or tot + len(log[take][2]) <= self._fold_segment_edges
            ):
                tot += len(log[take][2])
                take += 1
        prefix, rest = log[:take], log[take:]
        wild_ns_ids = frozenset(n.id for n in self._nm().namespaces() if n.name == "")
        mid = fb
        for _base_id, seg_wm, ops in prefix:
            mid = apply_delta(mid, ops, seg_wm, wild_ns_ids)
            if mid is None:
                return None
            # flush each segment's bucket patches before stacking the next
            # (apply_delta replaces ell_patch, it does not extend it)
            self._apply_ell_patch(mid)
        new_base = self._compact_locked(mid) if mid.has_overlay else mid
        if new_base is None or new_base.has_overlay:
            return None
        cur = new_base
        for _base_id, seg_wm, ops in rest:
            cur = apply_delta(cur, ops, seg_wm, wild_ns_ids)
            if cur is None:
                return None
            self._apply_ell_patch(cur)
        self._fold_base, self._seg_log = new_base, rest
        self._ov_pack = None  # a new lineage: the upload below re-packs
        self._incr("fold_runs")
        self.maintenance.observe_ms("fold", (time.monotonic() - t0) * 1e3)
        _log.info("overlay fold: %d/%d segments folded (%d remain)", take, len(log), len(rest))
        return cur

    # -- device patches (K9) ---------------------------------------------------

    def _apply_ell_patch(self, snap: GraphSnapshot) -> None:
        """Apply a delta's pending bucket-slot patches (tombstoned or
        restored iterated edges) with K9 on copies of the touched buckets,
        installed on ``snap`` alone: the base snapshot's tensors are
        untouched, so batches in flight keep gathering the old state."""
        patch = snap.ell_patch
        snap.ell_patch = None
        if self._sharded:
            if patch and snap.device_shards is not None:
                self._apply_ell_patch_sharded(snap, patch)
            return
        g = snap.device
        if not patch or g is None:
            return
        by_bucket: dict[int, list] = {}
        for bi, row, col, val in patch:
            by_bucket.setdefault(bi, []).append((row, col, val))
        bufs = list(g.buckets)
        targets = []
        for bi, entries in by_bucket.items():
            e = np.asarray(entries, np.int64)
            targets.append((bufs[bi], e[:, 0], e[:, 1], e[:, 2]))
        outs = self._guard_alloc("ell-patch", lambda: kernels.slot_set_many(targets))
        for bi, out in zip(by_bucket, outs):
            bufs[bi] = out
        snap.device = dataclasses.replace(g, buckets=tuple(bufs))

    def _apply_ell_patch_sharded(self, snap: GraphSnapshot, patch) -> None:
        """Sharded mode (tpu_engine.py:2578-2600): route each patched slot to
        its owning shard's row of the stacked bucket array (``patch_pos``),
        update the host stacked array in place (the upload truth, as the
        reference keeps it) and apply the slots with K9 on a copy of the
        touched stacks, so batches in flight keep gathering the old ones."""
        spec = snap.shard_spec
        by_bucket: dict[int, list] = {}
        for bi, row, col, val in patch:
            s, pos = spec.patch_pos(snap.buckets[bi].offset, bi, row)
            by_bucket.setdefault(bi, []).append((s, pos, col, val))
        dev = snap.device_shards
        bufs = list(dev.nbrs)
        targets = []
        for bi, entries in by_bucket.items():
            e = np.asarray(entries, np.int64)
            spec.nbrs_sh[bi][e[:, 0], e[:, 1], e[:, 2]] = e[:, 3]
            g, rb, cap = bufs[bi].shape
            targets.append((bufs[bi].view(g * rb, cap), e[:, 0] * rb + e[:, 1], e[:, 2], e[:, 3]))
        outs = self._guard_alloc("ell-patch", lambda: kernels.slot_set_many(targets))
        for bi, flat in zip(by_bucket, outs):
            bufs[bi] = flat.view(bufs[bi].shape)
        snap.device_shards = dataclasses.replace(dev, nbrs=tuple(bufs))

    def _upload_buckets(self, snap: GraphSnapshot) -> None:
        """Place the snapshot's buckets on the device (tpu_engine.py:
        2618-2663): one tensor per bucket, or in sharded mode the stacked
        per-shard arrays of a fresh row-range partitioning, their owned
        bytes in the per-shard ledger. Planned BEFORE the upload: during a
        swap the old snapshot's buckets are still resident."""
        if not self._sharded:
            arrays, meta = snapshot_arrays(snap)
            self._plan_or_refuse("snapshot buckets", sum(4 * int(a.size) for a in arrays))
            snap.device = self._guard_alloc(
                "snapshot-upload", lambda: device_graph_from_arrays(arrays, meta, self.device))
            self.hbm.register("snapshot", sum(int(t.nbytes) for t in snap.device.buckets))
            return
        spec = shard_mod.make_shard_spec(snap, self._shard_count)
        self._plan_or_refuse("snapshot buckets", spec.padded_bucket_bytes(),
                             per_shard=spec.owned_bucket_bytes)
        snap.shard_spec = spec
        snap.device_shards = self._guard_alloc(
            "snapshot-upload", lambda: shard_mod.ShardedBuckets.from_spec(spec, self.device))
        self.hbm.register("snapshot", spec.padded_bucket_bytes())
        self.hbm.register_shards("snapshot", spec.owned_bucket_bytes)

    def _apply_overlay_delta(self, snap: GraphSnapshot, delta) -> bool:
        """Scatter one delta's added and dropped overlay-ELL edges into the
        resident gather matrix with K9, on copies (the base snapshot's
        tensors stay untouched). True when the delta landed; False when it
        cannot (no resident pack, another lineage, capacity outgrown) and
        the caller re-packs. Holes are the ``num_int`` sentinel (an all-zero
        row), pad rows have ``dst = num_active``."""
        pack = self._ov_pack
        if pack is None or delta is None:
            return False
        base_id, added, dropped = delta
        if pack["snap_id"] != base_id:
            return False
        nbrs, dst = pack["nbrs"], pack["dst"]
        K, C = nbrs.shape
        slot, row_of, fill = pack["slot"], pack["row_of"], pack["fill"]
        rows: list = []
        cols: list = []
        vals: list = []
        drows: list = []
        dvals: list = []
        num_int = snap.num_int
        # the host mirror moves from here on: any bail or error below must
        # drop it, so the next upload re-packs
        for s, d in dropped:
            rc = slot.pop((s, d), None)
            if rc is None:
                self._ov_pack = None
                return False
            r, c = rc
            nbrs[r, c] = num_int
            rows.append(r)
            cols.append(c)
            vals.append(num_int)
        for s, d in added:
            r = row_of.get(d)
            if r is None:
                r = pack["rows_used"]
                if r >= K:
                    self._ov_pack = None
                    return False  # destination rows outgrew the capacity
                pack["rows_used"] = r + 1
                row_of[d] = r
                fill[r] = 0
                dst[r] = d
                drows.append(r)
                dvals.append(d)
            c = int(fill[r])
            if c >= C:
                self._ov_pack = None
                return False  # a row outgrew its column capacity
            fill[r] = c + 1
            nbrs[r, c] = s
            slot[(s, d)] = (r, c)
            rows.append(r)
            cols.append(c)
            vals.append(s)
        dev_n, dev_d = pack["dev"]
        try:
            targets = ([(dev_n, rows, cols, vals)] if rows else []) + (
                [(dev_d, drows, None, dvals)] if drows else [])
            outs = iter(self._guard_alloc("overlay-apply",
                                          lambda: kernels.slot_set_many(targets)))
            if rows:
                dev_n = next(outs)
            if drows:
                dev_d = next(outs)
        except Exception:
            self._ov_pack = None
            raise
        pack["dev"] = (dev_n, dev_d)
        pack["snap_id"] = int(snap.snapshot_id)
        snap.device_overlay = pack["dev"]
        self.hbm.register("overlay", int(dev_n.nbytes + dev_d.nbytes))
        self._incr("overlay_device_applies")
        return True

    def _upload_overlay(self, snap: GraphSnapshot) -> None:
        """Place the overlay-ELL edges as a ``[K, C]`` gather matrix plus a
        ``[K]`` dst vector (pow2-padded, so later deltas fit the spare
        capacity): a delta that fits the resident pack scatters into it
        (``_apply_overlay_delta``, K9), anything else re-packs and uploads."""
        delta = snap.ov_ell_delta
        snap.ov_ell_delta = None
        if snap.ov_ell is None or snap.ov_ell.shape[0] == 0:
            self._ov_pack = None
            snap.device_overlay = None
            snap.device_shard_overlay = None
            self.hbm.register("overlay", 0)
            if self._sharded:
                self.hbm.register_shards("overlay", [0] * self._shard_count)
            return
        if not self._sharded and self._apply_overlay_delta(snap, delta):
            return
        self._plan_or_refuse("overlay ELL", overlay_device_bytes(snap))
        src = snap.ov_ell[:, 0]
        dst = snap.ov_ell[:, 1]
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        uniq, starts = np.unique(dst, return_index=True)
        counts = np.diff(np.append(starts, dst.shape[0]))
        C = _ceil_pow2(int(counts.max()))
        if self._sharded:
            # route every overlay row to the shard owning its destination
            # (tpu_engine.py:2790-2811), re-routed in full on every delta
            self._ov_pack = None
            nbrs = np.full((uniq.shape[0], C), snap.num_int, np.int32)
            for i, (s0, c) in enumerate(zip(starts, counts)):
                nbrs[i, :c] = src[s0 : s0 + c]
            ovn, ovd, owned = shard_mod.route_overlay(snap.shard_spec, nbrs, uniq,
                                                      snap.num_active)
            snap.device_overlay = None
            snap.device_shard_overlay = self._guard_alloc(
                "overlay-upload", lambda: (torch.from_numpy(ovn).to(self.device),
                                           torch.from_numpy(ovd).to(self.device)))
            self.hbm.register("overlay", int(ovn.nbytes + ovd.nbytes))
            self.hbm.register_shards("overlay", owned)
            return
        K = _ceil_pow2(uniq.shape[0])
        nbrs = np.full((K, C), snap.num_int, np.int32)  # the all-zero bitmap row
        for i, (s0, c) in enumerate(zip(starts, counts)):
            nbrs[i, :c] = src[s0 : s0 + c]
        dst_pad = np.full(K, snap.num_active, np.int32)  # pad rows: masked
        dst_pad[: uniq.shape[0]] = uniq
        snap.device_overlay = self._guard_alloc("overlay-upload", lambda: (
            torch.from_numpy(nbrs.copy()).to(self.device),
            torch.from_numpy(dst_pad.copy()).to(self.device),
        ))
        self.hbm.register("overlay", int(nbrs.nbytes + dst_pad.nbytes))
        fill = np.zeros(K, np.int64)
        fill[: counts.shape[0]] = counts
        self._ov_pack = {
            "snap_id": int(snap.snapshot_id),
            "nbrs": nbrs,
            "dst": dst_pad,
            "dev": snap.device_overlay,
            "row_of": {int(d): i for i, d in enumerate(uniq)},
            "fill": fill,
            "rows_used": int(uniq.shape[0]),
            "slot": {
                (int(src[s0 + j]), int(uniq[i])): (i, j)
                for i, (s0, c) in enumerate(zip(starts, counts))
                for j in range(int(c))
            },
        }

    # -- counters ------------------------------------------------------------

    def _incr(self, name: str, by: int = 1) -> None:
        self.maintenance.incr(name, by)

    def counters(self) -> dict:
        """The route and maintenance counters since construction (see
        ``maintenance`` in ``__init__``): a view over its counters."""
        out = self.maintenance.raw()[0]
        for name in ("audit_checks", "audit_mismatches", "audit_skipped_stale"):
            out.setdefault(name, 0)
        return out

    # -- the shadow audit (tpu_engine.py:1816-1900) ----------------------------

    def _audit_sample(self, tuples, decisions, token: Optional[int]) -> None:
        """Queue a random ``audit_sample_rate`` sample of live decisions for
        the background re-check (never on the serving path)."""
        rate = self.audit_sample_rate
        if rate <= 0.0 or token is None:
            return
        rng = self._audit_rng
        picked = False
        for i, rt in enumerate(tuples):
            if rng.random() < rate:
                self._audit_pending.append((rt, bool(decisions[i]), token))
                picked = True
        if picked:
            self._audit_task.kick()

    def _audit_oracle_check(self, rt: RelationTuple) -> bool:
        """The CPU oracle's decision over the live store."""
        if self._audit_oracle is None:
            from keto_tpu_torch.check.engine import CheckEngine

            self._audit_oracle = CheckEngine(self._store)
        return self._audit_oracle.subject_is_allowed(rt)

    def _audit_pass(self) -> None:
        """One supervised audit pass: drain the sample queue and re-check
        each decision on the oracle. A sample whose snaptoken no longer
        equals the store's watermark is skipped (the oracle reads the live
        store: comparing across a write would fabricate a divergence)."""
        while True:
            try:
                rt, decision, token = self._audit_pending.popleft()
            except IndexError:
                return
            try:
                wm = self._store.watermark()
            except Exception:
                continue  # the store is unreadable: the refresh path raises that
            if wm != token:
                self._incr("audit_skipped_stale")
                continue
            got = self._audit_oracle_check(rt)
            self._incr("audit_checks")
            if got != decision:
                self._incr("audit_mismatches")
                self._note_audit_divergence(rt, decision, got, token)
                _log.error(
                    "shadow-parity audit MISMATCH: %r decided %s on the device, %s on the "
                    "CPU oracle (snaptoken %d)", rt, decision, got, token,
                )

    def _note_audit_divergence(self, rt: RelationTuple, device: bool, oracle: bool,
                               token: int) -> None:
        """Keep the evidence of one divergence: the store's shortest witness
        (what the device route should have found) beside the oracle's own
        traversal (keto_tpu_torch/explain/witness.py)."""
        try:
            from keto_tpu_torch.explain.witness import build_witness, oracle_witness

            _, dev_path, certificate = build_witness(self._store, rt)
            orc_path = oracle_witness(self._store, rt)
            self.audit_divergences.append({
                "tuple": str(rt),
                "device_decision": device,
                "oracle_decision": oracle,
                "snaptoken": token,
                "device_witness": [str(t) for t in dev_path] if dev_path else None,
                "oracle_witness": [str(t) for t in orc_path] if orc_path else None,
                "certificate": certificate,
            })
        except Exception:
            # the evidence is best-effort: the counter above already raised
            # the alarm
            _log.warning("could not capture the audit divergence's witnesses", exc_info=True)

    def audit_settled(self, timeout: Optional[float] = None) -> bool:
        """Block until the audit worker has re-checked every queued sample;
        False on timeout. Tests and ``chip_smoke.py`` use it."""
        return self._audit_task.wait_idle(timeout)

    # -- 2-hop labels (keto_tpu_torch/graph/labels.py) -------------------------

    #: landmark auto-cap of the HOST build: with ``labels_landmarks == 0``
    #: it processes min(num_int, this) nodes; the device build has no cap
    LABELS_AUTO_CAP = 131072

    def _interior_ell_slots(self, snap: GraphSnapshot) -> int:
        """Padded interior ELL edge slots — the size signal the device-build
        gate compares against ``labels_device_min_edges``."""
        return sum(int(b.n) * int(np.asarray(b.nbrs).shape[1]) for b in snap.buckets)

    def _build_label_index(self, snap: GraphSnapshot):
        """Construct the 2-hop index for ``snap``. On the device (batched
        sweeps, no landmark cap; ``labels_min_gain`` bounds the build) once
        the graph has ``labels_device_min_edges`` interior ELL slots, its
        transient planned against the governor with ``evict=False`` and
        registered under ``build`` while it runs (tpu_engine.py:2945-2995);
        on the host (per-landmark BFS, ``LABELS_AUTO_CAP``) below that,
        with ``labels_device_build=False``, or when the governor refuses
        the transient (counted in ``label_device_build_skipped``: a build
        never pushes serving state off the card) — never after a device
        error, which propagates. Entry-identical either way."""
        n = snap.num_int
        landmarks = self._labels_landmarks
        if (
            self._labels_device_build
            and n > 0
            and self._interior_ell_slots(snap) >= self._labels_device_min_edges
        ):
            need = label_build.estimate_build_bytes(n, self._labels_max_width, self._labels_batch)
            self.label_build_bytes = need
            if not self.hbm.plan(need, what="label build transient", evict=False):
                self._incr("label_device_build_skipped")
            else:
                _log.info("device label build: %d interior rows, ~%d transient device bytes",
                          n, need)
                self.hbm.register("build", need)
                try:
                    idx, info = label_build.device_build_labels(
                        snap,
                        max_width=self._labels_max_width,
                        landmarks=landmarks,
                        min_gain=self._labels_min_gain,
                        batch=self._labels_batch,
                        device=self.device,
                        mesh=self._mesh,
                        shard_count=self._shard_count,
                        progress_cb=self._label_build_progress,
                    )
                finally:
                    self.hbm.release("build")
                self.label_build_info = info
                self._incr("label_device_builds")
                self.maintenance.observe_ms("label_build_device", idx.build_ms)
                self.maintenance.set_gauge("label_build_batches", info.batches)
                if info.truncated:
                    self._note_label_truncation(info.truncated, idx)
                return idx
        if landmarks == 0:
            landmarks = min(n, self.LABELS_AUTO_CAP)
        idx = build_labels(snap, max_width=self._labels_max_width, landmarks=landmarks)
        if landmarks < n:
            self._note_label_truncation("cap", idx)
        return idx

    def _label_build_progress(self, done: int, total: int, entries: int) -> None:
        """The device build's progress after each batch, as gauges."""
        self.maintenance.set_gauge("label_build_landmarks", done)
        self.maintenance.set_gauge("label_build_landmarks_total", total)
        self.maintenance.set_gauge("label_build_entries", entries)

    def _note_label_truncation(self, reason: str, idx) -> None:
        """Count a truncated build by reason (``cap`` or ``min_gain``) and
        log the coverage it reached."""
        self._incr(f"label_build_truncated_{reason}")
        _log.warning(
            "label build truncated (%s): %d/%d landmarks processed, coverage_ratio=%.4f — "
            "uncovered deep checks fall back to the BFS kernels",
            reason, idx.n_landmarks, idx.n, idx.coverage,
        )

    def _start_label_build(self, snap: GraphSnapshot) -> None:
        """Kick the label construction for ``snap`` on a background thread;
        the engine serves ``snap`` on the BFS route until the index installs
        under the install lock. The thread launches on its own current stream (the
        default stream, as serving does), so its kernels and serving's
        serialise on the card. A failure is kept on the engine and raised
        by the next check and by ``labels_settled()``. Nothing starts
        while the governor's labels rung is evicted."""
        if not self._labels_enabled or self._labels_suspended:
            return
        self._label_build_error = None

        def work():
            try:
                with self.build_progress.phase("labels"):
                    idx = self._build_label_index(snap)
            except Exception as e:  # kept on the engine and raised by the next check
                _log.error("background label build failed", exc_info=True)
                self._incr("label_build_failures")
                if self._label_build_thread is threading.current_thread():
                    self._label_build_error = e
                return
            with self._swap_lock:
                self._install_labels_locked(snap, idx)

        t = threading.Thread(target=work, name="label-build", daemon=True)
        self._label_build_thread = t
        t.start()

    def _install_labels_locked(self, snap: GraphSnapshot, idx) -> None:
        """Land a background-built index (caller holds the install lock) on
        the snapshot it was built for, and upload it only while that
        snapshot is the one being served: a fold or a rebuild makes a new
        snapshot object, which gets its own index (patched or built), and an
        index never serves another snapshot's edges. An index that lands
        while the labels rung is evicted is dropped."""
        if self._labels_suspended:
            return
        snap.labels = idx
        self._incr("label_builds")
        self.maintenance.observe_ms("label_build", idx.build_ms)
        if self._snapshot is snap:
            self._place_labels(snap)

    def _restart_label_build(self, snap: GraphSnapshot) -> None:
        """Build the index again for the serving snapshot once the labels
        rung has restored (the background pass calls this): not while a
        build runs, nor while a failed build's error waits for a caller."""
        t = self._label_build_thread
        if (t is not None and t.is_alive()) or self._label_build_error is not None:
            return
        self._start_label_build(snap)

    def _place_labels(self, snap: GraphSnapshot) -> None:
        """Plan, then upload the label arrays (tpu_engine.py:2884-2905). A
        plan the ladder cannot meet, or one that evicted the labels rung
        itself, drops the fresh index (the BFS route answers); so does an
        upload whose own OOM retry evicted the labels rung."""
        need = snap.labels.device_bytes()
        self._last_label_bytes = max(self._last_label_bytes, need)
        if not self.hbm.plan(need, what="label arrays") or self._labels_suspended:
            snap.labels = None
            snap.device_labels = None
            snap.device_shard_labels = None
            return
        self._upload_labels(snap)
        if self._labels_suspended:
            snap.labels = None
            snap.device_labels = None
            snap.device_shard_labels = None
            self.hbm.release("labels")
            return
        idx = snap.labels
        self.maintenance.set_gauge("label_coverage", round(idx.coverage, 4))
        self.maintenance.set_gauge("label_entries", idx.n_entries)

    def _label_build_wait(self) -> None:
        """Join the in-flight background label build."""
        t = self._label_build_thread
        if t is not None and t.is_alive():
            t.join()

    def _raise_errors(self) -> None:
        """Raise a background failure: the label build's (until a new build
        starts) or the refresh pass's (once, to the next caller)."""
        err = self._label_build_error
        if err is not None:
            raise RuntimeError("the label build failed") from err
        err, self._maintenance_error = self._maintenance_error, None
        if err is not None:
            raise RuntimeError("the background refresh failed") from err

    def labels_settled(self) -> bool:
        """Force the snapshot refresh and block until its label build has
        installed; raises the build's error if it failed. Returns whether
        the serving snapshot carries an index."""
        self.snapshot()
        self._label_build_wait()
        self._raise_errors()
        snap = self._snapshot
        return snap is not None and snap.labels is not None

    def _upload_labels(self, snap: GraphSnapshot) -> None:
        """Place the label arrays on the device: the pair, or in sharded mode
        (tpu_engine.py:3142-3160) row stripes per shard, each padded with
        its side's own pad."""
        idx = snap.labels
        out_lab = idx.out_lab
        in_lab = idx.in_lab
        if self._sharded:
            out_sh, in_sh, rl, owned = shard_mod.route_labels(out_lab, in_lab, self._shard_count)
            snap.device_labels = None
            snap.device_shard_labels = self._guard_alloc(
                "labels-upload", lambda: (torch.from_numpy(out_sh).to(self.device),
                                          torch.from_numpy(in_sh).to(self.device), rl))
            self.hbm.register("labels", int(out_sh.nbytes + in_sh.nbytes))
            self.hbm.register_shards("labels", owned)
            return
        snap.device_labels = self._guard_alloc(
            "labels-upload",
            lambda: tuple(host_tensor(a, np.int32, self.device) for a in (out_lab, in_lab)))
        self.hbm.register("labels", sum(int(t.nbytes) for t in snap.device_labels))

    def _labels_dev(self, snap: GraphSnapshot):
        """The device label arrays this engine's mode reads: the row
        stripes when sharded, else the pair."""
        return snap.device_shard_labels if self._sharded else snap.device_labels

    def _labels_usable(self, snap: GraphSnapshot) -> bool:
        """Route checks through the label index on this snapshot? Not while
        a pending overlay has mutated the interior subgraph (``lab_dirty``):
        stale labels would deny wrongly. Counted once per blocked snapshot
        as a ``label_invalidations`` event (tpu_engine.py:3182)."""
        if not self._labels_enabled or snap.labels is None:
            return False
        if snap.lab_dirty:
            with self._counter_lock:
                if self._label_blocked_snap != snap.snapshot_id:
                    self._label_blocked_snap = snap.snapshot_id
                    self._incr("label_invalidations")
                    self.maintenance.set_gauge("label_dirty_nodes", len(snap.lab_dirty))
            return False
        self.maintenance.set_gauge("label_dirty_nodes", 0)
        return self._labels_dev(snap) is not None

    def _label_patcher(self, idx, snap, added_edges, visit_budget: int = 65536):
        """Compaction's incremental label patch (tpu_engine.py:3101): on the
        device sweeps (``device_patch_labels``, K6 without expansion
        pruning) past ``labels_device_min_edges`` interior ELL slots, on the
        host walk below. A failed device patch raises (counted); it is not
        retried on the host. None means the patch aborted: rebuild."""
        if self._labels_device_build and self._interior_ell_slots(snap) >= self._labels_device_min_edges:
            try:
                return label_build.device_patch_labels(
                    idx, snap, added_edges, visit_budget=visit_budget,
                    batch=self._labels_batch, device=self.device,
                    mesh=self._mesh, shard_count=self._shard_count,
                )
            except Exception:
                self._incr("label_patch_failures")
                raise
        return patch_labels(idx, snap, added_edges, visit_budget=visit_budget)

    # -- resolution ----------------------------------------------------------

    def _ns_resolver(self):
        """Per-batch namespace-name → id resolver with a cache: ``None`` =
        unknown (→ denied, engine.go:76-77), ``WILDCARD`` = empty name."""
        nm = self._nm()
        cache: dict = {}

        def _ns(name: str):
            hit = cache.get(name, _UNSET)
            if hit is not _UNSET:
                return hit
            if name == "":
                r: object = WILDCARD
            else:
                try:
                    r = nm.get_namespace_by_name(name).id
                except ErrNamespaceUnknown:
                    r = None
            cache[name] = r
            return r

        return _ns

    def _subject_target(self, snap: GraphSnapshot, rt: RelationTuple, ns_of):
        """Resolve a query's subject to its target device row: the id, -1
        when no such node exists (target unreachable), or ``None`` when the
        subject itself forces a deny (nil subject, unknown subject
        namespace)."""
        sub = rt.subject
        if type(sub) is SubjectID:
            dev = snap.resolve_leaf(sub.id)
            return -1 if dev is None else dev
        if isinstance(sub, SubjectSet):
            sns_id = ns_of(sub.namespace)
            if sns_id is None:
                return None
            if sns_id == WILDCARD:
                # subjects are matched literally; an empty subject
                # namespace can only equal a stored subject in a
                # namespace named ""
                wild_list = list(snap.wild_ns_ids)
                if not wild_list:
                    return -1
                sns_id = wild_list[0]
            dev = snap.resolve_set(sns_id, sub.object, sub.relation)
            return -1 if dev is None else dev
        return None  # nil subject → denied

    def _resolve_specials(self, snap, tuples, indices, sd, tg, multi):
        """Wildcard/pattern queries, resolved in bulk through the snapshot's
        family-grouped sorted indexes (``resolve_starts_bulk``); subjects
        literally. Results splice into the caller's bulk arrays."""
        _ns = self._ns_resolver()
        live: list[int] = []
        pats: list[tuple] = []
        for i in indices:
            rt = tuples[i]
            ns_id = _ns(rt.namespace)
            if ns_id is None:
                continue  # unknown namespace → denied
            live.append(i)
            pats.append((ns_id, rt.object, rt.relation))
        if not live:
            return
        starts_l = snap.resolve_starts_bulk(pats)
        ni = snap.num_int
        sbase = snap.sink_base
        nl = snap.num_live
        for i, starts in zip(live, starts_l):
            if starts.size == 0:
                continue  # no matching start node → denied
            t = self._subject_target(snap, tuples[i], _ns)
            if t is None:
                continue  # nil subject / unknown subject namespace → denied
            if 0 <= t < nl or (t >= nl and snap.is_answerable_target(t)):
                tg[i] = t
            sd[i] = -2
            # interior starts seed the bitmap; sink starts (no out-edges)
            # contribute nothing; peeled/static starts are host-propagated
            # at pack time (pack_chunk)
            multi[i] = (
                starts[starts < ni],
                starts[((starts >= ni) & (starts < sbase)) | (starts >= nl)],
            )

    def _resolve_bulk(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple]
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Resolve every query to device rows (see ``_resolve_bulk_py`` for
        the result contract; tpu_engine.py:3301). Literal queries go through
        the C++ intern tables in one bulk call; wildcard/pattern queries,
        and every query of a batch whose strings hold a separator byte or
        of a snapshot interned in Python, take the host loop. Each batch
        counts its path (``resolve_native_batches``,
        ``resolve_python_batches``)."""
        if hasattr(snap.interned, "resolve_queries"):
            got = self._resolve_bulk_native(snap, tuples)
            if got is not None:
                self._incr("resolve_native_batches")
                return got
        self._incr("resolve_python_batches")
        return self._resolve_bulk_py(snap, tuples)

    def _resolve_bulk_native(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple]
    ):
        """Pack literal queries into the native wire format and resolve them
        in one C++ pass (tpu_engine.py:3315-3448); route the rest through
        the per-query Python path. Returns None when the buffer framing is
        unsafe (separator bytes in strings): the caller takes the host
        loop."""
        n = len(tuples)
        nl = snap.num_live
        wild_ids = snap.wild_ns_ids
        nm = self._nm()
        ns_cache: dict = {}

        def _ns_bytes(name: str):
            """namespace name → decimal-ASCII id bytes, _WILD, or None."""
            hit = ns_cache.get(name, _UNSET)
            if hit is not _UNSET:
                return hit
            if name == "":
                r: object = _WILD
            else:
                try:
                    ns_id = nm.get_namespace_by_name(name).id
                    r = _WILD if ns_id in wild_ids else b"%d" % ns_id
                except ErrNamespaceUnknown:
                    r = None
            ns_cache[name] = r
            return r

        parts: list[bytes] = []
        ap = parts.append
        special: list[int] = []
        dead: list[int] = []  # guaranteed denies; placeholder results ignored
        # queries whose start resolves normally but whose subject cannot
        # exist (an empty-namespace subject set with no "" namespace
        # configured): the placeholder subject may collide with a real
        # node, so tg is forced unreachable after the bulk resolve
        no_target: list[int] = []
        for i, rt in enumerate(tuples):
            ns = _ns_bytes(rt.namespace)
            if ns is None:
                dead.append(i)  # unknown namespace → denied
                ap(_PLACEHOLDER)
                continue
            obj, rel = rt.object, rt.relation
            if ns is _WILD or obj == "" or rel == "":
                special.append(i)  # wildcard pattern → host resolver
                ap(_PLACEHOLDER)
                continue
            sub = rt.subject
            if type(sub) is SubjectID:
                ap(b"%b\x1f%b\x1f%b\x1f1\x1f%b\x1f\x1f\x1e"
                   % (ns, obj.encode(), rel.encode(), sub.id.encode()))
            elif isinstance(sub, SubjectSet):
                sns = _ns_bytes(sub.namespace)
                if sns is None:
                    dead.append(i)  # unknown subject namespace → denied
                    ap(_PLACEHOLDER)
                    continue
                if sns is _WILD:
                    # subjects match literally (_subject_target): an empty
                    # subject namespace can only equal a stored subject in
                    # a namespace named "", so resolve against that
                    # namespace's id
                    wild_list = list(wild_ids)
                    if not wild_list:
                        # no namespace named "": the target cannot exist —
                        # resolve the start normally, force tg = -1
                        no_target.append(i)
                        ap(b"%b\x1f%b\x1f%b\x1f1\x1f\x1f\x1f\x1e"
                           % (ns, obj.encode(), rel.encode()))
                        continue
                    sns = b"%d" % wild_list[0]
                ap(b"%b\x1f%b\x1f%b\x1f0\x1f%b\x1f%b\x1f%b\x1e"
                   % (ns, obj.encode(), rel.encode(), sns,
                      sub.object.encode(), sub.relation.encode()))
            else:
                dead.append(i)  # nil subject → denied
                ap(_PLACEHOLDER)
        buf = b"".join(parts)
        # separator bytes inside strings corrupt framing — detectable as a
        # field-count mismatch, the same check as the interner's
        if buf.count(b"\x1f") != 6 * n or buf.count(b"\x1e") != n:
            return None
        got = snap.interned.resolve_queries(buf, n)
        if got is None:
            return None
        start_raw, sub_raw = got
        r2d = snap.raw2dev
        sd = np.where(start_raw >= 0, r2d[np.clip(start_raw, 0, None)], -1)
        t = r2d[np.clip(sub_raw, 0, None)]
        # a target only matters when the query has starts (as the host
        # loop, which leaves tg unreachable for start-less denies)
        tg = np.where((sub_raw >= 0) & (t < nl) & (sd >= 0), t, -1)
        if dead:
            # placeholder records may coincide with real nodes — force deny
            di = np.asarray(dead)
            sd[di] = -1
            tg[di] = -1
        if no_target:
            tg[np.asarray(no_target)] = -1
        multi: dict = {}
        if special:
            self._resolve_specials(snap, tuples, special, sd, tg, multi)
        if snap.ov_set_ids or snap.ov_leaf_ids or getattr(snap.interned, "has_ext", False):
            # nodes created since the base build — overlay nodes, or
            # fold-extension nodes (interner.ExtendedInterned) — are not in
            # the resident C++ tables: re-resolve the queries whose start or
            # target missed through the extension-aware host path, in ONE
            # bulk call
            done = set(special) | set(dead)
            miss = [
                int(i)
                for i in np.nonzero((sd == -1) | (tg == -1))[0]
                if int(i) not in done
            ]
            if miss:
                s1, t1, m1 = self._resolve_bulk_py(snap, [tuples[i] for i in miss])
                for j, i in enumerate(miss):
                    sd[i] = s1[j]
                    tg[i] = t1[j]
                    if j in m1:
                        multi[i] = m1[j]
        return sd, tg, multi

    def _resolve_bulk_py(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple]
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """One host pass resolving every query to device rows.

        Returns ``(sd, tg, multi)``: ``sd[i]`` the single start row (``-1``
        no start — a guaranteed deny; ``-2`` multi-start, rows in
        ``multi``), ``tg[i]`` the target row or ``-1`` when unreachable, and
        ``multi`` ``{i: (live start rows, host-propagated start rows)}`` for
        wildcard-pattern queries.
        """
        n = len(tuples)
        nl = snap.num_live
        sd = np.full(n, -1, np.int64)
        tg = np.full(n, -1, np.int64)
        multi: dict = {}
        resolve_set = snap.interned.resolve_set
        raw2dev = snap.raw2dev
        wild_ids = snap.wild_ns_ids
        ov_set = snap.ov_set_ids or {}
        _ns = self._ns_resolver()

        special: list[int] = []
        for i, rt in enumerate(tuples):
            ns_id = _ns(rt.namespace)
            if ns_id is None:
                continue  # unknown namespace → denied (engine.go:76-77)
            obj, rel = rt.object, rt.relation
            if ns_id == WILDCARD or ns_id in wild_ids or obj == "" or rel == "":
                special.append(i)  # wildcard pattern → bulk family resolver
                continue
            raw = resolve_set(ns_id, obj, rel)
            if raw >= 0:
                start_dev = int(raw2dev[raw])
            else:
                start_dev = ov_set.get((ns_id, obj, rel), -1)
                if start_dev < 0:
                    continue
            t = self._subject_target(snap, rt, _ns)
            if t is None:
                continue  # nil subject / unknown subject namespace → denied
            if 0 <= t < nl or (t >= nl and snap.is_answerable_target(t)):
                tg[i] = t
            sd[i] = start_dev
        if special:
            self._resolve_specials(snap, tuples, special, sd, tg, multi)
        return sd, tg, multi

    # -- public API ----------------------------------------------------------

    def batch_check(
        self,
        tuples: Sequence[RelationTuple],
        *,
        at_least: Optional[int] = None,
        mode: str = "latest",
    ) -> list[bool]:
        """Answer every query (see ``batch_check_with_token``)."""
        return self.batch_check_with_token(tuples, at_least=at_least, mode=mode)[0]

    def batch_check_with_token(
        self,
        tuples: Sequence[RelationTuple],
        *,
        at_least: Optional[int] = None,
        mode: str = "latest",
    ) -> tuple[list[bool], int]:
        """Decisions plus the id of the snapshot that produced them (the
        snaptoken). ``mode="latest"`` (the default) is read-your-writes;
        ``at_least=w`` serves any snapshot at or past a write's token;
        ``mode="serving"`` never stalls on a rebuild (``snapshot_serving``)."""
        snap = self._snapshot_for(at_least, mode)
        self._raise_errors()
        if snap.n_nodes == 0 or snap.n_edges == 0 or not tuples:
            return [False] * len(tuples), snap.snapshot_id
        out, max_iters = self._run_exact(snap, tuples)
        self._after_batch(max_iters)
        self._audit_sample(tuples, out, snap.snapshot_id)
        return out.tolist(), snap.snapshot_id

    def subject_is_allowed(self, requested: RelationTuple) -> bool:
        """Single-query convenience with the oracle engine's signature."""
        return self.batch_check([requested])[0]

    def batch_check_stream(
        self,
        tuples_iter,
        *,
        slice_cap: Optional[int] = None,
        at_least: Optional[int] = None,
        mode: str = "latest",
        ordered: bool = True,
    ):
        """Streaming check (tpu_engine.py:3718): consume an iterable of
        tuples and yield decision slices, keeping at most 16 slices in
        flight, so memory stays flat for any stream length.

        - slice widths follow ``stream_ctrl``, narrowed toward its 40 ms
          target when slices run slow and re-widened when they run fast;
          ``slice_cap`` bounds them from above;
        - the host resolves and packs slice k+2 while k+1 runs and k copies
          home, and a slice is unpacked the moment its copy has landed —
          no head-of-line blocking on a straggler;
        - ``ordered=True`` yields ``bool[slice]`` arrays in request order
          through an in-order delivery buffer; ``ordered=False`` yields
          ``(offset, bool[slice])`` as each slice lands, ``offset`` the
          stream index of the slice's first query.

        Per-slice service times land in ``stream_slice_stats``."""
        gen, _ = self.batch_check_stream_with_token(
            tuples_iter, slice_cap=slice_cap, at_least=at_least, mode=mode, ordered=ordered,
        )
        return gen

    def batch_check_stream_with_token(
        self,
        tuples_iter,
        *,
        slice_cap: Optional[int] = None,
        at_least: Optional[int] = None,
        mode: str = "latest",
        ordered: bool = True,
        with_info: bool = False,
    ):
        """``batch_check_stream`` plus the deciding snapshot's id, resolved
        eagerly: returns ``(generator, token)``. ``with_info=True``
        (requires ``ordered=False``) widens each yield to ``(offset,
        decisions, info)``, ``info`` describing the slice that landed:
        ``width`` (queries), ``bfs_steps``, ``route`` (``label`` |
        ``hybrid`` | ``bfs`` | ``host``) and ``service_ms``. A device
        error raises out of the generator; there is no CPU fallback."""
        if with_info and ordered:
            raise ValueError("with_info requires ordered=False")
        snap = self._snapshot_for(at_least, mode)
        self._raise_errors()
        gen = self._stream(snap, tuples_iter, slice_cap=slice_cap, ordered=ordered,
                           with_info=with_info)
        return gen, snap.snapshot_id

    def label_witness_info(
        self, rt: RelationTuple, *, at_least: Optional[int] = None, mode: str = "latest"
    ) -> Optional[dict]:
        """The explain path's enrichment (tpu_engine.py:3803-3867): the
        winning landmark of the 2-hop label intersection for ``rt``'s
        (start, target) pair — the hub the label route's proof went
        through — or None when the pair is not label-resolvable (labels
        off, the index missing or dirtied by a pending overlay, a wildcard
        query, a non-interior endpoint). Reads the device arrays through
        ``label_step_witness`` (K4) with one pair; the host index answers
        only when the labels are not on the device, and on a sharded engine
        (tpu_engine.py:3836: K4 has no sharded form). Unlike the reference,
        a failed K4 launch raises (counted as ``witness_errors``) and is
        never replaced by the host's answer. Only the explain path calls
        this; checks never do."""
        if not self._labels_enabled:
            return None
        snap = self._snapshot_for(at_least, mode)
        idx = snap.labels
        if idx is None or snap.lab_dirty:
            return None
        sd, tg, multi = self._resolve_bulk(snap, [rt])
        if 0 in multi:
            return None  # a wildcard pattern: no single (start, target) pair
        a, b = int(sd[0]), int(tg[0])
        ni = snap.num_int
        if a < 0 or b < 0 or a >= ni or b >= ni:
            return None
        dl = snap.device_labels
        if dl is not None and not self._sharded:
            pair = torch.tensor([[a], [b]], dtype=torch.int32).to(self.device)
            try:
                got = int(kernels.label_step_witness(dl[0], dl[1], pair[0], pair[1])[0])
            except Exception:
                self._incr("witness_errors")
                raise
            lm = got if got >= 0 else None
        else:
            lm = idx.witness_landmark(a, b)
        if lm is None:
            return None
        info: dict = {"kind": "2-hop-label", "pair": [a, b], "landmark_dev": int(lm)}
        kind, key = snap.key_of_dev(int(lm))
        if kind == "set":
            ns_id, obj, rel = key
            name = next((n.name for n in self._nm().namespaces() if n.id == ns_id), "")
            info["landmark"] = f"{name}:{obj}#{rel}"
        else:
            info["landmark"] = str(key)
        return info

    # -- stream statistics ---------------------------------------------------

    def _note_route(self, route: str, nq: int, ms: float) -> None:
        """Record one landed slice's route (label | hybrid | bfs | host)."""
        with self._counter_lock:
            st = self._route_stats.get(route)
            if st is None:
                st = self._route_stats[route] = DurationStats()
            self._route_slices[route] += 1
            self._route_queries[route] += nq
        st.observe(ms)

    def stream_route_snapshot(self) -> dict:
        """Per-route stream breakdown since the last ``reset_route_stats``:
        slice and query counts and service-time percentiles per route."""
        with self._counter_lock:
            routes = list(self._route_stats.items())
            slices, queries = dict(self._route_slices), dict(self._route_queries)
        out = {}
        for route, st in routes:
            snap = st.snapshot()
            out[route] = {
                "slices": int(slices.get(route, 0)),
                "queries": int(queries.get(route, 0)),
                "p50_ms": snap["p50_ms"],
                "p99_ms": snap["p99_ms"],
                "mean_ms": snap["mean_ms"],
            }
        return out

    def route_slice_counts(self) -> dict:
        """route → landed slice count (the ``keto_stream_route_slices_total``
        bridge)."""
        with self._counter_lock:
            return dict(self._route_slices)

    def reset_route_stats(self) -> None:
        """Zero the per-route breakdown."""
        with self._counter_lock:
            self._route_stats.clear()
            self._route_slices.clear()
            self._route_queries.clear()

    def staging_snapshot(self) -> dict:
        """The entry staging pool: bytes, leased buffers, free buffers."""
        return self._staging.snapshot()

    # -- batch execution -----------------------------------------------------

    def _cap_limit(self, snap: GraphSnapshot) -> int:
        """Iteration count that can NEVER truncate: monotone bitmaps reach
        the fixpoint in at most one pull per active row, +1 for the
        convergence observation."""
        return snap.num_active + 1

    def _run_exact(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple], it_cap: Optional[int] = None
    ) -> tuple[np.ndarray, int]:
        """Dispatch + collect with the exactness guarantee: a truncated
        kernel (frontier still growing at it_cap) never decides a query.
        Affected queries re-run with an escalating cap bounded by
        ``_cap_limit`` — the final rung cannot truncate."""
        cap = it_cap or self._it_cap
        out = np.zeros(len(tuples), dtype=bool)
        max_iters = 0
        trunc_idx: list[int] = []
        recs: list = []
        try:
            # every slice is enqueued, its copy home right behind its
            # kernels, before the first one lands
            for rec in self._dispatch_slices(snap, tuples, it_cap=cap):
                if rec[0] is not None:
                    rec[0].copy_to_host_async()
                recs.append(rec)
            pos = 0
            for dev, host_ans, nq, _chunk, leases, _n_ent in recs:
                bits, iters, truncated, _route = self._land_slice(dev, host_ans, nq, leases)
                out[pos : pos + nq] = bits
                max_iters = max(max_iters, iters)
                if truncated:
                    # these queries carry no decision: they re-run below
                    trunc_idx.extend(range(pos, pos + nq))
                pos += nq
        finally:
            for rec in recs:
                self._stage_release(rec[4])
        if trunc_idx:
            limit = self._cap_limit(snap)
            if cap >= limit:
                raise RuntimeError(
                    f"BFS truncated at the fixpoint bound (cap={cap}, "
                    f"active rows={snap.num_active})"
                )
            new_cap = min(max(cap * 8, 8), limit)
            _log.info(
                "check BFS hit it_cap=%d; re-running %d queries exactly at cap=%d",
                cap, len(trunc_idx), new_cap,
            )
            redo, redo_iters = self._run_exact(
                snap, [tuples[i] for i in trunc_idx], it_cap=new_cap
            )
            out[np.asarray(trunc_idx)] = redo
            max_iters = max(max_iters, redo_iters)
        return out, max_iters

    def _slice_cap(self, snap: GraphSnapshot) -> int:
        """Queries per device slice: the widest bitmap the workspace budget
        allows (~3 W-wide int32 bitmaps over interior rows) and the check
        kernels index (a bitmap of under 2^31 words, as ``pull_runs``
        checks)."""
        rows = snap.num_int + 1
        spec = snap.shard_spec  # a sharded bitmap's slabs pad its rows
        index_rows = max(rows, spec.n_shards * spec.rows_per_shard) if spec else rows
        w_cap = next(
            (w for w in reversed(self._word_widths())
             if rows * 12 * w <= self._mem_budget and index_rows * w < kernels.INDEX_LIMIT),
            _WORD_WIDTHS[0],
        )
        return min(self._max_batch, 32 * w_cap)

    def stream_widths(self, snap: GraphSnapshot) -> list:
        """The slice widths (queries, ascending) a slice may take on this
        snapshot: the ladder in service, up to ``_slice_cap``."""
        cap = self._slice_cap(snap)
        return [32 * w for w in self._word_widths() if 32 * w <= cap]

    def _warm_width_bytes(self, snap: GraphSnapshot, B: int) -> int:
        """Device bytes one warmed width holds while its slice runs: the
        BFS workspace (~3 W-wide int32 bitmaps over interior rows, the
        ``_slice_cap`` formula)."""
        return (snap.num_int + 1) * 12 * (B // 32)

    def warm_compile(self) -> int:
        """Run one empty slice a width on the current snapshot's geometry
        (tpu_engine.py:3206-3275): K2's seeds, run and answer (sharded:
        K10a), and K3 (sharded: K10b) when labels are on the device. On
        the card this loads each kernel's module and leaves each width's
        workspace in the caching allocator. A width whose workspace the
        budget cannot hold is SKIPPED (planned with ``evict=False``: warming
        is optional work), counted in ``warm_widths_skipped``;
        ``warmup`` keeps the widest warmed width and the ``warmup`` tag its
        workspace. Returns the number of slices run."""
        snap = self.snapshot()
        if snap.n_nodes == 0 or snap.n_edges == 0:
            return 0
        ni = snap.num_int
        warmed = skipped = warm_bytes = 0
        for B in self.stream_widths(snap):
            need = self._warm_width_bytes(snap, B)
            if not self.hbm.plan(need - warm_bytes, what=f"warm width {B}", evict=False):
                skipped += 1
                continue
            # the empty slice: every entry at its pad, every row a sentinel
            e_rows = np.full(B, ni + 1, np.int32)
            e_q = np.zeros(B, np.int32)
            packed = (e_rows, e_q, e_rows, e_q, np.full(B, ni, np.int32), e_q,
                      np.full(B, ni, np.int32))
            leases: list = []
            try:
                if self._sharded:
                    dev = self._dispatch_sharded(snap, packed, self._it_cap, leases)
                else:
                    buf, sizes = pack_entries(packed)
                    g = snap.device
                    ov = snap.device_overlay or (None, None)
                    dev = _DeviceOut(self._guard_alloc("warm-compile", lambda: kernels.check_step(
                        g.buckets, torch.from_numpy(buf).to(g.device), ov[0], ov[1],
                        sizes=sizes, n_active=g.num_active, n_int=ni, valid_rows=g.valid_rows,
                        it_cap=self._it_cap, block_iters=self._block_iters)))
                dev.words()
            finally:
                self._stage_release(leases)
            warmed += 1
            # one slice runs at a time: the family holds the WIDEST warmed
            # width's workspace, not the sum over widths
            warm_bytes = max(warm_bytes, need)
            self.warmup = max(self.warmup, B)
            self.hbm.register("warmup", warm_bytes)
            if self._labels_usable(snap):
                pairs = np.concatenate([np.full(B, ni, np.int32), np.full(B, ni, np.int32),
                                        np.zeros(B, np.int32)])
                if self._sharded:
                    out_sh, in_sh, rl = snap.device_shard_labels
                    out = self._guard_alloc("warm-compile", lambda: self._shard_call(
                        shard_mod.label_step, self._mesh, out_sh, in_sh,
                        torch.from_numpy(pairs).to(self.device), n_pairs=B, B=B, rl=rl))
                else:
                    out_lab, in_lab = snap.device_labels
                    out = self._guard_alloc("warm-compile", lambda: kernels.label_step(
                        out_lab, in_lab, torch.from_numpy(pairs).to(self.device),
                        n_pairs=B, B=B))
                _DeviceOut(out).words()
                warmed += 1
        self.warm_widths_skipped = skipped
        self.maintenance.set_gauge("warm_widths_skipped", skipped)
        return warmed

    def _entry_counts(
        self, snap: GraphSnapshot, sd: np.ndarray, tg: np.ndarray, multi: dict
    ) -> np.ndarray:
        """Per-query device entry counts (seeds + answer gathers) of a
        resolved slice. Host-propagated starts are estimated at one hop of
        out-degree; this only balances sub-chunk boundaries."""
        n = sd.shape[0]
        ni = snap.num_int
        sbase = snap.sink_base
        nl = snap.num_live
        ip = snap.fwd_indptr
        sp_ = snap.sink_indptr
        cnt = np.zeros(n, np.int64)
        m_int = (sd >= 0) & (sd < ni)
        cnt[m_int] = 1
        m_host = ((sd >= ni) & (sd < sbase)) | (sd >= nl)
        if m_host.any():
            s = sd[m_host]
            in_b = s < snap.n_base_nodes
            c = np.ones(s.shape[0], np.int64)  # overlay adjacency: small
            c[in_b] = ip[s[in_b] + 1] - ip[s[in_b]]
            cnt[m_host] = c
        has_start = m_int | m_host
        for i, (live, hostp) in multi.items():
            cnt[i] = live.size + hostp.size
            has_start[i] = live.size > 0 or hostp.size > 0
        m_ans = has_start & (tg >= sbase) & (tg < nl)
        if m_ans.any():
            t = tg[m_ans] - sbase
            cnt[m_ans] += sp_[t + 1] - sp_[t]
        return cnt

    def _dispatch_slices(
        self, snap: GraphSnapshot, tuples: Sequence[RelationTuple], it_cap: Optional[int] = None
    ):
        """Resolve + pack + dispatch ``tuples`` in ``_slice_cap`` query
        slices (tpu_engine.py:4120-4188), yielding ``(dev | None, host_ans,
        nq, chunk, leases, n_entries)`` as each slice is enqueued: ``chunk``
        lets a truncated slice re-run, ``leases`` are staging buffers to
        release once the slice lands, ``n_entries`` feeds the controller's
        entry-cost model. A slice whose fan-out exceeds its entry budget is
        sub-chunked at the same width, so entry arrays stay within the
        ``{B, 2B, 4B}`` pad geometries; the budget is the smaller of
        ``4·B`` and the controller's predicted-service-time
        ``entry_budget()`` (never below ``B``), so a chunk the model
        predicts slow splits before dispatch."""
        cap_q = self._slice_cap(snap)
        n = len(tuples)
        for s0 in range(0, n, cap_q):
            s1 = min(s0 + cap_q, n)
            sd, tg, multi = self._resolve_bulk(snap, tuples[s0:s1])
            nq = s1 - s0
            W = next(w for w in _WORD_WIDTHS if 32 * w >= nq)
            B = 32 * W
            cap_e = 4 * B
            budget = self.stream_ctrl.entry_budget()
            if budget is not None:
                cap_e = min(cap_e, max(B, budget))
            cnt = self._entry_counts(snap, sd, tg, multi)
            if int(cnt.sum()) <= cap_e:
                bounds = [(0, nq)]
            else:
                csum = np.concatenate([np.zeros(1, np.int64), np.cumsum(cnt)])
                bounds = []
                i0 = 0
                while i0 < nq:
                    i1 = int(np.searchsorted(csum, csum[i0] + cap_e, side="right")) - 1
                    i1 = max(i0 + 1, min(i1, nq))
                    bounds.append((i0, i1))
                    i0 = i1
                self._incr("slice_splits", len(bounds) - 1)
            use_labels = self._labels_usable(snap)
            for a, b in bounds:
                # sub-chunks keep the slice width: queries pad, geometry stays
                if use_labels:
                    dev, host_ans, leases = self._device_batch_labeled(
                        snap, sd, tg, multi, a, b, W, it_cap=it_cap
                    )
                else:
                    dev, host_ans, leases = self._device_batch(
                        snap, sd, tg, multi, a, b, W, it_cap=it_cap
                    )
                yield dev, host_ans, b - a, tuples[s0 + a : s0 + b], leases, int(cnt[a:b].sum())

    #: per-query pair-fanout cap on the label route: a query spawning more
    #: pairs than this costs more as intersections than as one BFS rider
    _LABEL_PAIR_CAP = 64

    def _device_batch_labeled(self, snap, sd, tg, multi, i0, i1, W, it_cap=None):
        """The label route for one sub-chunk (tpu_engine.py:4408): resolve
        the chunk with the SAME host machinery as the BFS route
        (``pack_chunk``), answer every label-certifiable query with ONE
        ``label_step``, and ride the rest on a compacted BFS sub-batch.

        The reach0 mapping (keto_tpu_torch/graph/labels.py):

        - a query's **pairs** are (seed row u) × (target-side row r): the
          interior target itself, or a sink target's interior in-neighbour
          gathers (``a_rows``, what the BFS kernel gathers);
        - an e1 seed equal to an interior target would conflate reach0 with
          the "via ≥ 1 edge" rule, so that query falls back; an e2 seed
          equal to the target was reached via a real edge on the host walk,
          so ``host_ans`` already granted it and the pair drops;
        - multi-start queries, uncertifiable pairs (coverage gaps) and
          over-fanout queries fall back.
        """
        idx = snap.labels
        packed, host_ans = pack_chunk(snap, sd, tg, multi, i0, i1, W, native=self._native_pack)
        nq = i1 - i0
        leases: list = []
        if packed is None:
            return None, host_ans, leases  # nothing reaches any device path
        (e1r, e1q, e2r, e2q, ar, aq, targets) = packed
        ni = snap.num_int
        B = 32 * W
        tq = np.asarray(targets[:nq], np.int64)
        t_int = tq < ni

        fallback = np.zeros(nq, bool)
        for i in multi:
            if i0 <= i < i1:
                fallback[i - i0] = True

        # valid (non-padding) entries; e1/e2 pad with row ni+1, a with ni
        m1 = (e1r != ni + 1) & (e1q < nq)
        m2 = (e2r != ni + 1) & (e2q < nq)
        ma = (ar != ni) & (aq < nq)
        s_rows = np.concatenate([e1r[m1], e2r[m2]]).astype(np.int64)
        s_q = np.concatenate([e1q[m1], e2q[m2]]).astype(np.int64)
        # e1 seed == interior target: reach0 would count the 0-edge path
        e1_rows_v = e1r[m1].astype(np.int64)
        e1_q_v = e1q[m1].astype(np.int64)
        self_hit = t_int[e1_q_v] & (e1_rows_v == tq[e1_q_v])
        if self_hit.any():
            fallback[e1_q_v[self_hit]] = True

        # target-side rows per query: the interior target, or the sink
        # answer-gather rows
        b_rows = np.concatenate([tq[t_int], ar[ma].astype(np.int64)])
        b_q = np.concatenate([np.nonzero(t_int)[0], aq[ma].astype(np.int64)])

        # group both sides by query, then cross-join per query
        so = np.argsort(s_q, kind="stable")
        s_rows, s_q = s_rows[so], s_q[so]
        bo = np.argsort(b_q, kind="stable")
        b_rows, b_q = b_rows[bo], b_q[bo]
        ns = np.bincount(s_q, minlength=nq)
        nr = np.bincount(b_q, minlength=nq)
        over = ns * nr > self._LABEL_PAIR_CAP
        if over.any():
            fallback[over] = True
        # drop both sides of fallback queries before the join
        keep_s = ~fallback[s_q]
        keep_b = ~fallback[b_q]
        s_rows, s_q = s_rows[keep_s], s_q[keep_s]
        b_rows, b_q = b_rows[keep_b], b_q[keep_b]
        ns = np.bincount(s_q, minlength=nq) if s_q.size else np.zeros(nq, np.int64)
        nr = np.bincount(b_q, minlength=nq) if b_q.size else np.zeros(nq, np.int64)

        rep_nr = np.repeat(nr, ns)  # aligned to s_rows
        total = int(rep_nr.sum())
        if total:
            b_starts = np.cumsum(nr) - nr
            base = np.repeat(b_starts[s_q], rep_nr)
            csum = np.cumsum(rep_nr) - rep_nr
            within = np.arange(total) - np.repeat(csum, rep_nr)
            pa = np.repeat(s_rows, rep_nr)
            pb = b_rows[base + within]
            pq = np.repeat(s_q, rep_nr)
            # e2-seed == target pairs: already host-granted (e1 cases fell
            # back above)
            drop = t_int[pq] & (pa == pb)
            if drop.any():
                pa, pb, pq = pa[~drop], pb[~drop], pq[~drop]
            # coverage: a miss on an uncertifiable pair is not a deny
            cert = idx.certifiable(pa, pb)
            if not cert.all():
                bad = np.unique(pq[~cert])
                fallback[bad] = True
                keep = ~fallback[pq]
                pa, pb, pq = pa[keep], pb[keep], pq[keep]
        else:
            pa = pb = pq = np.zeros(0, np.int64)

        n_fb = int(np.count_nonzero(fallback))
        self._incr("label_checks", nq - n_fb)
        if n_fb:
            self._incr("label_fallbacks", n_fb)

        ldev = bfs_dev = bfs_pos = None
        try:
            if pa.size:
                P = _entry_pad(B, pa.size)
                pad = P - pa.size
                stg = self._stage_acquire(3 * P)
                leases.append(stg)
                np.concatenate([pa, np.full(pad, ni), pb, np.full(pad, ni), pq, np.zeros(pad)],
                               out=stg.numpy(), casting="unsafe")
                if self._sharded:
                    # row-striped labels: the pair-row exchange, then K3
                    out_sh, in_sh, rl = snap.device_shard_labels
                    ldev = _DeviceOut(self._guard_alloc("check-dispatch", lambda: self._shard_call(
                        shard_mod.label_step, self._mesh, out_sh, in_sh,
                        stg.to(self.device, non_blocking=True), n_pairs=P, B=B, rl=rl)))
                else:
                    out_lab, in_lab = snap.device_labels
                    ldev = _DeviceOut(self._guard_alloc(
                        "check-dispatch", lambda: kernels.label_step(
                            out_lab, in_lab, stg.to(self.device, non_blocking=True),
                            n_pairs=P, B=B)))
            if n_fb:
                pos = np.nonzero(fallback)[0]
                gidx = pos + i0
                multi2 = {j: multi[int(i)] for j, i in enumerate(gidx) if int(i) in multi}
                W2 = next(w for w in _WORD_WIDTHS if 32 * w >= pos.size)
                bfs_dev, _, bfs_leases = self._device_batch(
                    snap, sd[gidx], tg[gidx], multi2, 0, pos.size, W2, it_cap=it_cap
                )
                leases.extend(bfs_leases)
                bfs_pos = pos
        except BaseException:
            self._stage_release(leases)  # nothing of the slice will land
            raise
        if ldev is None and bfs_dev is None:
            return None, host_ans, leases
        return _HybridSlice(ldev, bfs_dev, bfs_pos), host_ans, leases

    def _device_batch(self, snap, sd, tg, multi, i0, i1, force_W=None, it_cap=None):
        """Pack + dispatch one sub-chunk. Returns ``(dev, host_ans,
        leases)``: the kernel's int32[W+2] output still on the device (a
        ``_DeviceOut``; None when no query of the chunk reaches the
        device), the host-decided grants, and the staging buffers the
        caller releases only once the slice has landed."""
        packed, host_ans = pack_chunk(
            snap, sd, tg, multi, i0, i1, force_W, native=self._native_pack
        )
        leases: list = []
        if packed is None:
            return None, host_ans, leases
        if self._sharded:
            try:
                dev = self._dispatch_sharded(snap, packed, it_cap or self._it_cap, leases)
            except BaseException:
                self._stage_release(leases)  # nothing of the slice will land
                raise
            return dev, host_ans, leases
        stg = self._stage_acquire(sum(a.shape[0] for a in packed))
        leases.append(stg)
        try:
            _, sizes = pack_entries(packed, out=stg.numpy())
        except BaseException:
            self._stage_release(leases)
            raise
        g = snap.device
        ov = snap.device_overlay or (None, None)
        try:
            dev = self._guard_alloc("check-dispatch", lambda: kernels.check_step(
                g.buckets,
                stg.to(g.device, non_blocking=True),
                ov[0],
                ov[1],
                sizes=sizes,
                n_active=g.num_active,
                n_int=g.num_int,
                valid_rows=g.valid_rows,
                it_cap=it_cap or self._it_cap,
                block_iters=self._block_iters,
            ))
        except BaseException:
            self._stage_release(leases)  # nothing of the slice will land
            raise
        return _DeviceOut(dev), host_ans, leases

    def _dispatch_sharded(self, snap: GraphSnapshot, packed, it_cap: int, leases: list):
        """Route one packed chunk's entries to their owning shards and run
        K10a (tpu_engine.py:4695-4742): a ``_ShardedSlice`` whose
        ``uint32[W+3]`` output lands like any BFS output, plus the halo
        bytes of one round. The routed ``[g, L]`` entry stack stages through
        the pool (its lease joins ``leases``). A failure anywhere in it, the
        routing and staging included, is counted and raised."""
        spec = snap.shard_spec
        B = packed[-1].shape[0]

        def out_alloc(shape):
            stg = self._stage_acquire(shape[0] * shape[1])
            leases.append(stg)
            return stg.numpy().reshape(shape)

        def dispatch():
            entries, sizes = shard_mod.route_entries(spec, packed, B, out_alloc=out_alloc)
            stg = leases[-1]
            if entries.ctypes.data != stg.numpy().ctypes.data:
                raise RuntimeError("the routed entries did not land in their staging buffer")
            ent = stg.view(entries.shape).to(self.device, non_blocking=True)
            ov = snap.device_shard_overlay or (None, None)
            return shard_mod.check_step(
                self._mesh, snap.device_shards, ent, ov[0], ov[1], sizes=sizes,
                rps=spec.rows_per_shard, B=B, it_cap=it_cap, block_iters=self._block_iters,
            )

        dev = self._guard_alloc("check-dispatch", lambda: self._shard_call(dispatch))
        return _ShardedSlice(_DeviceOut(dev), shard_mod.halo_bytes_per_round(spec, B // 32))

    def _shard_call(self, fn, *args, **kw):
        """Run one sharded program; a failure is counted
        (``shard_dispatch_failures``) and raised — never retried on the
        unsharded kernels or the host."""
        try:
            return fn(*args, **kw)
        except Exception:
            self._incr("shard_dispatch_failures")
            raise

    def _note_sharded_stats(self, iters: int, frontier_bits: int, halo_bytes_per_round: int) -> None:
        """One sharded slice's tail words into the ``shard_*`` counters
        (tpu_engine.py:4744-4753): one halo exchange per real hop."""
        if iters:
            self._incr("shard_halo_rounds", iters)
            self._incr("shard_halo_bytes", iters * halo_bytes_per_round)
        if frontier_bits:
            self._incr("shard_frontier_bits", frontier_bits)

    def _stage_release(self, leases) -> None:
        """Return a landed slice's staging buffers to the pool. Empties the
        lease list, so releasing a record twice (``land()`` plus the
        stream's teardown sweep) never frees a buffer twice."""
        if not leases:
            return
        for buf in leases:
            self._staging.release(buf)
        del leases[:]

    @staticmethod
    def _decode_packed(f: np.ndarray, host_ans: np.ndarray, nq: int):
        """Decode one kernel's packed ``uint32[W+2]`` output (decision bits,
        iteration count, truncation flag): device bits ∪ host-decided
        grants. Returns ``(bool[nq], iters, truncated)``."""
        W = f.shape[0] - 2
        lanes = np.arange(32, dtype=np.uint32)
        bits = ((f[:W, None] >> lanes) & 1).astype(bool).ravel()[:nq]
        return bits | host_ans[:nq], int(f[W]), bool(f[W + 1])

    @staticmethod
    def _decode_packed_sharded(f: np.ndarray, host_ans: np.ndarray, nq: int):
        """Decode one sharded output ``uint32[W+3]`` (tpu_engine.py:4209):
        ``(bool[nq], iters, truncated, frontier_bits)``, the last read as
        unsigned."""
        W = f.shape[0] - 3
        lanes = np.arange(32, dtype=np.uint32)
        bits = ((f[:W, None] >> lanes) & 1).astype(bool).ravel()[:nq]
        return bits | host_ans[:nq], int(f[W]), bool(f[W + 1]), int(f[W + 2])

    def _decode_bfs(self, dev, host_ans: np.ndarray, nq: int):
        """Land one BFS output of either kind (tpu_engine.py:4218-4227): a
        sharded one also feeds the ``shard_*`` counters. Returns
        ``(bool[nq], iters, truncated)``."""
        if isinstance(dev, _ShardedSlice):
            bits, it, tr, fb = self._decode_packed_sharded(dev.words(), host_ans, nq)
            self._note_sharded_stats(it, fb, dev.halo_bytes_per_round)
            return bits, it, tr
        return self._decode_packed(dev.words(), host_ans, nq)

    @staticmethod
    def _decode_label_bits(f: Optional[np.ndarray], nq: int) -> np.ndarray:
        """Label kernel output ``uint32[W]`` → bool[nq] (None → zeros)."""
        if f is None:
            return np.zeros(nq, bool)
        lanes = np.arange(32, dtype=np.uint32)
        return ((f[:, None] >> lanes) & 1).astype(bool).ravel()[:nq]

    def _decode_hybrid(self, lab, bfs_dev, bfs_pos, host_ans, nq):
        """Decode one label-routed slice: label bits (fetched) for the whole
        slice, the BFS sub-batch's bits (landed here, sharded or not)
        scattered onto their positions. Only the BFS part can truncate."""
        out = self._decode_label_bits(lab, nq)
        iters, trunc = 0, False
        if bfs_dev is not None:
            bits2, iters, trunc = self._decode_bfs(bfs_dev, host_ans[bfs_pos], bfs_pos.size)
            out[bfs_pos] = bits2
        return out | host_ans[:nq], iters, trunc

    def _land_slice(self, dev, host_ans, nq, leases):
        """Land one dispatched slice: wait for its copy home if it has not
        finished, unpack it, and release its staging leases (the copy is
        over, or the slice failed). Returns ``(bool[nq], iters, truncated,
        route)``; a truncated slice's queries carry no decision."""
        try:
            if dev is None:
                out, iters, truncated = host_ans[:nq], 0, False
            elif isinstance(dev, _HybridSlice):
                lab = dev.label_dev.words() if dev.label_dev is not None else None
                out, iters, truncated = self._decode_hybrid(lab, dev.bfs_dev, dev.bfs_pos,
                                                            host_ans, nq)
            else:
                out, iters, truncated = self._decode_bfs(dev, host_ans, nq)
        finally:
            self._stage_release(leases)
        route = _route_of(dev)
        if route in ("bfs", "hybrid"):
            self.bfs_steps_stats.observe(float(iters))
        return out, iters, truncated, route

    def _stream(self, snap, tuples_iter, *, slice_cap, ordered, with_info=False):
        """The pipeline behind ``batch_check_stream`` (tpu_engine.py:3886-4067):
        a window of ``_DISPATCH_WINDOW`` dispatched slices, each copying home as soon
        as it is enqueued; every slice whose copy has landed unpacks at
        once (ready order), and only a full window (or the end of the
        input) blocks, on the oldest slice. A truncated slice re-runs
        exactly, mid-stream. A failed or abandoned stream releases its
        in-flight slices' staging leases."""
        depth = self._DISPATCH_WINDOW
        bound = self._slice_cap(snap)
        if slice_cap:
            bound = min(bound, slice_cap)
        ctrl = self.stream_ctrl
        stats = self.stream_slice_stats
        it = iter(tuples_iter)
        max_iters = 0
        t_prev_ready = time.perf_counter()

        def slices():
            off = 0
            while True:
                batch = list(itertools.islice(it, min(bound, ctrl.cap())))
                if not batch:
                    return
                if snap.n_nodes == 0 or snap.n_edges == 0:
                    # the empty graph: a host slice, every query denied
                    yield off, None, np.zeros(len(batch), dtype=bool), len(batch), batch, [], 0
                    off += len(batch)
                    continue
                for dev, host_ans, nq, chunk, leases, n_ent in self._dispatch_slices(snap, batch):
                    yield off, dev, host_ans, nq, chunk, leases, n_ent
                    off += nq

        def land(rec):
            # unpack one slice (blocks iff its copy has not finished); a
            # truncated frontier re-runs exactly, mid-stream
            nonlocal max_iters, t_prev_ready
            _seq, off, dev, host_ans, nq, chunk, leases, n_ent, t_disp = rec
            out, iters, truncated, route = self._land_slice(dev, host_ans, nq, leases)
            if truncated:
                out, redo_iters = self._run_exact(
                    snap, chunk, it_cap=min(max(self._it_cap * 8, 8), self._cap_limit(snap))
                )
                iters = max(iters, redo_iters)
            max_iters = max(max_iters, iters)
            now = time.perf_counter()
            # the slice's service time: dispatch→ready when the pipeline ran
            # dry, ready→ready when saturated
            ms = (now - max(t_disp, t_prev_ready)) * 1e3
            t_prev_ready = now
            stats.observe(ms)
            ctrl.observe(nq, ms, route=route, bfs_steps=int(iters), entries=n_ent)
            self._note_route(route, nq, ms)
            self._audit_sample(chunk, out, snap.snapshot_id)
            if not with_info:
                return off, out
            info = {"width": nq, "bfs_steps": int(iters), "route": route,
                    "service_ms": round(ms, 3)}
            halo = _halo_bytes_of(dev)
            if halo is not None:
                # one frontier all-gather per real hop (tpu_engine.py:3987-3999)
                info["halo_rounds"] = int(iters)
                info["halo_bytes"] = int(iters) * halo
            return off, out, info

        src = slices()
        exhausted = False
        inflight: list = []
        done: dict = {}  # landed, awaiting in-order delivery
        seq = 0
        next_seq = 0
        try:
            while True:
                # keep the window full: resolve/pack/dispatch overlaps the
                # device work of every slice in flight
                while not exhausted and len(inflight) < depth:
                    nxt = next(src, None)
                    if nxt is None:
                        exhausted = True
                        break
                    off, dev, host_ans, nq, chunk, leases, n_ent = nxt
                    if dev is not None:
                        dev.copy_to_host_async()
                    inflight.append((seq, off, dev, host_ans, nq, chunk, leases, n_ent,
                                     time.perf_counter()))
                    seq += 1
                if not inflight and exhausted:
                    break
                # ready-order landing: every finished slice unpacks now
                progressed = False
                still = []
                for rec in inflight:
                    if rec[2] is None or rec[2].is_ready():
                        res = land(rec)
                        if ordered:
                            done[rec[0]] = res
                        else:
                            yield res
                        progressed = True
                    else:
                        still.append(rec)
                inflight = still
                if ordered:
                    while next_seq in done:
                        yield done.pop(next_seq)[1]
                        next_seq += 1
                if not progressed and inflight and (exhausted or len(inflight) >= depth):
                    # nothing ready and the window is full (or the input is
                    # done): block on the oldest slice
                    rec = inflight.pop(0)
                    res = land(rec)
                    if ordered:
                        done[rec[0]] = res
                        while next_seq in done:
                            yield done.pop(next_seq)[1]
                            next_seq += 1
                    else:
                        yield res
        finally:
            # a failed or abandoned stream discards its in-flight outputs;
            # their staging buffers may recycle (a lease list land() already
            # emptied releases nothing)
            for rec in inflight:
                self._stage_release(rec[6])
        self._after_batch(max_iters)

    def _after_batch(self, max_iters: int) -> None:
        # adapt the pull-block size so deep workloads converge within few
        # host observations. Grow-only, as the reference: converged steps
        # inside a block are guarded no-ops on the device.
        want = min(32, _ceil_pow2(max_iters + 1))
        if want > self._block_iters:
            self._block_iters = want
