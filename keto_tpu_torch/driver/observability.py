"""The observability wiring: the metrics registry with its bridges, the SLO
engine, the timeline recorder's readers and the flight recorder.

The counterpart of keto_tpu/driver/registry.py:1107-1300 (the timeline,
SLO and flight-recorder builders) and :1301-2460 (``metrics()`` and
``_register_metric_bridges``), and their one home in the port: the
``Registry`` (keto_tpu_torch/driver/registry.py) calls these functions and
copies none of them. Every function takes the components it reads
explicitly, as late-bound getters (zero-argument callables that answer the
component or None, the registry's ``peek``), so the registry and a caller
that builds its servers by hand (``chip_smoke.py``'s lanes phase) wire the
same way, and a scrape never constructs anything.

A bridge reads live host values only: no callback synchronizes the
device or launches work (``torch.cuda.memory_allocated`` is a host
counter; the governor's ledger is host bookkeeping).

Families of components the port does not have yet are absent from the
scrape, not declared at zero, each with the ROADMAP item that brings it
(``PENDING_FAMILIES``; tests/test_torch_observability.py pins the list).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from keto_tpu_torch.driver.batch import LANES
from keto_tpu_torch.driver.hbm import RUNGS as HBM_RUNGS
from keto_tpu_torch.driver.hbm import TAGS as HBM_TAGS
from keto_tpu_torch.driver.health import HealthState
from keto_tpu_torch.graph.stream_build import PHASES as BUILD_PHASES
from keto_tpu_torch.servers.rest import expand_metrics, http_metrics
from keto_tpu_torch.version import __version__
from keto_tpu_torch.x.flightrec import FlightRecorder
from keto_tpu_torch.x.metrics import MetricsRegistry, NullMetricsRegistry
from keto_tpu_torch.x.slo import SloEngine

Getter = Callable[[], Optional[Any]]

#: the reference's families the port's scrape leaves out, by the ROADMAP
#: item that ports their component; each later item shrinks this
PENDING_FAMILIES = {
    # gRPC (A7's second half)
    "keto_grpc_requests_total": "A7",
    "keto_grpc_request_duration_seconds": "A7",
    # tenants (A9)
    "keto_tenant_known": "A9",
    "keto_tenant_resident": "A9",
    "keto_tenant_evictions_total": "A9",
    "keto_tenant_faultins_total": "A9",
    "keto_tenant_shed_spikes_total": "A9",
    "keto_tenant_checks_total": "A9",
    "keto_tenant_shed_total": "A9",
    "keto_tenant_resident_bytes": "A9",
    "keto_tenant_degraded": "A9",
    # replicas, their check cache and the fleet (A10)
    "keto_replication_apply_delay_seconds": "A10",
    "keto_replica_lag_seconds": "A10",
    "keto_replica_applied_commits_total": "A10",
    "keto_replica_bootstraps_total": "A10",
    "keto_checkcache_hits_total": "A10",
    "keto_checkcache_misses_total": "A10",
    "keto_checkcache_invalidations_total": "A10",
    "keto_fleet_epoch": "A10",
    "keto_fleet_promotions_total": "A10",
    "keto_fleet_replicas": "A10",
    # the live reshard and the routing weights (A11)
    "keto_reshard_state": "A11",
    "keto_route_weight": "A11",
}

#: the streaming pipeline's answering routes, as the reference labels them
STREAM_ROUTES = ("label", "hybrid", "bfs", "host", "cpu")

BUILD_PHASE_BUCKETS = (0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0, 1200.0)
GROUP_COMMIT_WAIT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)
GROUP_COMMIT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _none() -> None:
    return None


# -- instruments the components record into directly ---------------------------


def stream_slice_histogram(m):
    return m.histogram(
        "keto_engine_stream_slice_duration_seconds",
        "Per-slice device service time of the streaming check "
        "pipeline (what StreamSliceController steers by).",
    )


def build_phase_histogram(m):
    return m.histogram(
        "keto_build_phase_duration_seconds",
        "Wall time per streaming-build pipeline phase "
        "(scan / intern / device_build / labels / "
        "cache_save), one histogram series per phase.",
        ("phase",),
        buckets=BUILD_PHASE_BUCKETS,
    )


def stage_histogram(m):
    return m.histogram(
        "keto_timeline_stage_duration_seconds",
        "Per-request time attributed to each pipeline stage "
        "(admit/pack/dispatch/device/land/deliver, from the "
        "request timelines); slowest sample per stage carries "
        "a trace_id exemplar.",
        ("stage",),
    )


def group_commit_histograms(m) -> dict:
    """``wait_histogram`` and ``batch_histogram`` for a
    ``GroupCommitCoordinator`` (keto_tpu/driver/registry.py:185-201)."""
    return {
        "wait_histogram": m.histogram(
            "keto_group_commit_wait_seconds",
            "Time a writer spent queued in the group-commit "
            "coordinator before its group's durable transaction "
            "started (the coalescing cost the "
            "serve.group_commit_window_ms knob trades against "
            "fsyncs).",
            buckets=GROUP_COMMIT_WAIT_BUCKETS,
        ),
        "batch_histogram": m.histogram(
            "keto_group_commit_batch_size",
            "Writers coalesced per durable group transaction "
            "(1 = no batching benefit; the ceiling is "
            "serve.group_commit_max_writers).",
            buckets=GROUP_COMMIT_BATCH_BUCKETS,
        ),
    }


def attach_engine(m, engine) -> None:
    """Mirror the engine's slice service times and build phases into their
    histograms (keto_tpu/driver/registry.py:740-762). Call before the
    engine's first build to see its phases."""
    engine.stream_slice_stats.attach_histogram(stream_slice_histogram(m))
    engine.build_progress.attach_histogram(build_phase_histogram(m))


def attach_recorder(m, recorder, tracer) -> None:
    """The timeline recorder's readers (keto_tpu/driver/registry.py:
    1107-1133): stage spans through ``tracer``, stage durations into
    ``keto_timeline_stage_duration_seconds``."""
    recorder.set_tracer(tracer)
    recorder.attach_stage_histogram(stage_histogram(m))


# -- the registry --------------------------------------------------------------


def build_metrics(
    *,
    enabled: bool = True,
    engine: Getter = _none,
    batcher: Getter = _none,
    monitor: Getter = _none,
    recorder: Getter = _none,
    explain: Getter = _none,
    decision_log: Getter = _none,
    lister: Getter = _none,
    store: Getter = _none,
    writer: Getter = _none,
    tracer: Getter = _none,
    flightrec: Getter = _none,
    slo: Getter = _none,
    watch_hub: Getter = _none,
):
    """The process's ``MetricsRegistry`` (keto_tpu/driver/registry.py:
    1301-1372): ``keto_build_info``, the eagerly declared histograms and
    request families, and a scrape-time bridge over every component the
    port has. ``enabled=False`` answers the null registry (``/metrics``
    then answers 404)."""
    if not enabled:
        return NullMetricsRegistry()
    m = MetricsRegistry()
    m.gauge(
        "keto_build_info",
        "Always 1; the version label identifies the running build.",
        ("version",),
    ).set((__version__,), 1)
    stream_slice_histogram(m)
    build_phase_histogram(m)
    stage_histogram(m)
    http_metrics(m)
    expand_metrics(m)
    group_commit_histograms(m)
    _register_bridges(m, engine=engine, batcher=batcher, monitor=monitor, recorder=recorder,
                      explain=explain, decision_log=decision_log, lister=lister, store=store,
                      writer=writer, tracer=tracer, flightrec=flightrec, slo=slo,
                      watch_hub=watch_hub)
    return m


def _register_bridges(m, *, engine, batcher, monitor, recorder, explain, decision_log, lister,
                      store, writer, tracer, flightrec, slo, watch_hub) -> None:
    """Scrape-time callbacks (keto_tpu/driver/registry.py:1374-2460, the
    families of the components the port has); a family reads zeros until
    its component exists."""

    def attr_of(getter: Getter, attr: str, scale: float = 1.0):
        def read():
            c = getter()
            v = getattr(c, attr, 0) if c is not None else 0
            yield (), float(v or 0) * scale

        return read

    # -- the check batcher and admission --------------------------------------
    m.register_callback(
        "keto_check_queue_depth", "gauge",
        "Coalescing check batcher: requests queued, not yet packed.",
        attr_of(batcher, "queue_depth"),
    )
    m.register_callback(
        "keto_check_inflight", "gauge",
        "Accepted check requests whose futures have not resolved.",
        attr_of(batcher, "inflight"),
    )
    m.register_callback(
        "keto_check_shed_total", "counter",
        "Check requests refused at the door with 429/RESOURCE_EXHAUSTED "
        "(queue at capacity).",
        attr_of(batcher, "shed_count"),
    )
    m.register_callback(
        "keto_check_deadline_drops_total", "counter",
        "Check requests dropped before dispatch because their deadline "
        "expired (504/DEADLINE_EXCEEDED).",
        attr_of(batcher, "deadline_drop_count"),
    )

    def lane_map(attr):
        def read():
            b = batcher()
            vals = getattr(b, attr, {}) if b is not None else {}
            return [((lane,), float(vals.get(lane, 0))) for lane in LANES]

        return read

    m.register_callback(
        "keto_lane_queue_depth", "gauge",
        "Priority lanes: tuples queued per lane, not yet packed into a "
        "dispatch round.",
        lane_map("lane_depths"), ("lane",),
    )
    m.register_callback(
        "keto_lane_shed_total", "counter",
        "Requests refused at the door per lane (queue full or over the "
        "admission window), 429/RESOURCE_EXHAUSTED + Retry-After.",
        lane_map("shed_by_lane"), ("lane",),
    )
    m.register_callback(
        "keto_admission_shed_total", "counter",
        "Batch-lane requests shed by the AIMD admission window "
        "specifically (subset of keto_check_shed_total).",
        attr_of(batcher, "admission_shed_count"),
    )

    def admission():
        b = batcher()
        return getattr(b, "admission", None) if b is not None else None

    m.register_callback(
        "keto_admission_window", "gauge",
        "AIMD admission control: currently admitted batch-lane window "
        "(queued tuples); shrinks multiplicatively past the latency "
        "budget, recovers additively.",
        attr_of(admission, "window"),
    )
    m.register_callback(
        "keto_admission_latency_budget_seconds", "gauge",
        "The latency budget the admission controller sheds against "
        "(serve.admission_latency_budget_ms, default 4x the slice "
        "target).",
        attr_of(admission, "budget_ms", 1e-3),
    )
    m.register_callback(
        "keto_admission_observed_p99_seconds", "gauge",
        "Slice service-time p99 the admission controller last judged "
        "(same DurationStats the stream width controller steers by).",
        attr_of(admission, "last_p99_ms", 1e-3),
    )

    # -- the engine's maintenance stats ---------------------------------------
    def maintenance_raw():
        stats = getattr(engine(), "maintenance", None)
        if stats is None:
            return {}, {}, {}
        return stats.raw()

    def maintenance_events():
        counters, _, _ = maintenance_raw()
        return [((k,), float(v)) for k, v in counters.items()] or [(("none",), 0.0)]

    m.register_callback(
        "keto_maintenance_events_total", "counter",
        "Snapshot maintenance events (delta applies, compactions, "
        "rebuilds, cache saves/loads, failures), by event.",
        maintenance_events, ("event",),
    )

    def maintenance_durations(field, scale):
        def read():
            _, _, durations = maintenance_raw()
            return [
                ((op,), float(d[field]) * scale) for op, d in durations.items()
            ] or [(("none",), 0.0)]

        return read

    m.register_callback(
        "keto_maintenance_duration_seconds_total", "counter",
        "Cumulative wall time spent in maintenance operations "
        "(compaction, rebuild, cache save/reload), by op.",
        maintenance_durations("total_ms", 1e-3), ("op",),
    )
    m.register_callback(
        "keto_maintenance_runs_total", "counter",
        "Completed maintenance operations, by op.",
        maintenance_durations("count", 1.0), ("op",),
    )

    def counters_of(*pairs):
        def read():
            counters, _, _ = maintenance_raw()
            return [((label,), float(counters.get(key, 0))) for label, key in pairs]

        return read

    def maint_counter(key):
        def read():
            counters, _, _ = maintenance_raw()
            yield (), float(counters.get(key, 0))

        return read

    def maint_gauge(key):
        def read():
            _, gauges, _ = maintenance_raw()
            v = gauges.get(key, 0)
            yield (), float(v) if isinstance(v, (int, float)) else 0.0

        return read

    m.register_callback(
        "keto_label_checks_total", "counter",
        "Check queries answered by the 2-hop label fast path (path="
        "label) vs routed to the BFS kernel while labels were live "
        "(path=fallback: wildcards, coverage gaps, self-queries).",
        counters_of(("label", "label_checks"), ("fallback", "label_fallbacks")), ("path",),
    )
    m.register_callback(
        "keto_label_coverage_ratio", "gauge",
        "Fraction of interior rows the 2-hop label index can certify "
        "on both sides (processed landmark, untruncated labels) — "
        "label build/patch/invalidation events ride "
        "keto_maintenance_events_total.",
        maint_gauge("label_coverage"),
    )
    m.register_callback(
        "keto_label_build_truncated_total", "counter",
        "Label builds that stopped before processing every interior "
        "landmark, by reason (cap: the host path's 131072 landmark "
        "safety cap; min_gain: the device build's "
        "labels_min_gain early exit). Each one logs the "
        "achieved coverage ratio; uncovered deep checks take "
        "the BFS kernels bit-identically, paying the depth tax the "
        "labels exist to remove.",
        counters_of(("cap", "label_build_truncated_cap"),
                    ("min_gain", "label_build_truncated_min_gain")), ("reason",),
    )
    m.register_callback(
        "keto_label_patch_aborts_total", "counter",
        "Incremental label patches (compaction folding overlay "
        "inserts into the index) abandoned on the visit budget — "
        "each abort schedules a full device rebuild in the same "
        "supervised maintenance pass (rides "
        "keto_maintenance_events_total as label_rebuilds). A rising "
        "rate means overlay inserts land in dense regions; raise the "
        "budget or compact more often.",
        maint_counter("label_patch_aborts"),
    )

    # -- the streaming slice scheduler ------------------------------------------
    def route_slices():
        fn = getattr(engine(), "route_slice_counts", None)
        counts = fn() if fn is not None else {}
        return [((r,), float(counts.get(r, 0))) for r in STREAM_ROUTES]

    m.register_callback(
        "keto_stream_route_slices_total", "counter",
        "Streaming check slices landed, by answering route: label "
        "(intersection kernel only), hybrid (label + BFS sub-batch), "
        "bfs, host (no device work), cpu (the reference's degraded "
        "fallback; the port has no CPU route, so it always reads 0).",
        route_slices, ("route",),
    )

    def stream_tail_ratio():
        stats = getattr(engine(), "stream_slice_stats", None)
        snap = stats.snapshot() if stats is not None else None
        if not snap or not snap.get("p50_ms"):
            yield (), 0.0
        else:
            yield (), float(snap["p99_ms"]) / float(snap["p50_ms"])

    m.register_callback(
        "keto_stream_tail_ratio", "gauge",
        "Observed per-slice service-time p99/p50 ratio over the "
        "engine's sliding window — the number the slice controller's "
        "tail guard (stream_tail_ratio) steers.",
        stream_tail_ratio,
    )

    def native_pack_paths():
        from keto_tpu_torch.check.native_pack import COUNTERS

        return [((p,), float(COUNTERS.get(p, 0))) for p in ("native", "numpy")]

    m.register_callback(
        "keto_native_pack_chunks_total", "counter",
        "Check chunks packed per host-walk path: native (GIL-released "
        "C++ walk, native/pack.cpp) vs numpy (the snapshot carries "
        "host-visible overlay state).",
        native_pack_paths, ("path",),
    )

    # -- the streaming snapshot build -------------------------------------------
    def build_progress():
        return getattr(engine(), "build_progress", None)

    def build_phase():
        bp = build_progress()
        current = bp.current_phase if bp is not None else "idle"
        return [((p,), 1.0 if p == current else 0.0) for p in ("idle",) + BUILD_PHASES]

    m.register_callback(
        "keto_build_phase", "gauge",
        "Streaming-build pipeline phase, one-hot over idle/scan/"
        "intern/device_build/labels/cache_save — nonzero off idle "
        "means a snapshot build is in flight.",
        build_phase, ("phase",),
    )
    m.register_callback(
        "keto_build_rows_ingested_total", "counter",
        "Store rows scanned+interned by snapshot builds since boot "
        "(cumulative across rebuilds; rate it to watch a cold start "
        "make progress).",
        attr_of(build_progress, "rows_ingested"),
    )
    m.register_callback(
        "keto_build_edges_ingested_total", "counter",
        "Graph edges laid out by snapshot builds since boot "
        "(cumulative across rebuilds).",
        attr_of(build_progress, "edges_ingested"),
    )
    m.register_callback(
        "keto_overlay_edges", "gauge",
        "Delta-overlay occupancy: pending edges + tombstones not yet "
        "folded into the base layout.",
        maint_gauge("overlay_edges"),
    )
    m.register_callback(
        "keto_overlay_budget", "gauge",
        "overlay_edge_budget: occupancy past this triggers "
        "compaction.",
        maint_gauge("overlay_budget"),
    )

    # -- the device-memory governor ----------------------------------------------
    def hbm_snapshot():
        gov = getattr(engine(), "hbm", None)
        return gov.snapshot() if gov is not None else {}

    def hbm_ledger():
        led = hbm_snapshot().get("ledger", {})
        out = [((t,), float(led.get(t, 0))) for t in HBM_TAGS]
        out += [((t,), float(v)) for t, v in sorted(led.items()) if t not in HBM_TAGS]
        return out

    m.register_callback(
        "keto_hbm_resident_bytes", "gauge",
        "Device bytes resident per governor ledger tag (snapshot "
        "buckets, overlay ELL, label arrays, warm-ladder workspace); "
        "the series sums to the governor's total ledger.",
        hbm_ledger, ("tag",),
    )

    def hbm_scalar(key):
        def read():
            yield (), float(hbm_snapshot().get(key, 0) or 0)

        return read

    m.register_callback(
        "keto_hbm_budget_bytes", "gauge",
        "The enforced device-memory budget: hbm_budget_bytes, "
        "or the auto value (the card's memory minus headroom).",
        hbm_scalar("budget_bytes"),
    )
    m.register_callback(
        "keto_hbm_eviction_rung", "gauge",
        "Current eviction-ladder depth: 0 = full service, then "
        "staging pool dropped -> labels dropped -> reverse layouts "
        "dropped -> warm ladder trimmed -> overlay budget shrunk; "
        "refresh refusals ride keto_hbm_refusals_total.",
        hbm_scalar("rung"),
    )

    def hbm_evictions():
        by = hbm_snapshot().get("evictions_by_rung", {})
        return [((r,), float(by.get(r, 0))) for r in HBM_RUNGS]

    m.register_callback(
        "keto_hbm_evictions_total", "counter",
        "Eviction-ladder descents, by rung (labels / warm-ladder / "
        "overlay-budget) — planned pressure and real-OOM containment "
        "both count here.",
        hbm_evictions, ("rung",),
    )
    m.register_callback(
        "keto_hbm_refusals_total", "counter",
        "Snapshot refreshes refused because the plan stayed over "
        "budget with every eviction rung spent — the engine serves "
        "stale and reports DEGRADED(memory_pressure).",
        hbm_scalar("refusals"),
    )
    m.register_callback(
        "keto_hbm_warm_widths_skipped", "gauge",
        "Slice widths the boot warmup skipped because their "
        "footprint would breach the device-memory budget "
        "(warming never evicts; it just stops lower on the ladder).",
        maint_gauge("warm_widths_skipped"),
    )
    m.register_callback(
        "keto_oom_events_total", "counter",
        "Device allocations or launches that raised a classified "
        "out-of-memory error (torch.OutOfMemoryError or a CUDA "
        "out-of-memory message).",
        hbm_scalar("oom_events"),
    )
    m.register_callback(
        "keto_oom_recoveries_total", "counter",
        "OOMs contained by evicting one ladder rung and retrying "
        "once successfully (the rest raise to the caller; the "
        "port has no CPU fallback).",
        hbm_scalar("oom_recoveries"),
    )

    # -- sharded serving ---------------------------------------------------------
    def shard_hbm():
        shards = hbm_snapshot().get("shards") or []
        return [((str(s),), float(v)) for s, v in enumerate(shards)] or [(("0",), 0.0)]

    m.register_callback(
        "keto_shard_hbm_resident_bytes", "gauge",
        "Per-shard device bytes resident under the governor's "
        "per-shard ledger (owned bucket/overlay/label rows; "
        "replicated state spreads evenly) — the hottest shard is "
        "the binding constraint of every mesh-wide plan.",
        shard_hbm, ("shard",),
    )
    m.register_callback(
        "keto_shard_halo_rounds_total", "counter",
        "Halo-exchange rounds executed by the sharded BFS kernel: "
        "one copy of every shard's frontier bitmap slab "
        "per real BFS hop.",
        maint_counter("shard_halo_rounds"),
    )
    m.register_callback(
        "keto_shard_halo_bytes_total", "counter",
        "Frontier-slab bytes received per shard across all halo "
        "rounds ((shards-1) x slab bytes per round) — the "
        "cost of cross-shard reachability.",
        maint_counter("shard_halo_bytes"),
    )
    m.register_callback(
        "keto_shard_frontier_bits_total", "counter",
        "Set bits in the fixpoint frontier bitmaps summed over "
        "shards and dispatches — the reachability work the mesh "
        "actually performed.",
        maint_counter("shard_frontier_bits"),
    )

    # -- the shadow audit --------------------------------------------------------
    m.register_callback(
        "keto_audit_checks_total", "counter",
        "Live check decisions re-verified against the CPU reference "
        "oracle by the background shadow-parity auditor.",
        maint_counter("audit_checks"),
    )
    m.register_callback(
        "keto_audit_mismatches_total", "counter",
        "Audited decisions that DIVERGED from the CPU oracle — any "
        "nonzero value flips health to DEGRADED (continuous proof "
        "that eviction rungs never change answers).",
        maint_counter("audit_mismatches"),
    )

    # -- decision provenance -----------------------------------------------------
    def explain_requests():
        ex = explain()
        totals = getattr(ex, "requests_by_route", {}) if ex is not None else {}
        return [((r,), float(v)) for r, v in sorted(totals.items())] or [(("bfs",), 0.0)]

    m.register_callback(
        "keto_explain_requests_total", "counter",
        "Check-explain requests served, by the route that decided "
        "them (label / hybrid / bfs / host — the stream's own "
        "route label, not a re-derivation).",
        explain_requests, ("route",),
    )
    m.register_callback(
        "keto_witness_verify_failures_total", "counter",
        "Witnesses that FAILED edge-by-edge verification against the "
        "store before return — each one is a bug in the producing "
        "route; the response carries the CPU oracle's witness "
        "and the flight recorder captures the failing path.",
        attr_of(explain, "verify_failures"),
    )
    m.register_callback(
        "keto_decision_log_records_total", "counter",
        "Records appended to the durable decision-audit log (sampled "
        "hot-path checks plus every explain request), all tenants.",
        attr_of(decision_log, "records_total"),
    )
    m.register_callback(
        "keto_decision_log_bytes_total", "counter",
        "Bytes appended to the decision-audit log across active and "
        "sealed segments, all tenants.",
        attr_of(decision_log, "bytes_total"),
    )

    # -- reverse queries ---------------------------------------------------------
    def list_requests():
        eng = lister()
        totals = getattr(eng, "requests_total", {}) if eng is not None else {}
        out = [((op, path), float(v)) for (op, path), v in sorted(totals.items())]
        return out or [(("objects", "device"), 0.0)]

    m.register_callback(
        "keto_list_requests_total", "counter",
        "Reverse-query requests served, by op (objects/subjects) and "
        "answering path (device BFS, host = CPU-reference lister, "
        "oracle = store-backed wildcard/pattern path, empty = "
        "unresolvable query).",
        list_requests, ("op", "path"),
    )
    m.register_callback(
        "keto_list_device_errors_total", "counter",
        "Device list-BFS failures (each one raised to its caller; "
        "the port has no host fallback for them).",
        attr_of(lister, "device_errors"),
    )

    # -- health --------------------------------------------------------------------
    def health_states():
        mon = monitor()
        current = mon.status()[0] if mon is not None else None
        return [((s.value,), 1.0 if s is current else 0.0) for s in HealthState]

    m.register_callback(
        "keto_health_state", "gauge",
        "Serving health state machine, one-hot over "
        "starting/serving/degraded/not_serving.",
        health_states, ("state",),
    )
    m.register_callback(
        "keto_health_transitions_total", "counter",
        "Health state transitions since boot.",
        attr_of(monitor, "transitions"),
    )

    # -- timelines, the flight recorder, SLOs and the tracer ----------------------
    def timeline_finished():
        rec = recorder()
        by = getattr(rec, "finished_by_surface", {}) if rec is not None else {}
        return [((s,), float(by.get(s, 0))) for s in ("http", "grpc")] + [
            ((s,), float(v)) for s, v in sorted(by.items()) if s not in ("http", "grpc")
        ]

    m.register_callback(
        "keto_timeline_finished_total", "counter",
        "Request timelines recorded (ring + top-K slowest, queryable "
        "at GET /debug/requests), by serving surface.",
        timeline_finished, ("surface",),
    )

    def flightrec_snapshot():
        fr = flightrec()
        return fr.snapshot() if fr is not None else {}

    def flightrec_bundles():
        by = flightrec_snapshot().get("bundles_by_reason", {})
        return [((r,), float(v)) for r, v in sorted(by.items())] or [(("none",), 0.0)]

    m.register_callback(
        "keto_flightrec_bundles_total", "counter",
        "Flight-recorder debug bundles written to "
        "serve.debug_bundle_dir, by trigger reason (health-degraded/"
        "health-not_serving/oom/drain).",
        flightrec_bundles, ("reason",),
    )

    def flightrec_suppressed():
        yield (), float(flightrec_snapshot().get("suppressed", 0) or 0)

    m.register_callback(
        "keto_flightrec_suppressed_total", "counter",
        "Flight-recorder triggers refused by the rate limit "
        "(serve.debug_bundle_min_interval_s) — a flapping anomaly "
        "cannot fill the disk.",
        flightrec_suppressed,
    )

    def slo_field(field):
        def read():
            s = slo()
            return s.metric_rows(field) if s is not None else []

        return read

    m.register_callback(
        "keto_slo_availability_ratio", "gauge",
        "Fraction of REST requests without a server-side "
        "failure (5xx) over each trailing "
        "window; 1.0 on an idle window.",
        slo_field("availability_ratio"), ("window",),
    )
    m.register_callback(
        "keto_slo_availability_burn_rate", "gauge",
        "Error-budget burn rate of the availability objective per "
        "window: 1.0 spends the budget exactly at the objective "
        "horizon, >1 is an alertable burn.",
        slo_field("availability_burn_rate"), ("window",),
    )
    m.register_callback(
        "keto_slo_latency_ratio", "gauge",
        "Fraction of REST requests answered within the latency "
        "objective threshold (bucket-quantized), per window.",
        slo_field("latency_ratio"), ("window",),
    )
    m.register_callback(
        "keto_slo_latency_burn_rate", "gauge",
        "Error-budget burn rate of the latency objective per "
        "window (same semantics as the availability burn rate).",
        slo_field("latency_burn_rate"), ("window",),
    )

    def slo_objectives():
        s = slo()
        return s.objective_rows() if s is not None else []

    m.register_callback(
        "keto_slo_objective", "gauge",
        "The configured objectives the burn rates are judged "
        "against (availability ratio, latency good-ratio, latency "
        "threshold seconds).",
        slo_objectives, ("objective",),
    )
    m.register_callback(
        "keto_tracer_spans_exported_total", "counter",
        "Spans handed to the configured trace exporter.",
        attr_of(tracer, "spans_exported"),
    )
    m.register_callback(
        "keto_tracer_spans_dropped_total", "counter",
        "Spans lost (full export queue, collector down, dead file).",
        attr_of(tracer, "spans_dropped"),
    )

    # -- the Watch changefeed (keto_tpu/driver/registry.py:2056-2085) ---------------

    def watch_stat(key):
        def read():
            hub = watch_hub()
            snap = hub.snapshot() if hub is not None else {}
            yield (), float(snap.get(key, 0))

        return read

    m.register_callback(
        "keto_watch_streams", "gauge",
        "Watch changefeed streams currently open (REST chunked + "
        "gRPC server-stream), bounded by serve.watch_max_streams.",
        watch_stat("active_streams"),
    )
    m.register_callback(
        "keto_watch_events_total", "counter",
        "Tuple-change events delivered to watch subscribers (inserts "
        "+ deletes, across all streams).",
        watch_stat("events_total"),
    )
    m.register_callback(
        "keto_watch_expired_total", "counter",
        "Watch resumes refused because the snaptoken predates the "
        "retained change log (410 Gone / OUT_OF_RANGE).",
        watch_stat("expired_total"),
    )

    # -- the store and the write path ---------------------------------------------
    m.register_callback(
        "keto_persistence_reconnect_retries_total", "counter",
        "Store operations re-run after a dialect-recognized connection "
        "loss (reads always; writes only when idempotency-keyed).",
        attr_of(store, "reconnect_retries"),
    )
    m.register_callback(
        "keto_idempotent_replays_total", "counter",
        "Keyed write retries answered from the dedup table instead of "
        "re-applying.",
        attr_of(store, "idempotent_replays"),
    )
    m.register_callback(
        "keto_group_commit_flush_total", "counter",
        "Durable group transactions committed by the write "
        "coordinator (each covers keto_group_commit_batch_size "
        "writers with one store transaction).",
        attr_of(writer, "flush_total"),
    )
    m.register_callback(
        "keto_group_commit_errors_total", "counter",
        "Group transactions that failed (every writer in the group "
        "observed the same error and retries individually).",
        attr_of(writer, "flush_errors"),
    )
    m.register_callback(
        "keto_overlay_device_applies_total", "counter",
        "Delta-overlay installs applied directly to the resident "
        "device ELL via slot-set patches (no full host re-pack + "
        "re-upload; the complement re-packs, e.g. on capacity "
        "growth).",
        maint_counter("overlay_device_applies"),
    )
    m.register_callback(
        "keto_fold_runs_total", "counter",
        "Background log-structured fold passes: oldest overlay "
        "segments folded into the base snapshot while new writes "
        "keep landing in the newest (the replacement for the "
        "stop-the-world compaction cliff).",
        maint_counter("fold_runs"),
    )

    def fold_duration():
        _, _, durations = maintenance_raw()
        d = durations.get("fold")
        yield (), float(d["total_ms"]) * 1e-3 if d else 0.0

    m.register_callback(
        "keto_fold_duration_seconds_total", "counter",
        "Cumulative wall time spent in background fold passes "
        "(rate against keto_fold_runs_total for the mean fold "
        "cost; folds run off the serving path).",
        fold_duration,
    )


# -- the SLO engine ------------------------------------------------------------------


def build_slo(m, *, availability_objective: float = 0.999,
              latency_objective_ms: float = 250.0,
              latency_objective_ratio: float = 0.99) -> SloEngine:
    """The SLO engine over ``m``'s request families
    (keto_tpu/driver/registry.py:1135-1154; the objectives' defaults are
    the reference schema's ``serve.slo_*``)."""
    return SloEngine(
        m,
        availability_objective=float(availability_objective),
        latency_objective_ms=float(latency_objective_ms),
        latency_objective_ratio=float(latency_objective_ratio),
    )


# -- the flight recorder ---------------------------------------------------------------


def build_flight_recorder(directory: str, collect: Callable[[], dict], *, max_bundles: int = 8,
                          min_interval_s: float = 30.0,
                          max_bytes: int = 4 << 20) -> Optional[FlightRecorder]:
    """The flight recorder (keto_tpu/driver/registry.py:1156-1179), or None
    for an empty ``directory``."""
    if not directory:
        return None
    return FlightRecorder(directory, collect=collect, max_bundles=int(max_bundles),
                          min_interval_s=float(min_interval_s), max_bytes=int(max_bytes),
                          version=__version__)


def flightrec_collect(*, recorder: Getter = _none, monitor: Getter = _none,
                      engine: Getter = _none, batcher: Getter = _none, metrics: Getter = _none,
                      slo: Getter = _none, explain: Getter = _none,
                      watch_hub: Getter = _none) -> Callable[[], dict]:
    """The bundle's sections (keto_tpu/driver/registry.py:1210-1299, for the
    components the port has), each gathered under its own guard so one
    broken component cannot suppress the evidence of the rest."""

    def collect() -> dict:
        sections: dict = {}

        def sec(name, fn):
            try:
                sections[name] = fn()
            except Exception as e:
                sections[name] = {"error": repr(e)}

        rec = recorder()
        if rec is not None:
            sec("timelines", lambda: rec.snapshot(recent=100, slowest=20))
        mon = monitor()
        if mon is not None:
            sec("health", mon.snapshot)
        eng = engine()
        gov = getattr(eng, "hbm", None)
        if gov is not None:
            sec("hbm", gov.snapshot)
        b = batcher()
        if b is not None:
            def batcher_state():
                adm = b.admission
                return {
                    "queue_depth": b.queue_depth,
                    "lane_depths": b.lane_depths,
                    "inflight": b.inflight,
                    "shed_count": b.shed_count,
                    "shed_by_lane": dict(b.shed_by_lane),
                    "admission_shed_count": b.admission_shed_count,
                    "deadline_drop_count": b.deadline_drop_count,
                    "admission": None if adm is None else {
                        "window": getattr(adm, "window", None),
                        "budget_ms": getattr(adm, "budget_ms", None),
                        "last_p99_ms": getattr(adm, "last_p99_ms", None),
                    },
                }

            sec("batcher", batcher_state)
        m = metrics()
        if m is not None:
            sec("metrics", m.render)
        hub = watch_hub()
        if hub is not None:
            sec("watch", hub.snapshot)
        s = slo()
        if s is not None:
            sec("slo", s.to_json)
        ex = explain()
        if ex is not None and ex.recent_failures:
            sec("explain", lambda: {
                "verify_failures": ex.verify_failures,
                "recent": list(ex.recent_failures),
            })
        divs = getattr(eng, "audit_divergences", None)
        if divs:
            sec("audit_divergences", lambda: list(divs))
        sections["config"] = {"role": "primary", "version": __version__}
        return sections

    return collect


def wire_flight_recorder(fr: Optional[FlightRecorder], *, monitor=None, engine=None) -> None:
    """Attach the recorder's triggers (keto_tpu/driver/registry.py:
    1181-1207): health transitions into DEGRADED or NOT_SERVING (an audit
    mismatch surfaces as a DEGRADED transition), and the governor's
    contained OOMs, deferred 0.3 s so the triggering request's finished
    timeline is in the bundle. A no-op for ``fr`` None."""
    if fr is None:
        return

    def on_transition(state, reason):
        if state in (HealthState.DEGRADED, HealthState.NOT_SERVING):
            fr.trigger(f"health-{state.value}", reason)

    if monitor is not None:
        monitor.add_listener(on_transition)
    gov = getattr(engine, "hbm", None)
    if gov is not None:
        gov.on_oom = lambda what: fr.trigger("oom", what, defer_s=0.3)
