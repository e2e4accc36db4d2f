"""Embedded JSON schema for the server configuration: the port's copy of
keto_tpu/config/schema.py, whole, so every config file validates here as
it does there.

The reference validates configuration against an embedded JSON schema
(reference internal/driver/config/provider.go:24-25,
.schema/config.schema.json). It covers the keys the framework implements;
unknown keys are rejected to catch typos early. The port validates with its
own validator (keto_tpu_torch/config/validate.py), never ``jsonschema``.
The ``description`` strings are the reference's and name its modules; the
port's counterparts keep the same directory names, and the README's key
table says which keys the port wires, which wait for a ROADMAP item and
which have no counterpart.
"""

NAMESPACE_SCHEMA = {
    "$id": "keto-tpu/namespace.schema.json",
    "type": "object",
    "properties": {
        "$schema": {"type": "string"},
        "name": {"type": "string"},
        "id": {"type": "integer", "minimum": 0},
        "config": {"type": "object"},
    },
    "additionalProperties": False,
    "required": ["name", "id"],
}

CONFIG_SCHEMA = {
    "$id": "keto-tpu/config.schema.json",
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "keto-tpu configuration",
    "type": "object",
    "properties": {
        "dsn": {
            "type": "string",
            "description": "Data source name: 'memory', 'sqlite://<path>', or 'sqlite://:memory:'.",
        },
        "serve": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "read": {
                    "type": "object",
                    "additionalProperties": False,
                    "properties": {
                        "host": {"type": "string", "default": ""},
                        "port": {"type": "integer", "default": 4466},
                    },
                },
                "write": {
                    "type": "object",
                    "additionalProperties": False,
                    "properties": {
                        "host": {"type": "string", "default": ""},
                        "port": {"type": "integer", "default": 4467},
                    },
                },
                "http_backend": {
                    "type": "string",
                    "enum": ["async", "threading"],
                    "default": "async",
                    "description": "REST backend behind the port mux: 'async' (one asyncio reactor, keep-alive, bounded handler pool) or 'threading' (stdlib thread-per-connection).",
                },
                "stream_slice_target_ms": {
                    "type": "number",
                    "default": 40.0,
                    "description": "Streaming check pipeline: per-slice service-time target in milliseconds. The engine's service-time-aware controller sizes slices along the compiled width ladder so each slice's PREDICTED service time (per-route cost model fit from live width/route/BFS-step observations) stays at or below this target — lower values trade batch throughput for per-slice serving latency. Ignored on multi-controller meshes (slice geometry must be identical on every host).",
                },
                "stream_tail_ratio": {
                    "type": "number",
                    "default": 5.0,
                    "description": "Slice-tail bound the streaming controller steers toward: when the observed per-slice service-time p99 exceeds this multiple of p50 (and the p99 is over the slice target), the controller's tail guard multiplicatively tightens both the planned slice width and the pre-dispatch entry budget until the tail recovers. The bench's slice_tail section and the tail-smoke CI gate grade against the same ratio.",
                },
                "native_pack_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Native (C++) pack walk for the check hot path: the host-side frontier expansion, seen/seed dedup, and sink answer gathers run as one GIL-released call into native/libketopack.so (threaded CSR gathers), so packing slice k+2 overlaps device execution of k+1 instead of fighting the GIL. Bit-identical to the numpy path by contract (fuzz-compared in CI); snapshots with host-visible overlay state (tombstones, overlay adjacency) always use the numpy path. false — or a missing/stale library — pins numpy everywhere.",
                },
                "staging_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Persistent entry staging for slice dispatch: packed entry arrays concatenate into pooled per-geometry host buffers (leased until their slice lands, so reuse can never alias an in-flight transfer) and — on backends that implement XLA buffer donation (TPU/GPU) — ship through donated kernel arguments so the device-side staging allocation aliases into the kernel output instead of allocating fresh per slice. Pool bytes ride the HBM governor's 'staging' ledger tag and are the FIRST eviction-ladder rung (dropping them costs only per-slice allocation churn). false pins per-slice allocation + device_put.",
                },
                "overlay_edge_budget": {
                    "type": "integer",
                    "default": 4096,
                    "description": "Delta-overlay edge budget: past this many pending overlay edges + tombstones, the engine folds the overlay into the base layout by segment (overlay compaction — seconds, ids stable) instead of serving an ever-growing overlay; only overlays past 4x the budget (or shapes compaction cannot fold) fall back to a full rebuild. Overlay occupancy against this budget is exposed via the engine's maintenance counters.",
                },
                "snapshot_cache_dir": {
                    "type": "string",
                    "default": "",
                    "description": "Directory for the persistent snapshot cache. When set, every full snapshot build is serialized here (versioned, keyed by watermark) and cold start mmap-reloads the newest cache at or below the store watermark, then catches up through the delta path — minutes of ingest+build become seconds. Empty disables caching.",
                },
                "staleness_budget_s": {
                    "type": "number",
                    "default": 60.0,
                    "description": "Health state machine: how far (seconds) the serving snapshot may fall behind the store watermark before readiness flips to NOT_SERVING (REST /health/ready 503, grpc.health.v1 NOT_SERVING). Serving keeps answering from the last snapshot throughout — the budget bounds the staleness external consumers will tolerate, not availability. Recovery is automatic once the supervised refresh catches up.",
                },
                "degraded_probe_s": {
                    "type": "number",
                    "default": 5.0,
                    "description": "Degraded (CPU fallback) mode: how often the engine re-probes the failing device path with a live batch. While degraded, checks are served by the CPU reference engine with bit-identical decisions and health reports DEGRADED; a successful probe restores the device path automatically.",
                },
                "shed_on_full": {
                    "type": "boolean",
                    "default": True,
                    "description": "Load shedding: answer 429 / RESOURCE_EXHAUSTED (with a Retry-After hint) immediately when a check lane is at capacity, instead of blocking callers into their own timeouts. Expired request deadlines (gRPC deadline, X-Request-Timeout-Ms) always shed with 504 / DEADLINE_EXCEEDED before packing.",
                },
                "interactive_max_tuples": {
                    "type": "integer",
                    "default": 16,
                    "description": "Priority lanes: check requests with at most this many tuples (and no explicit X-Keto-Priority / x-keto-priority hint) classify into the interactive lane, which is packed into the next dispatch round ahead of all queued batch-lane work. Larger requests ride the batch lane.",
                },
                "batch_sub_slice": {
                    "type": "integer",
                    "default": 1024,
                    "description": "Priority lanes: at most this many batch-lane tuples join one dispatch round, so a monster batch request is served in bounded sub-slices that interleave with interactive checks instead of owning the device for its full width. An interactive check arriving mid-burst waits at most one sub-slice, not the whole batch.",
                },
                "admission_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Adaptive admission control: an AIMD window over the batch check lane, keyed off the slice service-time histogram the stream width controller records plus the batcher's queue-delay estimate. Past the latency budget the admitted window shrinks multiplicatively and excess batch-lane load sheds 429 + Retry-After before it queues; interactive checks are never admission-limited.",
                },
                "admission_latency_budget_ms": {
                    "type": "number",
                    "default": 0.0,
                    "description": "The latency estimate (slice p99 or queued-delay) past which the admission controller judges the server overloaded. 0 derives 4x serve.stream_slice_target_ms.",
                },
                "admission_min_window": {
                    "type": "integer",
                    "default": 64,
                    "description": "Floor of the AIMD admission window (queued batch-lane tuples): even in deep overload this much batch work stays admitted, so the lane drains and recovery is observable.",
                },
                "group_commit_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Group-commit write path: concurrent write transactions coalesce in the driver's commit coordinator and commit as ONE durable SQL transaction (batched executemany row inserts, one fsync), with per-writer snaptokens, idempotency keys, and traceparents preserved — each writer still gets its own replayable key row and its own token from the group's commit sequence. false pins every write to its own BEGIN/COMMIT (the pre-group-commit behavior).",
                },
                "group_commit_max_writers": {
                    "type": "integer",
                    "default": 128,
                    "description": "Group-commit size cap: at most this many writers coalesce into one durable transaction. The coordinator flushes at this size or at group_commit_window_ms, whichever lands first; larger groups amortize the commit cost further but lengthen the failure blast radius (every writer in a failed group sees the same error and retries).",
                },
                "group_commit_window_ms": {
                    "type": "number",
                    "default": 2.0,
                    "description": "Group-commit coalescing window (milliseconds): how long the coordinator holds the FIRST writer of a forming group waiting for company before flushing. The direct ack-latency tax a lone writer pays for batching — keep it well under the write SLO; 0 flushes every collector pass (batching only what arrived concurrently).",
                },
                "group_commit_max_pending": {
                    "type": "integer",
                    "default": 4096,
                    "description": "Group-commit queue depth: past this many queued writers, enqueue blocks (bounded by the caller's timeout) instead of growing the queue — blocking backpressure, not shedding, because a write has no cheap retry answer. Effective floor is group_commit_max_writers.",
                },
                "watch_gc_max_rows": {
                    "type": "integer",
                    "default": 10000,
                    "description": "Watch-log GC pass cap: the interval-guarded retention GC that piggybacks on the write path prunes at most this many delete-log rows per pass (boundary commit-time ties may exceed it slightly), so a long-idle backlog drains across passes instead of stalling a group commit behind one unbounded DELETE sweep. 0 removes the cap.",
                },
                "fold_segment_edges": {
                    "type": "integer",
                    "default": 2048,
                    "description": "Log-structured compaction: target overlay-edge count folded into the base snapshot per background fold pass. Each pass folds the oldest overlay segments (up to this many edges) through the device-splice compactor while new writes keep landing in the newest segment — overlay occupancy is bounded by fold rate instead of a stop-the-world budget trip. Smaller = shorter passes, more of them.",
                },
                "idempotency_ttl_s": {
                    "type": "number",
                    "default": 86400.0,
                    "description": "Idempotent writes: how long (seconds) an X-Idempotency-Key / x-idempotency-key binding dedups retries of the same transaction. Within the TTL a retried key re-applies nothing and replays the original snaptoken (X-Keto-Idempotent-Replay: true); past it the key is garbage-collected from the durable dedup table and a resend applies as a fresh write. Size it to your clients' worst-case retry horizon.",
                },
                "labels_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "2-hop reachability labels: build a pruned-landmark label index over the interior graph at snapshot-build time and serve label-certifiable checks with one O(1)-step intersection kernel instead of the depth-paying BFS loop. Checks the labels cannot certify (wildcards, overlay-dirtied interior edges, coverage gaps, self-queries) fall back to BFS bit-identically. false skips construction entirely.",
                },
                "labels_max_width": {
                    "type": "integer",
                    "default": 64,
                    "description": "Per-row width cap of the 2-hop label arrays (entries per node per direction). A row hitting the cap is marked uncovered — checks through it fall back to BFS — so the cap bounds device memory without ever changing a decision. Raise on hub-heavy graphs whose labels overflow (watch keto_label_coverage_ratio).",
                },
                "labels_landmarks": {
                    "type": "integer",
                    "default": 0,
                    "description": "How many degree-ranked interior nodes to process as 2-hop landmarks. 0 = auto: the device build (serve.labels_device_build) streams ALL interior rows — no coverage cap — stopping early only via serve.labels_min_gain; the host fallback keeps the 131072 safety cap (its per-landmark BFS is serial Python). Fewer landmarks shrink build time and coverage; uncovered pairs fall back to BFS, never to a wrong answer. Either truncation emits keto_label_build_truncated_total with the achieved coverage ratio.",
                },
                "labels_device_build": {
                    "type": "boolean",
                    "default": True,
                    "description": "Build the 2-hop label index as batched landmark BFS sweeps on the accelerator (bit-packed frontier waves, 64 landmarks per dispatch, PLL pruning as an ANDNOT against covered rows) instead of the serial host walk — entry-set-identical, orders of magnitude faster on deep graphs, and overlapped with the rest of the snapshot pipeline. The build's transient footprint is planned against the HBM governor (evict=False) and falls back to the host path when the plan is refused, the graph is under serve.labels_device_min_edges, or the sweep errors.",
                },
                "labels_min_gain": {
                    "type": "number",
                    "default": 0.0,
                    "description": "Early-exit threshold for the uncapped device label build: stop streaming landmarks once a batch's marginal coverage gain (new label entries per landmark per interior row) drops below this. 0.0 processes every landmark (exact full build). Nonzero values trade tail coverage for build time on graphs whose low-degree tail adds nothing — truncation is reported via keto_label_build_truncated_total{reason=\"min_gain\"} and the uncovered pairs fall back to BFS.",
                },
                "labels_batch": {
                    "type": "integer",
                    "default": 64,
                    "description": "Landmarks swept concurrently per device dispatch (lanes of the bit-packed frontier words, rounded up to a multiple of 32 internally). Larger batches amortize dispatch overhead but widen the frontier/covered matrices (HBM transient scales linearly) and raise the odds of an intra-batch dependency restart; 64 is right for almost everyone.",
                },
                "labels_device_min_edges": {
                    "type": "integer",
                    "default": 65536,
                    "description": "Interior adjacency slots (ELL rows x width) below which the label build skips the device path and uses the host walk directly — tiny graphs finish on host faster than one XLA dispatch. Set 0 to force the device path everywhere (parity tests do).",
                },
                "hbm_budget_bytes": {
                    "type": "integer",
                    "default": 0,
                    "description": "Device-memory (HBM) budget in bytes for the engine's resident state (snapshot buckets, overlay ELL, 2-hop label arrays, warm-ladder workspace). Every upload is planned against the governor's ledger BEFORE it happens; over budget, a deterministic eviction ladder sheds coverage-only state (labels -> warm compile-width ladder -> overlay budget -> refuse the refresh and serve stale with DEGRADED memory_pressure) instead of dying on RESOURCE_EXHAUSTED. 0 = auto: the device's reported bytes_limit minus headroom, with a conservative fallback when the backend exposes no memory stats (e.g. CPU).",
                },
                "audit_sample_rate": {
                    "type": "number",
                    "default": 0.0,
                    "description": "Sampled shadow-parity auditor: the fraction of live check decisions re-verified against the CPU reference oracle in a supervised background worker (0 disables). Samples whose snaptoken the store has moved past are skipped; any real divergence increments keto_audit_mismatches_total and flips health to DEGRADED — continuous proof that HBM eviction rungs (and everything else) never change answers. Costs one oracle traversal per sampled check, off the serving path.",
                },
                "explain_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Decision provenance (keto_tpu/explain): GET /check/explain + gRPC ExplainService reconstruct, for any Check, a concrete witness path (grant) or frontier-exhaustion certificate (deny), report the route that decided (label/hybrid/bfs/host/cpu) and — on label-route grants — the winning 2-hop landmark, and verify every witness edge-by-edge against the Manager before returning it. false answers the endpoints 404 and adds zero work anywhere (the check hot path never touches the explain subsystem either way).",
                },
                "decision_log_sample": {
                    "type": "number",
                    "default": 0.0,
                    "description": "Durable decision-audit log sampling: the fraction of live check decisions appended to the decision log (keto_tpu/explain/decision_log.py) as {tuple, decision, route, snaptoken, trace_id, tenant} records — witness-free on the hot path; the snaptoken makes any sampled decision re-explainable later via GET /check/explain?snaptoken=... (docs/concepts/explain.md). 0 disables sampling; explain requests themselves are always recorded (witness included) when the log is configured. Costs one RNG draw plus, on sampled requests, one buffered JSON append — bench.py's explain_overhead section gates a 1% sample at <= 5% check p99 impact.",
                },
                "decision_log_dir": {
                    "type": "string",
                    "default": "",
                    "description": "Decision-audit log root directory: tenant-scoped subdirectories each holding an append-only active segment plus sealed segments (atomic fsync-then-rename rotation like the snapshot cache, so sealed segments are never torn; a SIGKILL can at worst leave a partial final line in the active segment, which readers tolerate). Empty disables the decision log entirely.",
                },
                "decision_log_segment_bytes": {
                    "type": "integer",
                    "default": 1048576,
                    "description": "Decision-log segment size: the active segment is sealed (fsync + atomic rename) and a fresh one started once it crosses this many bytes.",
                },
                "decision_log_retention": {
                    "type": "integer",
                    "default": 8,
                    "description": "Decision-log retention: newest sealed segments kept per tenant; older ones are deleted after each rotation.",
                },
                "watch_poll_ms": {
                    "type": "number",
                    "default": 100.0,
                    "description": "Watch changefeed poll period: how often an idle watch stream probes the store watermark for new commits (keto_tpu/list/watch.py). Poll-based liveness is correct across multi-process deployments sharing one SQL store — a commit from another server's write port still reaches every watcher within one period.",
                },
                "watch_max_streams": {
                    "type": "integer",
                    "default": 64,
                    "description": "Concurrent watch streams (REST chunked + gRPC server-stream) per process; past it new subscriptions shed 429/RESOURCE_EXHAUSTED with Retry-After instead of accumulating unbounded long-lived connections.",
                },
                "list_cache_entries": {
                    "type": "integer",
                    "default": 64,
                    "description": "Materialized reverse-query result sets kept per process (LRU, keyed by query + snapshot id): follow-up pages of one listing slice the cached sorted result instead of re-running the BFS. A snapshot advance naturally invalidates (the key changes).",
                },
                "compile_cache_dir": {
                    "type": "string",
                    "default": "",
                    "description": "Persistent XLA compilation cache directory (jax compilation_cache_dir). When set, compiled kernels survive process restarts — and boot warms the full slice-width ladder (BFS + label kernels) ahead of traffic, so the multi-second warmup/compile cost is paid once per binary instead of once per boot. Empty disables both.",
                },
                "device_build_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Device-side snapshot construction: run the build's edge-scale stable sorts (device-id renumbering, ELL grouping, forward/transposed CSRs, list layouts — the O(E log E) tail of a full rebuild and of compaction's CSR splice) on the accelerator instead of host numpy. Bit-identical by the stable-sort contract and fuzz-asserted so; each dispatch is planned against the HBM governor as a transient 'build' allocation and falls back to the host path (same answers) under memory pressure. false pins the host path.",
                },
                "build_chunk_rows": {
                    "type": "integer",
                    "default": 262144,
                    "description": "Rows per chunk of the streaming snapshot scan (the persisters' chunked-cursor seam): each chunk feeds the native intern worker pool while the cursor fetches the next, so store I/O overlaps interning during full rebuilds. Larger chunks amortize per-chunk overhead; smaller ones smooth the pipeline and bound buffered-chunk memory.",
                },
                "mesh_graph": {
                    "type": "integer",
                    "default": 1,
                    "description": "Graph-axis size of the device mesh: how many shards the interior bitmap / bucket / label rows partition into by contiguous row range (keto_tpu/parallel/sharded.py). 1 (default) serves from a single device. Values > 1 require mesh_graph * mesh_data (or mesh_graph when mesh_data is auto) devices and enable multi-chip serving; decisions stay bit-identical to the single-device engine.",
                },
                "mesh_data": {
                    "type": "integer",
                    "default": 0,
                    "description": "Data-axis size of the device mesh: query slices replicate along this axis. 0 = auto (every device not consumed by the graph axis). Only meaningful when mesh_graph > 1 or mesh_data > 1.",
                },
                "mesh_sharded": {
                    "type": "boolean",
                    "default": True,
                    "description": "Mesh execution strategy: true (default) runs the explicit shard_map program — row-range shards with a per-hop halo exchange of the frontier bitmap slabs, per-shard HBM ledger, per-shard snapshot-cache segments, and the keto_shard_* metric families; false falls back to the legacy GSPMD path (XLA's partitioner infers the cross-shard traffic, no per-shard observability).",
                },
                "role": {
                    "type": "string",
                    "enum": ["primary", "replica"],
                    "default": "primary",
                    "description": "Serving role. 'primary' owns the SQL store and the write path. 'replica' holds NO SQL access: it bootstraps its tuple state from the primary's GET /snapshot/export (riding the primary's snapshot-cache segments when their watermarks line up), tails the primary's /watch changefeed applying each commit group at the primary's own snaptoken through the delta-overlay path, keeps a durable applied-watermark (serve.replica_dir) for exactly-once resume after SIGKILL, and serves check/expand/list at any snaptoken <= its watermark. Writes to a replica answer 403; reads pinned above the watermark block up to serve.staleness_wait_ms then answer 412 + Retry-After with the current watermark.",
                },
                "primary_url": {
                    "type": "string",
                    "default": "",
                    "description": "Replica mode: base URL of the primary's READ API (http://host:4466) — the source of /snapshot/export bootstraps and the /watch feed. Required when serve.role=replica.",
                },
                "replica_dir": {
                    "type": "string",
                    "default": "",
                    "description": "Replica mode: directory for the durable applied-watermark file. With it set, a SIGKILL'd replica resumes its Watch feed from the last applied snaptoken with exactly-once re-application (the store's watermark guard skips re-delivered groups); empty keeps the watermark in memory only (a restart re-bootstraps from scratch — still correct, just slower).",
                },
                "staleness_wait_ms": {
                    "type": "number",
                    "default": 200.0,
                    "description": "Replica mode: how long a read pinned to a snaptoken ABOVE the replica's applied watermark blocks on the feed before answering 412 Precondition Failed (+ Retry-After and the current watermark). The feed normally closes small gaps within one watch poll period, so this bounds the tail, not the common case.",
                },
                "replica_staleness_budget_s": {
                    "type": "number",
                    "default": 30.0,
                    "description": "Replica mode: how long the replica may go without confirming it is caught up with the primary (feed lagging, or the primary unreachable — indistinguishable and handled the same) before health reports DEGRADED(replication_lag). The replica keeps serving at its watermark throughout; the budget bounds the staleness consumers will tolerate.",
                },
                "checkcache_entries": {
                    "type": "integer",
                    "default": 65536,
                    "description": "Replica mode: capacity of the Watch-invalidated check cache (positive AND negative decisions, keyed by tuple + snaptoken window, LRU). Any applied delta closes every open window — globally, because reachability is transitive across namespaces — so the cache can never serve a hit an applied delta invalidated; snaptoken-pinned reads below a closed window still hit. 0 disables.",
                },
                "fleet_enabled": {
                    "type": "boolean",
                    "default": False,
                    "description": "Fleet control plane (keto_tpu/fleet/): run the lease-election / membership / promotion loop. A primary acquires and renews a fenced lease row (keto_fleet_lease) through the SQL store and stamps its writes with the lease epoch; replicas heartbeat membership, watch the lease, and on primary death the most-caught-up replica promotes itself — installing a direct SQL store at its applied watermark, fencing it at the won epoch, and flipping the write path — while the deposed primary's in-flight writes answer 409 ErrFencedEpoch. false (default) keeps the static primary/replica topology.",
                },
                "fleet_node_id": {
                    "type": "string",
                    "default": "",
                    "description": "Stable identity of this node in the fleet membership table (lease holder, heartbeat row, routing-weight label). Empty derives hostname-pid — fine for ephemeral replicas, set it explicitly when the durable applied-watermark (serve.replica_dir) should survive restarts under the same identity.",
                },
                "fleet_advertise_url": {
                    "type": "string",
                    "default": "",
                    "description": "Base URL of this node's READ API as other fleet members and SDK clients should reach it (http://host:4466). Published in the membership table; the SDK's lag-aware routing and post-failover primary re-resolution both read it. Empty publishes no URL (the node still participates in election).",
                },
                "fleet_lease_ttl_s": {
                    "type": "number",
                    "default": 2.0,
                    "description": "Fleet lease time-to-live. The primary renews every serve.fleet_heartbeat_s; a lease unrenewed past this is up for grabs, so primary-death failover completes in roughly ttl + promotion grace + install time (the <5s budget the chaos smoke asserts). Lower is faster failover but less tolerance for store hiccups; must comfortably exceed the heartbeat period.",
                },
                "fleet_heartbeat_s": {
                    "type": "number",
                    "default": 0.5,
                    "description": "Fleet control-loop period: lease renewal on the primary, membership heartbeat + lease watch on replicas. Membership rows older than ~3 heartbeats age out of fleet_size and the routing-weight table.",
                },
                "fleet_promotion_grace_s": {
                    "type": "number",
                    "default": 0.5,
                    "description": "Rank-staggered election backoff: after observing the lease expire, the replica ranked k by (-applied watermark, node_id) waits k times this before contending, so the most-caught-up replica wins the CAS uncontested in the common case. The stagger bounds added failover latency for lower ranks; the guarded-update CAS stays correct (exactly one winner per epoch) even when ranks race.",
                },
                "fleet_autoscale_enabled": {
                    "type": "boolean",
                    "default": False,
                    "description": "SLO-burn autoscale loop (keto_tpu/fleet/autoscale.py): watch the worst-window availability/latency burn rates, batcher queue-depth ratio, and HBM eviction rung, and grow/shrink the replica fleet between serve.fleet_min_replicas and serve.fleet_max_replicas with asymmetric hysteresis (grow after sustained overload, shrink only after a much longer calm, cooldown between actions, HBM pressure vetoes shrink). Advisory — snapshot/metrics only — unless the daemon is given a replica spawn template.",
                },
                "fleet_min_replicas": {
                    "type": "integer",
                    "default": 0,
                    "description": "Autoscaler floor: never retire below this many replicas.",
                },
                "fleet_max_replicas": {
                    "type": "integer",
                    "default": 4,
                    "description": "Autoscaler ceiling: never spawn above this many replicas (bound it by the snapshot-export fan-out the primary can serve and the devices available).",
                },
                "fleet_scale_sustain_s": {
                    "type": "number",
                    "default": 5.0,
                    "description": "Autoscaler hysteresis: overload (any burn rate > 1, or queue depth >= 80% of capacity) must hold continuously this long before a grow action; calm must hold 4x this long before a shrink. Readings between the two thresholds (the dead band) reset both timers — a 10x diurnal swell scales up once and back down once instead of flapping.",
                },
                "fleet_scale_cooldown_s": {
                    "type": "number",
                    "default": 30.0,
                    "description": "Autoscaler cooldown: minimum seconds between scale actions in either direction, so a freshly spawned replica's bootstrap window cannot itself trigger the next action.",
                },
                "watch_log_retention_s": {
                    "type": "number",
                    "default": 3600.0,
                    "description": "How long (seconds, wall clock) the durable change logs feeding /watch and the delta-overlay path retain entries before GC (memory and SQL stores; on SQL the tuple rows themselves also serve insert replay and are never GC'd — this bounds the delete log). A watch resume (or replica feed) older than the retained horizon answers 410/ErrWatchExpired; replicas recover by automatic full re-bootstrap. 0 disables time-based GC (the count-based caps still apply).",
                },
                "timeline_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Per-request timeline recorder (keto_tpu/x/timeline.py): every non-health request records the stages it passes through (arrival, admission verdict, lane queue wait, pack, dispatch, each device slice with width/BFS-steps/route/halo cost, land, deliver) into a bounded ring, emits them as child spans under the request's traceparent, summarizes them in the Server-Timing response header (gRPC: server-timing trailing metadata), and serves them at GET /debug/requests. Cheap enough to leave on (bench.py timeline_overhead gates <= 5% p99 impact); false disables recording entirely (the endpoints stay, reporting empty).",
                },
                "timeline_ring": {
                    "type": "integer",
                    "default": 512,
                    "description": "How many finished request timelines the recorder's ring retains (plus a fixed top-K slowest set kept separately). GET /debug/requests reads from this bound; older timelines rotate out.",
                },
                "debug_bundle_dir": {
                    "type": "string",
                    "default": "",
                    "description": "Flight recorder (keto_tpu/x/flightrec.py): directory anomaly debug bundles are atomically written to. A bundle (recent+slowest request timelines, health transition history, HBM governor ledger, admission/batcher state, a metrics snapshot, the lockwatch report when the sanitizer runs) is dumped on DEGRADED/NOT_SERVING health transitions, contained device OOMs, SIGTERM drains, and lock-watchdog trips — rate-limited, size-capped, and count-bounded. Empty disables the recorder.",
                },
                "debug_bundle_max": {
                    "type": "integer",
                    "default": 8,
                    "description": "Flight recorder retention: newest bundles kept in serve.debug_bundle_dir; older ones are pruned after each dump.",
                },
                "debug_bundle_min_interval_s": {
                    "type": "number",
                    "default": 30.0,
                    "description": "Flight recorder rate limit: minimum seconds between bundle dumps — a flapping health state or an OOM storm produces one bundle per interval, not one per event (suppressed triggers are counted on keto_flightrec_suppressed_total).",
                },
                "debug_bundle_max_bytes": {
                    "type": "integer",
                    "default": 4194304,
                    "description": "Flight recorder size cap: a bundle exceeding this sheds sections in a deterministic order (metrics snapshot first, timelines last) and records which were shed, so one dump can never write an unbounded file.",
                },
                "slo_availability_objective": {
                    "type": "number",
                    "default": 0.999,
                    "description": "SLO engine (keto_tpu/x/slo.py): the availability objective (fraction of REST+gRPC requests without a server-side 5xx/INTERNAL-class failure) the keto_slo_* burn rates and GET /slo are judged against.",
                },
                "slo_latency_objective_ms": {
                    "type": "number",
                    "default": 250.0,
                    "description": "SLO engine: the latency threshold (milliseconds) a request must answer within to count as 'good' for the latency objective. Quantized UP to the nearest request-latency histogram bucket edge; the /slo report states the edge actually used.",
                },
                "slo_latency_objective_ratio": {
                    "type": "number",
                    "default": 0.99,
                    "description": "SLO engine: the target fraction of requests answering within serve.slo_latency_objective_ms; the latency burn rate measures budget spend against 1 minus this.",
                },
                "drain_timeout_s": {
                    "type": "number",
                    "default": 5.0,
                    "description": "Graceful shutdown: after SIGTERM/SIGINT the daemon pins readiness to NOT_SERVING (new traffic routes away) and waits up to this many seconds for in-flight checks to resolve before tearing the servers down — the zero-dropped-requests half of a rolling restart.",
                },
                "tenant_enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "Multi-tenant serving (keto_tpu/driver/tenants.py): an X-Keto-Tenant header (gRPC: x-keto-tenant metadata) scopes the request to that tenant's own engine, check batcher + admission window, store view, and watch hub, pooled in the TenantPool. Absent header = the default tenant, which is the pre-tenancy registry — every existing contract is untouched either way. false rejects non-default tenant headers with 400; tenant-scoped requests are always primary-only.",
                },
                "tenant_backend": {
                    "type": "string",
                    "enum": ["oracle", "device", "auto"],
                    "default": "oracle",
                    "description": "Engine kind built per non-default tenant: 'oracle' (CPU reference engine — bit-identical decisions by construction, no device residency, scales to thousands of mostly-idle tenants), 'device' (a full TpuCheckEngine per tenant with its own snapshot/overlay/label lifecycle and segmented snapshot cache under <snapshot_cache_dir>/tenants/<id>), or 'auto' (device when the default engine is device-backed, oracle otherwise). The default tenant always keeps the engine.backend selection.",
                },
                "tenant_max_resident": {
                    "type": "integer",
                    "default": 8,
                    "description": "How many non-default tenants may hold device-resident engine state at once. Admitting tenant N+1 evicts the least-recently-dispatching resident tenant WHOLE (engine closed, bytes returned to the HBM ledger) — never a tenant mid-dispatch — and the evicted tenant faults back in through its snapshot cache on first touch. The governor's tenant-lru eviction rung sheds the coldest tenant under machine-wide memory pressure the same way.",
                },
                "tenant_quota_share": {
                    "type": "number",
                    "default": 0.25,
                    "description": "Per-tenant admission quota as a fraction of the machine's batch capacity (engine.batch_size-derived, clamped to [0.01, 1.0]): each tenant's batcher caps its pending queue and AIMD admission window at this share, so one tenant's 10x storm sheds 429 for THAT tenant while every other tenant's lanes stay within budget. Retry-After on a tenant's 429s reflects that tenant's consecutive overloaded ticks, not the machine's.",
                },
                "tenant_shed_spike": {
                    "type": "integer",
                    "default": 50,
                    "description": "Per-tenant shed-rate anomaly trigger: this many sheds from one tenant inside the sliding 10-second window fires the flight recorder (reason tenant-shed-spike, bundle carries the per-tenant ledger and shed totals), once per window crossing. 0 disables the trigger.",
                },
                "tenant_hbm_budget_bytes": {
                    "type": "integer",
                    "default": 0,
                    "description": "Per-tenant HBM budget (bytes) handed to each device-backed tenant engine's own governor ledger; 0 = auto (same derivation as serve.hbm_budget_bytes). Cross-tenant residency is arbitrated above this by serve.tenant_max_resident and the tenant-lru rung.",
                },
            },
        },
        "namespaces": {
            "oneOf": [
                {"type": "array", "items": NAMESPACE_SCHEMA},
                {"type": "string", "description": "file:// URI of a namespace file or directory"},
            ]
        },
        "engine": {
            "type": "object",
            "additionalProperties": False,
            "description": "TPU check-engine tuning; no reference analog (the reference engine has no knobs).",
            "properties": {
                "backend": {"type": "string", "enum": ["tpu", "oracle", "auto"], "default": "auto"},
                "batch_size": {"type": "integer", "default": 4096},
                "it_cap": {
                    "type": "integer",
                    "default": 4096,
                    "description": "BFS iteration cap per device batch; hitting it logs a truncation warning.",
                },
                "peel_seed_cap": {
                    "type": "number",
                    "default": 4.0,
                    "description": "Max host-propagated seeds a peeled node may expand to; raise on local hardware with fast host-device links.",
                },
                "batch_window_ms": {"type": "number", "default": 1.0},
                "sync_rebuild_budget_s": {
                    "type": "number",
                    "default": 0.25,
                    "description": "Serving-path policy: when the last full snapshot rebuild cost more than this, default-consistency checks serve the current snapshot and rebuilds run in the background (bounded staleness); cheaper stores catch up inline (read-your-writes).",
                },
            },
        },
        "limit": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "max_read_depth": {
                    "type": "integer",
                    "default": 5,
                    "description": "Global expand depth cap; requests asking for 0 or more than this get this.",
                }
            },
        },
        "log": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "level": {
                    "type": "string",
                    "enum": ["trace", "debug", "info", "warning", "error", "fatal"],
                    "default": "info",
                },
                "format": {"type": "string", "enum": ["text", "json"], "default": "text"},
            },
        },
        "tracing": {
            "type": "object",
            "additionalProperties": False,
            "description": "Span export, config-selected like the reference's tracing.provider (reference internal/driver/config/provider.go:145-155).",
            "properties": {
                "provider": {
                    "type": "string",
                    "enum": ["", "log", "memory", "otlp-file", "otlp-http"],
                    "default": "",
                },
                "otlp": {
                    "type": "object",
                    "additionalProperties": False,
                    "properties": {
                        "file": {
                            "type": "string",
                            "default": "",
                            "description": "otlp-file provider: path appended with one OTLP/JSON ExportTraceServiceRequest per line (tail it with a collector's filelog receiver).",
                        },
                        "endpoint": {
                            "type": "string",
                            "default": "http://127.0.0.1:4318/v1/traces",
                            "description": "otlp-http provider: OTLP/HTTP collector endpoint (standard local listener by default).",
                        },
                    },
                },
            },
        },
        "profiling": {
            "type": "string",
            "enum": ["", "cpu", "mem", "trace"],
            "default": "",
            "description": "Process profiler: 'cpu' (cProfile), 'mem' (tracemalloc), or 'trace' (jax.profiler device timeline — no-op when jax/its profiler backend is unavailable). Stats land on stderr at clean shutdown; traces under KETO_TPU_TRACE_DIR (default ./keto-tpu-trace).",
        },
        "metrics": {
            "type": "object",
            "additionalProperties": False,
            "description": "Prometheus exposition of the process-wide MetricsRegistry (keto_tpu/x/metrics.py) at GET /metrics on both API ports: request counters and latency histograms (trace-exemplared), batcher queue/shed gauges, engine slice service times, maintenance, health, tracer, and persistence counters.",
            "properties": {
                "enabled": {
                    "type": "boolean",
                    "default": True,
                    "description": "false swaps in a no-op registry (recording sites stay, cost nothing) and /metrics answers 404.",
                }
            },
        },
        "telemetry": {
            "type": "object",
            "additionalProperties": False,
            "description": "In-process usage counters (the zero-egress analog of the reference's SQA middleware, reference internal/driver/daemon.go:27-55). Off by default.",
            "properties": {"enabled": {"type": "boolean", "default": False}},
        },
    },
    "additionalProperties": False,
}
