"""The serving process: one store, one check engine on the card, the list
engine and the snapshot-backed expand engine beside it on the same
snapshots, one check batcher and the read and write REST ports (reference
internal/driver/daemon.go, cut to the Check, Expand, List and tuple
slices). ``max_read_depth`` caps an expand's depth (the reference's
``limit.max_read_depth``, default 5). The engine serves with
2-hop labels on, as the reference's daemon does; ``engine_options`` passes
the label knobs (``labels_enabled``, ``labels_max_width``,
``labels_landmarks``, ``labels_device_build``, ``labels_min_gain``,
``labels_batch``, ``labels_device_min_edges``) and the overlay knobs
(``overlay_edge_budget``, ``fold_segment_edges``, ``compact_after_s``,
``sync_rebuild_budget_s``), ``device_build_enabled`` (the build's sorts
on the card) and the stream and audit knobs (``stream_slice_target_ms``,
``stream_tail_ratio``, ``audit_sample_rate``) through to
``TorchCheckEngine``. Writes apply as
delta overlays folded in the background (keto_tpu_torch/graph/overlay.py,
keto_tpu_torch/graph/compaction.py).

Decision provenance (keto_tpu/driver/registry.py:790-838, defaults from
keto_tpu/config/schema.py:208-230): ``explain_enabled`` (default true)
serves ``GET /check/explain`` through an ``ExplainEngine`` over the engine
and the store; ``decision_log_dir`` (default "": no log) keeps a
``DecisionLog`` that records every explain and, with
``decision_log_sample`` > 0, that fraction of ``/check`` decisions, in
segments of ``decision_log_segment_bytes`` (1 MiB) of which
``decision_log_retention`` (8) sealed ones are kept.

Sharded serving (keto_tpu/driver/registry.py:650-680, the registry's
``serve.mesh_graph``): ``mesh_graph`` > 1 serves from a ``ShardMesh`` of
that many row-range shards on the engine's device
(keto_tpu_torch/parallel/); 1 (the default) serves unsharded.

The check batcher is wired by ``make_batcher`` as the reference's registry
wires it (keto_tpu/driver/registry.py:878-920): priority lanes, a full lane
shedding 429, and admission control over the engine's slice service times
(``admission_enabled``). ``timeline_enabled`` (default true) keeps one
``TimelineRecorder`` for both ports. ``drain_and_shutdown`` is the
reference's drain (keto_tpu/driver/daemon.py:163-277) cut to this daemon:
the health monitor is pinned NOT_SERVING (``/health/ready`` answers 503)
while the batcher's in-flight checks and the servers' open exchanges
finish, then everything stops; the signal handling stays with the CLI
(ROADMAP A7).

Health (keto_tpu/driver/daemon.py:90-93): the daemon makes one
``HealthMonitor`` over its engine before it serves, and both ports'
``/health/ready`` read it (keto_tpu_torch/driver/health.py). Its
staleness budget and the engine's device-memory budget are the reference
schema's defaults (``serve.staleness_budget_s`` 60 s,
``serve.hbm_budget_bytes`` 0 = auto; keto_tpu/config/schema.py:88-91,
:198-202), held as constants until the config loader (ROADMAP A7).

Writes (keto_tpu/driver/registry.py:161-230): the write port's
transactions go through a ``GroupCommitCoordinator``
(keto_tpu_torch/driver/group_commit.py) that commits concurrent writers as
one store group, at the reference's defaults (128 writers, a 2.0 ms
window, 4,096 pending; they become settings with the config loader,
ROADMAP A7); the drain waits for its queued writers too
(keto_tpu/driver/daemon.py:249-252). ``snapshot_cache_dir`` (default "":
off, keto_tpu/config/schema.py:83-86) keeps the engine's snapshot cache
there (keto_tpu_torch/graph/snapcache.py).

Observability (keto_tpu/driver/registry.py:1107-2460, wired by
keto_tpu_torch/driver/observability.py; the keys and defaults of
keto_tpu/config/schema.py): ``metrics_enabled`` (``metrics.enabled``, true)
builds the metrics registry both ports' ``GET /metrics`` serve, bridged to
every component; ``tracing_provider`` (``tracing.provider``, "": off;
``log``, ``memory``, ``otlp-file`` with ``tracing_otlp_file``, ``otlp-http``
with ``tracing_otlp_endpoint``) traces every request with its stage spans;
the SLO engine behind ``GET /slo`` judges the objectives
``SLO_AVAILABILITY_OBJECTIVE`` (0.999), ``SLO_LATENCY_OBJECTIVE_MS`` (250)
and ``SLO_LATENCY_OBJECTIVE_RATIO`` (0.99); ``debug_bundle_dir`` ("": off)
keeps a flight recorder there (``DEBUG_BUNDLE_MAX`` 8 bundles, one per
``DEBUG_BUNDLE_MIN_INTERVAL_S`` 30 s at most, ``DEBUG_BUNDLE_MAX_BYTES``
4 MiB each; these six are constants at the reference schema's defaults until
the config loader, ROADMAP A7) that dumps a bundle on a health transition
into DEGRADED or NOT_SERVING, on the governor's contained OOMs (0.3 s later, so the
request's timeline is in it) and first thing in a drain; ``log_level`` and
``log_format`` (``log.level`` info, ``log.format`` text) set the logger the
servers log through. The drain closes (flushes) the tracer last
(keto_tpu/driver/daemon.py:173-178, :265-280)."""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence, Union

import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.admission import AdmissionController
from keto_tpu_torch.driver.batch import CheckBatcher
from keto_tpu_torch.driver.group_commit import GroupCommitCoordinator
from keto_tpu_torch.driver import observability as obs
from keto_tpu_torch.driver.health import HealthMonitor, HealthState
from keto_tpu_torch.expand.snapshot_engine import SnapshotExpandEngine
from keto_tpu_torch.explain import DecisionLog, ExplainEngine
from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.servers.rest import MAX_READ_DEPTH, READ, WRITE, RestServer
from keto_tpu_torch.x.device import resolve_device
from keto_tpu_torch.x.logging import new_logger
from keto_tpu_torch.x.timeline import TimelineRecorder
from keto_tpu_torch.x.tracing import DEFAULT_OTLP_ENDPOINT, Tracer

#: the readiness reason while a drain runs (keto_tpu/driver/daemon.py:183)
DRAINING = "draining: shutdown requested"
#: the reference schema's defaults (keto_tpu/config/schema.py:88-91,
#: :198-202): seconds behind the store before /health/ready answers 503,
#: and the device-memory budget (0 = auto); knobs with the config loader
STALENESS_BUDGET_S = 60.0
HBM_BUDGET_BYTES = 0
#: the reference schema's ``serve.slo_*`` and ``serve.debug_bundle_*``
#: defaults (keto_tpu/config/schema.py); knobs with the config loader
SLO_AVAILABILITY_OBJECTIVE = 0.999
SLO_LATENCY_OBJECTIVE_MS = 250.0
SLO_LATENCY_OBJECTIVE_RATIO = 0.99
DEBUG_BUNDLE_MAX = 8
DEBUG_BUNDLE_MIN_INTERVAL_S = 30.0
DEBUG_BUNDLE_MAX_BYTES = 4 << 20


#: the reference registry's batcher settings at their defaults
#: (keto_tpu/driver/registry.py:878-920: ``engine.batch_size``,
#: ``engine.batch_window_ms``, ``serve.interactive_max_tuples``,
#: ``serve.batch_sub_slice``, ``serve.admission_min_window``); they come
#: back as knobs with the config loader (ROADMAP A7)
BATCH_SIZE = 4096
WINDOW_MS = 1.0
INTERACTIVE_MAX_TUPLES = 16
BATCH_SUB_SLICE = 1024
ADMISSION_MIN_WINDOW = 64


def make_batcher(engine, *, admission_enabled: bool = True) -> CheckBatcher:
    """The serving process's check batcher, wired as the reference's
    registry wires it: lanes of ``max_pending = 8 × BATCH_SIZE`` tuples that
    shed when full, and (``admission_enabled``) an AIMD admission window
    over the batch lane keyed off the engine's slice service times, its
    budget 4 × the engine's slice target (``engine.stream_ctrl``)."""
    max_pending = 8 * BATCH_SIZE
    admission = None
    if admission_enabled:
        ctrl = getattr(engine, "stream_ctrl", None)
        admission = AdmissionController(
            stats=getattr(engine, "stream_slice_stats", None),
            target_ms=float(getattr(ctrl, "target_ms", 40.0)),
            min_window=ADMISSION_MIN_WINDOW,
            max_window=max_pending,
        )
    return CheckBatcher(
        engine,
        batch_size=BATCH_SIZE,
        window_ms=WINDOW_MS,
        max_pending=max_pending,
        shed_on_full=True,
        interactive_max_tuples=INTERACTIVE_MAX_TUPLES,
        batch_sub_slice=BATCH_SUB_SLICE,
        admission=admission,
    )


def drain(servers: Sequence[RestServer], batcher: CheckBatcher, drain_timeout_s: float,
          writer: Optional[GroupCommitCoordinator] = None) -> dict:
    """The drain before a shutdown: every server's health monitor is pinned
    NOT_SERVING (``/health/ready`` answers 503 from now on); then wait up
    to ``drain_timeout_s`` for the batcher's in-flight checks, the
    group-commit coordinator's queued writers (an acknowledged snaptoken
    must have committed) and for the servers to write every accepted
    response. Returns ``{"batcher_idle",
    "writers_idle", "servers_idle", "seconds"}``; stops nothing."""
    t0 = time.monotonic()
    for s in servers:
        s.app.monitor.set_override(HealthState.NOT_SERVING, DRAINING)
    deadline = t0 + max(0.0, drain_timeout_s)
    idle = batcher.drain(drain_timeout_s)
    writers_idle = writer is None or writer.drain(max(0.5, deadline - time.monotonic()))
    servers_idle = all(s.drain(max(0.5, deadline - time.monotonic())) for s in servers)
    return {"batcher_idle": idle, "writers_idle": writers_idle, "servers_idle": servers_idle,
            "seconds": time.monotonic() - t0}


class Daemon:
    def __init__(
        self,
        namespaces: Iterable[namespace_pkg.Namespace],
        *,
        device: Optional[Union[str, torch.device]] = None,
        host: str = "127.0.0.1",
        read_port: int = 0,
        write_port: int = 0,
        tuples: Iterable[RelationTuple] = (),
        engine_options: Optional[dict] = None,
        explain_enabled: bool = True,
        decision_log_dir: str = "",
        decision_log_sample: float = 0.0,
        decision_log_segment_bytes: int = 1 << 20,
        decision_log_retention: int = 8,
        mesh_graph: int = 1,
        max_read_depth: int = MAX_READ_DEPTH,
        admission_enabled: bool = True,
        timeline_enabled: bool = True,
        snapshot_cache_dir: str = "",
        metrics_enabled: bool = True,
        tracing_provider: str = "",
        tracing_otlp_file: str = "",
        tracing_otlp_endpoint: str = DEFAULT_OTLP_ENDPOINT,
        debug_bundle_dir: str = "",
        log_level: str = "info",
        log_format: str = "text",
    ):
        #: the structured logger the servers log through
        self.logger = new_logger(log_level, log_format)
        #: the request spans' tracer
        self.tracer = Tracer(tracing_provider, self.logger, otlp_file=tracing_otlp_file,
                             otlp_endpoint=tracing_otlp_endpoint)
        nm = namespace_pkg.MemoryManager(namespaces)
        options = dict(engine_options or {})
        options.setdefault("hbm_budget_bytes", HBM_BUDGET_BYTES)
        if snapshot_cache_dir:
            options["snapshot_cache_dir"] = snapshot_cache_dir
        if int(mesh_graph) > 1:
            options["mesh"] = make_mesh(graph=int(mesh_graph), device=resolve_device(device))
        self.store = MemoryPersister(nm)
        tuples = list(tuples)
        if tuples:
            self.store.write_relation_tuples(*tuples)
        self.engine = TorchCheckEngine(self.store, nm, device=device, **options)
        #: the health state machine both ports' /health/ready read
        self.monitor = HealthMonitor(self.engine, staleness_budget_s=STALENESS_BUDGET_S)
        self.lister = SnapshotListEngine(self.engine, nm, device=self.engine.device)
        self.expander = SnapshotExpandEngine(self.engine, nm)
        self.batcher = make_batcher(self.engine, admission_enabled=admission_enabled)
        #: the request timelines of both ports
        self.recorder = TimelineRecorder(enabled=timeline_enabled)
        self.decision_log = (
            DecisionLog(decision_log_dir, sample=decision_log_sample,
                        segment_bytes=decision_log_segment_bytes,
                        retention=decision_log_retention)
            if decision_log_dir else None
        )
        self.explain = (
            ExplainEngine(self.engine, self.store, decision_log=self.decision_log)
            if explain_enabled else None
        )
        self.writer: Optional[GroupCommitCoordinator] = None
        self.flightrec = None
        #: the metrics registry both ports' /metrics serve
        self.metrics = obs.build_metrics(
            enabled=metrics_enabled,
            engine=lambda: self.engine, batcher=lambda: self.batcher,
            monitor=lambda: self.monitor, recorder=lambda: self.recorder,
            explain=lambda: self.explain, decision_log=lambda: self.decision_log,
            lister=lambda: self.lister, store=lambda: self.store, writer=lambda: self.writer,
            tracer=lambda: self.tracer, flightrec=lambda: self.flightrec, slo=lambda: self.slo,
        )
        obs.attach_engine(self.metrics, self.engine)
        obs.attach_recorder(self.metrics, self.recorder, self.tracer)
        #: the SLO engine GET /slo reports
        self.slo = obs.build_slo(self.metrics,
                                 availability_objective=SLO_AVAILABILITY_OBJECTIVE,
                                 latency_objective_ms=SLO_LATENCY_OBJECTIVE_MS,
                                 latency_objective_ratio=SLO_LATENCY_OBJECTIVE_RATIO)
        #: the flight recorder, None without a bundle directory
        self.flightrec = obs.build_flight_recorder(
            debug_bundle_dir,
            obs.flightrec_collect(
                recorder=lambda: self.recorder, monitor=lambda: self.monitor,
                engine=lambda: self.engine, batcher=lambda: self.batcher,
                metrics=lambda: self.metrics, slo=lambda: self.slo,
                explain=lambda: self.explain),
            max_bundles=DEBUG_BUNDLE_MAX, min_interval_s=DEBUG_BUNDLE_MIN_INTERVAL_S,
            max_bytes=DEBUG_BUNDLE_MAX_BYTES,
        )
        seen = dict(metrics=self.metrics, tracer=self.tracer, slo=self.slo,
                    logger=self.logger, recorder=self.recorder, monitor=self.monitor)
        self.read = RestServer(READ, self.store, self.batcher, host, read_port,
                               lister=self.lister, explain=self.explain,
                               decision_log=self.decision_log, expander=self.expander,
                               max_read_depth=max_read_depth, **seen)
        #: the group-commit coordinator of the write port
        self.writer = GroupCommitCoordinator(self.store,
                                             **obs.group_commit_histograms(self.metrics))
        self.write = RestServer(WRITE, self.store, self.batcher, host, write_port,
                                transact=self.writer.transact, **seen)

    def start(self) -> None:
        """Wire the flight recorder's triggers, build the first snapshot on
        the device, then open both ports."""
        obs.wire_flight_recorder(self.flightrec, monitor=self.monitor, engine=self.engine)
        self.engine.snapshot()
        self.batcher.start()
        self.writer.start()
        self.read.start()
        self.write.start()

    def drain_and_shutdown(self, drain_timeout_s: float = 5.0) -> dict:
        """Dump a ``drain`` bundle (while the state it freezes still
        describes live serving), answer 503 on ``/health/ready``, let the
        in-flight checks and responses finish (up to ``drain_timeout_s``),
        flush the tracer, then stop. Returns ``drain``'s record."""
        if self.flightrec is not None:
            self.flightrec.trigger("drain", "SIGTERM/SIGINT drain requested")
        out = drain((self.read, self.write), self.batcher, drain_timeout_s, self.writer)
        self.tracer.close()
        self.stop()
        return out

    def stop(self) -> None:
        self.read.stop()
        self.write.stop()
        self.batcher.stop()
        self.writer.stop()
        self.engine.close()
        if self.decision_log is not None:
            self.decision_log.close()
        self.tracer.close()
