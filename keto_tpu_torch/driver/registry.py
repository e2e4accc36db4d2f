"""Dependency-injection registry: the port's copy of
keto_tpu/driver/registry.py, cut to the components the port has.

Config in (keto_tpu_torch/config), everything else built lazily on first
access and memoized (reference internal/driver/registry.go:26-58,
registry_default.go:158-170). ``Registry(config, device=None)`` takes one
argument the reference has not: ``device``, the explicit device the CLI's
``--device`` and the tests pass; ``None`` means the card, and the check
engine raises where there is none.

The key policy. Every key of the schema is accepted, and is one of:

- **wired** to its component, as the reference's registry wires it
  (``ENGINE_KEYS`` for the check engine's, and the builders below);
- **waiting for a later ROADMAP item** (``WAITING``): accepted at its
  default, and any other value raises at registry build, naming the item;
- **without a counterpart by design** (``NO_COUNTERPART``): documented
  there and logged once at registry build.

Nothing is silently ignored. The metrics bridges, the SLO engine and the
flight recorder are built by keto_tpu_torch/driver/observability.py, the
one home of those bridges; the registry calls it with its ``peek`` getters,
so a scrape never constructs a component.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Union

import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.config.provider import Config
from keto_tpu_torch.config.schema import CONFIG_SCHEMA
from keto_tpu_torch.driver import observability as obs
from keto_tpu_torch.driver.admission import AdmissionController
from keto_tpu_torch.driver.batch import CheckBatcher
from keto_tpu_torch.persistence.memory import MemoryPersister
from keto_tpu_torch.version import __version__ as VERSION
from keto_tpu_torch.x.logging import new_logger

#: the check engine's constructor arguments and the keys that set them
#: (keto_tpu/driver/registry.py:674-735); the keyword ``Daemon`` translates
#: its ``engine_options`` through the same table
ENGINE_KEYS = {
    "it_cap": "engine.it_cap",
    "peel_seed_cap": "engine.peel_seed_cap",
    "sync_rebuild_budget_s": "engine.sync_rebuild_budget_s",
    "stream_slice_target_ms": "serve.stream_slice_target_ms",
    "stream_tail_ratio": "serve.stream_tail_ratio",
    "overlay_edge_budget": "serve.overlay_edge_budget",
    "fold_segment_edges": "serve.fold_segment_edges",
    "snapshot_cache_dir": "serve.snapshot_cache_dir",
    "labels_enabled": "serve.labels_enabled",
    "labels_max_width": "serve.labels_max_width",
    "labels_landmarks": "serve.labels_landmarks",
    "labels_device_build": "serve.labels_device_build",
    "labels_min_gain": "serve.labels_min_gain",
    "labels_batch": "serve.labels_batch",
    "labels_device_min_edges": "serve.labels_device_min_edges",
    "hbm_budget_bytes": "serve.hbm_budget_bytes",
    "audit_sample_rate": "serve.audit_sample_rate",
    "device_build_enabled": "serve.device_build_enabled",
    "build_chunk_rows": "serve.build_chunk_rows",
    "native_pack_enabled": "serve.native_pack_enabled",
    "staging_enabled": "serve.staging_enabled",
}

#: keys accepted at their default that wait for a later ROADMAP item; any
#: other value raises at registry build (``mesh_data`` waits only past 1)
WAITING = {
    "dsn": "A8",
    "serve.role": "A10",
    "serve.primary_url": "A10",
    "serve.replica_dir": "A10",
    "serve.staleness_wait_ms": "A10",
    "serve.replica_staleness_budget_s": "A10",
    "serve.checkcache_entries": "A10",
    "serve.mesh_data": "A11",
    "serve.mesh_sharded": "A11",
}
#: key prefixes that wait as a family: the fleet (A10) and the tenants (A9)
WAITING_PREFIXES = {"serve.fleet_": "A10", "serve.tenant_": "A9"}

#: keys without a counterpart in the port by design, each logged once at
#: registry build with what the port does instead
NO_COUNTERPART = {
    "serve.compile_cache_dir": (
        "there is no XLA compilation cache to keep; the CUDA kernels build "
        "once per source hash under build/kernels/. As in the reference, a "
        "non-empty value turns on the boot warm_compile()"
    ),
    "engine.backend": (
        "'tpu' and 'auto' build TorchCheckEngine on the card (on the CPU "
        "only where the caller asked for it, as the CLI's --device cpu does) "
        "and raise with no CUDA device; 'oracle' builds the host CheckEngine. "
        "'auto' never picks the oracle: the memory store always has "
        "snapshot_rows"
    ),
    "serve.degraded_probe_s": (
        "it paces the reference's CPU fallback's recovery probe, and the port "
        "has no CPU fallback on the device path: a failing kernel raises"
    ),
}


def _schema_node(dotted: str) -> dict:
    node: Any = CONFIG_SCHEMA
    for part in dotted.split("."):
        node = node["properties"][part]
    return node


def schema_default(dotted: str) -> Any:
    """The schema's ``default`` of a key (``dsn`` has none: ``memory``)."""
    return _schema_node(dotted).get("default", "memory" if dotted == "dsn" else None)


def _coerce(dotted: str, value: Any) -> Any:
    """A config value as its schema type's Python type."""
    t = _schema_node(dotted).get("type")
    if t == "integer":
        return int(value)
    if t == "number":
        return float(value)
    if t == "boolean":
        return bool(value)
    return value


def waiting_keys() -> dict[str, str]:
    """Every key ``WAITING`` and ``WAITING_PREFIXES`` name, with its item."""
    out = dict(WAITING)
    serve = CONFIG_SCHEMA["properties"]["serve"]["properties"]
    for prefix, item in WAITING_PREFIXES.items():
        for key in serve:
            if f"serve.{key}".startswith(prefix):
                out[f"serve.{key}"] = item
    return out


def _waits(dotted: str, value: Any) -> bool:
    """Does ``value`` of a waiting key ask for what the port lacks?"""
    if dotted == "serve.mesh_data":
        return int(value) > 1
    return value != schema_default(dotted)


def make_batcher(engine, *, batch_size: int = 4096, window_ms: float = 1.0,
                 shed_on_full: bool = True, interactive_max_tuples: int = 16,
                 batch_sub_slice: int = 1024, admission_enabled: bool = True,
                 admission_latency_budget_ms: float = 0.0,
                 admission_min_window: int = 64) -> CheckBatcher:
    """The serving process's check batcher, wired as the reference's registry
    wires it (keto_tpu/driver/registry.py:878-930; the defaults are the
    schema's): lanes of ``8 × batch_size`` tuples that shed when full, and
    (``admission_enabled``) an AIMD admission window over the batch lane
    keyed off the engine's slice service times, its budget
    ``admission_latency_budget_ms`` or, at 0, 4 × the engine's slice target
    (``engine.stream_ctrl``). Not started."""
    max_pending = 8 * int(batch_size)
    admission = None
    if admission_enabled:
        ctrl = getattr(engine, "stream_ctrl", None)
        admission = AdmissionController(
            stats=getattr(engine, "stream_slice_stats", None),
            target_ms=float(getattr(ctrl, "target_ms", 40.0)),
            budget_ms=float(admission_latency_budget_ms) or None,
            min_window=int(admission_min_window),
            max_window=max_pending,
        )
    return CheckBatcher(
        engine,
        batch_size=int(batch_size),
        window_ms=float(window_ms),
        max_pending=max_pending,
        shed_on_full=bool(shed_on_full),
        interactive_max_tuples=int(interactive_max_tuples),
        batch_sub_slice=int(batch_sub_slice),
        admission=admission,
    )


class Registry:
    """The serving process's components, built from one ``Config``."""

    def __init__(self, config: Config, device: Optional[Union[str, torch.device]] = None):
        self._config = config
        self._device = device
        self._lock = threading.RLock()  # guards: _singletons
        self._singletons: dict[str, Any] = {}
        #: check-engine constructor arguments the schema has no key for
        #: (``compact_after_s``, ...): empty when serving from a config; the
        #: keyword ``Daemon`` puts its ``engine_options`` without a key here
        self.engine_options: dict[str, Any] = {}
        config.on_namespace_change(self._on_namespace_change)
        self._refuse_waiting_keys()
        self._log_no_counterpart()

    def _memo(self, key: str, build: Callable[[], Any]) -> Any:
        got = self._singletons.get(key)
        if got is None:
            with self._lock:
                got = self._singletons.get(key)
                if got is None:
                    got = build()
                    self._singletons[key] = got
        return got

    def _on_namespace_change(self) -> None:
        # nothing to invalidate: the store and the engines resolve the
        # namespace manager through namespaces_source() on every use
        pass

    def peek(self, key: str):
        """An already-built component, or None: shutdown paths and the
        scrape-time bridges read through this, so they never build one."""
        return self._singletons.get(key)

    def _peeker(self, key: str) -> Callable[[], Any]:
        return lambda: self._singletons.get(key)

    # -- the key policy ------------------------------------------------------

    def _refuse_waiting_keys(self) -> None:
        for key, item in waiting_keys().items():
            value = self._config.get(key, schema_default(key))
            if _waits(key, value):
                raise ValueError(
                    f"{key}: {value!r} is not served by this port yet (ROADMAP {item}); "
                    f"leave it at {schema_default(key)!r}"
                )

    def _log_no_counterpart(self) -> None:
        log = self.logger()
        for key, what in NO_COUNTERPART.items():
            log.info("config %s = %r has no counterpart here: %s", key,
                     self._config.get(key, schema_default(key)), what)

    # -- leaf dependencies ---------------------------------------------------

    def config(self) -> Config:
        return self._config

    def logger(self):
        return self._memo(
            "logger",
            lambda: new_logger(self._config.get("log.level", "info"),
                               self._config.get("log.format", "text")),
        )

    def namespace_manager(self) -> namespace_pkg.Manager:
        return self._config.namespace_manager()

    def namespaces_source(self) -> Callable[[], namespace_pkg.Manager]:
        return self._config.namespace_manager

    def is_replica(self) -> bool:
        """Always False: replicas are ROADMAP A10 (``serve.role`` waits)."""
        return False

    # -- storage -------------------------------------------------------------

    def _build_direct_store(self):
        """The tuple store of ``dsn`` (keto_tpu/driver/registry.py:92-130):
        ``memory`` only; the SQL stores are ROADMAP A8."""
        dsn = self._config.dsn
        if dsn != "memory":
            raise ValueError(f"dsn {dsn!r}: the SQL stores are not ported yet (ROADMAP A8)")
        store = MemoryPersister(self.namespaces_source())
        store.idempotency_ttl_s = float(self._config.get("serve.idempotency_ttl_s", 86400.0))
        store.watch_log_retention_s = float(
            self._config.get("serve.watch_log_retention_s", 3600.0))
        store.watch_gc_max_rows = int(self._config.get("serve.watch_gc_max_rows", 10000))
        return store

    def relation_tuple_manager(self):
        return self._memo("manager", self._build_direct_store)

    def write_coordinator(self):
        """The group-commit coordinator (keto_tpu_torch/driver/group_commit.py),
        started; None with ``serve.group_commit_enabled: false``."""
        if not bool(self._config.get("serve.group_commit_enabled", True)):
            return None

        def build():
            from keto_tpu_torch.driver.group_commit import GroupCommitCoordinator

            co = GroupCommitCoordinator(
                self.relation_tuple_manager(),
                max_writers=int(self._config.get("serve.group_commit_max_writers", 128)),
                window_ms=float(self._config.get("serve.group_commit_window_ms", 2.0)),
                max_pending=int(self._config.get("serve.group_commit_max_pending", 4096)),
                **obs.group_commit_histograms(self.metrics()),
            )
            co.start()
            return co

        return self._memo("group_commit", build)

    def transact_writes(self):
        """The write path's entry: ``(insert, delete, idempotency_key=None)
        -> TransactResult``, through the group-commit coordinator when one
        is on, else the store's own transaction."""
        co = self.write_coordinator()
        if co is not None:
            return co.transact
        return self.relation_tuple_manager().transact_relation_tuples

    # -- engines -------------------------------------------------------------

    def permission_engine(self):
        return self._memo("permission_engine", self._build_permission_engine)

    def engine_kwargs(self) -> dict[str, Any]:
        """The check engine's constructor arguments from the config (every
        ``ENGINE_KEYS`` key) and ``engine_options``."""
        cfg = self._config
        out = {kw: _coerce(key, cfg.get(key, schema_default(key)))
               for kw, key in ENGINE_KEYS.items()}
        out["snapshot_cache_dir"] = str(out["snapshot_cache_dir"] or "") or None
        out.update(self.engine_options)
        return out

    def _build_permission_engine(self):
        """The check engine (keto_tpu/driver/registry.py:614-766):
        ``TorchCheckEngine`` on ``device`` for ``engine.backend`` ``tpu`` and
        ``auto``, sharded over ``serve.mesh_graph`` row-range shards when it
        is past 1; the host ``CheckEngine`` for ``oracle``, behind the
        batcher's stream interface (``HostStreamEngine``)."""
        store = self.relation_tuple_manager()
        if self._config.get("engine.backend", "auto") == "oracle":
            from keto_tpu_torch.check.engine import HostStreamEngine

            return HostStreamEngine(store)
        from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
        from keto_tpu_torch.parallel import make_mesh
        from keto_tpu_torch.x.device import resolve_device

        mesh = None
        mesh_graph = int(self._config.get("serve.mesh_graph", 1))
        if mesh_graph > 1:
            mesh = make_mesh(graph=mesh_graph, device=resolve_device(self._device))
        engine = TorchCheckEngine(store, self.namespaces_source(), device=self._device,
                                  mesh=mesh, **self.engine_kwargs())
        obs.attach_engine(self.metrics(), engine)
        return engine

    def expand_depth(self, requested: int) -> int:
        """A request's max-depth clamped to ``limit.max_read_depth``: 0, or
        more than the cap, takes the cap."""
        cap = int(self._config.get("limit.max_read_depth", 5))
        return cap if requested <= 0 or requested > cap else requested

    def expand_engine(self):
        """The snapshot-backed expand engine over the check engine's
        snapshots, or the store-backed recursion beside the oracle."""

        def build():
            check = self.permission_engine()
            if hasattr(check, "snapshot"):
                from keto_tpu_torch.expand.snapshot_engine import SnapshotExpandEngine

                return SnapshotExpandEngine(check, self.namespaces_source())
            from keto_tpu_torch.expand.engine import ExpandEngine

            return ExpandEngine(self.relation_tuple_manager())

        return self._memo("expand_engine", build)

    def explain_enabled(self) -> bool:
        return bool(self._config.get("serve.explain_enabled", True))

    def decision_log(self):
        """The decision-audit log, or None without ``serve.decision_log_dir``."""
        d = str(self._config.get("serve.decision_log_dir", "") or "")
        if not d:
            return None

        def build():
            from keto_tpu_torch.explain import DecisionLog

            return DecisionLog(
                d,
                sample=float(self._config.get("serve.decision_log_sample", 0.0)),
                segment_bytes=int(self._config.get("serve.decision_log_segment_bytes", 1 << 20)),
                retention=int(self._config.get("serve.decision_log_retention", 8)),
            )

        return self._memo("decision_log", build)

    def explain_engine(self):
        """The decision-provenance engine, None with ``serve.explain_enabled:
        false`` or beside the oracle; a witness that fails verification fires
        the flight recorder."""
        if not self.explain_enabled():
            return None
        check = self.permission_engine()
        if not hasattr(check, "snapshot"):
            return None

        def build():
            from keto_tpu_torch.explain import ExplainEngine

            def on_verify_failure(note):
                fr = self.flight_recorder()
                if fr is not None:
                    fr.trigger("witness-verify-failure", detail=note.get("tuple", ""))

            return ExplainEngine(check, self.relation_tuple_manager(),
                                 decision_log=self.decision_log(),
                                 on_verify_failure=on_verify_failure)

        return self._memo("explain_engine", build)

    def list_engine(self):
        """The reverse-query engine on the check engine's snapshots, or the
        store-backed one beside the oracle."""

        def build():
            check = self.permission_engine()
            if hasattr(check, "snapshot"):
                from keto_tpu_torch.list.gpu_engine import SnapshotListEngine

                return SnapshotListEngine(
                    check, self.namespaces_source(), device=check.device,
                    cache_entries=int(self._config.get("serve.list_cache_entries", 64)))
            from keto_tpu_torch.list.engine import ListEngine

            return ListEngine(self.relation_tuple_manager())

        return self._memo("list_engine", build)

    def watch_hub(self):
        """The Watch changefeed hub over the store's change logs."""
        from keto_tpu_torch.list.watch import WatchHub

        return self._memo(
            "watch_hub",
            lambda: WatchHub(
                self.relation_tuple_manager(),
                poll_s=float(self._config.get("serve.watch_poll_ms", 100.0)) / 1e3,
                max_streams=int(self._config.get("serve.watch_max_streams", 64)),
            ),
        )

    def check_batcher(self) -> CheckBatcher:
        """The check batcher (``make_batcher`` with the config's keys),
        started."""

        def build():
            cfg = self._config
            b = make_batcher(
                self.permission_engine(),
                batch_size=int(cfg.get("engine.batch_size", 4096)),
                window_ms=float(cfg.get("engine.batch_window_ms", 1.0)),
                shed_on_full=bool(cfg.get("serve.shed_on_full", True)),
                interactive_max_tuples=int(cfg.get("serve.interactive_max_tuples", 16)),
                batch_sub_slice=int(cfg.get("serve.batch_sub_slice", 1024)),
                admission_enabled=bool(cfg.get("serve.admission_enabled", True)),
                admission_latency_budget_ms=float(
                    cfg.get("serve.admission_latency_budget_ms", 0.0)),
                admission_min_window=int(cfg.get("serve.admission_min_window", 64)),
            )
            b.start()
            return b

        return self._memo("check_batcher", build)

    def health_monitor(self):
        """The health state machine both ports' ``/health/ready`` read."""
        from keto_tpu_torch.driver.health import HealthMonitor

        return self._memo(
            "health_monitor",
            lambda: HealthMonitor(
                self.permission_engine(),
                staleness_budget_s=float(self._config.get("serve.staleness_budget_s", 60.0)),
            ),
        )

    # -- request timelines, SLOs and the flight recorder ---------------------

    def timeline_recorder(self):
        def build():
            from keto_tpu_torch.x.timeline import TimelineRecorder

            rec = TimelineRecorder(
                capacity=int(self._config.get("serve.timeline_ring", 512)),
                enabled=bool(self._config.get("serve.timeline_enabled", True)),
            )
            obs.attach_recorder(self.metrics(), rec, self.tracer())
            return rec

        return self._memo("timeline", build)

    def slo_engine(self):
        cfg = self._config
        return self._memo("slo", lambda: obs.build_slo(
            self.metrics(),
            availability_objective=float(cfg.get("serve.slo_availability_objective", 0.999)),
            latency_objective_ms=float(cfg.get("serve.slo_latency_objective_ms", 250.0)),
            latency_objective_ratio=float(cfg.get("serve.slo_latency_objective_ratio", 0.99)),
        ))

    def flight_recorder(self):
        """The flight recorder, or None without ``serve.debug_bundle_dir``."""
        cfg = self._config
        bundle_dir = str(cfg.get("serve.debug_bundle_dir", "") or "")
        if not bundle_dir:
            return None
        p = self._peeker
        return self._memo("flightrec", lambda: obs.build_flight_recorder(
            bundle_dir,
            obs.flightrec_collect(
                recorder=p("timeline"), monitor=p("health_monitor"),
                engine=p("permission_engine"), batcher=p("check_batcher"),
                metrics=p("metrics"), slo=p("slo"), explain=p("explain_engine"),
                watch_hub=p("watch_hub")),
            max_bundles=int(cfg.get("serve.debug_bundle_max", 8)),
            min_interval_s=float(cfg.get("serve.debug_bundle_min_interval_s", 30.0)),
            max_bytes=int(cfg.get("serve.debug_bundle_max_bytes", 4 << 20)),
        ))

    def wire_flight_recorder(self) -> None:
        """Attach the flight recorder's triggers to the live components; a
        no-op without a bundle directory."""
        fr = self.flight_recorder()
        if fr is not None:
            obs.wire_flight_recorder(fr, monitor=self.health_monitor(),
                                     engine=self.permission_engine())

    # -- observability -------------------------------------------------------

    def metrics(self):
        """The metrics registry both ports' ``/metrics`` serve, bridged to
        every component through ``peek``; the null registry with
        ``metrics.enabled: false``."""
        p = self._peeker
        return self._memo("metrics", lambda: obs.build_metrics(
            enabled=bool(self._config.get("metrics.enabled", True)),
            engine=p("permission_engine"), batcher=p("check_batcher"),
            monitor=p("health_monitor"), recorder=p("timeline"),
            explain=p("explain_engine"), decision_log=p("decision_log"),
            lister=p("list_engine"), store=p("manager"), writer=p("group_commit"),
            tracer=p("tracer"), flightrec=p("flightrec"), slo=p("slo"),
            watch_hub=p("watch_hub"),
        ))

    def tracer(self):
        from keto_tpu_torch.x.tracing import DEFAULT_OTLP_ENDPOINT, Tracer

        return self._memo(
            "tracer",
            lambda: Tracer(
                self._config.get("tracing.provider", ""),
                self.logger(),
                otlp_file=self._config.get("tracing.otlp.file", ""),
                otlp_endpoint=self._config.get("tracing.otlp.endpoint", DEFAULT_OTLP_ENDPOINT),
            ),
        )

    def telemetry(self):
        """The per-route request counter (``telemetry.enabled``); both REST
        ports record into it, ``snapshot()`` reads it."""
        from keto_tpu_torch.x.telemetry import Telemetry

        return self._memo(
            "telemetry",
            lambda: Telemetry(bool(self._config.get("telemetry.enabled", False))),
        )

    def version(self) -> str:
        return VERSION

    def close(self) -> None:
        """Stop every component this registry built, the watch hub first and
        the store's writers before the engine."""
        hub = self._singletons.get("watch_hub")
        if hub is not None:
            hub.close()
        batcher = self._singletons.get("check_batcher")
        if batcher is not None:
            batcher.stop()
        co = self._singletons.get("group_commit")
        if co is not None:
            co.stop()
        engine = self._singletons.get("permission_engine")
        if engine is not None and hasattr(engine, "close"):
            engine.close()
        dlog = self._singletons.get("decision_log")
        if dlog is not None:
            dlog.close()
        tracer = self._singletons.get("tracer")
        if tracer is not None:
            tracer.close()
        self._config.close()
