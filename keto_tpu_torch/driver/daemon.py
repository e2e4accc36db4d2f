"""The serving process: the port's copy of keto_tpu/driver/daemon.py.

``Daemon(registry)`` serves the components of one ``Registry``
(keto_tpu_torch/driver/registry.py) on the read and write ports, each
role's REST backend on its own port, chosen by ``serve.http_backend``
(``async``, the reference's default, or ``threading``;
keto_tpu_torch/servers/async_rest.py). The reference puts a port mux with
a gRPC backend in front of each; gRPC and the muxes are the second half of
ROADMAP A7.

``serve_all(block)`` takes the reference's serve sequence
(keto_tpu/driver/daemon.py:75-123): the namespace manager primed (a watched
source loads at boot), the health monitor, the timeline recorder, the SLO
engine and the flight recorder's triggers, the first snapshot built in the
background (``_warm_snapshot``: a failure logs and leaves the first request
to build on the same card; a non-empty ``serve.compile_cache_dir`` also
runs the engine's ``warm_compile``), then the two roles. ``block=True``
waits for ``shutdown_soon`` or a signal (``install_signal_handlers``:
SIGTERM and SIGINT), then drains.

The drain (``drain_and_shutdown``, keto_tpu/driver/daemon.py:163-277): a
``drain`` flight-recorder bundle, ``/health/ready`` pinned NOT_SERVING
(503 ``draining: shutdown requested``), the watch hub closed so every
``/watch`` stream ends, then up to ``serve.drain_timeout_s`` for the
batcher's in-flight checks, the group-commit coordinator's queued writers
and the servers' accepted responses; the tracer flushed; then everything
stops.

The keyword form, ``Daemon(namespaces, device=..., tuples=..., ...)``, is a
thin translation of its keywords into ``Config`` overrides feeding the same
registry, so the daemon has one wiring path. It serves on the loopback with
the ``threading`` backend unless ``http_backend`` asks otherwise, reads no
environment variables, and its ``engine_options`` go to the engine through
``registry.ENGINE_KEYS`` (the few without a schema key, e.g.
``compact_after_s``, through ``Registry.engine_options``). ``start()``
builds the first snapshot before the ports open; ``stop()`` shuts down.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Iterable, Optional, Sequence, Union

import torch

from keto_tpu_torch import namespace as namespace_pkg
from keto_tpu_torch.config.provider import Config
from keto_tpu_torch.driver.group_commit import GroupCommitCoordinator
from keto_tpu_torch.driver.health import HealthState
from keto_tpu_torch.driver.registry import ENGINE_KEYS, Registry, make_batcher
from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.servers.async_rest import make_rest_server
from keto_tpu_torch.servers.rest import MAX_READ_DEPTH, READ, WRITE
from keto_tpu_torch.x.tracing import DEFAULT_OTLP_ENDPOINT

__all__ = ["DRAINING", "Daemon", "drain", "make_batcher", "role_server"]

#: the readiness reason while a drain runs (keto_tpu/driver/daemon.py:183)
DRAINING = "draining: shutdown requested"


def drain(servers: Sequence, batcher, drain_timeout_s: float,
          writer: Optional[GroupCommitCoordinator] = None, hub=None) -> dict:
    """The drain before a shutdown: every server's health monitor is pinned
    NOT_SERVING (``/health/ready`` answers 503 from now on) and the watch
    hub closed (its streams end at their next poll); then wait up to
    ``drain_timeout_s`` for the batcher's in-flight checks, the group-commit
    coordinator's queued writers (an acknowledged snaptoken must have
    committed) and for the servers to write every accepted response.
    Returns ``{"batcher_idle", "writers_idle", "servers_idle", "seconds"}``;
    stops nothing."""
    t0 = time.monotonic()
    for s in servers:
        s.app.monitor.set_override(HealthState.NOT_SERVING, DRAINING)
    if hub is not None:
        hub.close()
    deadline = t0 + max(0.0, drain_timeout_s)
    idle = batcher.drain(drain_timeout_s)
    writers_idle = writer is None or writer.drain(max(0.5, deadline - time.monotonic()))
    servers_idle = all(s.drain(max(0.5, deadline - time.monotonic())) for s in servers)
    return {"batcher_idle": idle, "writers_idle": writers_idle, "servers_idle": servers_idle,
            "seconds": time.monotonic() - t0}


def keyword_config(
    namespaces: Iterable[namespace_pkg.Namespace],
    *,
    host: str = "127.0.0.1",
    read_port: int = 0,
    write_port: int = 0,
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
    http_backend: str = "threading",
    drain_timeout_s: float = 5.0,
) -> tuple[Config, dict]:
    """The keyword form's ``Config`` (no environment read) and the engine
    options the schema has no key for."""
    overrides = {
        "dsn": "memory",
        "namespaces": [n.to_json() for n in namespaces],
        "serve.read.host": host,
        "serve.read.port": int(read_port),
        "serve.write.host": host,
        "serve.write.port": int(write_port),
        "serve.http_backend": http_backend,
        "serve.explain_enabled": bool(explain_enabled),
        "serve.decision_log_dir": decision_log_dir,
        "serve.decision_log_sample": float(decision_log_sample),
        "serve.decision_log_segment_bytes": int(decision_log_segment_bytes),
        "serve.decision_log_retention": int(decision_log_retention),
        "serve.mesh_graph": int(mesh_graph),
        "limit.max_read_depth": int(max_read_depth),
        "serve.admission_enabled": bool(admission_enabled),
        "serve.timeline_enabled": bool(timeline_enabled),
        "serve.snapshot_cache_dir": snapshot_cache_dir or "",
        "metrics.enabled": bool(metrics_enabled),
        "tracing.provider": tracing_provider,
        "tracing.otlp.file": tracing_otlp_file,
        "tracing.otlp.endpoint": tracing_otlp_endpoint,
        "serve.debug_bundle_dir": debug_bundle_dir,
        "log.level": log_level,
        "log.format": log_format,
        "serve.drain_timeout_s": float(drain_timeout_s),
    }
    extra = {}
    for kw, value in (engine_options or {}).items():
        key = ENGINE_KEYS.get(kw)
        if key is None:
            extra[kw] = value
        else:
            overrides[key] = "" if key == "serve.snapshot_cache_dir" and value is None else value
    return Config(overrides=overrides, env={}), extra


def role_server(registry: Registry, role: str, host: str = "127.0.0.1", port: int = 0,
                backend: Optional[str] = None):
    """One role's REST server over ``registry``'s components, not started:
    the backend ``serve.http_backend`` names (or ``backend``); the read role
    serves checks, expand, the list routes, explain and ``/watch``, the write
    role the tuple writes through ``transact_writes``."""
    cfg = registry.config()
    seen = dict(recorder=registry.timeline_recorder(), monitor=registry.health_monitor(),
                metrics=registry.metrics(), tracer=registry.tracer(), slo=registry.slo_engine(),
                logger=registry.logger(), watch_hub=registry.watch_hub(),
                telemetry=registry.telemetry())
    if role == READ:
        kw = dict(lister=registry.list_engine(), explain=registry.explain_engine(),
                  decision_log=registry.decision_log(), expander=registry.expand_engine(),
                  max_read_depth=int(cfg.get("limit.max_read_depth", MAX_READ_DEPTH)))
    else:
        kw = dict(transact=registry.transact_writes())
    return make_rest_server(backend or str(cfg.get("serve.http_backend", "async")), role,
                            registry.relation_tuple_manager(), registry.check_batcher(),
                            host or "0.0.0.0", port, **kw, **seen)


class Daemon:
    """Owns both roles' REST servers over one registry's components."""

    def __init__(self, registry: Union[Registry, Iterable[namespace_pkg.Namespace]], *,
                 device: Optional[Union[str, torch.device]] = None,
                 tuples: Iterable[RelationTuple] = (), **keywords):
        if not isinstance(registry, Registry):
            cfg, extra = keyword_config(registry, **keywords)
            registry = Registry(cfg, device=device)
            registry.engine_options.update(extra)
            tuples = list(tuples)
            if tuples:
                registry.relation_tuple_manager().write_relation_tuples(*tuples)
        elif keywords or device is not None or tuples:
            raise TypeError("Daemon(registry) takes no keywords: they belong in its Config")
        self.registry = registry
        self._roles: dict = {}
        # set by a signal or shutdown_soon(); serve_all's blocking wait ends
        self._stop_requested = threading.Event()
        # the boot warm (_warm_snapshot); shutdown joins it briefly
        self._warm_thread: Optional[threading.Thread] = None

    # -- the components ------------------------------------------------------

    @property
    def engine(self):
        return self.registry.permission_engine()

    @property
    def store(self):
        return self.registry.relation_tuple_manager()

    @property
    def batcher(self):
        return self.registry.check_batcher()

    @property
    def monitor(self):
        return self.registry.health_monitor()

    @property
    def lister(self):
        return self.registry.list_engine()

    @property
    def expander(self):
        return self.registry.expand_engine()

    @property
    def recorder(self):
        return self.registry.timeline_recorder()

    @property
    def decision_log(self):
        return self.registry.decision_log()

    @property
    def explain(self):
        return self.registry.explain_engine()

    @property
    def writer(self) -> Optional[GroupCommitCoordinator]:
        return self.registry.write_coordinator()

    @property
    def flightrec(self):
        return self.registry.flight_recorder()

    @property
    def metrics(self):
        return self.registry.metrics()

    @property
    def slo(self):
        return self.registry.slo_engine()

    @property
    def tracer(self):
        return self.registry.tracer()

    @property
    def logger(self):
        return self.registry.logger()

    @property
    def watch_hub(self):
        return self.registry.watch_hub()

    # -- serving -------------------------------------------------------------

    def _start_role(self, role: str, host: str, port: int):
        server = role_server(self.registry, role, host, port)
        server.start()
        self.registry.logger().info("serving %s API on :%d (REST)", role, server.port)
        return server

    def serve_all(self, block: bool = True) -> None:
        """The serve sequence (see the module docstring); ``block`` waits
        for a shutdown request and drains."""
        reg = self.registry
        cfg = reg.config()
        # a watched namespace source connects and loads at boot, not on the
        # first request (reference registry_default.go:240-261)
        reg.namespace_manager()
        reg.health_monitor()
        reg.timeline_recorder()
        reg.slo_engine()
        reg.wire_flight_recorder()
        self._warm_snapshot()
        read_host, read_port = cfg.read_api_address()
        write_host, write_port = cfg.write_api_address()
        self._roles[READ] = self._start_role(READ, read_host, read_port)
        self._roles[WRITE] = self._start_role(WRITE, write_host, write_port)
        if block:
            try:
                self.wait_for_shutdown()
            except KeyboardInterrupt:
                pass
            self.drain_and_shutdown()

    def start(self) -> None:
        """Build the first snapshot on the device, then serve both ports
        without blocking."""
        engine = self.engine
        if hasattr(engine, "snapshot"):
            engine.snapshot()
        self.serve_all(block=False)

    def wait_for_shutdown(self, poll_s: float = 1.0) -> None:
        """Block until a shutdown signal or ``shutdown_soon``. The wait is
        bounded and looped, so a signal always ends it within ``poll_s``."""
        while not self._stop_requested.wait(timeout=poll_s):
            pass

    def install_signal_handlers(self) -> None:
        """SIGTERM and SIGINT request the drain. Only from the main thread
        (a CPython rule for ``signal.signal``); elsewhere a no-op."""
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        # the handler only flags: serve_all's wait performs the drain
        self._stop_requested.set()

    def shutdown_soon(self) -> None:
        """The programmatic shutdown signal."""
        self._stop_requested.set()

    @property
    def read(self):
        return self._roles[READ]

    @property
    def write(self):
        return self._roles[WRITE]

    @property
    def read_port(self) -> int:
        return self._roles[READ].port

    @property
    def write_port(self) -> int:
        return self._roles[WRITE].port

    def drain_and_shutdown(self, drain_timeout_s: Optional[float] = None) -> dict:
        """Dump a ``drain`` bundle (while the state it freezes still
        describes live serving), then ``drain`` (503 on ``/health/ready``,
        the watch streams ended, in-flight checks, writes and responses
        finished within ``drain_timeout_s``, by default
        ``serve.drain_timeout_s``), flush the tracer and shut down. Returns
        ``drain``'s record ({} when not serving)."""
        if not self._roles:
            return {}
        self._stop_requested.set()
        reg = self.registry
        if drain_timeout_s is None:
            drain_timeout_s = float(reg.config().get("serve.drain_timeout_s", 5.0))
        fr = reg.flight_recorder()
        if fr is not None:
            fr.trigger("drain", "SIGTERM/SIGINT drain requested")
        out = drain(list(self._roles.values()), reg.check_batcher(), drain_timeout_s,
                    reg.peek("group_commit"), hub=reg.peek("watch_hub"))
        if not out["batcher_idle"]:
            reg.logger().warning("drain timed out after %.1fs with %d checks in flight",
                                 drain_timeout_s, reg.check_batcher().inflight)
        tracer = reg.peek("tracer")
        if tracer is not None:
            tracer.close()
        self.shutdown()
        return out

    def _warm_snapshot(self) -> None:
        """Build the first snapshot off the request path; with a non-empty
        ``serve.compile_cache_dir`` also run the engine's ``warm_compile``.
        A failure logs, counts ``warm_failures`` and leaves the first
        request to build on the same card."""
        engine = self.engine
        if not hasattr(engine, "snapshot"):
            return
        log = self.registry.logger()
        warm_widths = bool(self.registry.config().get("serve.compile_cache_dir", "")) \
            and hasattr(engine, "warm_compile")

        def run():
            try:
                engine.snapshot()
                gov = getattr(engine, "hbm", None)
                if gov is not None:
                    snap = gov.snapshot()
                    log.info("HBM governor: %d / %d bytes resident after boot snapshot "
                             "(eviction rung %d/%d)", snap["resident_bytes"],
                             snap["budget_bytes"], snap["rung"], len(snap["rungs"]))
                if warm_widths:
                    log.info("width-ladder warmup ran %d kernels", engine.warm_compile())
            except Exception:
                stats = getattr(engine, "maintenance", None)
                if stats is not None:
                    stats.incr("warm_failures")
                log.warning("boot snapshot warm failed; first request will build",
                            exc_info=True)

        self._warm_thread = threading.Thread(target=run, name="keto-snapshot-warm", daemon=True)
        self._warm_thread.start()

    def shutdown(self) -> None:
        """Stop both servers and close the registry. Idempotent."""
        if not self._roles:
            return
        hub = self.registry.peek("watch_hub")
        if hub is not None:
            hub.close()
        for server in self._roles.values():
            server.stop()
        self._roles.clear()
        warm = self._warm_thread
        if warm is not None and warm.is_alive():
            warm.join(timeout=30.0)
        self.registry.close()

    def stop(self) -> None:
        """Shut down without a drain (the keyword form's ``stop``); a daemon
        that never served closes its registry."""
        if self._roles:
            self.shutdown()
        else:
            self.registry.close()
