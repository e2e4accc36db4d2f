"""The port's ``Registry`` (keto_tpu_torch/driver/registry.py) against the
reference's on the CPU: for every key of the check engine, the batcher, the
store, the write coordinator, the watch hub, the health monitor, the
decision log, the SLO engine and the flight recorder, a non-default value
reaches the port's component as the reference's registry passes it to its
own (one case a key: each side's constructor is wrapped to record its
arguments). Every key that waits for a later ROADMAP item raises naming
it, every key without a counterpart logs once, ``engine.backend`` ``auto``
and ``tpu`` raise without a CUDA device unless the caller asked for the
CPU, and the ``Telemetry`` route counter reads as the reference's on the
same requests."""

from __future__ import annotations

import logging

import pytest

from keto_tpu_torch.config import Config
from keto_tpu_torch.config.schema import CONFIG_SCHEMA
from keto_tpu_torch.driver import registry as registry_mod
from keto_tpu_torch.driver.registry import (
    ENGINE_KEYS,
    NO_COUNTERPART,
    Registry,
    schema_default,
    waiting_keys,
)

NSS = [{"id": 0, "name": "acl"}]


def _other(key):
    """A valid value of ``key`` other than its default."""
    node = CONFIG_SCHEMA
    for part in key.split("."):
        node = node["properties"][part]
    default = schema_default(key)
    if "enum" in node:
        return next(e for e in node["enum"] if e != default)
    t = node.get("type")
    if t == "boolean":
        return not default
    if t == "integer":
        return int(default or 0) + 2
    if t == "number":
        return float(default or 0.0) + 1.5
    return "sqlite://x" if key == "dsn" else "x"


class _Recorder:
    """Wraps a class's ``__init__`` to record the arguments of each call."""

    def __init__(self, monkeypatch, cls):
        self.calls = []
        orig = cls.__init__

        def init(obj, *a, **kw):
            self.calls.append((a, kw))
            orig(obj, *a, **kw)

        monkeypatch.setattr(cls, "__init__", init)

    @property
    def kw(self):
        assert self.calls, "the component was never built"
        return self.calls[-1][1]


def _pair(monkeypatch, keys, mine_cls, ref_cls):
    """Both registries over ``keys``, with ``mine_cls`` and ``ref_cls``
    recording their constructor arguments."""
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.registry import Registry as RefRegistry

    recs = (_Recorder(monkeypatch, mine_cls), _Recorder(monkeypatch, ref_cls))
    overrides = {"namespaces": NSS, **keys}
    mine = Registry(Config(overrides=overrides, env={}), device="cpu")
    ref = RefRegistry(RefConfig(overrides=overrides, env={}))
    return mine, ref, recs


# -- the check engine ------------------------------------------------------------


@pytest.mark.parametrize("kw", sorted(ENGINE_KEYS))
def test_engine_key_reaches_the_engine_as_the_reference_passes_it(monkeypatch, tmp_path, kw):
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine

    key = ENGINE_KEYS[kw]
    value = str(tmp_path / "cache") if kw == "snapshot_cache_dir" else _other(key)
    mine, ref, (rm, rr) = _pair(monkeypatch, {key: value}, TorchCheckEngine, TpuCheckEngine)
    try:
        mine.permission_engine()
        ref.permission_engine()
        assert rm.kw[kw] == rr.kw[kw] == value
    finally:
        mine.close()
        ref.close()


def test_engine_defaults_equal_the_references(monkeypatch):
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine

    mine, ref, (rm, rr) = _pair(monkeypatch, {}, TorchCheckEngine, TpuCheckEngine)
    try:
        mine.permission_engine()
        ref.permission_engine()
        for kw in ENGINE_KEYS:
            assert rm.kw[kw] == rr.kw[kw], kw
    finally:
        mine.close()
        ref.close()


# -- the batcher -------------------------------------------------------------------

BATCHER_KEYS = ["engine.batch_size", "engine.batch_window_ms", "serve.shed_on_full",
                "serve.interactive_max_tuples", "serve.batch_sub_slice",
                "serve.admission_enabled", "serve.admission_latency_budget_ms",
                "serve.admission_min_window", "serve.stream_slice_target_ms"]


@pytest.mark.parametrize("key", BATCHER_KEYS)
def test_batcher_key_reaches_the_batcher_as_the_reference_passes_it(key):
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.registry import Registry as RefRegistry

    overrides = {"namespaces": NSS, key: _other(key)}
    mine = Registry(Config(overrides=overrides, env={}), device="cpu")
    ref = RefRegistry(RefConfig(overrides=overrides, env={}))
    try:
        b, rb = mine.check_batcher(), ref.check_batcher()
        for attr in ("_batch_size", "_window_s", "_max_pending", "_shed_on_full",
                     "_interactive_max_tuples", "_sub_slice", "_batch_reserve"):
            assert getattr(b, attr) == getattr(rb, attr), attr
        assert (b.admission is None) == (rb.admission is None)
        if b.admission is not None:
            assert b.admission.snapshot() == rb.admission.snapshot()
            assert (b.admission.min_window, b.admission.budget_ms) == \
                (rb.admission.min_window, rb.admission.budget_ms)
    finally:
        mine.close()
        ref.close()


# -- the store, the write coordinator, the watch hub, health -------------------------

STORE_KEYS = ["serve.idempotency_ttl_s", "serve.watch_log_retention_s", "serve.watch_gc_max_rows"]


@pytest.mark.parametrize("key", STORE_KEYS)
def test_store_key_reaches_the_store(key):
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.registry import Registry as RefRegistry

    overrides = {"namespaces": NSS, key: _other(key)}
    mine = Registry(Config(overrides=overrides, env={}), device="cpu")
    ref = RefRegistry(RefConfig(overrides=overrides, env={}))
    try:
        attr = key.split(".")[1]
        assert getattr(mine.relation_tuple_manager(), attr) == \
            getattr(ref.relation_tuple_manager(), attr) == _other(key)
    finally:
        mine.close()
        ref.close()


GROUP_COMMIT_KEYS = ["serve.group_commit_max_writers", "serve.group_commit_window_ms",
                     "serve.group_commit_max_pending"]


@pytest.mark.parametrize("key", GROUP_COMMIT_KEYS + ["serve.group_commit_enabled"])
def test_write_coordinator_key(monkeypatch, key):
    from keto_tpu.driver.group_commit import GroupCommitCoordinator as RefCo

    from keto_tpu_torch.driver.group_commit import GroupCommitCoordinator

    mine, ref, (rm, rr) = _pair(monkeypatch, {key: _other(key)}, GroupCommitCoordinator, RefCo)
    try:
        co, rco = mine.write_coordinator(), ref.write_coordinator()
        if key == "serve.group_commit_enabled":
            assert co is None and rco is None
            assert mine.transact_writes() == mine.relation_tuple_manager().transact_relation_tuples
            return
        kw = key.split("group_commit_")[1]
        assert rm.kw[kw] == rr.kw[kw] == _other(key)
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("key", ["serve.watch_poll_ms", "serve.watch_max_streams"])
def test_watch_hub_key(key):
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.registry import Registry as RefRegistry

    overrides = {"namespaces": NSS, key: _other(key)}
    mine = Registry(Config(overrides=overrides, env={}), device="cpu")
    ref = RefRegistry(RefConfig(overrides=overrides, env={}))
    try:
        hub, rhub = mine.watch_hub(), ref.watch_hub()
        assert (hub._poll_s, hub.max_streams) == (rhub._poll_s, rhub.max_streams)
    finally:
        mine.close()
        ref.close()


def test_health_monitor_key(monkeypatch):
    from keto_tpu.driver.health import HealthMonitor as RefMonitor

    from keto_tpu_torch.driver.health import HealthMonitor

    key = "serve.staleness_budget_s"
    mine, ref, (rm, rr) = _pair(monkeypatch, {key: 7.5}, HealthMonitor, RefMonitor)
    try:
        mine.health_monitor()
        ref.health_monitor()
        assert rm.kw["staleness_budget_s"] == rr.kw["staleness_budget_s"] == 7.5
    finally:
        mine.close()
        ref.close()


# -- explain, the SLO engine, the flight recorder ------------------------------------

DECISION_LOG_KEYS = {"serve.decision_log_sample": "sample",
                     "serve.decision_log_segment_bytes": "segment_bytes",
                     "serve.decision_log_retention": "retention"}


@pytest.mark.parametrize("key", sorted(DECISION_LOG_KEYS))
def test_decision_log_key(monkeypatch, tmp_path, key):
    from keto_tpu.explain.decision_log import DecisionLog as RefLog

    from keto_tpu_torch.explain.decision_log import DecisionLog

    value = 0.25 if key == "serve.decision_log_sample" else _other(key)
    keys = {"serve.decision_log_dir": str(tmp_path / "d"), key: value}
    mine, ref, (rm, rr) = _pair(monkeypatch, keys, DecisionLog, RefLog)
    try:
        mine.decision_log()
        ref.decision_log()
        kw = DECISION_LOG_KEYS[key]
        assert rm.kw[kw] == rr.kw[kw] == value
        assert rm.calls[-1][0] == rr.calls[-1][0] == (str(tmp_path / "d"),)
    finally:
        mine.close()
        ref.close()


def test_explain_enabled_key():
    mine = Registry(Config(overrides={"namespaces": NSS, "serve.explain_enabled": False},
                           env={}), device="cpu")
    try:
        assert not mine.explain_enabled() and mine.explain_engine() is None
    finally:
        mine.close()


SLO_KEYS = ["serve.slo_availability_objective", "serve.slo_latency_objective_ms",
            "serve.slo_latency_objective_ratio"]


@pytest.mark.parametrize("key", SLO_KEYS)
def test_slo_key(monkeypatch, key):
    from keto_tpu.x.slo import SloEngine as RefSlo

    from keto_tpu_torch.x.slo import SloEngine

    value = {"serve.slo_latency_objective_ms": 100.0}.get(key, 0.95)
    mine, ref, (rm, rr) = _pair(monkeypatch, {key: value}, SloEngine, RefSlo)
    try:
        mine.slo_engine()
        ref.slo_engine()
        kw = key.split("slo_")[1]
        assert rm.kw[kw] == rr.kw[kw] == value
    finally:
        mine.close()
        ref.close()


FLIGHTREC_KEYS = ["serve.debug_bundle_max", "serve.debug_bundle_min_interval_s",
                  "serve.debug_bundle_max_bytes"]


@pytest.mark.parametrize("key", FLIGHTREC_KEYS)
def test_flight_recorder_key(monkeypatch, tmp_path, key):
    from keto_tpu.x.flightrec import FlightRecorder as RefRec

    from keto_tpu_torch.x.flightrec import FlightRecorder

    keys = {"serve.debug_bundle_dir": str(tmp_path / "b"), key: _other(key)}
    mine, ref, (rm, rr) = _pair(monkeypatch, keys, FlightRecorder, RefRec)
    try:
        mine.flight_recorder()
        ref.flight_recorder()
        kw = {"serve.debug_bundle_max": "max_bundles",
              "serve.debug_bundle_min_interval_s": "min_interval_s",
              "serve.debug_bundle_max_bytes": "max_bytes"}[key]
        assert rm.kw[kw] == rr.kw[kw] == _other(key)
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("key,attr", [("serve.timeline_ring", "capacity"),
                                      ("serve.timeline_enabled", "enabled"),
                                      ("serve.list_cache_entries", None),
                                      ("limit.max_read_depth", None)])
def test_other_wired_keys(key, attr):
    value = _other(key)
    reg = Registry(Config(overrides={"namespaces": NSS, key: value}, env={}), device="cpu")
    try:
        if attr is not None:
            assert getattr(reg.timeline_recorder(), attr) == value
        elif key == "limit.max_read_depth":
            assert reg.expand_depth(0) == value and reg.expand_depth(1) == 1
        else:
            assert reg.list_engine()._cache_entries == value
    finally:
        reg.close()


# -- the key policy ------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(waiting_keys()))
def test_a_waiting_key_raises_naming_its_item(key):
    item = waiting_keys()[key]
    value = 2 if key == "serve.mesh_data" else _other(key)
    cfg = Config(overrides={"namespaces": NSS, key: value}, env={})
    with pytest.raises(ValueError, match=f"{key}.*ROADMAP {item}"):
        Registry(cfg, device="cpu")
    # at its default the key is accepted
    Registry(Config(overrides={"namespaces": NSS, key: schema_default(key)}, env={}),
             device="cpu").close()


def test_every_schema_key_is_classified():
    """Every leaf key of the schema is wired, waiting or without a
    counterpart; the wired ones are the rest, and each has a test above or
    a reader in the registry."""
    leaves = []

    def walk(node, prefix):
        for k, v in node.get("properties", {}).items():
            if v.get("type") == "object" and "properties" in v:
                walk(v, f"{prefix}{k}.")
            else:
                leaves.append(f"{prefix}{k}")

    walk(CONFIG_SCHEMA, "")
    import inspect

    source = inspect.getsource(registry_mod) + inspect.getsource(
        __import__("keto_tpu_torch.driver.daemon", fromlist=["x"]))
    source += inspect.getsource(__import__("keto_tpu_torch.cmd", fromlist=["x"]))
    source += inspect.getsource(__import__("keto_tpu_torch.config.provider", fromlist=["x"]))
    for key in leaves:
        if key in waiting_keys() or key in NO_COUNTERPART:
            continue
        short = {"namespaces": "namespace_manager", "profiling": '"profiling"'}.get(key, key)
        assert short in source or key in ENGINE_KEYS.values(), f"{key} is not wired"


@pytest.mark.parametrize("key", sorted(NO_COUNTERPART))
def test_a_key_without_a_counterpart_logs_once(monkeypatch, key):
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(f"test-registry-boot-{key}")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.handlers = [Grab()]
    monkeypatch.setattr(registry_mod, "new_logger", lambda *a, **kw: logger)
    Registry(Config(overrides={"namespaces": NSS}, env={}), device="cpu").close()
    assert sum(f"config {key} " in r for r in records) == 1


@pytest.mark.parametrize("backend", ["auto", "tpu"])
def test_the_card_engine_raises_without_cuda(monkeypatch, backend):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = Registry(Config(overrides={"namespaces": NSS, "engine.backend": backend}, env={}))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reg.permission_engine()
    finally:
        reg.close()
    reg = Registry(Config(overrides={"namespaces": NSS, "engine.backend": backend}, env={}),
                   device="cpu")
    try:
        assert str(reg.permission_engine().device) == "cpu"
    finally:
        reg.close()


def test_the_oracle_backend_serves_from_the_host_engine():
    """``engine.backend: oracle`` serves the cat-videos checks, Expand and
    the list routes from the host engine and the store, explain off."""
    from test_torch_rest import _req

    from keto_tpu_torch.check.engine import CheckEngine
    from keto_tpu_torch.driver.daemon import Daemon
    from keto_tpu_torch.workloads import (
        CAT_VIDEOS_CHECKS,
        CAT_VIDEOS_NAMESPACES,
        CAT_VIDEOS_TUPLES,
        parse_tuples,
    )
    from keto_tpu_torch.relationtuple.model import RelationTuple

    reg = Registry(Config(overrides={
        "namespaces": [n.to_json() for n in CAT_VIDEOS_NAMESPACES], "engine.backend": "oracle",
        "serve.read.port": 0, "serve.write.port": 0, "serve.read.host": "127.0.0.1",
        "serve.write.host": "127.0.0.1"}, env={}))
    reg.relation_tuple_manager().write_relation_tuples(*parse_tuples(CAT_VIDEOS_TUPLES))
    assert isinstance(reg.permission_engine(), CheckEngine)
    assert reg.explain_engine() is None
    d = Daemon(reg)
    d.start()
    try:
        for check, allowed in CAT_VIDEOS_CHECKS:
            q = RelationTuple.from_string(check).to_url_query()
            assert _req("GET", d.read_port, "/check?" + q)[0] == (200 if allowed else 403)
        status, body, _ = _req("POST", d.read_port, "/check/batch", {
            "tuples": [RelationTuple.from_string(c).to_json() for c, _ in CAT_VIDEOS_CHECKS]})
        assert status == 200 and body["results"] == [a for _, a in CAT_VIDEOS_CHECKS]
        status, body, _ = _req("GET", d.read_port, "/expand?namespace=videos&object=/cats/1.mp4"
                               "&relation=view&max-depth=3")
        assert status == 200 and body["type"] == "union"
        status, body, _ = _req("GET", d.read_port, "/relation-tuples/list-subjects?"
                               "namespace=videos&object=/cats/2.mp4&relation=view")
        assert status == 200 and "cat lady" in body["subject_ids"]
        assert _req("GET", d.read_port, "/check/explain?namespace=videos&object=/cats/1.mp4"
                    "&relation=view&subject_id=*")[0] == 404
    finally:
        d.drain_and_shutdown()


# -- the telemetry route sink ----------------------------------------------------------


def test_telemetry_snapshot_equals_the_references():
    from keto_tpu.config.provider import Config as RefConfig
    from keto_tpu.driver.daemon import Daemon as RefDaemon
    from keto_tpu.driver.registry import Registry as RefRegistry
    from test_torch_rest import _req

    from keto_tpu_torch.driver.daemon import Daemon

    overrides = {"namespaces": NSS, "serve.read.port": 0, "serve.write.port": 0,
                 "serve.read.host": "127.0.0.1", "serve.write.host": "127.0.0.1",
                 "telemetry.enabled": True}
    mine = Daemon(Registry(Config(overrides=overrides, env={}), device="cpu"))
    ref = RefDaemon(RefRegistry(RefConfig(overrides=overrides, env={})))
    mine.start()
    ref.serve_all(block=False)
    try:
        for d in (mine, ref):
            t = {"namespace": "acl", "object": "o", "relation": "r", "subject_id": "u"}
            _req("PUT", d.write_port, "/relation-tuples", t)
            for _ in range(3):
                _req("GET", d.read_port, "/check?namespace=acl&object=o&relation=r&subject_id=u")
            _req("GET", d.read_port, "/health/ready")
            _req("GET", d.read_port, "/no/such/route")
            _req("GET", d.write_port, "/version")
        got = mine.registry.telemetry().snapshot()
        assert got == ref.registry.telemetry().snapshot()
        assert got["read GET /check"] == 3 and got["write PUT /relation-tuples"] == 1
    finally:
        mine.drain_and_shutdown()
        ref.drain_and_shutdown()
    off = Registry(Config(overrides={"namespaces": NSS}, env={}), device="cpu")
    try:
        off.telemetry().record("read GET /check")
        assert off.telemetry().snapshot() == {}
    finally:
        off.close()
