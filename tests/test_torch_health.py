"""The health state machine of the port (keto_tpu_torch/driver/health.py)
and the readiness route that reads it, on the CPU.

- ``HealthMonitor`` gives the reference monitor's state and reason (and
  transition count, STARTING detail, readiness) on the same seeded
  sequences of ``health()`` dicts, overrides included.
- ``/health/ready``'s three bodies (keto_tpu/servers/rest.py:509-548): 200
  ``{"status": "ok"}`` while SERVING, 200 with the state and reason in the
  other ready states (STARTING with the build's detail), 503 with
  ``Retry-After: 1`` when NOT_SERVING; the drain's override.
- On a real engine: memory pressure reads DEGRADED, a snapshot further
  behind the store than the staleness budget reads NOT_SERVING, and both
  recover once the budget returns.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request

import pytest

from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver.daemon import DRAINING, Daemon, drain
from keto_tpu_torch.driver.health import READY_STATES, HealthMonitor, HealthState
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.servers.rest import READ, RestApp

from test_torch_snapshot import port_store


class FakeEngine:
    """An engine whose ``health()`` answers the next dict of a script."""

    def __init__(self, script=None, h=None):
        self.script = list(script or [])
        self.h = h
        self.raise_with = None

    def health(self):
        if self.raise_with is not None:
            raise RuntimeError(self.raise_with)
        if self.script:
            self.h = self.script.pop(0)
        return self.h


def random_health(rng):
    h = {
        "has_snapshot": rng.random() < 0.8,
        "staleness_s": rng.choice([0.0, 0.5, 3.0, 61.0, 600.0]),
        "maintenance_alive": rng.random() < 0.9,
        "refresh_last_error": rng.choice([None, "", "OSError: store gone"]),
        "degraded": rng.random() < 0.1,
        "memory_pressure": rng.random() < 0.3,
        "audit_mismatches": rng.choice([0, 0, 0, 2]),
        "build_phase": rng.choice(["idle", "scan", "intern", None]),
        "build_pct": rng.choice([0.0, 0.35, 0.5]),
        "build_rows_ingested": rng.choice([0, 1234]),
    }
    for k in list(h):  # a missing key takes the monitor's default
        if rng.random() < 0.05:
            del h[k]
    return h


def _drive(mod, script, overrides, budget):
    eng = FakeEngine()
    m = mod.HealthMonitor(eng, staleness_budget_s=budget)
    out = []
    for h, ov in zip(script, overrides):
        eng.h = h
        if ov == "clear":
            m.set_override(None)
        elif ov is not None:
            m.set_override(mod.HealthState(ov[0]), ov[1])
        state, reason = m.status()
        out.append((state.value, reason, m.ready(), m.transitions, m.starting_detail()))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_monitor_equals_the_reference_on_the_same_inputs(seed):
    from keto_tpu.driver import health as ref_health
    from keto_tpu_torch.driver import health as port_health

    rng = random.Random(seed)
    script = [random_health(rng) for _ in range(80)]
    overrides = [
        None if rng.random() < 0.9 else rng.choice(
            ["clear", ("not_serving", DRAINING), ("degraded", "rehearsal")])
        for _ in script
    ]
    budget = rng.choice([1.0, 60.0])
    assert _drive(port_health, script, overrides, budget) == \
        _drive(ref_health, script, overrides, budget)
    assert [s.value for s in port_health.READY_STATES] == \
        [s.value for s in ref_health.READY_STATES]


def test_an_engine_without_health_serves_and_a_broken_probe_does_not():
    assert HealthMonitor(object()).status() == (HealthState.SERVING, "")
    eng = FakeEngine(h={"has_snapshot": True})
    m = HealthMonitor(eng)
    assert m.status() == (HealthState.SERVING, "")
    eng.raise_with = "boom"
    state, reason = m.status()
    assert state is HealthState.NOT_SERVING and reason == "health probe failed: boom"
    assert m.starting_detail() == {}


def test_listeners_and_watch_see_each_transition_once():
    eng = FakeEngine(h={"has_snapshot": False})
    m = HealthMonitor(eng, staleness_budget_s=1.0)
    seen = []
    m.add_listener(lambda s, r: seen.append(s))
    m.add_listener(lambda s, r: 1 / 0)  # contained
    assert m.status()[0] is HealthState.STARTING
    eng.h = {"has_snapshot": True}
    m.status()
    m.status()
    eng.h = {"has_snapshot": True, "staleness_s": 5.0}
    m.status()
    assert seen == [HealthState.SERVING, HealthState.NOT_SERVING]
    assert m.transitions == 3 and len(m.transitions_log) == 3
    polls = iter(range(6))
    got = list(m.watch(poll_s=0.0, should_stop=lambda: next(polls, None) is None))
    assert got[0][0] is HealthState.NOT_SERVING and len(got) == 1
    snap = m.snapshot()
    assert snap["state"] == "not_serving" and snap["engine"]["staleness_s"] == 5.0


class FakeBatcher:
    def __init__(self, engine):
        self.engine = engine


class FakeStore:
    def transact_relation_tuples(self, *a, **k):
        raise AssertionError("no writes here")


def _ready(app):
    return app.handle("GET", "/health/ready", {}, b"")


@pytest.mark.parametrize("h,status,body,retry", [
    ({"has_snapshot": True}, 200, {"status": "ok"}, None),
    ({"has_snapshot": True, "memory_pressure": True}, 200, "degraded", None),
    ({"has_snapshot": True, "audit_mismatches": 3}, 200, "degraded", None),
    ({"has_snapshot": False, "build_phase": "intern", "build_pct": 0.35,
      "build_rows_ingested": 4096}, 200, "starting", None),
    ({"has_snapshot": False}, 200, "starting", None),
    ({"has_snapshot": True, "staleness_s": 120.0}, 503, "unavailable", "1"),
    ({"maintenance_alive": False, "refresh_last_error": "X"}, 503, "unavailable", "1"),
])
def test_health_ready_bodies(h, status, body, retry):
    eng = FakeEngine(h=h)
    app = RestApp(READ, FakeStore(), FakeBatcher(eng))
    st, got, headers = _ready(app)
    assert st == status
    if isinstance(body, dict):
        assert got == body and headers == {}
        return
    assert got["status"] == body and got["reason"]
    assert headers.get("Retry-After") == retry
    ref_state, ref_reason = HealthMonitor(eng).status()
    assert got["reason"] == ref_reason
    if body == "starting" and h.get("build_phase"):
        assert (got["phase"], got["pct"], got["rows_ingested"]) == ("intern", 0.35, 4096)
    if body == "degraded":
        assert ref_state in READY_STATES


def test_the_drain_override_reads_503_and_clears():
    eng = FakeEngine(h={"has_snapshot": True})
    app = RestApp(READ, FakeStore(), FakeBatcher(eng))
    assert app.draining is None
    app.monitor.set_override(HealthState.NOT_SERVING, DRAINING)
    assert app.draining == DRAINING
    assert _ready(app) == (503, {"status": "unavailable", "reason": DRAINING},
                           {"Retry-After": "1"})
    app.monitor.set_override(HealthState.DEGRADED, "rehearsal")
    assert app.draining is None
    assert _ready(app)[:2] == (200, {"status": "degraded", "reason": "rehearsal"})
    app.monitor.set_override(None)
    assert _ready(app)[:2] == (200, {"status": "ok"})


# -- a real engine ------------------------------------------------------------------


NS = [("ns0", 0)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def ring():
    rows = [T("ns0", f"o{i}", "r0", SubjectSet("ns0", f"o{(i + d) % 10}", "r0"))
            for i in range(10) for d in (1, 3)]
    return rows + [T("ns0", "o0", "r0", SubjectID("u0"))]


def wait_for(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_staleness_past_the_budget_reads_not_serving_and_recovers():
    p = port_store(NS, ring())
    e = TorchCheckEngine(p, p.namespaces, device="cpu")
    m = HealthMonitor(e, staleness_budget_s=0.3)
    try:
        assert m.status()[0] is HealthState.STARTING
        e.batch_check([T("ns0", "o3", "r0", SubjectID("u0"))])
        assert m.status() == (HealthState.SERVING, "")
        e.hbm.set_budget_bytes(1)
        p.write_relation_tuples(T("ns0", "o2", "r0", SubjectSet("ns0", "o9", "r0")))
        e.batch_check([T("ns0", "o3", "r0", SubjectID("u0"))], mode="serving")
        state, reason = m.status()
        assert state is HealthState.DEGRADED and reason.startswith("memory_pressure")
        wait_for(lambda: m.status()[0] is HealthState.NOT_SERVING, msg="NOT_SERVING")
        assert "behind the store (budget 0.3s)" in m.status()[1]
        assert e.staleness_s() > 0.3
        e.hbm.set_budget_bytes(64 << 20)
        wait_for(lambda: m.status()[0] is HealthState.SERVING, msg="recovery")
        assert e.staleness_s() == 0.0 and not e.health()["memory_pressure"]
        assert e._snapshot.snapshot_id == p.watermark()
    finally:
        e.close()
    # a stopped maintenance worker is a dead one
    assert m.status()[0] is HealthState.NOT_SERVING


def _http(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read()), dict(err.headers)


def test_daemon_ready_over_http_degraded_then_unavailable_then_drained():
    from keto_tpu_torch import namespace as tns

    d = Daemon([tns.Namespace(id=0, name="ns0")], device="cpu", tuples=ring())
    d.start()
    try:
        assert d.monitor.staleness_budget_s == 60.0
        assert d.engine.hbm.configured_budget == 0
        assert _http(d.read.port, "/health/ready")[:2] == (200, {"status": "ok"})
        d.engine.hbm.set_budget_bytes(1)
        d.store.write_relation_tuples(T("ns0", "o2", "r0", SubjectSet("ns0", "o9", "r0")))
        d.engine.snapshot_serving()
        st, body, _ = _http(d.write.port, "/health/ready")
        assert (st, body["status"]) == (200, "degraded") and "memory_pressure" in body["reason"]
        d.monitor.set_staleness_budget_s(0.2)
        wait_for(lambda: _http(d.read.port, "/health/ready")[0] == 503, msg="503")
        st, body, headers = _http(d.read.port, "/health/ready")
        assert body["status"] == "unavailable" and "behind the store" in body["reason"]
        assert headers["Retry-After"] == "1"
        d.engine.hbm.set_budget_bytes(64 << 20)
        wait_for(lambda: _http(d.read.port, "/health/ready")[0] == 200, msg="recovery")
        out = drain((d.read, d.write), d.batcher, 5.0)
        assert out["batcher_idle"]
        for port in (d.read.port, d.write.port):
            assert _http(port, "/health/ready")[:2] == \
                (503, {"status": "unavailable", "reason": DRAINING})
    finally:
        d.stop()
