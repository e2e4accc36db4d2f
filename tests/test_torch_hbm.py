"""The device-memory governor of the port (keto_tpu_torch/driver/hbm.py) and
its engine seams, on the CPU, against the JAX package's.

- ``HbmGovernor``: the same seeded call sequences (register, add, release,
  plan with and without ``per_shard``, evict_one, maybe_restore,
  set_budget_bytes, the counters, deterministic mode) give the reference
  governor's results and ``snapshot()`` word for word.
- The classifier: ``torch.OutOfMemoryError`` and CUDA's out-of-memory
  texts are device-memory exhaustion; Python's ``MemoryError`` never is.
- Ports of tests/test_hbm.py:193-479: a tiny budget walks every rung with
  decisions equal to the reference engine's and the oracle's; the rungs
  walked step by step and recovered; a refused refresh serves stale as
  DEGRADED; a real ``torch.OutOfMemoryError`` at each upload and dispatch
  site evicts one rung, retries once and answers equal; a second OOM, or
  one with the ladder spent, RAISES (no CPU fallback); ``warm_compile``
  skips the widths over budget; every ledger tag equals its tensors'
  bytes; an audit mismatch flips DEGRADED.
- ``cuda``-marked twins fill the card with a real ballast tensor.
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest
import torch

from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.driver import hbm as port_hbm
from keto_tpu_torch.driver.health import HealthMonitor, HealthState
from keto_tpu_torch.list.gpu_engine import SnapshotListEngine
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store
from test_torch_stream import to_jax

NS = [("ns0", 0), ("ns1", 1)]
ENGINE_RUNGS = ["staging", "labels", "reverse", "warm-ladder", "overlay-budget"]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def wait_for(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def oom(site="test"):
    return torch.OutOfMemoryError(f"CUDA out of memory at {site}. Tried to allocate 2.00 GiB")


# -- the governor against the reference's ----------------------------------------


def _run_sequence(mod, seed: int, deterministic: bool, budget: int):
    """Apply one seeded call sequence to a governor of ``mod``; returns
    every call's result and the snapshot after each call."""
    rng = random.Random(seed)
    g = mod.HbmGovernor(budget_bytes=budget, deterministic=deterministic)
    if deterministic:
        g.set_budget_bytes(budget)
    tags = ["snapshot", "overlay", "labels", "reverse", "warmup", "build"]
    rung_tags = {"staging": None, "labels": "labels", "reverse": "reverse",
                 "warm-ladder": "warmup", "overlay-budget": "overlay"}
    g.attach_rungs([
        (name, (lambda t=t: g.release(t) if t else 0), (lambda: None))
        for name, t in rung_tags.items()
    ])
    out = []
    for _ in range(60):
        op = rng.choice(["register", "add", "release", "plan", "plan_shard", "evict",
                         "restore", "budget", "shards", "notes"])
        if op == "register":
            r = g.register(rng.choice(tags), rng.randrange(0, budget // 3))
        elif op == "add":
            r = g.add(rng.choice(tags), rng.randrange(0, budget // 6))
        elif op == "release":
            r = g.release(rng.choice(tags))
        elif op == "plan":
            r = g.plan(rng.randrange(0, budget), what="t", evict=rng.random() < 0.7)
        elif op == "plan_shard":
            per = [rng.randrange(0, budget // 4) for _ in range(rng.randrange(1, 5))]
            r = g.plan(sum(per), what="s", per_shard=per, evict=rng.random() < 0.7)
        elif op == "evict":
            r = g.evict_one("oom")
        elif op == "restore":
            r = g.maybe_restore(planned=rng.randrange(0, budget // 2))
        elif op == "budget":
            r = g.set_budget_bytes(rng.randrange(budget // 2, 2 * budget))
        elif op == "shards":
            n = rng.randrange(1, 5)
            g.set_shard_count(n)
            r = g.register_shards(rng.choice(tags), [rng.randrange(0, budget // 8)
                                                     for _ in range(n)])
        else:
            g.note_refused()
            g.note_forced("x", 1)
            g.note_oom("site")
            r = g.note_oom_recovered()
        out.append((op, r, g.fits(rng.randrange(0, budget)), g.rung_depth,
                    g.shard_resident_bytes(), g.snapshot()))
    return out


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_governor_equals_the_reference_word_for_word(seed, deterministic):
    from keto_tpu.driver import hbm as ref_hbm

    budget = 10_000 + 997 * seed
    mine = _run_sequence(port_hbm, seed, deterministic, budget)
    ref = _run_sequence(ref_hbm, seed, deterministic, budget)
    assert mine == ref


def test_governor_constants_equal_the_reference():
    from keto_tpu.driver import hbm as ref_hbm

    for name in ("TAGS", "RUNGS", "DEFAULT_HEADROOM_FRAC", "FALLBACK_BUDGET_BYTES",
                 "RESTORE_FRAC"):
        assert getattr(port_hbm, name) == getattr(ref_hbm, name), name


def test_auto_budget_never_probes_an_unnamed_device():
    fb = port_hbm.FALLBACK_BUDGET_BYTES
    assert port_hbm.device_budget_bytes() == fb
    assert port_hbm.device_budget_bytes("cpu") == fb
    assert port_hbm.device_budget_bytes("cuda", deterministic=True) == fb
    assert port_hbm.HbmGovernor(device="cpu").budget_bytes == fb
    assert port_hbm.device_measured_bytes("cpu") is None
    assert port_hbm.device_measured_bytes() is None


def test_host_families_are_kept_apart_from_the_budget():
    g = port_hbm.HbmGovernor(budget_bytes=100)
    assert "host" not in g.snapshot()
    g.set_host_bytes("staging", 1 << 20)
    g.register("snapshot", 60)
    assert g.resident_bytes() == 60 and g.fits(40) and not g.fits(41)
    assert g.snapshot()["host"] == {"staging": 1 << 20}


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 MiB"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("keto_check_run: cudaErrorMemoryAllocation"), True),
    (MemoryError(), False),
    (MemoryError("out of memory"), False),
    (ValueError("out of memory"), False),
    (RuntimeError("an illegal memory access was encountered"), False),
    (RuntimeError("boom"), False),
])
def test_is_resource_exhausted_classifier(exc, want):
    assert port_hbm.is_resource_exhausted(exc) is want


# -- the engine ---------------------------------------------------------------------


def chain_rows(seed=3, n_random=90):
    """A 10-node ring of interior sets (each with two out-edges), grants
    into it, and random tuples."""
    rng = random.Random(seed)
    rows = [T("ns0", f"o{i}", "r0", SubjectSet("ns0", f"o{(i + d) % 10}", "r0"))
            for i in range(10) for d in (1, 3)]
    rows += [T("ns0", "o0", "r0", SubjectID("u0")), T("ns0", "o5", "r0", SubjectID("u1"))]
    rows += [T("ns1", f"d{j}", "view", SubjectSet("ns0", f"o{j % 10}", "r0"))
             for j in range(20)]
    objs = [f"p{i}" for i in range(8)]
    for _ in range(n_random):
        sub = (SubjectID(f"u{rng.randrange(6)}") if rng.random() < 0.5
               else SubjectSet(rng.choice(["ns0", "ns1"]), rng.choice(objs), "r1"))
        rows.append(T(rng.choice(["ns0", "ns1"]), rng.choice(objs), "r1", sub))
    return rows


def queries_for(seed=5, n=160):
    rng = random.Random(seed)
    objs = [f"o{i}" for i in range(10)] + [f"p{i}" for i in range(8)]
    out = []
    for _ in range(n):
        if rng.random() < 0.3:
            out.append(T("ns1", f"d{rng.randrange(20)}", "view",
                         SubjectID(f"u{rng.randrange(7)}")))
        elif rng.random() < 0.5:
            sub = (SubjectID(f"u{rng.randrange(7)}") if rng.random() < 0.6
                   else SubjectSet("ns0", rng.choice(objs), rng.choice(["r0", "r1"])))
            out.append(T("ns0", rng.choice(objs), rng.choice(["r0", "r1"]), sub))
        else:
            out.append(T("ns1", rng.choice(objs), "r1", SubjectID(f"u{rng.randrange(7)}")))
    return out


def port_engine(rows, **kw):
    p = port_store(NS, rows)
    kw.setdefault("device", "cpu")
    e = TorchCheckEngine(p, p.namespaces, **kw)
    return p, e


def oracle(p, queries):
    o = CheckEngine(p)
    return [o.subject_is_allowed(q) for q in queries]


def ref_decisions(rows, queries, **kw):
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    jp = jax_store(NS, rows)
    je = TpuCheckEngine(jp, jp.namespaces, **kw)
    try:
        return je.batch_check([to_jax(q) for q in queries]), je
    finally:
        je.close()


def test_tiny_budget_walks_every_rung_with_decision_parity():
    rows, queries = chain_rows(), queries_for()
    want, je = ref_decisions(rows, queries, hbm_budget_bytes=1)
    ref_snap = je.hbm.snapshot()
    p, e = port_engine(rows, hbm_budget_bytes=1)
    lst = SnapshotListEngine(e, p.namespaces, device="cpu")
    try:
        assert e.batch_check(queries) == want == oracle(p, queries)
        snap = e.hbm.snapshot()
        assert snap["evicted"] == ENGINE_RUNGS == ref_snap["evicted"]
        assert snap["forced_allocs"] >= 1
        assert e._staging_suspended and e._labels_suspended and lst._suspended
        assert e._snapshot.labels is None
        assert len(e._word_widths()) < 7
        assert e._max_overlay_edges < e._configured_overlay_budget
        assert e.batch_check(queries) == want
        assert not e.health()["degraded"]
        got, _ = lst.list_objects("ns1", "view", SubjectID("u0"))
        assert ("objects", "evicted") in lst.requests_total
        assert got == sorted(f"d{j}" for j in range(20))
    finally:
        e.close()


def test_rungs_walk_stepwise_and_recover_when_pressure_clears():
    rows, queries = chain_rows(seed=11), queries_for(seed=12)
    p, e = port_engine(rows)
    try:
        want = oracle(p, queries)
        assert e.labels_settled()
        assert e.batch_check(queries) == want
        led = e.hbm.ledger()
        assert led.get("labels", 0) > 0
        # staging is host memory: only the labels rung can make this room
        e.hbm.set_budget_bytes(e.hbm.resident_bytes() - 1)
        assert e.hbm.plan(led["snapshot"], what="test swap")
        assert e.hbm.rung_depth >= 2
        assert e._staging_suspended and e._labels_suspended
        before = e.counters().get("label_checks", 0)
        assert e.batch_check(queries) == want
        assert e.counters().get("label_checks", 0) == before, "labels gone: BFS only"

        e.hbm.set_budget_bytes(64 << 20)
        e._refresh_task.kick()
        wait_for(lambda: e.hbm.rung_depth == 0 and e._snapshot.labels is not None
                 and e._snapshot.device_labels is not None, msg="restore + label rebuild")
        assert not e._labels_suspended and not e._staging_suspended
        assert e.hbm.ledger().get("labels", 0) > 0
        assert e.hbm.snapshot()["restores"] >= 2
        assert e.batch_check(queries) == want
        assert e.counters().get("label_checks", 0) > before
    finally:
        e.close()


def test_refusal_serves_stale_with_memory_pressure_degraded():
    rows = [T("ns0", f"o{i}", "r0", SubjectSet("ns0", f"o{(i + 1) % 10}", "r0"))
            for i in range(10)] + [T("ns0", "o0", "r0", SubjectID("u0"))]
    queries = [T("ns0", f"o{i}", "r0", SubjectID("u0")) for i in range(10)]
    p, e = port_engine(rows)
    monitor = HealthMonitor(e, staleness_budget_s=3600.0)
    try:
        baseline = e.batch_check(queries)
        token = e._snapshot.snapshot_id
        assert monitor.status()[0] is HealthState.SERVING
        e.hbm.set_budget_bytes(1)
        # an interior → interior edge: its overlay upload must be planned
        p.write_relation_tuples(T("ns0", "o3", "r0", SubjectSet("ns0", "o7", "r0")))
        got, got_token = e.batch_check_with_token(queries, mode="serving")
        assert got == baseline and got_token == token, "a refused refresh serves stale"
        assert e.health()["memory_pressure"]
        state, reason = monitor.status()
        assert state is HealthState.DEGRADED and "memory_pressure" in reason
        snap = e.hbm.snapshot()
        assert snap["refusals"] >= 1 and snap["evicted"] == ENGINE_RUNGS
        # the background pass keeps retrying; its refusals never reach a caller
        assert e.batch_check_with_token(queries, mode="serving")[1] == token

        e.hbm.set_budget_bytes(64 << 20)
        e._refresh_task.kick()
        wait_for(lambda: not e.health()["memory_pressure"]
                 and e._snapshot.snapshot_id == p.watermark(), msg="recovery")
        assert monitor.status()[0] is HealthState.SERVING
        assert e.batch_check(queries) == oracle(p, queries)
    finally:
        e.close()


class _OomAt:
    """Make the engine's next ``times`` attempts at ``site`` raise a real
    ``torch.OutOfMemoryError`` inside its OOM guard, before the upload or
    dispatch runs (where an allocation would raise)."""

    def __init__(self, engine, site: str, times: int = 1):
        self.site, self.left, self.fired = site, times, 0
        guard = engine._guard_alloc

        def guarded(what, fn):
            if what != self.site:
                return guard(what, fn)

            def attempt():
                if self.left > 0:
                    self.left -= 1
                    self.fired += 1
                    raise oom(what)
                return fn()

            return guard(what, attempt)

        engine._guard_alloc = guarded


def _oom_counts(e):
    s = e.hbm.snapshot()
    return s["oom_events"], s["oom_recoveries"], s["rung"]


@pytest.mark.parametrize("labels", [False, True])
def test_oom_at_check_dispatch_evicts_retries_and_answers_equal(labels):
    rows, queries = chain_rows(seed=7), queries_for(seed=8)
    want, _ = ref_decisions(rows, queries, labels_enabled=labels)
    p, e = port_engine(rows, labels_enabled=labels)
    try:
        if labels:
            assert e.labels_settled()
        assert e.batch_check(queries) == want == oracle(p, queries)
        inj = _OomAt(e, "check-dispatch")
        assert e.batch_check(queries) == want
        assert inj.fired == 1
        assert _oom_counts(e) == (1, 1, 1)
        assert e.hbm.snapshot()["evicted"] == ["staging"]
        c = e.counters()
        assert c["oom_events"] == 1 and c["oom_recoveries"] == 1
    finally:
        e.close()


def test_a_second_oom_raises_with_no_answer():
    rows, queries = chain_rows(seed=9), queries_for(seed=10)
    p, e = port_engine(rows, labels_enabled=False)
    try:
        want = oracle(p, queries)
        assert e.batch_check(queries) == want
        inj = _OomAt(e, "check-dispatch", times=2)
        with pytest.raises(torch.OutOfMemoryError):
            e.batch_check(queries)
        assert inj.fired == 2
        assert _oom_counts(e) == (1, 0, 1)
        assert e.health()["degraded"] is False
        assert HealthMonitor(e).status()[0] is HealthState.SERVING
        # the OOM is gone: the engine answers again, on the card's path
        assert e.batch_check(queries) == want
    finally:
        e.close()


def test_an_oom_with_the_ladder_spent_raises():
    rows, queries = chain_rows(seed=13), queries_for(seed=14)
    p, e = port_engine(rows, labels_enabled=False)
    try:
        want = oracle(p, queries)
        assert e.batch_check(queries) == want
        e.hbm.set_budget_bytes(1)
        assert not e.hbm.plan(1 << 30)
        assert e.hbm.rung_depth == len(ENGINE_RUNGS)
        inj = _OomAt(e, "check-dispatch")
        with pytest.raises(torch.OutOfMemoryError):
            e.batch_check(queries)
        assert inj.fired == 1
        assert _oom_counts(e) == (1, 0, len(ENGINE_RUNGS))
        assert e.batch_check(queries) == want
    finally:
        e.close()


def _interior_write(p, k, dst=None):
    """An interior → interior edge (its overlay upload must be planned)."""
    d = (k + 4) % 10 if dst is None else dst
    p.write_relation_tuples(T("ns0", f"o{k}", "r0", SubjectSet("ns0", f"o{d}", "r0")))


def _arm_and_drive(site, p, e, queries):
    """Drive the engine up to ``site``, arm one OOM there and drive it
    through the site; returns the injector."""
    if site == "snapshot-upload":
        inj = _OomAt(e, site)
        e.batch_check(queries)
        return inj
    if site == "labels-upload":
        inj = _OomAt(e, site)
        assert e.labels_settled()
        return inj
    assert e.labels_settled()
    e.batch_check(queries)
    if site == "overlay-upload":
        inj = _OomAt(e, site)
        _interior_write(p, 3)
    elif site == "overlay-apply":
        for k in (1, 2, 3):
            _interior_write(p, k, dst=8)
        e.batch_check(queries)
        inj = _OomAt(e, site)  # the next edge fits the resident pack's spare slots
        _interior_write(p, 4, dst=8)
    elif site == "ell-patch":
        inj = _OomAt(e, site)  # a base edge's tombstone patches its bucket slot
        p.delete_relation_tuples(T("ns0", "o3", "r0", SubjectSet("ns0", "o4", "r0")))
    elif site == "compaction-upload":
        _interior_write(p, 3)
        e.batch_check(queries)
        inj = _OomAt(e, site)
        assert not e.maintenance_settled(fold=True, timeout=60).has_overlay
        return inj
    else:  # warm-compile
        inj = _OomAt(e, site)
        assert e.warm_compile() >= 1
        return inj
    e.batch_check(queries)
    return inj


@pytest.mark.parametrize("site", ["snapshot-upload", "labels-upload", "overlay-upload",
                                  "overlay-apply", "ell-patch", "compaction-upload",
                                  "warm-compile"])
def test_oom_at_each_refresh_upload_site_recovers(site):
    rows, queries = chain_rows(seed=17), queries_for(seed=18)
    p, e = port_engine(rows)
    try:
        inj = _arm_and_drive(site, p, e, queries)
        assert inj.fired == 1, site
        assert _oom_counts(e)[:2] == (1, 1)
        e.maintenance_settled(timeout=60)
        assert e.batch_check(queries) == oracle(p, queries)
        assert e.counters().get("full_rebuilds", 0) == 1, "the delta and fold paths held"
    finally:
        e.close()


def test_a_labels_eviction_during_a_refresh_upload_drops_the_new_labels():
    """An OOM at the overlay upload with the staging rung already spent
    evicts the labels rung: the snapshot being installed (a delta carries
    its base's label arrays) loses them too, so they are freed before the
    retry; the fold builds them again once the rung has restored."""
    rows, queries = chain_rows(seed=35), queries_for(seed=36)
    p, e = port_engine(rows)
    try:
        assert e.labels_settled()
        assert e.hbm.evict_one("test") == "staging"
        old = e._snapshot.device_labels
        inj = _OomAt(e, "overlay-upload")
        _interior_write(p, 3)
        snap = e.snapshot()
        assert inj.fired == 1 and _oom_counts(e)[:2] == (1, 1)
        assert e.hbm.snapshot()["evictions_by_rung"]["labels"] == 1
        assert old is not None and snap.labels is None and snap.device_labels is None
        assert "labels" not in e.hbm.ledger() and e.hbm.rung_depth == 0
        assert e.batch_check(queries) == oracle(p, queries)
        assert e.maintenance_settled(fold=True, timeout=60).labels is not None
        before = e.counters().get("label_checks", 0)
        assert e.batch_check(queries) == oracle(p, queries)
        assert e.counters()["label_checks"] > before
    finally:
        e.close()


def test_warm_compile_skips_widths_over_budget():
    rows, queries = chain_rows(seed=19), queries_for(seed=20)
    p, e = port_engine(rows)
    try:
        e.batch_check(queries[:8])
        # the background label build plans its arrays against the budget:
        # let it land before the budget is cut to the warmup's size
        assert e.labels_settled()
        snap = e._snapshot
        widths = e.stream_widths(snap)
        assert len(widths) > 1
        smallest = e._warm_width_bytes(snap, widths[0])
        e.hbm.set_budget_bytes(e.hbm.resident_bytes() + smallest)
        assert e.warm_compile() >= 1
        assert e.warm_widths_skipped == len(widths) - 1
        assert e.hbm.rung_depth == 0, "warming is optional: it never evicts"
        assert e.hbm.ledger()["warmup"] == smallest
        assert e.warmup == widths[0]
        e.hbm.set_budget_bytes(64 << 20)
        e.warm_compile()
        assert e.warmup == widths[-1] and e.warm_widths_skipped == 0
        assert e.batch_check(queries) == oracle(p, queries)
    finally:
        e.close()


def test_every_ledger_tag_equals_its_tensors_bytes():
    rows, queries = chain_rows(seed=21), queries_for(seed=22)
    _, je = ref_decisions(rows, queries)
    p, e = port_engine(rows)
    lst = SnapshotListEngine(e, p.namespaces, device="cpu")
    try:
        assert e.labels_settled()
        e.batch_check(queries)
        led = e.hbm.ledger()
        ref_led = je.hbm.ledger()
        assert led["snapshot"] == ref_led["snapshot"] == e.hbm_ledger_bytes()["snapshot"]
        assert led["labels"] == ref_led["labels"] == e.hbm_ledger_bytes()["labels"]
        _interior_write(p, 2)
        e.batch_check(queries)
        lst.list_objects("ns1", "view", SubjectID("u0"))
        lst.list_subjects("ns1", "d3", "view")
        snap = e._snapshot
        led = e.hbm.ledger()
        want = e.hbm_ledger_bytes()
        assert want["overlay"] > 0
        for tag in ("snapshot", "overlay", "labels"):
            assert led[tag] == want[tag], tag
        assert led["reverse"] == lst.device_bytes(snap) > 0
        assert sum(led.values()) == e.hbm.resident_bytes()
        h = e.health()
        assert h["hbm_resident_bytes"] == e.hbm.resident_bytes()
        assert h["hbm_budget_bytes"] == e.hbm.budget_bytes == port_hbm.FALLBACK_BUDGET_BYTES
    finally:
        e.close()


def test_health_inputs_carry_the_reference_keys():
    rows, queries = chain_rows(seed=23), queries_for(seed=24)
    _, je = ref_decisions(rows, queries)
    p, e = port_engine(rows)
    try:
        e.batch_check(queries)
        # the background label build narrates its "labels" phase into
        # health() until it lands, as the reference's does
        e.labels_settled()
        h = e.health()
        # the reference's device-error streak feeds its CPU fallback: not ported
        assert set(h) == set(je.health()) - {"consecutive_device_errors"}
        assert h["has_snapshot"] and h["staleness_s"] == 0.0 and h["maintenance_alive"]
        assert h["degraded"] is False and h["memory_pressure"] is False
        assert h["build_phase"] == "idle" and h["build_pct"] == 1.0
    finally:
        e.close()


def test_audit_mismatch_flips_degraded(monkeypatch):
    rows, queries = chain_rows(seed=25), queries_for(seed=26)
    p, e = port_engine(rows, audit_sample_rate=1.0)
    try:
        monkeypatch.setattr(CheckEngine, "subject_is_allowed", lambda self, rt: None)
        e.batch_check(queries[:16])
        assert e.audit_settled(60)
        assert e.health()["audit_mismatches"] >= 1
        state, reason = HealthMonitor(e).status()
        assert state is HealthState.DEGRADED and "audit" in reason
    finally:
        e.close()


def test_the_staging_rung_drops_the_pinned_pool():
    rows, queries = chain_rows(seed=27), queries_for(seed=28)
    p, e = port_engine(rows, labels_enabled=False)
    try:
        want = oracle(p, queries)
        assert e.batch_check(queries) == want
        held = e.staging_snapshot()["bytes"]
        assert held > 0 and e.hbm.snapshot()["host"] == {"staging": held}
        assert "staging" not in e.hbm.ledger(), "host memory is never the card's"
        assert e.hbm.evict_one("test") == "staging"
        assert e.staging_snapshot()["bytes"] == 0 and e.hbm.snapshot()["host"]["staging"] == 0
        assert e.batch_check(queries) == want
        assert e.staging_snapshot()["bytes"] == 0, "per-slice buffers while evicted"
        e.hbm.maybe_restore()
        assert not e._staging_suspended
        assert e.batch_check(queries) == want
        assert e.staging_snapshot()["bytes"] > 0
    finally:
        e.close()


def test_a_refused_label_build_transient_builds_on_the_host():
    rows, queries = chain_rows(seed=29), queries_for(seed=30)
    p, e = port_engine(rows, labels_device_min_edges=0)
    try:
        assert e.labels_settled()
        c0 = e.counters()
        assert c0["label_device_builds"] == 1
        dev_idx = e._snapshot.labels
        # the build transient alone does not fit: the labels build on the host
        e.hbm.set_budget_bytes(e.hbm.resident_bytes() + e.label_build_bytes - 1)
        idx = e._build_label_index(e._snapshot)
        c = e.counters()
        assert c["label_device_build_skipped"] == 1
        assert c["label_device_builds"] == 1
        assert idx.backend == "host" and dev_idx.backend == "device"
        assert e.hbm.rung_depth == 0, "a refused transient never evicts"
        assert np.array_equal(idx.out_lab, dev_idx.out_lab)
        assert np.array_equal(idx.in_lab, dev_idx.in_lab)
        assert "build" not in e.hbm.ledger()
        assert e.batch_check(queries) == oracle(p, queries)
    finally:
        e.close()


# -- on the card: a real ballast --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a real out-of-memory error needs the card")
    return torch.device("cuda")


def _fill_card():
    """Hold every byte the caching allocator can get: one ballast tensor
    over the driver's free memory less 64 MiB, then ever smaller tensors
    until each size raises ``torch.OutOfMemoryError``."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    held = [torch.empty(max(0, free - (64 << 20)), dtype=torch.uint8, device="cuda")]
    for size in (16 << 20, 1 << 20, 64 << 10, 4 << 10, 512):
        while True:
            try:
                held.append(torch.empty(size, dtype=torch.uint8, device="cuda"))
            except torch.OutOfMemoryError:
                break
    return held


@pytest.mark.cuda
def test_cuda_a_real_oom_at_dispatch_evicts_and_retries(cuda_device):
    """The first attempt of the slice dispatch fills the card and asks the
    caching allocator for more: a real ``torch.OutOfMemoryError``, which
    the guard classifies, counts and answers by evicting one rung; the
    ballast is gone before the retry, which answers."""
    rows, queries = chain_rows(seed=31), queries_for(seed=32)
    p, e = port_engine(rows, device=cuda_device, labels_enabled=False)
    try:
        want = oracle(p, queries)
        assert e.batch_check(queries) == want
        e.warm_compile()  # the widest workspace sits in the allocator's cache
        fired = []
        guard = e._guard_alloc

        def once(what, fn):
            if what != "check-dispatch" or fired:
                return guard(what, fn)

            def attempt():
                if not fired:
                    fired.append(1)
                    held = _fill_card()
                    try:
                        torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
                    finally:
                        del held
                return fn()

            return guard(what, attempt)

        e._guard_alloc = once
        assert e.batch_check(queries) == want
        assert fired and _oom_counts(e) == (1, 1, 1)
    finally:
        e.close()


@pytest.mark.cuda
def test_cuda_an_oom_no_rung_clears_raises(cuda_device):
    """The card filled: the batch's dispatch raises, the guard evicts the
    staging rung (host memory: nothing on the card), the retry raises too
    and reaches the caller; health stays SERVING; freed, the card answers."""
    rows, queries = chain_rows(seed=33), queries_for(seed=34)
    p, e = port_engine(rows, device=cuda_device, labels_enabled=False)
    try:
        want = oracle(p, queries)
        assert e.batch_check(queries) == want
        held = _fill_card()
        try:
            with pytest.raises(torch.OutOfMemoryError):
                e.batch_check(queries)
            g = e.hbm.snapshot()
            assert (g["oom_events"], g["oom_recoveries"], g["evicted"]) == (1, 0, ["staging"])
        finally:
            del held
            torch.cuda.empty_cache()
        assert HealthMonitor(e).status()[0] is HealthState.SERVING
        assert e.batch_check(queries) == want
    finally:
        e.close()


@pytest.mark.cuda
def test_cuda_a_refresh_oom_is_relieved_by_the_labels_rung(cuda_device):
    """The card filled and the staging rung spent: the refresh's overlay
    upload raises, the guard evicts the labels rung, whose arrays — the
    serving snapshot's and the one being installed — free their blocks,
    and the retry succeeds."""
    rows, queries = chain_rows(seed=37), queries_for(seed=38)
    p, e = port_engine(rows, device=cuda_device)
    try:
        assert e.labels_settled()
        assert e.batch_check(queries) == oracle(p, queries)
        assert e.hbm.evict_one("test") == "staging"
        _interior_write(p, 3)
        held = _fill_card()
        try:
            snap = e.snapshot()
        finally:
            del held
            torch.cuda.empty_cache()
        g = e.hbm.snapshot()
        assert (g["oom_events"], g["oom_recoveries"]) == (1, 1)
        assert g["evictions_by_rung"]["labels"] == 1 and snap.device_labels is None
        assert snap.snapshot_id == p.watermark()
        assert e.batch_check(queries) == oracle(p, queries)
    finally:
        e.close()
