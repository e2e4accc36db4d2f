"""The shadow audit of ``TorchCheckEngine`` (keto_tpu/check/tpu_engine.py:
1818-1900) on the CPU: a sampled decision is re-checked on the CPU oracle
by a background worker, off the serving path.

- At rate 1.0 every decision the batch path and the stream answered is
  re-checked: ``audit_checks`` equals them, no mismatch, and the answers
  the callers got are the engine's.
- A sample taken before a write is skipped as stale, not compared.
- A divergence forced by making the port's oracle call disagree is counted
  and captures both witnesses, equal to what the reference's engine
  captures under its ``audit-flip`` fault on the same store and tuple.
- Rate 0 samples nothing; ``close`` stops the worker.
- The stream knobs reach the slice controller as the reference's do.
"""

from __future__ import annotations

import pytest

from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet

from test_torch_snapshot import jax_store, port_store
from test_torch_stream import NS, mixed_depth, to_jax


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


def engine(rows, rate=1.0, **kw):
    p = port_store(NS, rows)
    e = TorchCheckEngine(p, p.namespaces, device="cpu", audit_sample_rate=rate, **kw)
    e.labels_settled()
    return p, e


AUDIT = ("audit_checks", "audit_mismatches", "audit_skipped_stale")


def audit_counts(e):
    c = e.counters()
    return {k: c[k] for k in AUDIT}


@pytest.mark.parametrize("labels", [False, True])
def test_every_decision_is_audited_at_rate_one(labels):
    rows, queries = mixed_depth(seed=31, n_queries=300)
    p, e = engine(rows, labels_enabled=labels)
    try:
        assert audit_counts(e) == dict.fromkeys(AUDIT, 0)
        got = e.batch_check(queries)
        assert e.audit_settled(60)
        assert audit_counts(e) == {"audit_checks": 300, "audit_mismatches": 0,
                                   "audit_skipped_stale": 0}
        streamed = [bool(x) for s in e.batch_check_stream(queries[:200], slice_cap=64)
                    for x in s]
        assert e.audit_settled(60)
        assert audit_counts(e)["audit_checks"] == 500
        oracle = CheckEngine(p)
        assert got == [oracle.subject_is_allowed(q) for q in queries]
        assert streamed == got[:200]
        assert not e.audit_divergences
    finally:
        e.close()


def test_rate_zero_samples_nothing_and_a_fractional_rate_samples_some():
    rows, queries = mixed_depth(seed=32, n_queries=400)
    for rate, lo, hi in ((0.0, 0, 0), (0.25, 50, 150)):
        _, e = engine(rows, rate=rate)
        try:
            e.batch_check(queries)
            assert e.audit_settled(60)
            n = audit_counts(e)["audit_checks"]
            assert lo <= n <= hi, (rate, n)
        finally:
            e.close()


def test_a_sample_taken_before_a_write_is_skipped_as_stale():
    rows, queries = mixed_depth(seed=33, n_queries=50)
    p, e = engine(rows)
    try:
        kick = e._audit_task.kick
        e._audit_task.kick = lambda: None  # hold the samples back
        e.batch_check(queries)
        assert len(e._audit_pending) == 50
        p.write_relation_tuples(T("groups", "g0", "member", SubjectID("late-user")))
        e._audit_task.kick = kick
        kick()
        assert e.audit_settled(60)
        assert audit_counts(e) == {"audit_checks": 0, "audit_mismatches": 0,
                                   "audit_skipped_stale": 50}
        e.batch_check(queries[:10], mode="latest")
        assert e.audit_settled(60)
        assert audit_counts(e)["audit_checks"] == 10
    finally:
        e.close()


@pytest.mark.parametrize("case", ["grant", "deny", "chain"])
def test_forced_divergence_captures_both_witnesses_as_the_reference(monkeypatch, case):
    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu.x import faults

    rows = [
        T("docs", "doc", "view", SubjectSet("groups", "eng", "member")),
        T("groups", "eng", "member", SubjectID("alice")),
        T("groups", "eng", "member", SubjectSet("groups", "core", "member")),
        T("groups", "core", "member", SubjectID("bob")),
    ]
    q = {"grant": T("docs", "doc", "view", SubjectID("alice")),
         "deny": T("docs", "doc", "view", SubjectID("mallory")),
         "chain": T("docs", "doc", "view", SubjectID("bob"))}[case]
    p, e = engine(rows)
    jp = jax_store(NS, rows)
    ref = TpuCheckEngine(jp, jp.namespaces, audit_sample_rate=1.0)
    try:
        # the port: the oracle call disagrees with the device
        real = e._audit_oracle_check
        monkeypatch.setattr(e, "_audit_oracle_check", lambda rt: not real(rt))
        decided = e.batch_check([q])[0]
        assert e.audit_settled(60)
        assert audit_counts(e) == {"audit_checks": 1, "audit_mismatches": 1,
                                   "audit_skipped_stale": 0}
        mine = e.audit_divergences[-1]
        assert (mine["device_decision"], mine["oracle_decision"]) == (decided, not decided)
        # the reference: its audit-flip fault corrupts the device's decision
        ref._audit_task.kick = lambda: None
        assert ref.batch_check([to_jax(q)]) == [decided]
        with faults.injected("audit-flip"):
            ref._audit_pass()
        theirs = ref.audit_divergences[-1]
        assert (theirs["device_decision"], theirs["oracle_decision"]) == (not decided, decided)
        for key in ("tuple", "snaptoken", "device_witness", "oracle_witness", "certificate"):
            assert mine[key] == theirs[key], key
        if decided:
            assert mine["device_witness"] and mine["oracle_witness"]
        else:
            assert mine["certificate"]["type"] == "frontier-exhaustion"
    finally:
        e.close()
        ref.close()


def test_close_stops_the_audit_worker():
    rows, queries = mixed_depth(seed=34, n_queries=20)
    _, e = engine(rows)
    e.batch_check(queries)
    assert e.audit_settled(60)
    e.close()
    assert not e._audit_task._thread.is_alive()


def test_stream_knobs_reach_the_controller_as_the_reference():
    """``stream_slice_target_ms`` and ``stream_tail_ratio`` configure the
    slice controller as the reference engine's do (tpu_engine.py:1134)."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    rows, _ = mixed_depth(seed=35, n_queries=1)
    _, e = engine(rows, rate=0.0, stream_slice_target_ms=12.5, stream_tail_ratio=3.0)
    jp = jax_store(NS, rows)
    ref = TpuCheckEngine(jp, jp.namespaces, stream_slice_target_ms=12.5, stream_tail_ratio=3.0)
    try:
        mine, theirs = e.stream_ctrl.snapshot(), ref.stream_ctrl.snapshot()
        assert (mine["target_ms"], mine["tail_ratio"]) == (12.5, 3.0)
        assert mine == theirs
    finally:
        e.close()
        ref.close()
