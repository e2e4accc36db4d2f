"""The retry policy and the store-read retry of a refresh, against the JAX
package on the CPU.

- ``Backoff`` and ``retry_call`` (keto_tpu_torch/x/retry.py) draw the same
  delays as the JAX package's under the same ``random`` seed, honour
  ``retryable``, ``delay_hint`` and the deadline the same way, and call
  ``on_retry`` once per scheduled retry;
- the engine's ``_read_store`` (keto_tpu/check/tpu_engine.py:1507-1524)
  retries a flaky ``changes_since`` and the full build's ``snapshot_rows``
  and chunked scan (tests/test_streaming_build.py:223-260), each retry
  counted in ``refresh_read_retries`` as the JAX engine counts it, with
  decisions equal to the oracle's; a store that keeps failing past
  ``refresh_retry_max_wait_s`` fails the refresh and the next check raises;
  only the store's own errors (``OSError``) retry: a torch or CUDA error,
  or an error of the port's own code in a read or inside the scan's
  interning, raises at once.
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest
import torch

from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.check.gpu_engine import TorchCheckEngine
from keto_tpu_torch.graph import stream_build
from keto_tpu_torch.graph.snapshot import build_snapshot
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.x.retry import Backoff, retry_call

from test_torch_overlay import jt
from test_torch_snapshot import jax_store, port_store

NS = [("g", 1), ("d", 2)]


def T(ns, obj, rel, sub):
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=sub)


# -- the policy ----------------------------------------------------------------------------


@pytest.mark.parametrize("base_s,max_s,factor,jitter", [(0.2, 10.0, 2.0, 0.25),
                                                        (0.05, 0.5, 2.0, 0.25),
                                                        (1.0, 3.0, 3.0, 0.0)])
def test_backoff_draws_equal_reference(base_s, max_s, factor, jitter):
    from keto_tpu.x.retry import Backoff as RefBackoff

    seqs = []
    for cls in (Backoff, RefBackoff):
        random.seed(int(base_s * 1000) + int(max_s))
        b = cls(base_s=base_s, max_s=max_s, factor=factor, jitter=jitter)
        seq = [b.next() for _ in range(8)]
        assert b.attempt == 8
        b.reset()
        seq.append(b.next())
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert all(d <= max_s * (1 + jitter) for d in seqs[0])


def _flaky(n_fail, exc=ConnectionError):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= n_fail:
            raise exc(f"transient {len(calls)}")
        return len(calls)

    return fn, calls


@pytest.mark.parametrize("n_fail", [0, 1, 3])
def test_retry_call_equals_reference(monkeypatch, n_fail):
    from keto_tpu.x import retry as ref_retry

    out = []
    for mod in (retry_call, ref_retry.retry_call):
        random.seed(7)
        sleeps: list = []
        monkeypatch.setattr(time, "sleep", sleeps.append)
        fn, calls = _flaky(n_fail)
        seen: list = []
        got = mod(fn, max_wait_s=60.0, base_s=0.05, max_s=0.5,
                  on_retry=lambda e, d: seen.append((str(e), d)))
        out.append((got, len(calls), seen, sleeps))
    assert out[0] == out[1]
    assert out[0][0] == n_fail + 1 and len(out[0][2]) == n_fail


def test_retry_call_gives_up_at_the_deadline_and_filters(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    fn, calls = _flaky(100)
    with pytest.raises(ConnectionError):
        retry_call(fn, max_wait_s=0.0)  # the first sleep would cross it
    assert len(calls) == 1
    fn, calls = _flaky(100, ValueError)
    with pytest.raises(ValueError):
        retry_call(fn, max_wait_s=60.0, retryable=lambda e: not isinstance(e, ValueError))
    assert len(calls) == 1
    fn, calls = _flaky(2)
    delays: list = []
    assert retry_call(fn, max_wait_s=60.0, delay_hint=lambda e: 0.25,
                      on_retry=lambda e, d: delays.append(d)) == 3
    assert delays == [0.25, 0.25]


# -- the engine's store reads ----------------------------------------------------------------


class Flaky:
    """A store whose named reads fail ``n`` times each before they pass
    through (a dropped connection, as a SQL store would raise)."""

    def __init__(self, inner, n: int, reads=("changes_since",), exc=ConnectionError):
        self._inner = inner
        self._left = {r: n for r in reads}
        self._exc = exc
        self.calls = {r: 0 for r in reads}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._left:
            return attr

        def call(*a, **kw):
            self.calls[name] += 1
            if self._left[name] > 0:
                self._left[name] -= 1
                raise self._exc(f"{name}: server closed the connection")
            return attr(*a, **kw)

        return call


def rows_of(seed):
    rng = np.random.default_rng(seed)
    objs, users = [f"o{i}" for i in range(6)], [f"u{i}" for i in range(5)]
    rows = [T("g", f"o{i}", "m", SubjectSet("g", f"o{(i + 1) % 6}", "m")) for i in range(6)]
    for _ in range(40):
        sub = (SubjectID(users[rng.integers(5)]) if rng.random() < 0.5
               else SubjectSet("g", objs[rng.integers(6)], "m"))
        rows.append(T(("g", "d")[rng.integers(2)], objs[rng.integers(6)], "m", sub))
    return rows, objs, users


def _queries(objs, users):
    return [T(ns, o, "m", SubjectID(u)) for ns in ("g", "d") for o in objs for u in users + ["x"]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flaky_delta_read_is_retried_and_counted_as_the_reference(seed):
    from keto_tpu.check.tpu_engine import TpuCheckEngine

    read = "changes_since"
    rows, objs, users = rows_of(seed)
    p, j = port_store(NS, rows), jax_store(NS, rows)
    fp, fj = Flaky(p, 0, (read,)), Flaky(j, 0, (read,))
    eng = TorchCheckEngine(fp, p.namespaces, device="cpu", labels_enabled=False)
    ref = TpuCheckEngine(fj, j.namespaces, labels_enabled=False)
    try:
        eng.snapshot()
        ref.snapshot()
        new = [T("g", "o1", "m", SubjectID("late")), T("d", "o2", "m", SubjectID("late"))]
        p.write_relation_tuples(*new)
        j.write_relation_tuples(*[jt(t) for t in new])
        fp._left[read] = fj._left[read] = 2
        qs = _queries(objs, users + ["late"])
        oracle = CheckEngine(p)
        assert eng.batch_check(qs) == [oracle.subject_is_allowed(q) for q in qs]
        assert ref.batch_check([jt(q) for q in qs]) == eng.batch_check(qs)
        c, m = eng.counters(), ref.maintenance.snapshot()
        assert c.get("refresh_read_retries") == m.get("refresh_read_retries") == 2
        assert c.get("delta_applies") == m.get("delta_applies") == 1
        assert c.get("full_rebuilds") == m.get("full_rebuilds") == 1
    finally:
        eng.close()
        ref.close()


def test_flaky_full_build_read_is_retried():
    rows, objs, users = rows_of(2)
    p = port_store(NS, rows)
    eng = TorchCheckEngine(Flaky(p, 2, ("snapshot_rows",)), p.namespaces, device="cpu")
    try:
        qs = _queries(objs, users)
        oracle = CheckEngine(p)
        assert eng.batch_check(qs) == [oracle.subject_is_allowed(q) for q in qs]
        assert eng.counters().get("refresh_read_retries") == 2
        assert eng.build_info["path"] in ("rows", "python")
    finally:
        eng.close()


class FlakyScanStore:
    """A chunk-preferring store whose first scan dies mid-cursor with
    ``exc``."""

    scan_chunks_preferred = True

    def __init__(self, inner, exc=ConnectionError):
        self._inner = inner
        self._exc = exc
        self.scan_calls = 0

    def watermark(self):
        return self._inner.watermark()

    def snapshot_scan(self, on_chunk, chunk_rows=262144):
        self.scan_calls += 1
        if self.scan_calls == 1:
            rows, _ = self._inner.snapshot_rows()
            on_chunk(rows[: len(rows) // 2])
            raise self._exc("server closed the connection")
        return self._inner.snapshot_scan(on_chunk, chunk_rows=chunk_rows)

    def changes_since(self, wm):
        return self._inner.changes_since(wm)


def test_mid_scan_failure_retries_through_the_engine_read():
    rows, objs, users = rows_of(3)
    p = port_store(NS, rows)
    legacy = build_snapshot(*p.snapshot_rows())
    flaky = FlakyScanStore(p)
    eng = TorchCheckEngine(flaky, p.namespaces, device="cpu", labels_enabled=False)
    try:
        streamed = stream_build.full_build(flaky, chunk_rows=16, read_retry=eng._read_store)
        assert flaky.scan_calls == 2 and eng.counters().get("refresh_read_retries") == 1
        for k in ("raw2dev", "fwd_indptr", "fwd_indices", "sink_indptr", "sink_indices"):
            assert np.array_equal(getattr(streamed, k), getattr(legacy, k)), k
        for a, b in zip(streamed.buckets, legacy.buckets, strict=True):
            assert (a.offset, a.n) == (b.offset, b.n) and np.array_equal(a.nbrs, b.nbrs)
    finally:
        eng.close()


def test_a_store_failing_past_the_budget_fails_the_refresh():
    rows, objs, users = rows_of(4)
    p = port_store(NS, rows)
    fp = Flaky(p, 0, ("changes_since",))
    eng = TorchCheckEngine(fp, p.namespaces, device="cpu", labels_enabled=False,
                           refresh_retry_max_wait_s=0.2)
    try:
        eng.snapshot()
        p.write_relation_tuples(T("g", "o1", "m", SubjectID("late")))
        fp._left["changes_since"] = 10**6
        with pytest.raises(ConnectionError):
            eng.batch_check([T("g", "o1", "m", SubjectID("late"))])
        c = eng.counters()
        assert 1 <= c.get("refresh_read_retries", 0) < fp.calls["changes_since"] + 1
        # the store recovers: the next check catches up
        fp._left["changes_since"] = 0
        assert eng.batch_check([T("g", "o1", "m", SubjectID("late"))]) == [True]
    finally:
        eng.close()


@pytest.mark.parametrize("exc", [torch.cuda.OutOfMemoryError,
                                 lambda m: RuntimeError("CUDA error: " + m)])
def test_a_device_error_is_never_retried(exc):
    rows, _, _ = rows_of(5)
    p = port_store(NS, rows)
    fp = Flaky(p, 0, ("changes_since",), exc=exc)
    eng = TorchCheckEngine(fp, p.namespaces, device="cpu", labels_enabled=False)
    try:
        eng.snapshot()
        p.write_relation_tuples(T("g", "o1", "m", SubjectID("late")))
        fp._left["changes_since"] = 5
        with pytest.raises((torch.cuda.OutOfMemoryError, RuntimeError)):
            eng.snapshot()
        assert fp.calls["changes_since"] == 1
        assert eng.counters().get("refresh_read_retries", 0) == 0
    finally:
        eng.close()


@pytest.mark.parametrize("read", ["changes_since", "snapshot_rows"])
@pytest.mark.parametrize("exc", [TypeError, ValueError, KeyError, MemoryError])
def test_an_error_that_is_not_the_stores_is_never_retried(read, exc):
    """Only the store's own errors retry: a fault of the port's own code
    in a delta read or a full build's read raises at once, uncounted."""
    rows, _, _ = rows_of(6)
    p = port_store(NS, rows)
    fp = Flaky(p, 0, (read,), exc=exc)
    eng = TorchCheckEngine(fp, p.namespaces, device="cpu", labels_enabled=False)
    try:
        if read == "changes_since":
            eng.snapshot()
            p.write_relation_tuples(T("g", "o1", "m", SubjectID("late")))
        fp._left[read] = 5
        with pytest.raises(exc):
            eng.snapshot()
        assert fp.calls[read] == 1
        assert eng.counters().get("refresh_read_retries", 0) == 0
    finally:
        eng.close()


@pytest.mark.parametrize("exc", [RuntimeError, TypeError])
def test_an_error_inside_the_scan_is_never_retried(exc):
    """An error raised inside the streaming scan that is not the store's
    (the interner's, say) fails the build at once."""
    rows, _, _ = rows_of(7)
    p = port_store(NS, rows)
    flaky = FlakyScanStore(p, exc=exc)
    eng = TorchCheckEngine(flaky, p.namespaces, device="cpu", labels_enabled=False)
    try:
        with pytest.raises(exc):
            stream_build.full_build(flaky, chunk_rows=16, read_retry=eng._read_store)
        assert flaky.scan_calls == 1
        assert eng.counters().get("refresh_read_retries", 0) == 0
    finally:
        eng.close()
