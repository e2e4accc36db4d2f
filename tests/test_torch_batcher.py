"""The port's full check batcher (keto_tpu_torch/driver/batch.py) against
the reference's (keto_tpu/driver/batch.py).

- ``_take_locked`` of both batchers on the same queued items gives the same
  ``(item, start, count)`` segments and leaves the same lanes, over 200
  seeded queue states: mixed lanes, partial chunks, done futures, batch
  sizes, sub-slices, reserves and a planned slice width (``stream_ctrl.cap``).
- Ports of tests/test_overload.py:78-175 on a gated stream engine:
  interactive work rides ahead of a queued batch, a monster chunk across
  sub-slices, lane classification, a deadline that expires while blocked
  on a full queue (504, not a shed).
- Sheds: a full lane in serving mode and the admission window answer
  ``ErrTooManyRequests`` with ``retry_after_s`` (equal to the reference's
  on the same state), and a batch wider than the window sheds even into an
  empty lane in both.
- ``drain``/``inflight``, ``stop`` failing queued and in-round futures, a
  failed round failing every rider, a deadline shed at dispatch, and the
  stamps on a request's timeline.
- The port's batcher over ``TorchCheckEngine(device="cpu")`` and the
  reference's over ``TpuCheckEngine`` (JAX on the CPU) on the same store
  and 2,000 mixed-lane checks give equal decisions.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

from keto_tpu_torch.check.engine import CheckEngine
from keto_tpu_torch.driver.admission import AdmissionController
from keto_tpu_torch.driver.batch import BATCH, INTERACTIVE, LANES, CheckBatcher
from keto_tpu_torch.relationtuple.model import RelationTuple, SubjectID
from keto_tpu_torch.x.errors import ErrDeadlineExceeded, ErrTooManyRequests
from keto_tpu_torch.x.timeline import TimelineRecorder

from test_torch_stream import NS, engine_on, mixed_depth, to_jax
from test_torch_snapshot import jax_store


def T(obj, user="u"):
    return RelationTuple(namespace="acl", object=obj, relation="access", subject=SubjectID(user))


def wait_for(cond, timeout=10.0, interval=0.01, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


class GateEngine:
    """A stream engine that records every round's tuples; its first round
    blocks until released, so tests can stage work behind it. Allowed iff
    the object name ends in an even number."""

    STREAM_INFO = True

    def __init__(self, block_first=True, cap=1 << 20, fail=None):
        self.calls = []
        self.release = threading.Event()
        self._block_first = block_first
        self._first = True
        self._fail = fail
        self.stream_ctrl = SimpleNamespace(cap=lambda: cap)

    def batch_check_stream_with_token(self, tuples_iter, *, ordered=True, with_info=False, **kw):
        assert not ordered and with_info
        tuples = list(tuples_iter)
        self.calls.append(tuples)
        if self._block_first and self._first:
            self._first = False
            assert self.release.wait(10), "gate never released"
        if self._fail is not None:
            raise self._fail

        def gen():
            if tuples:
                out = np.array([int(t.object.rsplit("-", 1)[1]) % 2 == 0 for t in tuples])
                # two slices, so a request's decisions land in pieces
                half = max(1, len(tuples) // 2)
                for off in range(0, len(tuples), half):
                    yield off, out[off:off + half], {"width": len(out[off:off + half]),
                                                     "bfs_steps": 1, "route": "bfs",
                                                     "service_ms": 0.5}
        return gen(), 7


def quiet(fn):
    """A background caller whose request may be failed by ``stop``."""
    def go():
        try:
            fn()
        except RuntimeError:
            pass
    return go


def even(tuples):
    return [int(t.object.rsplit("-", 1)[1]) % 2 == 0 for t in tuples]


# -- _take_locked against the reference -----------------------------------------------


def _queue_state(rng):
    cfg = dict(
        batch_size=rng.choice([4, 8, 16, 64, 4096]),
        batch_sub_slice=rng.choice([None, 1, 3, 7, 1024]),
        batch_reserve_share=rng.choice([0.0, 0.125, 0.5]),
    )
    cap = rng.choice([1, 2, 5, 32, 1 << 20])
    items = []
    for _ in range(rng.randrange(0, 12)):
        lane = rng.choice(LANES)
        n = rng.randrange(1, 17) if lane == INTERACTIVE and rng.random() < 0.8 \
            else rng.randrange(1, 3000)
        taken = rng.randrange(0, n) if lane == BATCH and rng.random() < 0.3 else 0
        items.append((lane, n, taken, rng.random() < 0.15))
    return cfg, cap, items


def _load(batcher, items):
    loaded = []
    for lane, n, taken, done in items:
        it_cls = type(batcher)._take_locked.__globals__["_Item"]
        item = it_cls([T(f"o-{k}") for k in range(n)], Future(), None, False, None, lane)
        item.taken = taken
        if done:
            item.fut.set_result(None)
        batcher._lanes[lane].append(item)
        batcher._lane_tuples[lane] += n - taken
        loaded.append(item)
    return loaded


@pytest.mark.parametrize("seed", range(200))
def test_take_locked_equals_the_reference(seed):
    from keto_tpu.driver.batch import CheckBatcher as RefBatcher

    rng = random.Random(seed)
    cfg, cap, items = _queue_state(rng)
    engine = SimpleNamespace(stream_ctrl=SimpleNamespace(cap=lambda: cap))
    mine, ref = CheckBatcher(engine, **cfg), RefBatcher(engine, **cfg)
    pair = [_load(mine, items), _load(ref, items)]
    for _round in range(6):
        got = []
        for b, loaded in zip((mine, ref), pair):
            with b._cond:
                segs = b._take_locked()
            index = {id(it): k for k, it in enumerate(loaded)}
            got.append(([(index[id(it)], start, count) for it, start, count in segs],
                        dict(b._lane_tuples),
                        [it.taken for it in loaded],
                        {lane: [index[id(it)] for it in b._lanes[lane]] for lane in LANES}))
        assert got[0] == got[1], (seed, _round)


# -- lanes (tests/test_overload.py:78-175) ---------------------------------------------


def test_interactive_packs_ahead_of_queued_batch():
    eng = GateEngine()
    b = CheckBatcher(eng, batch_size=8, window_ms=2.0, batch_sub_slice=4)
    b.start()
    try:
        chunk = [T(f"c-{i}") for i in range(12)]
        batch_res = {}
        bt = threading.Thread(
            target=lambda: batch_res.update(r=b.check_batch(chunk, timeout=30, lane=BATCH)),
            daemon=True)
        bt.start()
        wait_for(lambda: len(eng.calls) == 1, msg="first round dispatched")
        inter_res = {}
        it = threading.Thread(target=lambda: inter_res.update(r=b.check(T("i-2"), timeout=30)),
                              daemon=True)
        it.start()
        wait_for(lambda: b.lane_depths[INTERACTIVE] == 1, msg="interactive queued")
        eng.release.set()
        it.join(timeout=10)
        bt.join(timeout=10)
        assert inter_res["r"] is True
        assert batch_res["r"] == even(chunk)
        # round 1: the chunk's first sub-slice only; round 2: the
        # interactive tuple first, the batch take within one sub-slice
        assert [t.object for t in eng.calls[0]] == ["c-0", "c-1", "c-2", "c-3"]
        assert eng.calls[1][0].object == "i-2"
        for call in eng.calls:
            assert sum(1 for t in call if t.object.startswith("c-")) <= 4
    finally:
        b.stop()


def test_monster_chunk_resolves_across_sub_slices():
    eng = GateEngine(block_first=False)
    b = CheckBatcher(eng, batch_size=8, window_ms=0.5, batch_sub_slice=3,
                     interactive_max_tuples=4)
    b.start()
    try:
        chunk = [T(f"m-{i}") for i in range(10)]
        got, token = b.check_batch_with_token(chunk, timeout=30)
        assert got == even(chunk) and token == 7
        assert len(eng.calls) >= 4 and all(len(c) <= 3 for c in eng.calls)
    finally:
        b.stop()


def test_batch_round_is_bounded_by_the_planned_width():
    eng = GateEngine(block_first=False, cap=2)
    b = CheckBatcher(eng, batch_size=64, window_ms=0.5, batch_sub_slice=16)
    b.start()
    try:
        chunk = [T(f"w-{i}") for i in range(9)]
        assert b.check_batch(chunk, timeout=30, lane=BATCH) == even(chunk)
        assert len(eng.calls) == 5 and all(len(c) <= 2 for c in eng.calls)
    finally:
        b.stop()


def test_lane_classification_by_size_and_hint():
    b = CheckBatcher(GateEngine(block_first=False), interactive_max_tuples=4)
    assert b.classify_lane(1, None) == INTERACTIVE
    assert b.classify_lane(4, None) == INTERACTIVE
    assert b.classify_lane(5, None) == BATCH
    assert b.classify_lane(1, "batch") == BATCH
    assert b.classify_lane(5000, "interactive") == INTERACTIVE
    with pytest.raises(ValueError):
        b.check_batch([T("x-1")], lane="urgent")


def test_deadline_expiring_while_blocked_on_full_queue_is_504():
    eng = GateEngine()
    b = CheckBatcher(eng, batch_size=1, window_ms=0.0, max_pending=1)
    b.start()
    try:
        threading.Thread(target=quiet(lambda: b.check(T("c-0"), timeout=30)),
                         daemon=True).start()
        wait_for(lambda: len(eng.calls) == 1, msg="collector blocked in the engine")
        threading.Thread(target=quiet(lambda: b.check(T("c-2"), timeout=30)),
                         daemon=True).start()
        wait_for(lambda: b.lane_depths[INTERACTIVE] >= 1, msg="lane full")
        t0 = time.monotonic()
        with pytest.raises(ErrDeadlineExceeded):
            b.check(T("c-4"), timeout=0.3)
        assert 0.2 <= time.monotonic() - t0 < 5
        assert b.shed_count == 0, "the race must not be misreported as a shed"
    finally:
        eng.release.set()
        b.stop()


def test_expired_request_is_shed_before_it_takes_a_slot():
    """A request whose deadline passes while queued never reaches the
    engine: the stream drops it as it pulls the round (``_expire``)."""
    eng = GateEngine()
    b = CheckBatcher(eng, batch_size=8, window_ms=0.0)
    b.start()
    try:
        threading.Thread(target=quiet(lambda: b.check(T("c-0"), timeout=30)),
                         daemon=True).start()
        wait_for(lambda: len(eng.calls) == 1, msg="collector blocked in the engine")
        errs = []

        def late():
            try:
                b.check(T("late-2"), deadline=time.monotonic() + 0.05)
            except ErrDeadlineExceeded as e:
                errs.append(e)

        t = threading.Thread(target=late, daemon=True)
        t.start()
        wait_for(lambda: b.lane_depths[INTERACTIVE] == 1, msg="queued")
        t.join(timeout=5)
        assert len(errs) == 1
        time.sleep(0.1)
        eng.release.set()
        assert b.check(T("after-4"), timeout=10) is True
        assert all(t.object != "late-2" for call in eng.calls for t in call)
        assert b.deadline_drop_count == 1
    finally:
        eng.release.set()
        b.stop()


# -- sheds ---------------------------------------------------------------------------


def test_full_lane_sheds_with_retry_after_in_serving_mode():
    from keto_tpu.driver.batch import CheckBatcher as RefBatcher
    from keto_tpu.relationtuple.model import RelationTuple as JT
    from keto_tpu.x.errors import ErrTooManyRequests as RefTooMany

    errs = []
    for cls, tup, exc in ((CheckBatcher, T, ErrTooManyRequests),
                          (RefBatcher, lambda o: JT.from_string(f"acl:{o}#access@u"), RefTooMany)):
        eng = GateEngine()
        # the collector is not started: the door judges the queued backlog
        b = cls(eng, batch_size=4, max_pending=4, shed_on_full=True)
        threading.Thread(target=quiet(lambda: b.check_batch([tup(f"q-{i}") for i in range(3)],
                                                            timeout=30, lane=BATCH)),
                         daemon=True).start()
        wait_for(lambda: b.lane_depths[BATCH] == 3, msg="batch queued")
        with pytest.raises(exc) as e:
            b.check_batch([tup(f"r-{i}") for i in range(2)], timeout=5, lane=BATCH)
        errs.append((e.value.status_code, e.value.retry_after_s, b.shed_count,
                     dict(b.shed_by_lane), b.admission_shed_count))
        b.stop()
    assert errs[0] == errs[1] == (429, 1.0, 1, {INTERACTIVE: 0, BATCH: 1}, 0)


def test_admission_sheds_batch_lane_only_and_advises_its_backoff():
    ctrl = AdmissionController(min_window=8, max_window=8)  # a pinned window
    eng = GateEngine(block_first=False)
    b = CheckBatcher(eng, batch_size=8, window_ms=0.5, admission=ctrl)
    b.start()
    try:
        with pytest.raises(ErrTooManyRequests) as exc:
            b.check_batch([T(f"c-{i}") for i in range(9)], timeout=5, lane=BATCH)
        assert exc.value.retry_after_s == ctrl.retry_after_s() == 1.0
        assert b.admission_shed_count == 1 and b.shed_by_lane[BATCH] == 1
        assert b.check(T("i-0"), timeout=5) is True  # interactive: never admission-limited
        assert b.check_batch([T(f"c-{i}") for i in range(8)], timeout=5, lane=BATCH) == \
            even([T(f"c-{i}") for i in range(8)])
    finally:
        b.stop()


def test_batch_wider_than_the_window_sheds_into_an_empty_lane_as_the_reference():
    """The serving wiring's window tops out at ``max_pending``: a batch
    wider than it is refused even with nothing queued, by both batchers."""
    from keto_tpu.driver.admission import AdmissionController as RefController
    from keto_tpu.driver.batch import CheckBatcher as RefBatcher
    from keto_tpu.relationtuple.model import RelationTuple as JT

    out = []
    for cls, ctl, tup in ((CheckBatcher, AdmissionController, T),
                          (RefBatcher, RefController,
                           lambda o: JT.from_string(f"acl:{o}#access@u"))):
        b = cls(GateEngine(block_first=False), batch_size=4, max_pending=32, shed_on_full=True,
                admission=ctl(max_window=32, min_window=4))
        b.start()
        try:
            res = []
            for n in (33, 32):
                try:
                    res.append(len(b.check_batch([tup(f"w-{i}") for i in range(n)], timeout=10)))
                except Exception as e:  # noqa: BLE001 - compared across the two
                    res.append((type(e).__name__, e.status_code, e.retry_after_s))
            out.append((res, b.admission_shed_count))
        finally:
            b.stop()
    assert out[0] == out[1] == ([("ErrTooManyRequests", 429, 1.0), 32], 1)


def test_admission_precheck_refuses_before_parse():
    ctrl = AdmissionController(min_window=4, max_window=4)
    eng = GateEngine()
    b = CheckBatcher(eng, batch_size=2, window_ms=0.0, admission=ctrl)  # not started
    try:
        b.admission_precheck()  # an empty lane admits
        b.admission_precheck(INTERACTIVE)

        def bg():
            try:
                b.check_batch([T(f"c-{i}") for i in range(4)], timeout=30, lane=BATCH)
            except RuntimeError:
                pass  # stopped at teardown

        threading.Thread(target=bg, daemon=True).start()
        wait_for(lambda: b.lane_depths[BATCH] >= 4, msg="batch backlog")
        with pytest.raises(ErrTooManyRequests):
            b.admission_precheck()
        b.admission_precheck(INTERACTIVE)  # the interactive lane is never refused
        assert b.admission_shed_count == 1
    finally:
        eng.release.set()
        b.stop()


# -- drain, stop, failures, timelines ---------------------------------------------------


def test_drain_waits_for_inflight_requests():
    eng = GateEngine()
    b = CheckBatcher(eng, batch_size=8, window_ms=0.0)
    b.start()
    try:
        assert b.inflight == 0 and b.drain(0.01)
        res = {}
        t = threading.Thread(target=lambda: res.update(r=b.check(T("d-2"), timeout=30)),
                             daemon=True)
        t.start()
        wait_for(lambda: len(eng.calls) == 1, msg="in flight")
        assert b.inflight == 1 and not b.drain(0.05)
        eng.release.set()
        assert b.drain(10) and b.inflight == 0
        t.join(timeout=5)
        assert res["r"] is True
    finally:
        b.stop()


def test_stop_fails_queued_and_in_round_futures():
    eng = GateEngine()
    b = CheckBatcher(eng, batch_size=1, window_ms=0.0)
    b.start()
    errs = []

    def call(obj):
        try:
            b.check(T(obj), timeout=30)
        except RuntimeError as e:
            errs.append((obj, str(e)))

    threads = [threading.Thread(target=call, args=("r-0",), daemon=True)]
    threads[0].start()
    wait_for(lambda: len(eng.calls) == 1, msg="round in flight")
    threads.append(threading.Thread(target=call, args=("q-2",), daemon=True))
    threads[1].start()
    wait_for(lambda: b.lane_depths[INTERACTIVE] == 1, msg="queued")
    t0 = time.monotonic()
    stopper = threading.Thread(target=b.stop, daemon=True)
    stopper.start()
    for t in threads:
        t.join(timeout=15)
    eng.release.set()
    stopper.join(timeout=15)
    assert time.monotonic() - t0 < 10
    assert sorted(errs) == [("q-2", "check batcher stopped"), ("r-0", "check batcher stopped")]
    with pytest.raises(RuntimeError):
        b.check(T("x-0"))


def test_a_failed_round_fails_every_rider():
    eng = GateEngine(block_first=False, fail=RuntimeError("injected"))
    b = CheckBatcher(eng, batch_size=64, window_ms=30.0)
    b.start()
    try:
        errors = []

        def worker(obj):
            try:
                b.check(T(obj), timeout=30)
            except RuntimeError as e:
                errors.append(str(e))

        threads = [threading.Thread(target=worker, args=(f"f-{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        with pytest.raises(RuntimeError, match="injected"):
            b.check_batch([T(f"b-{i}") for i in range(40)], timeout=30)
        assert errors == ["injected"] * 4
        assert b.drain(5) and b.inflight == 0
    finally:
        b.stop()


def test_timeline_stamps_of_a_request():
    """The caller's timeline, bound on its own thread, is stamped admit,
    pack, dispatch, one device stamp a slice it rode, and land."""
    rec = TimelineRecorder()
    b = CheckBatcher(GateEngine(block_first=False), batch_size=64, window_ms=0.0,
                     batch_sub_slice=4)
    b.start()
    try:
        tl = rec.begin("POST /check/batch")
        with rec.activate(tl):
            assert b.check_batch([T(f"t-{i}") for i in range(6)], timeout=10, lane=BATCH) == \
                even([T(f"t-{i}") for i in range(6)])
        stages = [s for s, _, _ in tl.stamps]
        # two rounds (4 + 2 tuples), each landing as two slices
        assert stages == ["arrival", "admit", "pack", "dispatch", "device", "device",
                          "dispatch", "device", "device", "land"], stages
        devices = [a for s, _, a in tl.stamps if s == "device"]
        assert [d["width"] for d in devices] == [2, 2, 1, 1]
        assert all(d["route"] == "bfs" for d in devices)
    finally:
        b.stop()


# -- decisions against the reference engine and batcher ---------------------------------


def test_batched_decisions_equal_the_reference_batcher():
    """The port's batcher over ``TorchCheckEngine(device="cpu")`` and the
    reference's over ``TpuCheckEngine`` on JAX-CPU: the same store, 2,000
    checks from 16 callers in both lanes (singles, small and wide batches,
    pinned and classified), equal decisions, equal to the oracle."""
    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu.driver.batch import CheckBatcher as RefBatcher

    rows, queries = mixed_depth(seed=21, n_queries=2000, cycles=True)
    p, engine = engine_on(rows)
    jp = jax_store(NS, rows)
    ref_engine = TpuCheckEngine(jp, jp.namespaces)
    ref_engine.labels_settled()
    rng = random.Random(21)
    plan, i = [], 0
    while i < len(queries):
        n = rng.choice([1, 1, 1, 5, 16, 40, 300])
        plan.append((i, min(i + n, len(queries)), rng.choice([None, INTERACTIVE, BATCH])))
        i += n
    results = []
    for b, conv in ((CheckBatcher(engine, batch_size=256, window_ms=1.0, batch_sub_slice=64),
                     lambda q: q),
                    (RefBatcher(ref_engine, batch_size=256, window_ms=1.0, batch_sub_slice=64),
                     to_jax)):
        b.start()
        got = [None] * len(queries)
        try:
            def worker(k):
                for a, z, lane in plan[k::16]:
                    qs = [conv(q) for q in queries[a:z]]
                    if z - a == 1 and lane != BATCH:
                        got[a] = b.check(qs[0], timeout=120)
                    else:
                        got[a:z] = b.check_batch(qs, timeout=120, lane=lane)

            threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
        finally:
            b.stop()
        results.append(got)
    try:
        oracle = CheckEngine(p)
        assert results[0] == results[1]
        assert results[0] == [oracle.subject_is_allowed(q) for q in queries]
    finally:
        engine.close()
        ref_engine.close()
