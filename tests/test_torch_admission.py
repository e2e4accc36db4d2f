"""The port's admission controller (keto_tpu_torch/driver/admission.py)
against the reference's (keto_tpu/driver/admission.py): both get the same
sequences of ``tick``, ``observe_round`` and slice service times at the
same injected clock, and must agree on ``window``, ``decreases``,
``increases``, ``retry_after_s()``, ``overloaded`` and ``snapshot()`` after
every step — the slice-p99 signal, the queue-delay signal, the stalled
device (a deep backlog and nothing landing), the rate limit on ticks and
the window's floor and ceiling. Then the AIMD scenarios of
tests/test_overload.py:189-226, run on the port."""

from __future__ import annotations

import random

import pytest

from keto_tpu_torch.driver.admission import AdmissionController
from keto_tpu_torch.x.telemetry import DurationStats


class FakeStats:
    def __init__(self):
        self._vals = []

    def feed(self, *ms):
        self._vals.extend(ms)

    def tail(self, n):
        if n <= 0:
            return [], len(self._vals)
        return self._vals[-n:], len(self._vals)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _state(c):
    return (c.window, c.decreases, c.increases, c.retry_after_s(), c.overloaded, c.snapshot())


@pytest.mark.parametrize("seed", range(12))
def test_port_equals_reference_at_every_step(seed):
    from keto_tpu.driver.admission import AdmissionController as RefController

    rng = random.Random(seed)
    kw = dict(
        target_ms=rng.choice([5.0, 10.0, 40.0]),
        budget_ms=rng.choice([None, 0.0, 25.0, 200.0]),
        min_window=rng.choice([1, 16, 64]),
        max_window=rng.choice([256, 1024, 32768]),
        decrease=rng.choice([0.5, 0.7]),
        increase=rng.choice([None, 8, 100]),
        interval_s=rng.choice([0.0, 0.25]),
    )
    stats = [FakeStats(), FakeStats()]
    clocks = [Clock(), Clock()]
    with_stats = seed % 4 != 3  # None: the queue-delay signal alone
    port = AdmissionController(stats=stats[0] if with_stats else None, time_fn=clocks[0], **kw)
    ref = RefController(stats=stats[1] if with_stats else None, time_fn=clocks[1], **kw)
    assert _state(port) == _state(ref)
    for step in range(300):
        op = rng.random()
        if op < 0.3:
            ms = [rng.choice([rng.uniform(0.1, 20.0), rng.uniform(50.0, 900.0)])
                  for _ in range(rng.randrange(0, 6))]
            for s in stats:
                s.feed(*ms)
        elif op < 0.5:
            n, wall = rng.randrange(0, 5000), rng.choice([0.0, rng.uniform(0.0005, 0.2)])
            port.observe_round(n, wall)
            ref.observe_round(n, wall)
        elif op < 0.6:
            dt = rng.choice([0.0, 0.1, 0.3, 1.0])
            for c in clocks:
                c.t += dt
        else:
            # a deep backlog past the window with nothing landing is the
            # stalled-device rule; explicit ``now`` and the clock both
            backlog = rng.choice([0, 10, rng.randrange(0, 3 * kw["max_window"])])
            if rng.random() < 0.2:
                now = clocks[0].t + rng.uniform(0.0, 2.0)
                port.tick(backlog=backlog, now=now)
                ref.tick(backlog=backlog, now=now)
            else:
                port.tick(backlog=backlog)
                ref.tick(backlog=backlog)
        assert _state(port) == _state(ref), (seed, step)


def test_stalled_device_shrinks_the_window_as_the_reference():
    """No slice lands and no round was observed, the backlog passes the
    window: both treat the silence as overload, step for step."""
    from keto_tpu.driver.admission import AdmissionController as RefController

    port = AdmissionController(stats=FakeStats(), min_window=8, max_window=256, interval_s=0.0)
    ref = RefController(stats=FakeStats(), min_window=8, max_window=256, interval_s=0.0)
    seen = []
    for backlog in (300, 300, 200, 100, 5, 5):
        port.tick(backlog=backlog)
        ref.tick(backlog=backlog)
        assert _state(port) == _state(ref)
        seen.append(port.window)
    assert seen == [128, 64, 32, 16, 32, 48]  # then +16 a healthy tick
    assert port.retry_after_s() == 1.0


def test_admission_aimd_shrinks_and_recovers():
    stats = FakeStats()
    ctrl = AdmissionController(stats=stats, target_ms=10.0, min_window=16, max_window=1024,
                               interval_s=0.0)
    assert ctrl.window == 1024 and ctrl.retry_after_s() == 1.0
    stats.feed(100.0, 120.0, 90.0)  # p99 over the 40 ms budget
    ctrl.tick()
    assert ctrl.window == 512
    stats.feed(200.0)
    ctrl.tick()
    stats.feed(200.0)
    ctrl.tick()
    assert ctrl.window == 128 and ctrl.retry_after_s() == 8.0 and ctrl.overloaded
    for _ in range(8):
        stats.feed(2.0)
        ctrl.tick()
    assert 128 < ctrl.window <= 1024 and ctrl.retry_after_s() == 1.0 and not ctrl.overloaded
    for _ in range(20):
        stats.feed(500.0)
        ctrl.tick()
    assert ctrl.window == 16


def test_admission_judges_queue_delay_without_slow_slices():
    stats = FakeStats()
    ctrl = AdmissionController(stats=stats, target_ms=10.0, min_window=16, max_window=1024,
                               interval_s=0.0)
    ctrl.observe_round(1000, 0.01)  # 100k tuples/s
    stats.feed(5.0)
    ctrl.tick(backlog=8000)  # 80 ms of queue > the 40 ms budget
    assert ctrl.window == 512
    snap = ctrl.snapshot()
    assert snap["last_queue_delay_ms"] == pytest.approx(80.0) and snap["overloaded"]


def test_tail_reads_what_landed_since_the_last_count():
    """``DurationStats.tail`` (the controller's reader) equals the
    reference's on the same observations."""
    from keto_tpu.x.telemetry import DurationStats as RefStats

    mine, ref = DurationStats(capacity=8), RefStats(capacity=8)
    rng = random.Random(3)
    for i in range(30):
        ms = rng.uniform(0.0, 50.0)
        mine.observe(ms)
        ref.observe(ms)
        for n in (0, 1, 5, 8, 20):
            assert mine.tail(n) == ref.tail(n), (i, n)
