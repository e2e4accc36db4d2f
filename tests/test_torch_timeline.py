"""The port's request timelines (keto_tpu_torch/x/timeline.py) against the
reference's (keto_tpu/x/timeline.py): the recorder's ring and top-K bounds,
the stamp cap, the filters, ``Server-Timing`` with repeated stages summed,
the disabled recorder and the context binding (ports of
tests/test_timeline.py:31-103); then both recorders fed the same stamps at
the same clock give equal ``Server-Timing`` strings and equal snapshots."""

from __future__ import annotations

import random
import re

import pytest

from keto_tpu_torch.x.timeline import (
    MAX_STAMPS,
    STAGES,
    Timeline,
    TimelineRecorder,
    current_timeline,
)

SERVER_TIMING_ENTRY = re.compile(r"^[a-z_]+;dur=\d+(\.\d+)?$")


def test_recorder_ring_and_topk_bounds():
    rec = TimelineRecorder(capacity=16, top_k=4)
    for i in range(50):
        tl = rec.begin("GET /check", request_id=f"r{i}")
        tl.stamp("admit")
        if i == 7:  # the slowest, by an arrival faked 10 s earlier
            tl._t0 -= 10.0
        rec.finish(tl, status=200)
    snap = rec.snapshot(recent=100, slowest=100)
    assert len(snap["recent"]) == 16
    assert len(snap["slowest"]) == 4
    # the slow request survives in the top-K after the ring rotated past it
    assert snap["slowest"][0]["request_id"] == "r7"
    assert snap["slowest"][0]["total_ms"] > 9000
    assert snap["finished"] == {"http": 50}


def test_stamp_cap_marks_truncation():
    tl = Timeline("GET /check")
    for i in range(MAX_STAMPS + 10):
        tl.stamp("device", width=i)
    assert len(tl.stamps) == MAX_STAMPS
    assert tl.truncated


def test_snapshot_filters_by_trace_snaptoken_and_tenant():
    rec = TimelineRecorder()
    a = rec.begin("GET /check", trace_id="a" * 32, tenant="default")
    rec.finish(a, status=200, snaptoken=5)
    b = rec.begin("GET /check", trace_id="b" * 32, tenant="other")
    rec.finish(b, status=200, snaptoken=9)
    assert [t["trace_id"] for t in rec.snapshot(trace_id="a" * 32)["recent"]] == ["a" * 32]
    assert [t["snaptoken"] for t in rec.snapshot(snaptoken="9")["recent"]] == ["9"]
    assert [t["tenant"] for t in rec.snapshot(tenant="other")["recent"]] == ["other"]


def test_server_timing_aggregates_repeated_stages():
    rec = TimelineRecorder()
    tl = rec.begin("POST /check/batch")
    tl.stamp("pack")
    tl.stamp("device", width=32)
    tl.stamp("device", width=32)
    rec.finish(tl, status=200)
    parts = [p.strip() for p in rec.server_timing(tl).split(",")]
    assert all(SERVER_TIMING_ENTRY.match(p) for p in parts), parts
    assert sum(p.startswith("device;") for p in parts) == 1
    assert parts[-1].startswith("total;dur=")


def test_disabled_recorder_is_inert():
    rec = TimelineRecorder(enabled=False)
    assert rec.begin("GET /check") is None
    with rec.activate(None):
        assert current_timeline() is None
    rec.finish(None, status=200)
    snap = rec.snapshot()
    assert snap["enabled"] is False and snap["recent"] == []


def test_activate_binds_context():
    rec = TimelineRecorder()
    tl = rec.begin("GET /check")
    assert current_timeline() is None
    with rec.activate(tl):
        assert current_timeline() is tl
    assert current_timeline() is None


def test_stages_and_cap_equal_the_reference():
    from keto_tpu.x import timeline as ref

    assert STAGES == ref.STAGES and MAX_STAMPS == ref.MAX_STAMPS


class _Clock:
    """One perf_counter for both modules, advanced by the test."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(6))
def test_both_recorders_render_and_filter_the_same_stamps(monkeypatch, seed):
    """The same requests, stamps and clock through both recorders: equal
    ``Server-Timing`` per request and equal ``snapshot()`` bodies under
    every filter (start times aside, which read the wall clock)."""
    import keto_tpu.x.timeline as ref_mod
    import keto_tpu_torch.x.timeline as port_mod

    clock = _Clock()
    for mod in (ref_mod, port_mod):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
    rng = random.Random(seed)
    port = port_mod.TimelineRecorder(capacity=16, top_k=4)
    ref = ref_mod.TimelineRecorder(capacity=16, top_k=4)
    stages = [s for s in STAGES if s not in ("arrival", "deliver")]
    timings = []
    for i in range(40):
        trace = rng.choice(["", "a" * 32, "b" * 32])
        tenant = rng.choice(["default", "t1"])
        tls = [rec.begin(f"GET /check{i % 3}", trace_id=trace, request_id=f"r{i}",
                         tenant=tenant) for rec in (port, ref)]
        for _ in range(rng.randrange(0, 60)):
            clock.t += rng.random() / 100
            stage = rng.choice(stages)
            attrs = {"width": rng.randrange(1, 4096), "route": "bfs"} if stage == "device" else {}
            for tl in tls:
                tl.stamp(stage, **attrs)
        clock.t += rng.random() / 100
        token = rng.choice([None, 3, 7])
        for rec, tl in zip((port, ref), tls):
            rec.finish(tl, status=rng.choice([200]), snaptoken=token)
        timings.append((port.server_timing(tls[0]), ref.server_timing(tls[1])))
    assert all(a == b for a, b in timings)

    def strip(snap):
        for key in ("recent", "slowest"):
            for t in snap[key]:
                t.pop("start_unix")
        return snap

    for kw in ({}, {"trace_id": "a" * 32}, {"snaptoken": "7"}, {"tenant": "t1"},
               {"recent": 5, "slowest": 2}, {"trace_id": "b" * 32, "tenant": "default"}):
        assert strip(port.snapshot(**kw)) == strip(ref.snapshot(**kw)), kw
