"""The engine's ``MaintenanceStats`` (keto_tpu_torch/x/telemetry.py) against
the reference's on the CPU.

The port's ``TorchCheckEngine(device="cpu")`` and the reference's
``TpuCheckEngine`` get the same store, writes, folds and checks (the
scenarios of tests/test_torch_write_path.py), and both settle their label
builds and refresh passes. Then ``maintenance.raw()`` must agree:

- the counters' keys and values are equal, past the keys only the port
  counts (``PORT_ONLY``, pinned below with the reason of each);
- the durations' keys and counts are equal (times are not compared);
- the gauges' keys are equal and their values too (``label_coverage``,
  ``label_entries``, ``overlay_edges``, ``overlay_budget``, the governor's
  budget and rung), except ``hbm_resident_bytes``: the two engines lay
  their device arrays out differently.

Plus the sink itself and ``BuildProgress`` against the reference's on the
same calls. Every comparison is exact (tolerance 0)."""

from __future__ import annotations

import pytest

from keto_tpu.graph.stream_build import BuildProgress as RefProgress
from keto_tpu.x.telemetry import DurationStats as RefDuration
from keto_tpu.x.telemetry import MaintenanceStats as RefStats
from keto_tpu_torch.graph.stream_build import PHASES, BuildProgress
from keto_tpu_torch.x.metrics import MetricsRegistry
from keto_tpu_torch.x.telemetry import DurationStats, MaintenanceStats

from test_torch_write_path import CHAIN, QUIET, TEAM, Both, T, deep_rows
from keto_tpu_torch.relationtuple.model import SubjectID, SubjectSet

#: counters the port keeps that the reference has no counter for
PORT_ONLY = {
    # the C++ bulk resolve and the host loop, by path (the reference
    # resolves in Python only)
    "resolve_native_batches", "resolve_python_batches",
    # the build sorter's batches on the host below its size gate (the
    # reference's sorter counts only its device batches)
    "device_build_host_dispatches",
}
#: gauges whose values depend on the device layout
LAYOUT_GAUGES = {"hbm_resident_bytes"}


def _chain(b):
    q = [T("d", "doc", "view", SubjectID(u)) for u in ("u1", "u2", "zz")]
    b.check(q)
    b.write([T("g", "g2b", "m", SubjectID("u3"))])
    b.check(q + [T("d", "doc", "view", SubjectID("u3"))])
    b.write([T("g", "g1", "m", SubjectSet("g", "g9", "m")), T("g", "g9", "m", SubjectID("u9"))],
            [T("g", "g2", "m", SubjectID("u1"))])
    b.check(q)
    b.fold()
    b.check(q)


def _ell_insert_fold(b):
    q = [T("d", "doc", "view", SubjectID("alice")), T("g", "c4", "m", SubjectID("alice")),
         T("g", "c5", "m", SubjectID("ghost"))]
    b.check(q)
    b.write([T("g", "c1", "m", SubjectSet("g", "c4", "m"))])
    b.check(q)
    b.fold()
    b.check(q)


def _sink_burst(b):
    b.write([T("g", "c5", "m", SubjectID(f"burst-{i}")) for i in range(10)])
    b.check([T("d", "doc", "view", SubjectID(f"burst-{i}")) for i in range(10)]
            + [T("d", "doc", "view", SubjectID("ghost"))])
    b.fold()
    b.check([T("d", "doc", "view", SubjectID("burst-3"))])


def _tombstone(b):
    b.write((), [T("g", "c1", "m", SubjectSet("g", "c2", "m"))])
    b.check([T("d", "doc", "view", SubjectID("alice"))])
    b.fold()
    b.check([T("d", "doc", "view", SubjectID("alice"))])


def _team_deltas(b):
    for i in range(3):
        b.write([T("g", "team", "member", SubjectID(f"m{i}"))])
        b.check([T("d", "doc", "view", SubjectID(f"m{j}")) for j in range(4)])
    b.fold()


SCENARIOS = {
    "chain": (CHAIN, {}, _chain),
    "ell-insert-host-patch": (deep_rows(6), {"labels_device_min_edges": 1 << 30},
                              _ell_insert_fold),
    "ell-insert-device-patch": (deep_rows(6), {"labels_device_min_edges": 0}, _ell_insert_fold),
    "sink-burst": (deep_rows(6), {}, _sink_burst),
    "tombstone": (deep_rows(5), {}, _tombstone),
    "team-deltas": (TEAM, {}, _team_deltas),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_maintenance_stats_equal_the_reference(name):
    rows, kw, run = SCENARIOS[name]
    b = Both(rows, **QUIET, **kw)
    try:
        run(b)
        b.settle()
        pc, pg, pd = b.port.maintenance.raw()
        rc, rg, rd = b.ref.maintenance.raw()
    finally:
        b.close()
    assert set(pc) - set(rc) <= PORT_ONLY, sorted(set(pc) - set(rc))
    assert {k: v for k, v in pc.items() if k not in PORT_ONLY} == rc
    assert {k: d["count"] for k, d in pd.items()} == {k: d["count"] for k, d in rd.items()}
    assert set(pg) == set(rg)
    assert {k: v for k, v in pg.items() if k not in LAYOUT_GAUGES} == \
        {k: v for k, v in rg.items() if k not in LAYOUT_GAUGES}
    # the scenario moved what it claims to
    assert pc["full_rebuilds"] >= 1 and "full_rebuild" in pd and "label_coverage" in pg
    # counters() stays a view over the counters (the shadow audit's always present)
    view = b.port.counters()
    assert {k: v for k, v in view.items() if k in pc} == pc
    assert view["audit_checks"] == 0


def test_cache_save_and_reload_stats_equal_the_reference(tmp_path):
    from keto_tpu.check.tpu_engine import TpuCheckEngine
    from keto_tpu_torch.check.gpu_engine import TorchCheckEngine

    from test_torch_write_path import manager

    b = Both(deep_rows(5), **QUIET, snapshot_cache_dir=str(tmp_path / "port"))
    try:
        b.ref.close()
        b.ref = TpuCheckEngine(b.pair.ref, b.pair.ref.namespaces, **QUIET,
                               snapshot_cache_dir=str(tmp_path / "ref"))
        b.settle()
        assert b.port.save_snapshot_cache() and b.ref.save_snapshot_cache()
        b.close()
        b.port = TorchCheckEngine(b.pair.mine, manager(), device="cpu", **QUIET,
                                  snapshot_cache_dir=str(tmp_path / "port"))
        b.ref = TpuCheckEngine(b.pair.ref, b.pair.ref.namespaces, **QUIET,
                               snapshot_cache_dir=str(tmp_path / "ref"))
        b.settle()
        b.check([T("d", "doc", "view", SubjectID("alice"))])
        pc, pg, pd = b.port.maintenance.raw()
        rc, rg, rd = b.ref.maintenance.raw()
    finally:
        b.close()
    assert pc["cache_loads"] == rc["cache_loads"] == 1
    assert "cache_reload" in pd and "cache_reload" in rd
    assert pg["cache_loaded_bytes"] == rg["cache_loaded_bytes"] > 0


def _sink_ops(s):
    s.incr("a")
    s.incr("a", by=4)
    s.incr("b_failures")
    s.set_gauge("g", 3)
    s.set_gauge("g", 0.25)
    s.set_gauge("state", "serving")
    for ms in (1.0, 2.5, 0.1234):
        s.observe_ms("fold", ms)
    s.observe_ms("cache_save", 7)


def test_maintenance_stats_sink_equals_the_reference():
    got = []
    for cls in (RefStats, MaintenanceStats):
        s = cls()
        _sink_ops(s)
        got.append((s.snapshot(), s.raw()))
    assert got[1] == got[0]


def test_duration_stats_mirror_into_a_histogram():
    m = MetricsRegistry()
    h = m.histogram("t_slice_seconds", "slices")
    got = []
    for cls in (RefDuration, DurationStats):
        d = cls(capacity=4)
        for ms in (5.0, 1.0, 9.0, 3.0, 7.0):
            d.observe(ms)
        got.append((d.snapshot(), d.tail(3)))
    assert got[1] == got[0]
    d = DurationStats()
    d.attach_histogram(h)
    for ms in (5.0, 1.0, 9.0):
        d.observe(ms)
    (_, _, _, count, _), = [s for s in h.samples() if s[0] == "t_slice_seconds_count"]
    assert count == 3


def _progress_ops(p):
    p.start()
    with p.phase("scan"):
        p.add_rows(100)
    p.observe("intern", 0.5)
    p.set_phase("device_build")
    p.add_edges(40)
    mid = (p.current_phase, p.pct())
    p.observe("device_build", 0.25)
    p.finish()
    return mid


def test_build_progress_equals_the_reference():
    got = []
    for cls, stats_cls in ((RefProgress, RefStats), (BuildProgress, MaintenanceStats)):
        stats = stats_cls()
        p = cls(stats=stats)
        mid = _progress_ops(p)
        snap = p.snapshot()
        snap["durations_s"] = sorted(snap["durations_s"])  # times are not compared
        raw = stats.raw()
        got.append((mid, snap, p.rows_ingested, p.edges_ingested, p.pct(),
                    {k: d["count"] for k, d in raw[2].items()}))
    assert got[1] == got[0]
    assert got[1][-1] == {"build_scan": 1, "build_intern": 1, "build_device_build": 1}


def test_build_progress_mirrors_phases_into_the_histogram():
    m = MetricsRegistry()
    h = m.histogram("t_phase_seconds", "phases", ("phase",))
    p = BuildProgress()
    p.attach_histogram(h)
    _progress_ops(p)
    phases = {dict(zip(names, labels))["phase"]
              for name, names, labels, _, _ in h.samples() if name.endswith("_count")}
    assert phases == {"scan", "intern", "device_build"} and set(phases) <= set(PHASES)
