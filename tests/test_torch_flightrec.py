"""The port's flight recorder (keto_tpu_torch/x/flightrec.py) on the CPU: the
policy cases of tests/test_flightrec.py:31-141 (rate limit, retention,
shedding under the size cap, the torn dump, unserializable sections, a
failing collector, foreign files), and ``validate_bundle`` against the
reference's on the same bundles. Exact comparisons (tolerance 0)."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import pytest

from keto_tpu.x import flightrec as ref
from keto_tpu_torch.x import flightrec as port
from keto_tpu_torch.x.flightrec import BUNDLE_PREFIX, FlightRecorder, list_bundles, validate_bundle


def _collect_small():
    return {"health": {"state": "serving"}, "timelines": {"recent": []}}


def test_constants_equal_the_reference():
    assert (port.SCHEMA, port.REQUIRED_KEYS, port.SHED_ORDER, port.BUNDLE_PREFIX) == (
        ref.SCHEMA, ref.REQUIRED_KEYS, ref.SHED_ORDER, ref.BUNDLE_PREFIX)


def test_bundle_write_is_valid_and_atomic(tmp_path):
    fr = FlightRecorder(tmp_path, collect=_collect_small, min_interval_s=0.0, version="v-test")
    path = fr.trigger("oom", "injected")
    bundle = json.loads(Path(path).read_text())
    assert validate_bundle(bundle) == [] and ref.validate_bundle(bundle) == []
    assert (bundle["reason"], bundle["detail"], bundle["version"]) == ("oom", "injected", "v-test")
    assert not list(tmp_path.glob(".flightrec-*.tmp"))
    assert fr.snapshot()["bundles_by_reason"] == {"oom": 1}


def test_rate_limit_suppresses_and_counts(tmp_path):
    fr = FlightRecorder(tmp_path, collect=_collect_small, min_interval_s=60.0)
    assert fr.trigger("oom") is not None
    assert fr.trigger("oom") is None
    assert fr.trigger("drain") is None  # the limit is global, not per reason
    assert fr.snapshot()["suppressed"] == 2
    assert len(list_bundles(tmp_path)) == 1


def test_retention_prunes_oldest(tmp_path):
    fr = FlightRecorder(tmp_path, collect=_collect_small, min_interval_s=0.0, max_bundles=3)
    for i in range(6):
        assert fr.trigger(f"r{i}") is not None
        time.sleep(0.002)  # distinct millisecond stamps in the names
    reasons = [json.loads(p.read_text())["reason"] for p in list_bundles(tmp_path)]
    assert reasons == ["r3", "r4", "r5"]


def test_size_cap_sheds_sections_in_order(tmp_path):
    def collect():
        return {
            "metrics": "x" * 20000,  # shed first
            "timelines": {"recent": [{"kind": "GET /check"}]},
            "health": {"state": "serving"},
        }

    fr = FlightRecorder(tmp_path, collect=collect, min_interval_s=0.0, max_bytes=8192)
    path = fr.trigger("oom")
    bundle = json.loads(Path(path).read_text())
    assert validate_bundle(bundle) == []
    assert bundle["sections"]["metrics"] == {"shed": "size cap"}
    assert bundle["shed_sections"] == ["metrics"]
    assert bundle["sections"]["timelines"]["recent"]
    assert len(Path(path).read_bytes()) <= 8192


def test_torn_dump_leaves_no_partial_bundle(tmp_path, monkeypatch):
    fr = FlightRecorder(tmp_path, collect=_collect_small, min_interval_s=0.0)
    real_replace = os.replace

    def torn(src, dst):
        raise OSError("disk died at the rename")

    monkeypatch.setattr(os, "replace", torn)
    assert fr.trigger("oom") is None
    assert fr.snapshot()["failures"] == 1
    assert list_bundles(tmp_path) == []
    assert not list(tmp_path.glob(".flightrec-*.tmp"))
    monkeypatch.setattr(os, "replace", real_replace)
    assert FlightRecorder(tmp_path, collect=_collect_small, min_interval_s=0.0).trigger("retry")


def test_unserializable_section_and_failing_collector_are_contained(tmp_path):
    fr = FlightRecorder(tmp_path, collect=lambda: {"health": {"state": "ok"},
                                                   "bad": {"thread": object()}},
                        min_interval_s=0.0)
    bundle = json.loads(Path(fr.trigger("oom")).read_text())
    assert "error" in bundle["sections"]["bad"] and bundle["sections"]["health"] == {"state": "ok"}

    def boom():
        raise RuntimeError("collector exploded")

    fr = FlightRecorder(tmp_path / "b", collect=boom, min_interval_s=0.0)
    bundle = json.loads(Path(fr.trigger("drain")).read_text())
    assert "collect_error" in bundle["sections"]


def test_deferred_trigger_dumps_later(tmp_path):
    fr = FlightRecorder(tmp_path, collect=_collect_small, min_interval_s=0.0)
    assert fr.trigger("oom", "at upload", defer_s=0.05) is None
    deadline = time.monotonic() + 10
    while not list_bundles(tmp_path) and time.monotonic() < deadline:
        time.sleep(0.01)
    (path,) = list_bundles(tmp_path)
    assert json.loads(path.read_text())["detail"] == "at upload"


def test_list_bundles_ignores_foreign_files(tmp_path):
    (tmp_path / "notes.txt").write_text("hi")
    (tmp_path / ".flightrec-torn.tmp").write_text("{")
    (tmp_path / f"{BUNDLE_PREFIX}123-oom.json").write_text("{}")
    assert [p.name for p in list_bundles(tmp_path)] == [f"{BUNDLE_PREFIX}123-oom.json"]
    assert [p.name for p in ref.list_bundles(tmp_path)] == [f"{BUNDLE_PREFIX}123-oom.json"]


GOOD = {"schema": port.SCHEMA, "reason": "oom", "detail": "", "created_unix": 1.0, "pid": 1,
        "version": "v", "sections": {"health": {}}}

BUNDLES = {
    "not-an-object": [],
    "good": GOOD,
    "bad-schema": {**GOOD, "schema": 99},
    "empty-sections": {**GOOD, "sections": {}},
    "sections-not-a-dict": {**GOOD, "sections": []},
    "no-reason": {k: v for k, v in GOOD.items() if k != "reason"},
    "no-keys": {"schema": 99, "sections": {}},
    "reason-not-a-string": {**GOOD, "reason": 5},
}


@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_validate_bundle_agrees_with_the_reference(name):
    assert validate_bundle(BUNDLES[name]) == ref.validate_bundle(BUNDLES[name])
