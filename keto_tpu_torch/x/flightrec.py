"""Flight recorder: a bounded debug bundle dumped at the moment of anomaly: a copy of
keto_tpu/x/flightrec.py.

When a serving process degrades in production, the evidence is usually
gone by the time an operator attaches: the ring of recent request
timelines has rotated, the health reason has changed, the HBM ledger has
moved on. The flight recorder freezes that evidence AT the anomaly: on a
trigger — a DEGRADED/NOT_SERVING health transition, a contained device
OOM, an audit mismatch (surfaced as a DEGRADED transition), a SIGTERM
drain, a lock-watchdog trip — it atomically writes one JSON bundle to
``serve.debug_bundle_dir`` containing:

- the recent + slowest request timelines (keto_tpu_torch/x/timeline.py),
- the health state, reason, and transition history,
- the HBM governor ledger/ladder snapshot,
- admission/batcher state (queue depths, windows, shed counters),
- a full metrics exposition snapshot,
- the lockwatch report when the sanitizer is installed,
- watch-hub / replica-controller state when present.

Bundles are **rate-limited** (``min_interval_s`` between dumps — a
flapping health state cannot fill a disk), **size-capped** (oversized
sections are shed in a deterministic order and the bundle says so), and
**bounded in count** (oldest pruned past ``max_bundles``). The write is
atomic (tmp + fsync + rename): a crash mid-dump leaves no torn bundle,
only an ignorable temp file that the next prune removes.

Collection never raises into the serving path: every section is
gathered under its own guard, a failing section becomes
``{"error": ...}`` inside the bundle instead of an exception at the
trigger site.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional

_log = logging.getLogger("keto_tpu_torch.flightrec")

#: bundle schema version (scripts/flightrec_smoke.py pins it)
SCHEMA = 1

#: bundle file name prefix; the rest is <unix-ms>-<reason>.json
BUNDLE_PREFIX = "bundle-"

#: keys every valid bundle carries
REQUIRED_KEYS = ("schema", "reason", "detail", "created_unix", "pid",
                 "version", "sections")

#: size-cap shedding order: sections dropped (replaced by a marker) until
#: the serialized bundle fits — biggest/least-essential first, so the
#: health picture and the timelines survive the longest
SHED_ORDER = ("metrics", "lockwatch", "watch", "replica", "slo",
              "tenants", "batcher", "hbm", "explain", "audit_divergences",
              "timelines")


def validate_bundle(bundle: dict) -> list[str]:
    """Schema problems with ``bundle`` (empty list = valid). Shared by
    the unit tests and the CI smoke so "loadable and valid" means one
    thing."""
    problems = []
    if not isinstance(bundle, dict):
        return ["bundle is not a JSON object"]
    for key in REQUIRED_KEYS:
        if key not in bundle:
            problems.append(f"missing required key {key!r}")
    if bundle.get("schema") != SCHEMA:
        problems.append(f"schema {bundle.get('schema')!r} != {SCHEMA}")
    sections = bundle.get("sections")
    if not isinstance(sections, dict):
        problems.append("sections is not an object")
    elif not sections:
        problems.append("sections is empty")
    if not isinstance(bundle.get("reason"), str) or not bundle.get("reason"):
        problems.append("reason missing/empty")
    return problems


def list_bundles(directory) -> list[Path]:
    """Completed bundle files in ``directory``, oldest first (temp files
    from torn writes are ignored)."""
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(
        p for p in d.iterdir()
        if p.name.startswith(BUNDLE_PREFIX) and p.name.endswith(".json")
    )


class FlightRecorder:
    """Anomaly-triggered bundle writer (see module docstring).

    ``collect`` is a zero-arg callable returning the sections dict; the
    driver registry supplies one that reads every live component
    (keto_tpu_torch/driver/observability.py). The recorder itself owns only policy:
    rate limit, size cap, retention, atomicity."""

    def __init__(
        self,
        directory,
        *,
        collect: Callable[[], dict],
        max_bundles: int = 8,
        min_interval_s: float = 30.0,
        max_bytes: int = 4 << 20,
        version: str = "",
    ):
        self.directory = Path(directory)
        self._collect = collect
        self.max_bundles = max(1, int(max_bundles))
        self.min_interval_s = max(0.0, float(min_interval_s))
        self.max_bytes = max(4096, int(max_bytes))
        self.version = version
        self._lock = threading.Lock()  # guards: _last_dump, bundles_by_reason, suppressed, failures
        self._last_dump: Optional[float] = None
        #: bundles written, by trigger reason (the /metrics bridge)
        self.bundles_by_reason: dict[str, int] = {}
        #: triggers refused by the rate limit
        self.suppressed = 0
        #: dump attempts that failed (I/O error, unserializable section)
        self.failures = 0
        self.last_path: Optional[str] = None

    # -- trigger ---------------------------------------------------------------

    def trigger(
        self, reason: str, detail: str = "", defer_s: float = 0.0
    ) -> Optional[str]:
        """Dump one bundle for ``reason`` unless rate-limited. Returns
        the bundle path, or None (suppressed, failed, or deferred).
        Never raises — a broken flight recorder must not take the
        anomaly path that invoked it down with it.

        ``defer_s`` delays the collection on a background thread:
        anomalies detected MID-request (a contained OOM inside a check's
        dispatch) defer briefly so the triggering request's own finished
        timeline makes it into the bundle; the rate-limit slot is
        claimed immediately either way."""
        now = time.monotonic()
        with self._lock:
            if (
                self._last_dump is not None
                and now - self._last_dump < self.min_interval_s
            ):
                self.suppressed += 1
                return None
            # claim the slot BEFORE collecting: concurrent triggers
            # (health flap + OOM in the same instant) produce one bundle
            self._last_dump = now
        if defer_s > 0:
            threading.Thread(
                target=self._dump_guarded, args=(reason, detail, defer_s),
                name="keto-tpu-torch-flightrec", daemon=True,
            ).start()
            return None
        return self._dump_guarded(reason, detail, 0.0)

    def _dump_guarded(
        self, reason: str, detail: str, defer_s: float
    ) -> Optional[str]:
        if defer_s > 0:
            time.sleep(defer_s)
        try:
            path = self._dump(reason, detail)
        except Exception:
            with self._lock:
                self.failures += 1
            _log.warning(
                "flight-recorder dump failed (reason=%s)", reason, exc_info=True
            )
            return None
        with self._lock:
            self.bundles_by_reason[reason] = (
                self.bundles_by_reason.get(reason, 0) + 1
            )
            self.last_path = str(path)
        _log.warning("flight-recorder bundle written: %s (reason=%s)", path, reason)
        return str(path)

    # -- internals -------------------------------------------------------------

    def _sections(self) -> dict:
        try:
            sections = self._collect()
        except Exception as e:
            sections = {"collect_error": repr(e)}
        # a section that cannot serialize must not kill the bundle
        out = {}
        for name, value in sections.items():
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = {"error": f"unserializable section ({type(value).__name__})"}
            out[name] = value
        return out

    def _dump(self, reason: str, detail: str) -> Path:
        bundle = {
            "schema": SCHEMA,
            "reason": reason,
            "detail": detail,
            "created_unix": round(time.time(), 3),
            "pid": os.getpid(),
            "version": self.version,
            "sections": self._sections(),
        }
        data = json.dumps(bundle).encode()
        shed = []
        for name in SHED_ORDER:
            if len(data) <= self.max_bytes:
                break
            if name in bundle["sections"]:
                bundle["sections"][name] = {"shed": "size cap"}
                shed.append(name)
                bundle["shed_sections"] = shed
                data = json.dumps(bundle).encode()
        self.directory.mkdir(parents=True, exist_ok=True)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )[:48]
        final = self.directory / (
            f"{BUNDLE_PREFIX}{int(time.time() * 1e3)}-{safe_reason}.json"
        )
        fd, tmp = tempfile.mkstemp(
            dir=str(self.directory), prefix=".flightrec-", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        """Keep the newest ``max_bundles`` bundles; sweep torn temp
        files older than a minute (a crash mid-write leaves one)."""
        bundles = list_bundles(self.directory)
        for path in bundles[: max(0, len(bundles) - self.max_bundles)]:
            try:
                path.unlink()
            except OSError:
                _log.debug("bundle prune raced removal: %s", path, exc_info=True)
        cutoff = time.time() - 60.0
        for p in self.directory.glob(".flightrec-*.tmp"):
            try:
                if p.stat().st_mtime < cutoff:
                    p.unlink()
            except OSError:
                _log.debug("temp prune raced removal: %s", p, exc_info=True)

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": str(self.directory),
                "bundles_by_reason": dict(self.bundles_by_reason),
                "suppressed": self.suppressed,
                "failures": self.failures,
                "last_path": self.last_path,
            }


__all__ = [
    "FlightRecorder",
    "validate_bundle",
    "list_bundles",
    "SCHEMA",
    "BUNDLE_PREFIX",
]
