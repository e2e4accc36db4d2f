"""Durable, sampled decision-audit log: a copy of
keto_tpu/explain/decision_log.py.

A tenant-scoped subdirectory per tenant holds an append-only *active* segment
(``active.jsonl.tmp``) plus sealed segments (``seg-<8-digit>.jsonl``). A
segment is sealed by flush + fsync + atomic ``os.replace``, so a sealed
segment is never torn — a SIGKILL can at worst leave a partial final line in
the active file, which readers tolerate (counted, skipped). Retention keeps
the newest N sealed segments per tenant.

Each record is one JSON line:

    {"ts": ..., "tenant": ..., "tuple": {...}, "decision": ..., "route": ...,
     "snaptoken": ..., "trace_id": ..., "witness": [...] | null}

``snaptoken`` makes any past decision re-explainable: replay the tuple
through ``GET /check/explain?snaptoken=...`` and the engine reconstructs the
witness at that watermark.

Sampling (``sampled()``) is a single RNG draw — the check hot path pays one
``is None`` test when the log is disabled and one float compare when it is
not.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from pathlib import Path
from typing import Any, Optional

_ACTIVE = "active.jsonl.tmp"
_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".jsonl"

DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_RETENTION = 8


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class DecisionLog:
    """Tenant-scoped durable decision log with sampling, atomic segment
    rotation, and bounded retention."""

    def __init__(
        self,
        root_dir: str,
        *,
        sample: float = 0.0,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        retention: int = DEFAULT_RETENTION,
        seed: Optional[int] = None,
    ):
        self._root = Path(root_dir)
        self._sample = max(0.0, min(1.0, float(sample)))
        self._segment_bytes = max(1, int(segment_bytes))
        self._retention = max(1, int(retention))
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # tenant -> (open file handle, bytes in active segment)
        self._open: dict[str, tuple[Any, int]] = {}
        self.records_total = 0
        self.bytes_total = 0
        self.rotations_total = 0

    # -- sampling -------------------------------------------------------------

    @property
    def sample_rate(self) -> float:
        return self._sample

    def sampled(self) -> bool:
        """One RNG draw; False when sampling is off."""
        return self._sample > 0.0 and self._rng.random() < self._sample

    # -- writing --------------------------------------------------------------

    def record(
        self,
        tenant: str,
        entry: dict[str, Any],
    ) -> None:
        """Append one decision record to the tenant's active segment,
        rotating when the segment crosses the size threshold. Thread-safe;
        I/O errors are swallowed (the log is observability, not the write
        path — a full disk must not fail checks)."""
        line = json.dumps(
            {"ts": round(time.time(), 6), "tenant": tenant, **entry},
            separators=(",", ":"),
            sort_keys=True,
        )
        data = line + "\n"
        with self._lock:
            try:
                f, size = self._open_for(tenant)
                f.write(data)
                size += len(data.encode("utf-8"))
                self.records_total += 1
                self.bytes_total += len(data.encode("utf-8"))
                if size >= self._segment_bytes:
                    self._rotate_locked(tenant, f)
                else:
                    self._open[tenant] = (f, size)
            except OSError:
                self._open.pop(tenant, None)

    def _tenant_dir(self, tenant: str) -> Path:
        d = self._root / tenant
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _open_for(self, tenant: str):
        got = self._open.get(tenant)
        if got is not None:
            return got
        path = self._tenant_dir(tenant) / _ACTIVE
        f = open(path, "a", encoding="utf-8")
        size = f.tell()
        self._open[tenant] = (f, size)
        return f, size

    def _rotate_locked(self, tenant: str, f) -> None:
        """Seal the active segment: fsync, atomic rename to the next sealed
        name, fsync the directory, then apply retention."""
        d = self._tenant_dir(tenant)
        _fsync_file(f)
        f.close()
        self._open.pop(tenant, None)
        sealed = self._sealed_segments(d)
        next_n = 0
        if sealed:
            next_n = int(sealed[-1].name[len(_SEG_PREFIX) : -len(_SEG_SUFFIX)]) + 1
        target = d / f"{_SEG_PREFIX}{next_n:08d}{_SEG_SUFFIX}"
        os.replace(d / _ACTIVE, target)
        _fsync_dir(d)
        self.rotations_total += 1
        for old in self._sealed_segments(d)[: -self._retention]:
            try:
                old.unlink()
            except OSError:
                pass

    @staticmethod
    def _sealed_segments(d: Path) -> list[Path]:
        segs = [
            p
            for p in d.glob(f"{_SEG_PREFIX}*{_SEG_SUFFIX}")
            if p.name[len(_SEG_PREFIX) : -len(_SEG_SUFFIX)].isdigit()
        ]
        segs.sort(key=lambda p: int(p.name[len(_SEG_PREFIX) : -len(_SEG_SUFFIX)]))
        return segs

    def flush(self) -> None:
        with self._lock:
            for f, _ in self._open.values():
                try:
                    _fsync_file(f)
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            for f, _ in self._open.values():
                try:
                    _fsync_file(f)
                    f.close()
                except OSError:
                    pass
            self._open.clear()

    # -- reading --------------------------------------------------------------

    def segments(self, tenant: str) -> list[Path]:
        """Sealed segments (oldest first) plus the active segment if present."""
        d = self._root / tenant
        if not d.is_dir():
            return []
        out = self._sealed_segments(d)
        active = d / _ACTIVE
        if active.exists():
            out.append(active)
        return out

    def read_all(self, tenant: str) -> tuple[list[dict[str, Any]], int]:
        """Read every record for a tenant (oldest first). Returns
        ``(records, corrupt_lines)`` — a torn or corrupt line is counted and
        skipped, never raised, so a post-SIGKILL log is always readable."""
        self.flush()
        records: list[dict[str, Any]] = []
        corrupt = 0
        for seg in self.segments(tenant):
            try:
                text = seg.read_text(encoding="utf-8", errors="replace")
            except OSError:
                corrupt += 1
                continue
            for line in text.splitlines():
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    corrupt += 1
                    continue
                if not isinstance(rec, dict):
                    corrupt += 1
                    continue
                records.append(rec)
        return records, corrupt

    def tenants(self) -> list[str]:
        if not self._root.is_dir():
            return []
        return sorted(p.name for p in self._root.iterdir() if p.is_dir())
