"""Device-memory budget governor: the ledger, plan before upload, the
eviction ladder and OOM containment.

A copy of keto_tpu/driver/hbm.py: ``TAGS``, ``RUNGS``, the constants,
``MemoryPressure`` and ``HbmGovernor`` (:170-508) with their logic
unchanged. Only what touches the device differs:

- ``device_budget_bytes(device)`` reads the named CUDA device's
  ``total_memory`` less the headroom; for the CPU, or in ``deterministic``
  mode, it is ``FALLBACK_BUDGET_BYTES``. It never probes a device the
  caller did not name.
- ``device_measured_bytes(device)`` is ``torch.cuda.memory_allocated``.
- ``is_resource_exhausted`` classifies ``torch.OutOfMemoryError`` and a
  ``RuntimeError`` whose text carries CUDA's out-of-memory error (the
  port's own extensions raise those), never Python's ``MemoryError``.

The engine (keto_tpu_torch/check/gpu_engine.py) registers every upload it
makes under a tag, plans refreshes, folds and label uploads before they
run, walks the ladder — ``staging``, ``labels``, ``reverse``,
``warm-ladder``, ``overlay-budget`` — and refuses a refresh only with every
rung spent. A classified OOM at an upload or a dispatch evicts one rung and
retries once; a second one raises to the caller. The reference's escalation
into a CPU fallback engine is not ported.

``staging`` keeps its first place on the ladder, but the port's staging
pool is pinned host memory, not card memory: its bytes are kept apart
(``set_host_bytes``), shown in ``snapshot()["host"]`` and never counted
against the card's budget.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

_log = logging.getLogger("keto_tpu_torch.hbm")

#: fraction of the device's memory held back from the auto budget (the
#: caching allocator's workspace and the kernels' temporaries, which the
#: ledger cannot see)
DEFAULT_HEADROOM_FRAC = 0.08

#: the auto budget where no CUDA device is named (the CPU) and in
#: deterministic mode: conservative, and the same on every host
FALLBACK_BUDGET_BYTES = 4 << 30

#: restore a rung only while resident + planned stays under this fraction
#: of the budget — hysteresis so the ladder doesn't oscillate at the edge
RESTORE_FRAC = 0.7

#: the canonical ledger tags, in scrape order ("build" is the snapshot
#: pipeline's transient device footprint — the GovernedSorter's sort
#: workspace and the label build's sweep matrices, registered around the
#: dispatches; "staging" is the reference's device staging family, which
#: the port keeps on the host: see the module docstring)
TAGS = ("snapshot", "overlay", "labels", "reverse", "warmup", "build",
        "staging")

#: the eviction ladder rung names, in descent order (the final "refuse
#: the refresh" step is not a rung — it is plan() returning False).
#: "staging" goes first: dropping the entry-staging pool reverts to
#: per-slice allocation — pure churn cost, never coverage.
#: "reverse" drops the list layouts' device arrays — reverse queries run
#: on the host lister with equal answers. "tenant-lru" is appended by a
#: multi-tenant registry, after the engine's own rungs
RUNGS = ("staging", "labels", "reverse", "warm-ladder", "overlay-budget",
         "tenant-lru")

_OOM_TEXTS = ("cudaErrorMemoryAllocation", "out of memory")


def device_budget_bytes(
    device=None,
    headroom_frac: float = DEFAULT_HEADROOM_FRAC,
    deterministic: bool = False,
) -> int:
    """The auto budget: the named CUDA device's ``total_memory`` minus
    headroom, or ``FALLBACK_BUDGET_BYTES`` for the CPU, for no device and
    in ``deterministic`` mode (ladder decisions there derive from
    replicated state only)."""
    if deterministic or device is None:
        return FALLBACK_BUDGET_BYTES
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return FALLBACK_BUDGET_BYTES
    total = int(torch.cuda.get_device_properties(dev).total_memory)
    return max(1, int(total * (1.0 - headroom_frac)))


def device_measured_bytes(device=None) -> Optional[int]:
    """The bytes PyTorch's caching allocator has handed out on the named
    CUDA device (``torch.cuda.memory_allocated``), else None."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(dev))


def is_resource_exhausted(exc: BaseException) -> bool:
    """Classify ``exc`` as device-memory exhaustion: ``torch.OutOfMemoryError``
    (``torch.cuda.OutOfMemoryError``), or a ``RuntimeError`` whose text
    carries CUDA's out-of-memory error — NEVER Python's ``MemoryError``,
    which is a host failure the ladder cannot help."""
    if isinstance(exc, MemoryError):
        return False
    import torch

    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    return any(t in msg for t in _OOM_TEXTS)


class MemoryPressure(RuntimeError):
    """A planned allocation was refused with every rung spent — the
    engine serves stale and reports DEGRADED(memory_pressure)."""


class _Rung:
    __slots__ = ("name", "evict", "restore", "evicted")

    def __init__(self, name: str, evict: Callable[[], int], restore: Callable[[], None]):
        self.name = name
        self.evict = evict  # returns estimated bytes freed (logging only)
        self.restore = restore
        self.evicted = False


class HbmGovernor:
    """Ledger + budget + eviction-ladder policy (see module docstring).

    Thread-safe; rung callables run under the governor's re-entrant lock
    and may call back into ``release``/``register``. The engine owns the
    rung semantics — the governor only owns the order and the account.
    ``stats`` is any object with ``incr(key)`` and ``set_gauge(key,
    value)`` (the engine's counters)."""

    def __init__(
        self,
        budget_bytes: int = 0,
        *,
        device=None,
        stats=None,
        deterministic: bool = False,
        headroom_frac: float = DEFAULT_HEADROOM_FRAC,
    ):
        self._lock = threading.RLock()
        self._ledger: dict[str, int] = {}
        # per-shard breakdown of tags the sharded engine mode registers
        # (keto_tpu_torch/parallel/sharded.py): tag → [bytes per shard].
        # Tags with no breakdown (replicated/transient state) spread evenly
        # over the shards in the per-shard view.
        self._n_shards = 1
        self._shard_ledger: dict[str, list] = {}
        # host-memory families the ladder manages but the card's budget
        # never counts (the pinned staging pool)
        self._host: dict[str, int] = {}
        self._rungs: list[_Rung] = []
        self._depth = 0  # rungs currently evicted (prefix of _rungs)
        self._stats = stats
        self.deterministic = bool(deterministic)
        self.configured_budget = int(budget_bytes)
        self.budget_bytes = (
            int(budget_bytes)
            if budget_bytes > 0
            else device_budget_bytes(device, headroom_frac, deterministic=deterministic)
        )
        self.evictions_by_rung: dict[str, int] = {r: 0 for r in RUNGS}
        self.restores = 0
        self.refusals = 0
        self.forced_allocs = 0  # over-budget allocations allowed (cold boot)
        self.oom_events = 0
        self.oom_recoveries = 0
        self._gauge("hbm_budget_bytes", self.budget_bytes)
        self._gauge("hbm_resident_bytes", 0)
        self._gauge("hbm_rung", 0)

    # -- stats plumbing ------------------------------------------------------

    def _gauge(self, key: str, value) -> None:
        if self._stats is not None:
            self._stats.set_gauge(key, value)

    def _incr(self, key: str) -> None:
        if self._stats is not None:
            self._stats.incr(key)

    def _publish_locked(self) -> None:
        self._gauge("hbm_resident_bytes", sum(self._ledger.values()))
        self._gauge("hbm_rung", self._depth)

    # -- ledger --------------------------------------------------------------

    def register(self, tag: str, nbytes: int) -> None:
        """Record ``tag``'s device residency as exactly ``nbytes``
        (replacing any prior figure — a snapshot swap re-registers its
        family once the old arrays are unreferenced)."""
        with self._lock:
            self._ledger[tag] = max(0, int(nbytes))
            self._publish_locked()

    def add(self, tag: str, nbytes: int) -> None:
        """Additive registration (the list layouts accumulate per
        orientation)."""
        with self._lock:
            self._ledger[tag] = self._ledger.get(tag, 0) + max(0, int(nbytes))
            self._publish_locked()

    def release(self, tag: str) -> int:
        """Drop ``tag`` from the ledger; returns the bytes released."""
        with self._lock:
            freed = self._ledger.pop(tag, 0)
            self._shard_ledger.pop(tag, None)
            self._publish_locked()
            return freed

    def set_host_bytes(self, tag: str, nbytes: int) -> None:
        """Record a host-memory family's bytes (the pinned staging pool):
        shown in ``snapshot()["host"]``, never held against the budget."""
        with self._lock:
            self._host[tag] = max(0, int(nbytes))

    # -- per-shard ledger (sharded serving) ----------------------------------

    def set_shard_count(self, n: int) -> None:
        """Declare the graph-axis shard count the per-shard ledger and
        per-shard budget slices divide by. Set once by the sharded
        engine at construction."""
        with self._lock:
            self._n_shards = max(1, int(n))
            self._shard_ledger = {}

    def register_shards(self, tag: str, per_shard) -> None:
        """Record ``tag``'s per-shard owned bytes (the unpadded rows each
        shard actually holds). The global figure for ``tag`` is still
        whatever ``register`` recorded — padding makes the two differ;
        the per-shard view is the honest hot-shard account."""
        with self._lock:
            vals = [max(0, int(v)) for v in per_shard]
            if len(vals) < self._n_shards:
                vals += [0] * (self._n_shards - len(vals))
            self._shard_ledger[tag] = vals[: self._n_shards]

    def shard_ledger(self) -> dict:
        """The per-shard breakdown by tag (``register_shards``)."""
        with self._lock:
            return {t: list(v) for t, v in self._shard_ledger.items()}

    def shard_resident_bytes(self) -> list:
        """Per-shard resident bytes: tracked tags contribute their owned
        slice, untracked tags spread evenly (replicated / transient
        state is on every shard's devices)."""
        with self._lock:
            return self._shard_resident_locked()

    def _shard_resident_locked(self) -> list:
        n = self._n_shards
        out = [0] * n
        for tag, total in self._ledger.items():
            per = self._shard_ledger.get(tag)
            if per is None:
                for s in range(n):
                    out[s] += total // n
            else:
                for s in range(n):
                    out[s] += per[s]
        return out

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._ledger.values())

    def ledger(self) -> dict[str, int]:
        with self._lock:
            return dict(self._ledger)

    def set_budget_bytes(self, nbytes: int) -> None:
        """Operator/test seam: re-pin the budget at runtime (pressure
        rehearsal, live retuning). Restores are NOT applied here — the
        next successful plan walks back up the ladder."""
        with self._lock:
            self.budget_bytes = max(1, int(nbytes))
            self._gauge("hbm_budget_bytes", self.budget_bytes)

    # -- the ladder ----------------------------------------------------------

    def attach_rungs(self, rungs) -> None:
        """``rungs`` is an ordered list of ``(name, evict_fn, restore_fn)``
        — descent order. Attached once by the engine at construction."""
        with self._lock:
            self._rungs = [_Rung(n, e, r) for n, e, r in rungs]
            self._depth = 0

    def append_rung(
        self, name: str, evict: Callable[[], int], restore: Callable[[], None]
    ) -> None:
        """Append one rung BELOW the engine's ladder (``attach_rungs``
        replaces the whole ladder — this is the seam for rungs owned by
        someone else, e.g. a registry's cross-tenant ``tenant-lru`` rung).
        Idempotent per name."""
        with self._lock:
            if any(r.name == name for r in self._rungs):
                return
            self._rungs.append(_Rung(name, evict, restore))

    @property
    def rung_depth(self) -> int:
        """How many rungs are currently evicted (0 = full service)."""
        with self._lock:
            return self._depth

    def fits(self, nbytes: int) -> bool:
        with self._lock:
            return sum(self._ledger.values()) + max(0, int(nbytes)) <= self.budget_bytes

    def _evict_next_locked(self, reason: str) -> Optional[str]:
        if self._depth >= len(self._rungs):
            return None
        rung = self._rungs[self._depth]
        self._depth += 1
        rung.evicted = True
        try:
            freed = int(rung.evict() or 0)
        except Exception:
            _log.warning("eviction rung %r failed; continuing down the ladder",
                         rung.name, exc_info=True)
            freed = 0
        self.evictions_by_rung[rung.name] = self.evictions_by_rung.get(rung.name, 0) + 1
        self._incr("hbm_evictions")
        self._publish_locked()
        _log.warning(
            "device memory pressure (%s): evicted rung %r (~%d bytes freed; rung %d/%d, "
            "resident %d / budget %d)",
            reason, rung.name, freed, self._depth, len(self._rungs),
            sum(self._ledger.values()), self.budget_bytes,
        )
        return rung.name

    def evict_one(self, reason: str = "") -> Optional[str]:
        """Descend one rung (the real-OOM containment path). Returns the
        rung name, or None when the ladder is spent. Deterministic mode
        never evicts reactively — per-host OOM timing is not replicated
        state."""
        if self.deterministic:
            return None
        with self._lock:
            return self._evict_next_locked(reason or "oom")

    def plan(
        self,
        nbytes: int,
        *,
        what: str = "",
        evict: bool = True,
        per_shard=None,
    ) -> bool:
        """Will ``nbytes`` more fit? Walks the eviction ladder (in order,
        at most once per rung) until it does; returns False only with
        every rung spent and the plan still over budget — the caller
        refuses the work (or, for optional work like warming one more
        width, simply skips it with ``evict=False``).

        ``per_shard`` (sharded serving) additionally holds each shard's
        incoming bytes against that shard's slice of the budget — the
        HOTTEST shard is the binding constraint, and any rung the walk
        evicts is MESH-WIDE (one ladder for every shard)."""
        need = max(0, int(nbytes))

        def over_locked() -> bool:
            if sum(self._ledger.values()) + need > self.budget_bytes:
                return True
            if per_shard is not None and self._n_shards > 1:
                shard_budget = self.budget_bytes // self._n_shards
                resident = self._shard_resident_locked()
                for s in range(self._n_shards):
                    add = int(per_shard[s]) if s < len(per_shard) else 0
                    if resident[s] + add > shard_budget:
                        return True
            return False

        with self._lock:
            while over_locked():
                if not evict or self._evict_next_locked(f"planning {what or 'allocation'}") is None:
                    return False
            return True

    def note_refused(self) -> None:
        """Count an actual refusal (the engine declined a refresh and is
        serving stale) — distinct from a failed plan the caller then
        force-allows (cold boot) or simply skips (optional warmup)."""
        with self._lock:
            self.refusals += 1
        self._incr("hbm_refusals")

    def note_forced(self, what: str, nbytes: int) -> None:
        """Account an allocation that proceeded over budget (cold boot:
        there is no stale snapshot to serve instead)."""
        with self._lock:
            self.forced_allocs += 1
        self._incr("hbm_forced_allocs")
        _log.warning(
            "device memory budget exceeded but no stale state to serve: allowing %s "
            "(%d bytes) over the %d-byte budget", what, nbytes, self.budget_bytes,
        )

    def maybe_restore(self, planned: int = 0) -> int:
        """Walk back UP the ladder while there is clear headroom
        (resident + planned under RESTORE_FRAC of budget). Called after a
        successful refresh; returns the number of rungs restored."""
        restored = 0
        with self._lock:
            while self._depth > 0:
                if sum(self._ledger.values()) + max(0, int(planned)) > (
                    RESTORE_FRAC * self.budget_bytes
                ):
                    break
                rung = self._rungs[self._depth - 1]
                try:
                    rung.restore()
                except Exception:
                    _log.warning("restore of rung %r failed; staying evicted",
                                 rung.name, exc_info=True)
                    break
                rung.evicted = False
                self._depth -= 1
                restored += 1
                self.restores += 1
                self._incr("hbm_restores")
                _log.info("device memory pressure cleared: restored rung %r (rung %d/%d)",
                          rung.name, self._depth, len(self._rungs))
            if restored:
                self._publish_locked()
        return restored

    # -- OOM accounting ------------------------------------------------------

    #: optional anomaly hook (a flight recorder's OOM trigger seam);
    #: invoked outside the governor lock, exceptions contained
    on_oom: Optional[Callable[[str], None]] = None

    def note_oom(self, what: str = "") -> None:
        with self._lock:
            self.oom_events += 1
        self._incr("oom_events")
        _log.warning("device out of memory at %s", what or "unknown site")
        cb = self.on_oom
        if cb is not None:
            try:
                cb(what)
            except Exception:
                _log.warning("on_oom hook failed", exc_info=True)

    def note_oom_recovered(self) -> None:
        with self._lock:
            self.oom_recoveries += 1
        self._incr("oom_recoveries")

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """Operator/metrics view: budget, ledger, ladder position, and
        the counters; ``host`` (only once a host family registered) the
        host-memory families kept apart from the budget."""
        with self._lock:
            out = {
                "budget_bytes": self.budget_bytes,
                "configured_budget_bytes": self.configured_budget,
                "resident_bytes": sum(self._ledger.values()),
                "ledger": dict(self._ledger),
                "shards": (
                    self._shard_resident_locked() if self._n_shards > 1 else []
                ),
                "shard_count": self._n_shards,
                "rung": self._depth,
                "rungs": [r.name for r in self._rungs],
                "evicted": [r.name for r in self._rungs if r.evicted],
                "evictions_by_rung": dict(self.evictions_by_rung),
                "restores": self.restores,
                "refusals": self.refusals,
                "forced_allocs": self.forced_allocs,
                "oom_events": self.oom_events,
                "oom_recoveries": self.oom_recoveries,
            }
            if self._host:
                out["host"] = dict(self._host)
            return out
