"""Health / readiness state machine for the serving core.

A copy of keto_tpu/driver/health.py: ``HealthState``, ``READY_STATES`` and
``HealthMonitor`` with their logic unchanged. It derives one externally
visible state from the engine's live health inputs
(``TorchCheckEngine.health()``):

::

                      first snapshot
        STARTING ───────────────────▶ SERVING ◀─────────────────▶ DEGRADED
                                        ▲  │ staleness > budget,          │
                                        │  │ or maintenance dead          │
                         refresh caught │  ▼                              │
                         up / thread ok └─ NOT_SERVING ◀──────────────────┘
                                                         (degraded AND stale)

- **STARTING** — no snapshot yet and nothing has failed. *Ready*: a cold
  engine builds its snapshot inline on first check.
- **SERVING** — snapshot within the staleness budget, maintenance alive.
- **DEGRADED** — still *ready*, answers still correct: the shadow audit
  saw a divergence, or the device-memory governor refused the last
  refresh (``memory_pressure``: serving stale within the budget). The
  reference's third reason, a CPU fallback engine serving, never arises
  in the port: it has no such fallback, and its ``health()["degraded"]``
  is always False.
- **NOT_SERVING** — the snapshot is further behind the store than
  ``staleness_budget_s`` allows, or a maintenance worker died. REST
  ``/health/ready`` returns 503 + reason.

The state is *derived on read* (staleness is a function of wall time);
``watch()`` polls cheaply and yields only transitions. ``set_override`` is
the operator drain seam. The reference's replica seam (``set_replica``,
``replication_lag``) waits for the replicas (ROADMAP A10); transitions are
counted in the engine's counters (``health_transitions``).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

_log = logging.getLogger("keto_tpu_torch.health")


class HealthState(enum.Enum):
    STARTING = "starting"
    SERVING = "serving"
    DEGRADED = "degraded"
    NOT_SERVING = "not_serving"


#: states in which the server should accept traffic
READY_STATES = (HealthState.STARTING, HealthState.SERVING, HealthState.DEGRADED)


class HealthMonitor:
    """Derives the serving state from an engine's ``health()`` inputs.

    ``engine`` may be any check engine: one without a ``health()`` method
    (the recursive oracle — no snapshot, no staleness concept) is always
    SERVING. Transitions are logged, counted into the engine's counters
    when it has them (``health_transitions``), and broadcast to
    ``watch()`` streams and listeners."""

    def __init__(self, engine=None, *, staleness_budget_s: float = 60.0):
        self._engine = engine
        self._budget = float(staleness_budget_s)
        # guards: _last_state, _last_reason, _override, _transitions,
        # transitions_log
        self._lock = threading.Lock()
        self._last_state: Optional[HealthState] = None
        self._last_reason = ""
        self._override: Optional[tuple[HealthState, str]] = None
        self._transitions = 0
        #: recent transitions [(unix, from, to, reason)]
        self.transitions_log: deque[dict] = deque(maxlen=64)
        # transition listeners; invoked OUTSIDE the monitor lock,
        # exceptions contained
        self._listeners: list[Callable[[HealthState, str], None]] = []

    def set_engine(self, engine) -> None:
        """Derive state from a newly installed engine from now on."""
        self._engine = engine

    @property
    def staleness_budget_s(self) -> float:
        return self._budget

    def set_staleness_budget_s(self, seconds: float) -> None:
        """Operator/test seam: re-pin the staleness budget at runtime."""
        self._budget = float(seconds)

    @property
    def transitions(self) -> int:
        """State transitions observed since boot."""
        with self._lock:
            return self._transitions

    # -- the state machine ---------------------------------------------------

    def add_listener(self, fn: Callable[[HealthState, str], None]) -> None:
        """Call ``fn(state, reason)`` on every state transition. Listeners
        run outside the monitor lock; exceptions are contained and
        logged."""
        with self._lock:
            self._listeners.append(fn)

    def status(self) -> tuple[HealthState, str]:
        """Current ``(state, reason)``; reason is "" while SERVING."""
        state, reason = self._compute()
        transitioned = False
        with self._lock:
            if state != self._last_state:
                if self._last_state is not None:
                    _log.warning(
                        "health transition %s -> %s%s",
                        self._last_state.value, state.value,
                        f" ({reason})" if reason else "",
                    )
                self.transitions_log.append(
                    {
                        "unix": round(time.time(), 3),
                        "from": (
                            self._last_state.value
                            if self._last_state is not None else None
                        ),
                        "to": state.value,
                        "reason": reason,
                    }
                )
                transitioned = self._last_state is not None
                self._transitions += 1
                self._last_state = state
                self._record()
            self._last_reason = reason
            listeners = list(self._listeners) if transitioned else []
        for fn in listeners:
            try:
                fn(state, reason)
            except Exception:
                _log.warning("health transition listener failed", exc_info=True)
        return state, reason

    def ready(self) -> bool:
        return self.status()[0] in READY_STATES

    def set_override(self, state: Optional[HealthState], reason: str = "") -> None:
        """Operator seam: pin the reported state (drain before maintenance,
        fault rehearsal); ``None`` returns control to the derived state."""
        with self._lock:
            self._override = None if state is None else (state, reason)

    def override(self) -> Optional[tuple[HealthState, str]]:
        """The pinned ``(state, reason)``, or None."""
        with self._lock:
            return self._override

    def _compute(self) -> tuple[HealthState, str]:
        with self._lock:
            if self._override is not None:
                return self._override
        eng = self._engine
        if eng is None or not hasattr(eng, "health"):
            return HealthState.SERVING, ""
        try:
            h = eng.health()
        except Exception as e:  # a broken health probe is itself a failure
            return HealthState.NOT_SERVING, f"health probe failed: {e}"
        if not h.get("maintenance_alive", True):
            return (
                HealthState.NOT_SERVING,
                "snapshot maintenance thread died: " + (h.get("refresh_last_error") or "unknown"),
            )
        staleness = float(h.get("staleness_s", 0.0))
        if staleness > self._budget:
            reason = (
                f"snapshot {staleness:.1f}s behind the store "
                f"(budget {self._budget:.1f}s)"
            )
            err = h.get("refresh_last_error")
            if err:
                reason += f"; last refresh error: {err}"
            return HealthState.NOT_SERVING, reason
        if not h.get("has_snapshot", True):
            # a cold start builds for seconds to minutes — the build's
            # progress is the boot heartbeat, so STARTING reads as alive
            phase = h.get("build_phase")
            if phase and phase != "idle":
                pct = float(h.get("build_pct") or 0.0)
                return (
                    HealthState.STARTING,
                    f"building first snapshot: phase={phase} ({pct:.0%}, "
                    f"{int(h.get('build_rows_ingested') or 0)} rows ingested)",
                )
            return HealthState.STARTING, "first snapshot not built yet"
        if int(h.get("audit_mismatches", 0) or 0) > 0:
            # the one alarm that must never be rationalized away: a
            # sampled live decision diverged from the CPU oracle
            return (
                HealthState.DEGRADED,
                "shadow-parity audit observed device/oracle divergence "
                f"({int(h['audit_mismatches'])} mismatches)",
            )
        if h.get("degraded"):
            return (
                HealthState.DEGRADED,
                "device path failing; serving bit-identical decisions "
                "from the CPU fallback engine",
            )
        if h.get("memory_pressure"):
            # the governor refused the last refresh with every eviction
            # rung spent: answers stay correct but bounded-stale until
            # pressure clears (the staleness budget still escalates to
            # NOT_SERVING above)
            return (
                HealthState.DEGRADED,
                "memory_pressure: HBM budget refused the last snapshot "
                "refresh (eviction ladder spent); serving stale within "
                "the staleness budget",
            )
        return HealthState.SERVING, ""

    def starting_detail(self) -> dict:
        """``{"phase": ..., "pct": ..., "rows_ingested": ...}`` of an
        in-flight first build, or ``{}`` — REST ``/health/ready`` merges
        this into the STARTING body."""
        eng = self._engine
        if eng is None or not hasattr(eng, "health"):
            return {}
        try:
            h = eng.health()
        except Exception:
            return {}
        phase = h.get("build_phase")
        if not phase or phase == "idle":
            return {}
        return {
            "phase": str(phase),
            "pct": round(float(h.get("build_pct") or 0.0), 3),
            "rows_ingested": int(h.get("build_rows_ingested") or 0),
        }

    def _record(self) -> None:
        incr = getattr(self._engine, "_incr", None)
        if incr is not None:
            incr("health_transitions")

    # -- streaming -----------------------------------------------------------

    def watch(self, poll_s: float = 0.2, should_stop: Optional[Callable[[], bool]] = None):
        """Yield ``(state, reason)`` — the current state immediately, then
        one entry per transition. ``should_stop()`` ends the stream."""
        last: Optional[HealthState] = None
        while should_stop is None or not should_stop():
            state, reason = self.status()
            if state != last:
                yield state, reason
                last = state
            time.sleep(poll_s)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """Operator view: state, reason, budget, transition count, and the
        engine's raw health inputs."""
        state, reason = self.status()
        out = {
            "state": state.value,
            "reason": reason,
            "staleness_budget_s": self._budget,
            "transitions": self._transitions,
            "transitions_log": list(self.transitions_log),
        }
        eng = self._engine
        if eng is not None and hasattr(eng, "health"):
            try:
                out["engine"] = eng.health()
            except Exception as e:
                out["engine"] = {"error": str(e)}
        return out
