"""The explain engine: decision + witness + verification + audit record.

A port of keto_tpu/explain/engine.py. ``ExplainEngine.explain`` answers
"why" for one Check:

1. **Decide** through the serving engine itself — ``TorchCheckEngine``'s
   stream with ``with_info=True``, so the route that really decided
   (label / hybrid / bfs / host) is reported, not re-derived — or the
   recursive oracle (keto_tpu_torch/check/engine.py), reported as ``cpu``.
2. **Reconstruct** the witness: device routes back-trace the subject-set
   closure against the Manager (``build_witness``: BFS with parent
   pointers, a shortest path); the cpu route threads the oracle's own
   traversal (``oracle_witness``). Denies carry the BFS's
   frontier-exhaustion certificate.
3. **Verify** edge by edge against the Manager before returning. A
   witness that fails verification is a bug: counted
   (``verify_failures``), kept in ``recent_failures``, handed to
   ``on_verify_failure``, and the response falls back to the oracle's
   witness.
4. **Enrich** label- and hybrid-route grants with the winning landmark of
   the 2-hop intersection (``TorchCheckEngine.label_witness_info``, K4 on
   the card). Unlike the reference, which turns an error there into "no
   landmark", an error propagates to the caller.
5. **Record** every explain in the decision log when one is configured,
   witness included.

None of this runs on the check hot path: explain is its own endpoint, and
the hot path's decision-log sample is a separate, witness-free record
(keto_tpu_torch/servers/rest.py).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from keto_tpu_torch.explain.decision_log import DecisionLog
from keto_tpu_torch.explain.witness import (
    DEFAULT_MAX_HEADS,
    build_witness,
    oracle_witness,
    verify_witness,
)
from keto_tpu_torch.relationtuple.manager import Manager
from keto_tpu_torch.relationtuple.model import RelationTuple

_log = logging.getLogger("keto_tpu_torch.explain")


class ExplainEngine:
    def __init__(
        self,
        engine: Any,
        manager: Manager,
        *,
        decision_log: Optional[DecisionLog] = None,
        page_size: int = 0,
        max_heads: int = DEFAULT_MAX_HEADS,
        on_verify_failure: Optional[Callable[[dict[str, Any]], None]] = None,
        decide: Optional[Callable[..., tuple[bool, str, Optional[int]]]] = None,
    ):
        self._engine = engine
        self._manager = manager
        #: optional decide override (tests inject wrong decisions with it)
        self._decide_fn = decide
        self._decision_log = decision_log
        self._page_size = page_size
        self._max_heads = max_heads
        self._on_verify_failure = on_verify_failure
        self._lock = threading.Lock()
        #: per-route request counts
        self.requests_by_route: dict[str, int] = {}
        #: witnesses that failed edge-by-edge verification — each one is a
        #: bug in the producing route
        self.verify_failures = 0
        #: recent verify failures
        self.recent_failures: deque = deque(maxlen=8)

    # -- decision -------------------------------------------------------------

    def _decide(self, rt: RelationTuple, at_least) -> tuple[bool, str, Optional[int]]:
        if self._decide_fn is not None:
            return self._decide_fn(rt, at_least)
        return self.decide_with(self._engine, self._manager, rt, at_least)

    @staticmethod
    def decide_with(
        eng: Any, manager: Manager, rt: RelationTuple, at_least
    ) -> tuple[bool, str, Optional[int]]:
        """One check through ``eng``, returning ``(allowed, route,
        snaptoken)`` with the route that actually decided it: the stream's
        ``with_info`` route for an engine that streams (``STREAM_INFO``),
        ``cpu`` for the oracle."""
        if getattr(eng, "STREAM_INFO", False):
            allowed = False
            route = "host"
            gen, token = eng.batch_check_stream_with_token(
                [rt], at_least=at_least, ordered=False, with_info=True
            )
            for _off, out, info in gen:
                allowed = bool(np.asarray(out).reshape(-1)[0])
                route = str(info.get("route", route))
            return allowed, route, token
        allowed = bool(eng.subject_is_allowed(rt))
        return allowed, "cpu", int(manager.watermark())

    # -- explain --------------------------------------------------------------

    def explain(
        self,
        requested: RelationTuple,
        *,
        at_least=None,
        trace_id: str = "",
        tenant: str = "default",
    ) -> dict[str, Any]:
        """Decide + reconstruct + verify + record; returns the response
        body of ``GET /check/explain``."""
        allowed, route, token = self._decide(requested, at_least)
        with self._lock:
            self.requests_by_route[route] = self.requests_by_route.get(route, 0) + 1

        path = None
        certificate = None
        witness_source = ""
        divergence = False

        if route == "cpu":
            # the oracle decided; its own traversal IS the witness
            path = oracle_witness(self._manager, requested, page_size=self._page_size)
            witness_source = "oracle"
            if allowed != (path is not None):
                divergence = True
            if path is None and not allowed:
                _, _, certificate = build_witness(
                    self._manager,
                    requested,
                    page_size=self._page_size,
                    max_heads=self._max_heads,
                )
        else:
            found, path, certificate = build_witness(
                self._manager,
                requested,
                page_size=self._page_size,
                max_heads=self._max_heads,
            )
            witness_source = "backtrace"
            if found != allowed:
                # the device route and the store-closure back-trace disagree:
                # a real bug, surfaced loudly
                divergence = True

        verified = False
        if allowed:
            ok, reason = (
                verify_witness(self._manager, requested, path)
                if path
                else (False, "no witness path found for an allowed decision")
            )
            if not ok:
                self._note_failure(requested, route, tenant, path, reason)
                path = oracle_witness(self._manager, requested, page_size=self._page_size)
                witness_source = "oracle-fallback"
                if path:
                    ok, _ = verify_witness(self._manager, requested, path)
            verified = bool(ok and path)
        elif divergence:
            # denied by the engine while the closure holds a path: counted
            # like a verify failure, the same class of bug
            self._note_failure(requested, route, tenant, path, "engine denied but closure grants")
            certificate = None

        witness = [t.to_json() for t in path] if path else None
        resp: dict[str, Any] = {
            "allowed": allowed,
            "route": route,
            "snaptoken": str(token) if token is not None else "",
            "tuple": requested.to_json(),
            "witness": witness,
            "certificate": certificate,
            "verified": verified,
            "witness_source": witness_source if path else "",
        }
        if divergence:
            resp["decision_divergence"] = True
        if allowed and route in ("label", "hybrid"):
            lw = getattr(self._engine, "label_witness_info", None)
            if lw is not None:
                landmark = lw(requested, at_least=at_least)
                if landmark:
                    resp["landmark"] = landmark

        dl = self._decision_log
        if dl is not None:
            # explain calls are explicit audit actions: always recorded
            dl.record(
                tenant,
                {
                    "kind": "explain",
                    "tuple": requested.to_json(),
                    "decision": allowed,
                    "route": route,
                    "witness": witness,
                    "certificate": certificate,
                    "snaptoken": resp["snaptoken"],
                    "trace_id": trace_id,
                },
            )
        return resp

    def _note_failure(
        self,
        requested: RelationTuple,
        route: str,
        tenant: str,
        path,
        reason: str,
    ) -> None:
        with self._lock:
            self.verify_failures += 1
            note = {
                "tuple": str(requested),
                "route": route,
                "tenant": tenant,
                "reason": reason,
                "witness": [str(t) for t in path] if path else None,
            }
            self.recent_failures.append(note)
        cb = self._on_verify_failure
        if cb is not None:
            try:
                cb(note)
            except Exception:  # the callback only reports: its fault must not fail the explain
                _log.exception("on_verify_failure callback failed")
