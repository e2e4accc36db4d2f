"""Watch changefeed: committed tuple deltas, in commit order, resumable.
The port's copy of keto_tpu/list/watch.py.

Every committed transact emits its tuple delta grouped under the
snaptoken it committed at. A subscriber replays from any retained
snaptoken and then tails live commits; messages are COMMIT GROUPS — one
(snaptoken, changes[]) unit per transaction — so resuming from the last
fully-received token is exactly-once by construction (a group is never
split across resume boundaries).

The event source is the store's change logs (the same insert/delete
logs the delta-overlay snapshot path reads), surfaced through the
``watch_changes_since`` Manager seam (keto_tpu_torch/persistence/):
events live as long as the store, and engine-side snapshot
maintenance (compaction, cache reloads) never touches them — a watch
stream rides THROUGH compactions untouched. One documented elision: an
insert whose tuple was later deleted may drop out of replay once the row
is gone (its delete still replays, and applying a delete for an unknown
tuple is a no-op), so a resumed subscriber always reconstructs the exact
final tuple state.

Retention is bounded by the store's log caps and its time-based GC
(``serve.watch_log_retention_s``); resuming from a token
older than the retained horizon raises ``ErrWatchExpired`` (REST 410 /
gRPC OUT_OF_RANGE) — the subscriber re-lists and re-subscribes from the
current snaptoken, the standard changefeed contract.

Liveness is poll-based (``serve.watch_poll_ms``): cheap, and correct
for any store behind the seam. ``close()``
ends every stream promptly; the daemon calls it at the head of the
SIGTERM drain so watch connections never hold the drain window open.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterator, Optional

#: commit-trace entries retained (token -> trace context); bounds the
#: index under write-heavy tenants — a missing entry only omits the
#: optional trace fields from the watch message, never an event
COMMIT_TRACE_CAP = 4096


class WatchHub:
    """Fan-out of the store's change log to streaming subscribers."""

    def __init__(self, store, poll_s: float = 0.1, max_streams: int = 64):
        self._store = store
        self._poll_s = max(0.005, float(poll_s))
        self.max_streams = int(max_streams)
        self._closed = threading.Event()
        self._lock = threading.Lock()  # guards: active_streams, _commit_traces
        #: /metrics bridges read these (keto_watch_* families)
        self.active_streams = 0
        self.events_total = 0
        self.expired_total = 0
        # REPLICATION-AWARE TRACING: the write path registers each
        # commit's traceparent + wall-clock commit time here; the watch
        # serializers attach them to the commit group's message so ONE
        # trace spans primary transact -> watch emit -> replica apply ->
        # 412-gate visibility. Process-local by design: commits from
        # OTHER processes sharing the SQL store simply carry no trace.
        self._commit_traces: OrderedDict[int, tuple[str, float]] = OrderedDict()

    def note_commit_trace(self, token: int, traceparent: str = "") -> None:
        """Record the trace context of the transaction committed at
        ``token`` (called by the REST/gRPC write handlers inside their
        server span; idempotent replays must NOT re-register)."""
        with self._lock:
            self._commit_traces[int(token)] = (traceparent, time.time())
            while len(self._commit_traces) > COMMIT_TRACE_CAP:
                self._commit_traces.popitem(last=False)

    def commit_trace(self, token: int) -> Optional[tuple[str, float]]:
        """``(traceparent, committed_unix)`` of a locally-registered
        commit, or None (foreign/evicted commits)."""
        with self._lock:
            return self._commit_traces.get(int(token))

    def enrich_group(self, token: int, msg: dict) -> dict:
        """Attach the commit's trace fields to a serialized watch
        message: ``traceparent``/``committed_at`` when known, plus
        ``emitted_at`` — the replica tier's replication timeline feeds
        on these (keto_tpu/replica/controller.py; ROADMAP A10)."""
        got = self.commit_trace(token)
        if got is not None:
            tp, committed = got
            if tp:
                msg["traceparent"] = tp
            msg["committed_at"] = round(committed, 6)
        msg["emitted_at"] = round(time.time(), 6)
        return msg

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        """End every subscriber's stream promptly (the SIGTERM drain
        seam): generators observe the flag between poll sleeps and
        return, letting the REST/gRPC drains complete."""
        self._closed.set()

    def try_acquire_stream(self) -> bool:
        """Reserve a stream slot; False past ``max_streams`` (the caller
        sheds 429/RESOURCE_EXHAUSTED)."""
        with self._lock:
            if self.active_streams >= self.max_streams:
                return False
            self.active_streams += 1
            return True

    def release_stream(self) -> None:
        """Return a slot taken with ``try_acquire_stream`` (serving
        layers that own the slot lifecycle)."""
        with self._lock:
            self.active_streams -= 1

    def changes_since(self, since: int) -> tuple[list, int]:
        """One catch-up read: ([(snaptoken, [(action, RelationTuple)])]
        commit groups after ``since``, current watermark). Raises
        ErrWatchExpired when ``since`` predates the retained horizon."""
        from keto_tpu_torch.x.errors import ErrWatchExpired

        try:
            return self._store.watch_changes_since(since)
        except ErrWatchExpired:
            self.expired_total += 1
            raise

    def subscribe(
        self, since: int, *, live: bool = True, own_slot: bool = True
    ) -> Iterator[tuple[int, list]]:
        """Commit groups after snaptoken ``since``, then (with
        ``live=True``) a poll-tail of future commits until ``close()``.
        Each yielded group is ``(snaptoken, [(action, RelationTuple)])``
        with action ``"insert"`` | ``"delete"``.

        ``own_slot=True`` (the default) acquires and releases a stream
        slot here (raising ErrTooManyRequests past ``max_streams``);
        serving layers that must shed BEFORE committing a response status
        acquire the slot themselves and pass ``own_slot=False``."""
        if own_slot and not self.try_acquire_stream():
            from keto_tpu_torch.x.errors import ErrTooManyRequests

            raise ErrTooManyRequests(
                "too many concurrent watch streams; retry with backoff",
                retry_after_s=1.0,
            )
        try:
            cursor = int(since)
            while True:
                groups, wm = self.changes_since(cursor)
                for token, changes in groups:
                    self.events_total += len(changes)
                    yield int(token), changes
                cursor = max(cursor, int(wm))
                if not live:
                    return
                if self._closed.wait(timeout=self._poll_s):
                    return
                # cheap liveness probe before the next full read
                try:
                    if int(self._store.watermark()) <= cursor:
                        continue
                except Exception:
                    continue  # store hiccup: keep polling
        finally:
            if own_slot:
                self.release_stream()

    def snapshot(self) -> dict:
        """Scrape-time view for the /metrics bridges."""
        return {
            "active_streams": self.active_streams,
            "events_total": self.events_total,
            "expired_total": self.expired_total,
        }


def resume_state(groups: Iterator[tuple[int, list]]) -> tuple[dict, Optional[int]]:
    """Test/SDK helper: fold commit groups into the final tuple state —
    ``{tuple-str: RelationTuple}`` — plus the last snaptoken seen.
    Deletes of unknown tuples are no-ops (the documented replay
    elision), so folding any resume point reconstructs the exact store
    state at the last token."""
    state: dict = {}
    last: Optional[int] = None
    for token, changes in groups:
        last = token
        for action, rt in changes:
            if action == "insert":
                state[str(rt)] = rt
            else:
                state.pop(str(rt), None)
    return state, last


__all__ = ["WatchHub", "resume_state"]
