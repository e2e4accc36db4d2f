"""Group-commit coordinator: many writers, one store transaction.

A copy of keto_tpu/driver/group_commit.py (``GroupCommitCoordinator`` and
``_Slot``, :45-239). The write-side sibling of the check batcher
(keto_tpu_torch/driver/batch.py): concurrent writers enqueue their
(insert, delete, idempotency_key) intents, a collector thread coalesces
them for up to ``window_ms`` (2.0) or ``max_writers`` (128), and ONE
``Manager.transact_many`` call commits the whole group
(keto_tpu_torch/persistence/memory.py: one lock hold). The defaults are
the reference's (keto_tpu/config/schema.py:128-146).

Per-writer semantics are untouched: each writer receives its own
snaptoken from the group's commit sequence and its own replayable
idempotency key.

Failure semantics: a store error fails EVERY writer in the group with
the same exception — the callers retry individually (keyed retries
dedup), exactly as if their solo transactions had all hit the same
outage. A writer whose own input the store refuses (``transact_many``
puts its exception in its place) fails alone, and the rest of its group
commits; the reference fails the whole group with that one writer's
error. Backpressure is blocking, not shedding: a write has no cheap
"try again" answer, so past ``max_pending`` (4,096) queued writers the
enqueue waits (bounded by the caller's timeout) instead of 429ing.
``stop()`` fails the writers left over.

``wait_histogram`` and ``batch_histogram`` (keto_tpu_torch/x/metrics.py)
record each writer's queued seconds and each group's writer count; the
``keto_group_commit_flush_total`` and ``_errors_total`` bridges read
``flush_total`` and ``flush_errors``
(keto_tpu_torch/driver/observability.py). Each acknowledged write's
commit group reaches the Watch changefeed from the store's change logs; the
REST write routes register its traceparent with the watch hub
(keto_tpu_torch/servers/rest.py ``_note_commit``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional, Sequence

from keto_tpu_torch.relationtuple.manager import TransactResult, TransactWrite

_log = logging.getLogger("keto_tpu_torch.driver.group_commit")


class GroupCommitCoordinator:
    """Batches concurrent ``transact`` calls into ``transact_many``
    groups. Start with :meth:`start`; stop via :meth:`stop` (fails
    leftover writers) after :meth:`drain` (waits for quiesce)."""

    def __init__(
        self,
        store,
        *,
        max_writers: int = 128,
        window_ms: float = 2.0,
        max_pending: int = 4096,
        wait_histogram=None,
        batch_histogram=None,
    ):
        self._store = store
        self._max_writers = max(1, int(max_writers))
        self._window_s = max(0.0, float(window_ms)) / 1e3
        self._max_pending = max(self._max_writers, int(max_pending))
        self._wait_hist = wait_histogram
        self._batch_hist = batch_histogram
        self._cond = threading.Condition()
        self._queue: deque = deque()  # (TransactWrite, _Slot)
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        self._inflight = 0
        #: groups committed (keto_group_commit_flush_total)
        self.flush_total = 0
        #: writers committed across all groups (avg batch size =
        #: writers_total / flush_total)
        self.writers_total = 0
        #: size of the most recent group (keto_group_commit_batch_size
        #: gauge peek)
        self.last_batch_size = 0
        #: groups that failed (every writer saw the error)
        self.flush_errors = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="group-commit", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the collector; leftover queued writers fail with a
        RuntimeError (the daemon drains before stopping, so a leftover
        here means the drain window expired)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self._idle.set()
        for slot in leftovers:
            slot.fail(RuntimeError("group-commit coordinator stopped"))

    def drain(self, timeout_s: float) -> bool:
        """Wait until no writer is queued or inflight (daemon shutdown
        sequencing). True when quiesced within the window."""
        return self._idle.wait(timeout=max(0.0, timeout_s))

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight + len(self._queue)

    # -- write path ----------------------------------------------------------

    def transact(
        self,
        insert: Sequence,
        delete: Sequence,
        idempotency_key: Optional[str] = None,
        timeout_s: float = 30.0,
    ) -> Optional[TransactResult]:
        """Enqueue one writer's intent and block until its group
        commits. Raises this writer's own refusal, whatever the group's
        ``transact_many`` raised, or TimeoutError when the result misses
        ``timeout_s``."""
        slot = _Slot(
            TransactWrite(
                insert=tuple(insert),
                delete=tuple(delete),
                idempotency_key=idempotency_key,
            )
        )
        deadline = time.monotonic() + timeout_s
        with self._cond:
            if self._stopping:
                raise RuntimeError("group-commit coordinator stopped")
            # blocking backpressure: a write has no sheddable answer
            while len(self._queue) >= self._max_pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopping:
                    raise TimeoutError("group-commit queue full")
                self._cond.wait(min(remaining, 0.1))
            self._queue.append(slot)
            self._idle.clear()
            self._cond.notify_all()
        return slot.wait(deadline)

    # -- collector -----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._idle.set()
                    self._cond.wait(0.05)
                if self._stopping:
                    return  # stop() fails whatever is left
                self._idle.clear()
                # coalescing window: wait (bounded) for more writers,
                # flush at the size cap or the latency deadline —
                # whichever lands first
                if self._window_s > 0:
                    deadline = time.monotonic() + self._window_s
                    while (
                        len(self._queue) < self._max_writers
                        and not self._stopping
                    ):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                n = min(len(self._queue), self._max_writers)
                batch = [self._queue.popleft() for _ in range(n)]
                self._inflight += n
                self._cond.notify_all()  # wake backpressured enqueuers
            if batch:
                self._commit(batch)
            with self._cond:
                self._inflight -= len(batch)
                if not self._queue and self._inflight == 0:
                    self._idle.set()

    def _commit(self, batch: list) -> None:
        start = time.monotonic()
        if self._wait_hist is not None:
            for slot in batch:
                self._wait_hist.observe(value=start - slot.enqueued_at)
        try:
            results = self._store.transact_many([s.write for s in batch])
        except Exception as e:  # noqa: BLE001 — forwarded to every writer
            self.flush_errors += 1
            for slot in batch:
                slot.fail(e)
            return
        self.flush_total += 1
        self.writers_total += len(batch)
        self.last_batch_size = len(batch)
        if self._batch_hist is not None:
            self._batch_hist.observe(value=float(len(batch)))
        for slot, result in zip(batch, results):
            if isinstance(result, BaseException):
                slot.fail(result)
            else:
                slot.resolve(result)


class _Slot:
    """One writer's parked result: event + cell (lighter than a Future,
    and immune to InvalidStateError races on shutdown)."""

    __slots__ = ("write", "enqueued_at", "_done", "_result", "_exc")

    def __init__(self, write: TransactWrite):
        self.write = write
        self.enqueued_at = time.monotonic()
        self._done = threading.Event()
        self._result: Optional[TransactResult] = None
        self._exc: Optional[BaseException] = None

    def resolve(self, result) -> None:
        self._result = result
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        if not self._done.is_set():
            self._exc = exc
            self._done.set()

    def wait(self, deadline: float) -> Optional[TransactResult]:
        if not self._done.wait(timeout=max(0.0, deadline - time.monotonic())):
            raise TimeoutError("group commit timed out")
        if self._exc is not None:
            raise self._exc
        return self._result
