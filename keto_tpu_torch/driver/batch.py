"""Request-coalescing check batcher: a lean port of keto_tpu/driver/batch.py.

On the card one device program answers thousands of checks, so concurrent
single-check requests are *coalesced*: a caller enqueues its tuples and
blocks on a future; a collector thread drains the queue up to
``batch_size`` tuples or ``window_ms`` (whichever first) and answers the
round through the engine's ready-order stream (keto_tpu/driver/batch.py:
533-580): each caller's future resolves as soon as the slices holding its
tuples have landed, and a round is bounded by the engine's planned slice
width (``stream_ctrl.cap()``, batch.py:611-625). A failed dispatch fails
every request of the round; there is no retry (the reference retries on
its CPU fallback, which the port does not have).

Freshness (keto_tpu/driver/batch.py:214-290, :472-480): the default is the
serving mode (``snapshot_serving``: a delta catches up inline, a rebuild or
a fold never stalls the round); ``at_least`` pins a write's snaptoken and
``latest`` forces read-your-writes. A round asks the engine for the
strongest of its requests: ``latest`` if any asked for it, else the highest
``at_least``.

Left out against the reference batcher: priority lanes (and with them the
batch lane's partial chunks: a round takes whole requests, at least one),
admission control, deadline shedding before dispatch and request
timelines.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional, Sequence

from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.x.errors import ErrDeadlineExceeded


class _Item:
    """One queued request: its tuples, its freshness, its future and, on
    the stream, the decisions landed so far."""

    __slots__ = ("tuples", "fut", "at_least", "latest", "results", "left")

    def __init__(self, tuples, fut, at_least=None, latest=False):
        self.tuples = tuples
        self.fut = fut
        self.at_least = at_least
        self.latest = latest
        self.results = [False] * len(tuples)
        self.left = len(tuples)


class CheckBatcher:
    def __init__(self, engine, batch_size: int = 4096, window_ms: float = 1.0):
        """``engine`` needs ``batch_check_stream_with_token`` and
        ``stream_ctrl`` (TorchCheckEngine)."""
        self._engine = engine
        self._batch_size = batch_size
        self._window_s = window_ms / 1e3
        self._cond = threading.Condition()
        self._queue: deque[_Item] = deque()  # guarded by _cond
        self._queued_tuples = 0  # guarded by _cond
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._stop.is_set()

    def start(self) -> None:
        if self._thread:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="check-batcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        # fail whatever is still queued promptly instead of letting callers
        # wait out their timeouts
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self._queued_tuples = 0
        for item in leftovers:
            try:
                item.fut.set_exception(RuntimeError("check batcher stopped"))
            except InvalidStateError:
                pass

    # -- API -----------------------------------------------------------------

    def check(
        self,
        tuple_: RelationTuple,
        timeout: Optional[float] = 30.0,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> bool:
        """Blocking single check, transparently batched with concurrent
        callers. Serving mode unless ``at_least`` or ``latest`` say
        otherwise."""
        return self.check_with_token(tuple_, timeout, at_least=at_least, latest=latest)[0]

    def check_with_token(
        self,
        tuple_: RelationTuple,
        timeout: Optional[float] = 30.0,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> tuple[bool, Optional[int]]:
        """``check`` plus the id of the snapshot that decided it."""
        results, token = self._submit([tuple_], timeout, at_least, latest)
        return bool(results[0]), token

    def check_batch(
        self,
        tuples: Sequence[RelationTuple],
        timeout: Optional[float] = None,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> list[bool]:
        return self.check_batch_with_token(tuples, timeout, at_least=at_least, latest=latest)[0]

    def check_batch_with_token(
        self,
        tuples: Sequence[RelationTuple],
        timeout: Optional[float] = None,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
    ) -> tuple[list[bool], Optional[int]]:
        tuples = list(tuples)
        if not tuples:
            return [], None
        results, token = self._submit(tuples, timeout, at_least, latest)
        return [bool(r) for r in results], token

    def _submit(self, tuples, timeout, at_least=None, latest=False):
        if self._stop.is_set() or self._thread is None:
            raise RuntimeError("check batcher is not running")
        item = _Item(tuples, Future(), at_least, latest)
        with self._cond:
            self._queue.append(item)
            self._queued_tuples += len(tuples)
            self._cond.notify_all()
        try:
            return item.fut.result(timeout=timeout)
        except FutureTimeout:
            raise ErrDeadlineExceeded("deadline expired waiting for the check result") from None

    @staticmethod
    def _consistency_kw(items) -> dict:
        """The engine arguments for one round: the strongest freshness any
        of its requests asked for."""
        if any(it.latest for it in items):
            return {"mode": "latest"}
        floors = [it.at_least for it in items if it.at_least is not None]
        return {"at_least": max(floors) if floors else None, "mode": "serving"}

    # -- dispatch ------------------------------------------------------------

    def _take_locked(self) -> list[_Item]:  # holds: _cond
        """Whole requests (at least one) up to ``batch_size`` tuples,
        bounded by the engine's planned slice width: a wider round would be
        split by the engine anyway."""
        items: list[_Item] = []
        n = 0
        cap = min(self._batch_size, max(1, int(self._engine.stream_ctrl.cap())))
        while self._queue and (not items or n + len(self._queue[0].tuples) <= cap):
            it = self._queue.popleft()
            items.append(it)
            n += len(it.tuples)
        self._queued_tuples -= n
        return items

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if not self._queue:
                    # bounded wait so stop() always terminates the loop
                    self._cond.wait(timeout=0.25)
                    if not self._queue:
                        continue
                # coalescing window: wait for more arrivals up to window_ms
                # or a full round
                window_end = time.monotonic() + self._window_s
                while self._queued_tuples < self._batch_size and not self._stop.is_set():
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                items = self._take_locked()
            if not items:
                continue
            try:
                self._dispatch_stream(items)
            except Exception as e:
                for it in items:
                    try:
                        it.fut.set_exception(e)
                    except InvalidStateError:
                        pass

    def _dispatch_stream(self, items) -> None:
        """The round through the engine's ready-order stream
        (``ordered=False``): results re-associate by stream offset, and
        each request's future resolves the moment its last slice lands."""
        emitted: list = []  # stream offset -> (item, index), built as tuples are pulled

        def live_tuples():
            for item in items:
                if item.fut.done():
                    continue
                for idx, t in enumerate(item.tuples):
                    emitted.append((item, idx))
                    yield t

        gen, token = self._engine.batch_check_stream_with_token(
            live_tuples(), ordered=False, **self._consistency_kw(items)
        )
        for off, out in gen:
            for j, allowed in enumerate(out.tolist()):
                item, idx = emitted[off + j]
                item.results[idx] = bool(allowed)
                item.left -= 1
                if item.left == 0:
                    try:
                        item.fut.set_result((item.results, token))
                    except InvalidStateError:
                        pass
