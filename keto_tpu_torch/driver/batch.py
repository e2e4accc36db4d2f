"""Request-coalescing check batcher with priority lanes: a port of
keto_tpu/driver/batch.py (its stream path).

On the card one device program answers thousands of checks, so concurrent
single-check requests are *coalesced*: a caller enqueues its tuples and
blocks on a future; a collector thread drains the lanes up to
``batch_size`` tuples or ``window_ms`` (whichever first) and answers the
round through the engine's ready-order stream
(``batch_check_stream_with_token(ordered=False, with_info=True)``): each
caller's future resolves as soon as the slices holding its tuples have
landed, re-associated by stream offset.

PRIORITY LANES. A single FIFO convoys: one interactive check behind a
64k-wide batch request waits the whole batch's service time. The batcher
keeps two lanes:

- ``interactive`` — single checks and small batches (≤
  ``interactive_max_tuples``): packed into the next round ahead of all
  queued batch work;
- ``batch`` — pre-batched chunks, dispatched in bounded sub-slices (≤
  ``batch_sub_slice`` tuples a round, and no wider than the engine's
  planned slice, ``stream_ctrl.cap()``), taking partial chunks, so a
  monster request interleaves with the interactive lane. A reserve
  (``batch_reserve_share`` of the round) keeps the batch lane moving when
  interactive traffic alone could fill every round.

Lane choice: explicit (``lane=``, from the REST ``X-Keto-Priority``
header) or by size. ADMISSION CONTROL: with an ``AdmissionController``
(keto_tpu_torch/driver/admission.py), batch-lane arrivals beyond its AIMD
window shed with ``ErrTooManyRequests`` (429 + ``Retry-After``) at the
door; in serving mode (``shed_on_full``) a full lane sheds the same way,
and in library mode it blocks the caller up to its deadline. DEADLINES: a
request's absolute deadline rides with it; one that expires while queued
is answered ``ErrDeadlineExceeded`` (504) before it takes a slot in a
slice. The caller's request timeline (keto_tpu_torch/x/timeline.py, bound
on the caller's thread) is stamped at admit, pack, dispatch, every device
slice it rode (the stream's slice info) and land.

Freshness (keto_tpu/driver/batch.py:471-480): the default is the serving
mode (``snapshot_serving``: a delta catches up inline, a rebuild or a fold
never stalls the round); ``at_least`` pins a write's snaptoken and
``latest`` forces read-your-writes. A round asks the engine for the
strongest of its requests.

A failed round fails every unresolved future of the round with its error.
The reference retries the round's unresolved checks once on its CPU
fallback (``_fail_or_retry``); the port has no CPU fallback (ROADMAP, "No
CPU fallback"), so there is nothing to retry on. Left out against the
reference, each with its ROADMAP item: the tenant tag and ``on_shed``
callback of a shed (A9), ``set_engine`` (live reshard, A11), the
``check-dispatch`` fault seam (A10), and the non-stream dispatch for
engines without the stream (no caller here).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import TYPE_CHECKING, Optional, Sequence

from keto_tpu_torch.relationtuple.model import RelationTuple
from keto_tpu_torch.x.errors import ErrDeadlineExceeded, ErrTooManyRequests
from keto_tpu_torch.x.timeline import current_timeline

if TYPE_CHECKING:
    from keto_tpu_torch.driver.admission import AdmissionController

INTERACTIVE = "interactive"
BATCH = "batch"
LANES = (INTERACTIVE, BATCH)


class _Item:
    """One queued request: a single tuple (the common case) or a
    pre-batched chunk. Chunks are consumed in bounded sub-slices across
    rounds; the future resolves once every tuple has a result."""

    __slots__ = (
        "tuples", "fut", "at_least", "latest", "deadline", "lane",
        "results", "taken", "remaining", "tl",
    )

    def __init__(self, tuples, fut, at_least, latest, deadline, lane, tl=None):
        self.tuples = tuples
        self.fut = fut
        self.at_least = at_least
        self.latest = latest
        self.deadline = deadline
        self.lane = lane
        self.results: list = [None] * len(tuples)
        self.taken = 0  # tuples already handed to a round
        self.remaining = len(tuples)  # results not yet filled in
        #: the caller's request timeline, None when recording is off
        self.tl = tl

    @property
    def n(self) -> int:
        return len(self.tuples)


class CheckBatcher:
    def __init__(
        self,
        engine,
        batch_size: int = 4096,
        window_ms: float = 1.0,
        max_pending: Optional[int] = None,
        shed_on_full: bool = False,
        interactive_max_tuples: int = 16,
        batch_sub_slice: Optional[int] = None,
        batch_reserve_share: float = 0.125,
        admission: Optional["AdmissionController"] = None,
    ):
        """``engine`` needs ``batch_check_stream_with_token`` and
        ``stream_ctrl`` (TorchCheckEngine).

        ``max_pending`` bounds each lane's queued tuples (default
        8×batch_size). In library mode a full lane blocks the caller up to
        its own deadline; with ``shed_on_full`` (the serving wiring,
        ``keto_tpu_torch/driver/registry.py``'s ``make_batcher``) it sheds
        at once with ``ErrTooManyRequests``. ``admission`` additionally
        sheds batch-lane arrivals beyond its adaptive window."""
        self._engine = engine
        self._batch_size = batch_size
        self._window_s = window_ms / 1e3
        self._max_pending = max_pending or 8 * batch_size
        self._shed_on_full = shed_on_full
        self._interactive_max_tuples = max(1, interactive_max_tuples)
        self._sub_slice = max(1, batch_sub_slice or max(1, batch_size // 4))
        self._batch_reserve = max(1, int(batch_size * batch_reserve_share))
        self.admission = admission
        self._cond = threading.Condition()  # guards: _lanes, _lane_tuples, _current_round, shed_count, shed_by_lane, admission_shed_count
        self._lanes: dict[str, deque] = {lane: deque() for lane in LANES}
        self._lane_tuples: dict[str, int] = {lane: 0 for lane in LANES}
        #: items taken into the current round (failed promptly by ``stop``
        #: so no caller hangs on a dead collector)
        self._current_round: list[_Item] = []
        #: requests refused at the door (lane full or admission window)
        self.shed_count = 0
        self.shed_by_lane: dict[str, int] = {lane: 0 for lane in LANES}
        #: the admission-window subset of ``shed_count``
        self.admission_shed_count = 0
        #: requests dropped at dispatch because their deadline had passed
        self.deadline_drop_count = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # in-flight accounting for a graceful drain: accepted requests whose
        # futures have not resolved yet (queued or dispatched)
        self._inflight = 0
        self._inflight_lock = threading.Lock()  # guards: _inflight
        self._idle = threading.Event()
        self._idle.set()

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._stop.is_set()

    @property
    def engine(self):
        """The engine the batcher dispatches to."""
        return self._engine

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
        # requests still queued (or stranded in a wedged round) would block
        # their callers for their whole timeout: fail them now
        with self._cond:
            leftovers = []
            for lane in LANES:
                leftovers.extend(self._lanes[lane])
                self._lanes[lane].clear()
                self._lane_tuples[lane] = 0
            leftovers.extend(self._current_round)
            self._cond.notify_all()
        for item in leftovers:
            if not item.fut.done():
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
        deadline: Optional[float] = None,
        lane: Optional[str] = None,
    ) -> bool:
        """Blocking single check, batched with concurrent callers. Serving
        mode unless ``at_least`` or ``latest`` say otherwise."""
        return self.check_with_token(tuple_, timeout, at_least=at_least, latest=latest,
                                     deadline=deadline, lane=lane)[0]

    def check_with_token(
        self,
        tuple_: RelationTuple,
        timeout: Optional[float] = 30.0,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
        deadline: Optional[float] = None,
        lane: Optional[str] = None,
    ) -> tuple[bool, Optional[int]]:
        """``check`` plus the id of the snapshot that decided it.

        ``deadline`` is the request's absolute ``time.monotonic()``
        deadline: a request that expires while queued is shed before it is
        packed, and the caller gets ``ErrDeadlineExceeded`` (504).
        ``timeout`` is the relative cap; the earlier of the two wins.
        ``lane`` pins the priority lane (single checks default to
        interactive)."""
        results, token = self._submit([tuple_], timeout, at_least, latest, deadline,
                                      lane or INTERACTIVE)
        return bool(results[0]), token

    def check_batch(
        self,
        tuples: Sequence[RelationTuple],
        timeout: Optional[float] = None,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
        deadline: Optional[float] = None,
        lane: Optional[str] = None,
    ) -> list[bool]:
        """Pre-batched requests ride the lanes: big chunks land in the batch
        lane and dispatch in bounded sub-slices."""
        return self.check_batch_with_token(tuples, timeout, at_least=at_least, latest=latest,
                                           deadline=deadline, lane=lane)[0]

    def check_batch_with_token(
        self,
        tuples: Sequence[RelationTuple],
        timeout: Optional[float] = None,
        *,
        at_least: Optional[int] = None,
        latest: bool = False,
        deadline: Optional[float] = None,
        lane: Optional[str] = None,
    ) -> tuple[list[bool], Optional[int]]:
        tuples = list(tuples)
        if not tuples:
            return [], None
        if lane is None:
            lane = self.classify_lane(len(tuples), None)
        results, token = self._submit(tuples, timeout, at_least, latest, deadline, lane)
        return [bool(r) for r in results], token

    def classify_lane(self, n_tuples: int, hint: Optional[str]) -> str:
        """An explicit hint wins, else size decides (≤
        ``interactive_max_tuples`` → interactive)."""
        if hint in LANES:
            return hint
        return INTERACTIVE if n_tuples <= self._interactive_max_tuples else BATCH

    def admission_precheck(self, lane: str = BATCH) -> None:
        """Cheap early shed: raise ``ErrTooManyRequests`` when the batch
        lane is already over its admitted window. The REST layer calls this
        before decoding a batch payload, so a refusal costs microseconds,
        not a 64k-tuple JSON parse."""
        if lane != BATCH or self.admission is None:
            return
        with self._cond:
            self.admission.tick(backlog=self._lane_tuples[BATCH])
            if self._lane_tuples[BATCH] >= self.admission.window:
                raise self._shed(
                    lane, True,
                    "batch lane over the admitted window (server near its "
                    "latency budget); retry after the advised backoff",
                )

    # -- enqueue -------------------------------------------------------------

    def _submit(self, tuples, timeout, at_least, latest, deadline, lane):
        if self._stop.is_set():
            raise RuntimeError("check batcher stopped")
        if lane not in LANES:
            raise ValueError(f"unknown priority lane {lane!r} (expected {LANES})")
        if timeout is not None:
            t_deadline = time.monotonic() + timeout
            deadline = t_deadline if deadline is None else min(deadline, t_deadline)
        if deadline is not None and time.monotonic() >= deadline:
            raise ErrDeadlineExceeded("deadline expired before the check was queued")
        # the timeline is read HERE, on the caller's thread; the collector
        # only ever stamps the item's own
        item = _Item(tuples, Future(), at_least, latest, deadline, lane, tl=current_timeline())
        self._enqueue(item)
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - time.monotonic())
        try:
            return item.fut.result(timeout=remaining)
        except FutureTimeout:
            raise ErrDeadlineExceeded("deadline expired waiting for the check result") from None

    def _shed(self, lane: str, admission: bool, message: str) -> ErrTooManyRequests:  # holds: _cond
        self.shed_count += 1
        self.shed_by_lane[lane] += 1
        if admission:
            self.admission_shed_count += 1
        retry_after = self.admission.retry_after_s() if self.admission is not None else 1.0
        return ErrTooManyRequests(message, retry_after_s=retry_after)

    def _enqueue(self, item: _Item) -> None:
        lane, n = item.lane, item.n
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("check batcher stopped")
            if lane == BATCH and self.admission is not None:
                self.admission.tick(backlog=self._lane_tuples[BATCH])
                if self._lane_tuples[BATCH] + n > self.admission.window:
                    if item.tl is not None:
                        item.tl.stamp("shed", lane=lane, why="admission")
                    raise self._shed(
                        lane, True,
                        "batch lane over the admitted window (server near its "
                        "latency budget); retry after the advised backoff",
                    )
            cap = self._max_pending
            if self._shed_on_full:
                # serving mode: a full lane answers 429 now. An oversized
                # chunk is still admitted into an EMPTY lane (the sub-slice
                # split serves it in bounded rounds)
                if self._lane_tuples[lane] + n > cap and self._lane_tuples[lane] > 0:
                    if item.tl is not None:
                        item.tl.stamp("shed", lane=lane, why="queue-full")
                    raise self._shed(
                        lane, False, "check queue full (device backlogged); retry with backoff"
                    )
            else:
                # library mode: a full lane blocks the caller against the
                # same deadline the result wait uses; a deadline that
                # expires here is a 504, not a queue-full error
                while self._lane_tuples[lane] + n > cap and self._lane_tuples[lane] > 0:
                    if self._stop.is_set():
                        raise RuntimeError("check batcher stopped")
                    if item.deadline is not None:
                        remaining = item.deadline - time.monotonic()
                        if remaining <= 0:
                            raise ErrDeadlineExceeded(
                                "deadline expired while blocked on a full check queue"
                            )
                        self._cond.wait(timeout=min(remaining, 0.25))
                    else:
                        self._cond.wait(timeout=0.25)
            self._lanes[lane].append(item)
            self._lane_tuples[lane] += n
            if item.tl is not None:
                item.tl.stamp("admit", lane=lane)
            self._cond.notify_all()
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()
        item.fut.add_done_callback(self._note_done)
        if self._stop.is_set() and not item.fut.done():
            # raced with stop()'s drain: nobody will serve the queue anymore
            try:
                item.fut.set_exception(RuntimeError("check batcher stopped"))
            except InvalidStateError:
                pass  # the collector resolved it; return that result

    # -- graceful drain ------------------------------------------------------

    def _note_done(self, _fut) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    @property
    def inflight(self) -> int:
        """Accepted check requests whose futures have not resolved yet."""
        with self._inflight_lock:
            return self._inflight

    @property
    def queue_depth(self) -> int:
        """Tuples queued across both lanes, not yet packed into a round."""
        with self._cond:
            return sum(self._lane_tuples.values())

    @property
    def lane_depths(self) -> dict[str, int]:
        """Queued tuples per lane."""
        with self._cond:
            return dict(self._lane_tuples)

    @property
    def max_pending(self) -> int:
        """Per-lane queue capacity."""
        return self._max_pending

    def drain(self, timeout_s: float) -> bool:
        """Wait until every in-flight request has been answered (the
        shutdown drain). True when the batcher went idle within
        ``timeout_s``."""
        return self._idle.wait(timeout=max(0.0, timeout_s))

    # -- dispatch ------------------------------------------------------------

    @staticmethod
    def _consistency_kw(at_leasts, latests) -> dict:
        """The strongest requested freshness wins (a fresher snapshot
        satisfies every weaker requirement in the round)."""
        if any(latests):
            return {"mode": "latest"}
        floors = [a for a in at_leasts if a is not None]
        return {"at_least": max(floors) if floors else None, "mode": "serving"}

    def _expire(self, item: _Item) -> None:
        self.deadline_drop_count += 1
        if not item.fut.done():
            try:
                item.fut.set_exception(ErrDeadlineExceeded("deadline expired before dispatch"))
            except InvalidStateError:
                pass

    def _fill(self, item: _Item, idx: int, allowed: bool, token) -> None:
        if item.results[idx] is None:
            item.results[idx] = allowed
            item.remaining -= 1
        if item.remaining == 0 and not item.fut.done():
            if item.tl is not None:
                item.tl.stamp("land")  # every tuple has its decision
            try:
                item.fut.set_result((item.results, token))
            except InvalidStateError:
                pass  # expired or failed concurrently

    def _dispatch_stream(self, segments, at_leasts, latests) -> None:
        """The round through the engine's ready-order stream
        (``ordered=False``): each caller's future resolves the moment its
        last slice lands, re-associated by stream offset. Expired items are
        shed as the stream pulls them, before they take a slot; each landed
        slice's info (width, BFS steps, route, service time) is stamped on
        every distinct rider's timeline as its ``device`` stage."""
        emitted: list = []  # stream offset -> (item, idx), built at pull time

        def live_tuples():
            for item, start, count in segments:
                if item.fut.done():
                    continue
                if item.deadline is not None and time.monotonic() >= item.deadline:
                    self._expire(item)
                    continue
                if item.tl is not None:
                    item.tl.stamp("dispatch")
                for idx in range(start, start + count):
                    emitted.append((item, idx))
                    yield item.tuples[idx]

        gen, token = self._engine.batch_check_stream_with_token(
            live_tuples(), ordered=False, with_info=True,
            **self._consistency_kw(at_leasts, latests),
        )
        for off, out, info in gen:
            # the device stamp precedes land in each timeline; a slice's
            # riders are contiguous, so dedup against the previous one
            prev = None
            for j in range(len(out)):
                item = emitted[off + j][0]
                if item is not prev and item.tl is not None:
                    item.tl.stamp("device", **info)
                prev = item
            for j, allowed in enumerate(out.tolist()):
                item, idx = emitted[off + j]
                self._fill(item, idx, bool(allowed), token)

    # -- collector -----------------------------------------------------------

    def _queued(self) -> int:
        return self._lane_tuples[INTERACTIVE] + self._lane_tuples[BATCH]

    def _take_locked(self) -> list:  # holds: _cond
        """Pack one round: interactive items first — every one rides the
        next round — then batch-lane work up to ``batch_sub_slice`` and the
        engine's planned slice width, taking partial chunks. A reserve
        keeps the batch lane moving when interactive traffic alone could
        fill every round. Returns ``[(item, start, count), ...]``."""
        segments = []
        n = 0
        cap = self._batch_size
        inter, batchq = self._lanes[INTERACTIVE], self._lanes[BATCH]
        reserve = self._batch_reserve if batchq else 0
        inter_cap = max(1, cap - reserve)
        while inter and n < inter_cap:
            item = inter.popleft()
            self._lane_tuples[INTERACTIVE] -= item.n
            if item.fut.done():
                continue  # expired or failed while queued
            segments.append((item, 0, item.n))
            item.taken = item.n
            if item.tl is not None:
                item.tl.stamp("pack")  # the queue wait ended here
            n += item.n
        # a batch sub-slice wider than the slice the engine plans would be
        # split by the engine anyway: bound the round here, so the next
        # interactive round comes sooner
        batch_cap = min(cap - n, self._sub_slice, max(1, int(self._engine.stream_ctrl.cap())))
        while batchq and batch_cap > 0:
            head = batchq[0]
            if head.fut.done():
                batchq.popleft()
                self._lane_tuples[BATCH] -= head.n - head.taken
                continue
            take = min(batch_cap, head.n - head.taken)
            segments.append((head, head.taken, take))
            if head.tl is not None and head.taken == 0:
                head.tl.stamp("pack")  # first sub-slice: the queue wait ended
            head.taken += take
            self._lane_tuples[BATCH] -= take
            batch_cap -= take
            n += take
            if head.taken == head.n:
                batchq.popleft()
        return segments

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if not self._queued():
                    # bounded wait so stop() always ends the loop
                    self._cond.wait(timeout=0.25)
                    if not self._queued():
                        continue
                # coalescing window: wait for more arrivals up to window_ms
                # or a full round
                window_end = time.monotonic() + self._window_s
                while self._queued() < self._batch_size and not self._stop.is_set():
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                segments = self._take_locked()
                self._current_round = [item for item, _, _ in segments]
                backlog = self._lane_tuples[BATCH]
                # space freed: wake producers blocked on a full lane
                self._cond.notify_all()
            if not segments:
                continue
            if self.admission is not None:
                self.admission.tick(backlog=backlog)
            n_tuples = sum(count for _, _, count in segments)
            t0 = time.monotonic()
            try:
                self._dispatch_stream(
                    segments,
                    [item.at_least for item, _, _ in segments],
                    [item.latest for item, _, _ in segments],
                )
            except Exception as e:
                # no CPU fallback to retry on: every unresolved rider fails
                for item, _, _ in segments:
                    if not item.fut.done():
                        try:
                            item.fut.set_exception(e)
                        except InvalidStateError:
                            pass
            finally:
                if self.admission is not None:
                    self.admission.observe_round(n_tuples, time.monotonic() - t0)
                with self._cond:
                    self._current_round = []
