"""Supervised maintenance worker: a copy of keto_tpu/x/supervise.py.

One persistent daemon thread per maintenance concern that waits for
``kick()``, runs its target, and on a crash logs it, hands the exception to
``on_error``, counts it into ``stats`` (``<name>_failures``) and retries
with jittered exponential backoff until a pass
succeeds. Kicks during a running pass coalesce into exactly one follow-up
pass. ``wait_idle()`` blocks until no pass is running or owed, which is
how tests and ``chip_smoke.py`` wait for a background fold.

The engine keeps the error of a failed pass and raises it from the next
check (keto_tpu_torch/check/gpu_engine.py): the worker retries, but never
hides the failure. The health state machine (keto_tpu_torch/driver/
health.py) reads ``alive()``, ``crashes``, ``consecutive_failures`` and
``last_error``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

_log = logging.getLogger("keto_tpu_torch.supervise")


class SupervisedTask:
    def __init__(
        self,
        name: str,
        target: Callable[[], None],
        *,
        on_error: Optional[Callable[[Exception], None]] = None,
        stats=None,
        quiet: Optional[Callable[[Exception], bool]] = None,
        base_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
    ):
        self.name = name
        self._target = target
        self._on_error = on_error
        # a MaintenanceStats-shaped sink (``incr(key)``): every failed pass
        # counts under ``<name>_failures`` (keto_tpu/x/supervise.py:46-52)
        self._stats = stats
        self._counter_key = name.replace("-", "_") + "_failures"
        # failures expected while a condition lasts (a refused refresh under
        # memory pressure) log one line, not a traceback a retry
        self._quiet = quiet
        self._base_s = base_backoff_s
        self._max_s = max_backoff_s
        self._attempt = 0
        self._cond = threading.Condition()
        self._kicked = False  # guarded by _cond
        self._running = False  # guarded by _cond
        self._stop = False  # guarded by _cond
        self._retry_at: Optional[float] = None  # guarded by _cond
        self._thread: Optional[threading.Thread] = None
        self.crashes = 0
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None

    def start(self) -> None:
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name=f"keto-torch-{self.name}", daemon=True
            )
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    def alive(self) -> bool:
        """True when the worker can still make progress: running, or never
        needed yet. False means the worker thread itself died."""
        t = self._thread
        return True if t is None else t.is_alive()

    def kick(self) -> None:
        """Request one pass (starts the worker on first use)."""
        self.start()
        with self._cond:
            self._kicked = True
            self._cond.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no pass is running or owed (a failed pass's retry
        does not count: its error is the owner's to raise). Returns False
        on timeout."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._running or self._kicked:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(timeout=left if left is not None else 0.5)
            return True

    def _backoff(self) -> float:
        raw = min(self._base_s * (2.0 ** self._attempt), self._max_s)
        self._attempt += 1
        return raw * random.uniform(0.75, 1.25)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._kicked and (
                    self._retry_at is None or time.monotonic() < self._retry_at
                ):
                    wait = None if self._retry_at is None else self._retry_at - time.monotonic()
                    self._cond.wait(timeout=wait)
                if self._stop:
                    self._retry_at = None
                    self._cond.notify_all()
                    return
                # clear before running: a kick that lands mid-pass owes
                # exactly one more pass
                self._kicked = False
                self._retry_at = None
                self._running = True
            try:
                self._target()
            except Exception as e:  # counted, kept by the owner, retried
                self.crashes += 1
                self.consecutive_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                if self._stats is not None:
                    self._stats.incr(self._counter_key)
                if self._on_error is not None:
                    self._on_error(e)
                delay = self._backoff()
                quiet = self._quiet is not None and self._quiet(e)
                _log.warning("%s maintenance pass failed (crash #%d, retry in %.2fs)%s",
                             self.name, self.crashes, delay, f": {e}" if quiet else "",
                             exc_info=not quiet)
                with self._cond:
                    self._retry_at = time.monotonic() + delay
            else:
                self._attempt = 0
                self.consecutive_failures = 0
                self.last_error = None
            finally:
                with self._cond:
                    self._running = False
                    self._cond.notify_all()
