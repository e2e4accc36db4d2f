"""Shared retry policy: jittered exponential backoff under a deadline.

A copy of keto_tpu/x/retry.py. One backoff shape for every
transient-failure seam — the store reads of a snapshot refresh
(keto_tpu_torch/check/gpu_engine.py ``_read_store``) among them — instead
of each site growing its own loop. Jitter decorrelates retry storms when
many callers hit the same failing dependency at once.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


class Backoff:
    """Jittered exponential delay sequence: ``base·factor^n``, capped at
    ``max_s``, each draw multiplied by ``1 ± jitter``. ``reset()`` after a
    success so the next failure starts from ``base_s`` again."""

    def __init__(
        self,
        base_s: float = 0.2,
        max_s: float = 10.0,
        factor: float = 2.0,
        jitter: float = 0.25,
    ):
        self.base_s = base_s
        self.max_s = max_s
        self.factor = factor
        self.jitter = jitter
        self._attempt = 0

    def next(self) -> float:
        raw = min(self.base_s * (self.factor**self._attempt), self.max_s)
        self._attempt += 1
        lo = max(0.0, 1.0 - self.jitter)
        hi = 1.0 + self.jitter
        return raw * random.uniform(lo, hi)

    def reset(self) -> None:
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt


def retry_call(
    fn: Callable,
    *,
    max_wait_s: float,
    base_s: float = 0.2,
    max_s: float = 10.0,
    jitter: float = 0.25,
    retryable: Optional[Callable[[BaseException], bool]] = None,
    on_retry: Optional[Callable[[BaseException, float], None]] = None,
    delay_hint: Optional[Callable[[BaseException], Optional[float]]] = None,
):
    """Call ``fn()`` until it succeeds, raises a non-retryable error, or
    the next sleep would cross ``max_wait_s`` from now — then the last
    error propagates. ``retryable(exc)`` filters which failures retry
    (default: every ``Exception``); ``on_retry(exc, delay)`` observes each
    scheduled retry (logging, counters). ``delay_hint(exc)`` may return
    the server's own backoff advice (a 429/503 ``Retry-After``), which
    replaces the backoff draw for that retry — an overloaded server's
    explicit schedule beats a client-side guess."""
    deadline = time.monotonic() + max_wait_s
    backoff = Backoff(base_s=base_s, max_s=max_s, jitter=jitter)
    while True:
        try:
            return fn()
        except Exception as e:
            if retryable is not None and not retryable(e):
                raise
            delay = backoff.next()
            if delay_hint is not None:
                hinted = delay_hint(e)
                if hinted is not None:
                    delay = max(0.0, float(hinted))
            if time.monotonic() + delay > deadline:
                raise
            if on_retry is not None:
                on_retry(e, delay)
            time.sleep(delay)
