"""Unified transient-fault retry policy: jittered exponential backoff
under a per-operation deadline.

Every layer that talks to a flaky remote endpoint (object-store transfers,
manifest reads, peer-read provider fallback) used to carry its own ad-hoc
single-retry loop.  :func:`with_backoff` replaces those: it retries the
callable on the listed transient errors, sleeping an exponentially growing,
deterministically jittered interval between attempts, until the per-op
deadline would be exceeded — then it publishes ``retry_exhausted`` (when a
bus is provided) and re-raises the last error, so callers keep their
existing exception contract but the telemetry sees the exhaustion instead
of a bare raise.

The jitter is *deterministic* (a CRC of ``(what, attempt, seed)``), never
``random``: the whole system runs on a simulated clock and chaos campaigns
replay seeded schedules, so retry timing must be a pure function of its
inputs.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type
from zlib import crc32

from . import events as E

TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError)


def _jitter_frac(what: str, attempt: int, seed: int) -> float:
    """Deterministic pseudo-random fraction in [0, 1)."""
    return crc32(f"{what}|{attempt}|{seed}".encode()) / 2**32


def with_backoff(op: Callable, deadline_s: float, *, clock=None,
                 base_s: float = 0.01, factor: float = 2.0,
                 jitter: float = 0.5,
                 retry_on: Tuple[Type[BaseException], ...] = TRANSIENT_ERRORS,
                 bus=None, what: str = "op", seed: int = 0):
    """Call ``op()`` with jittered exponential backoff under a deadline.

    Returns ``op()``'s result on the first success.  A transient error
    (``retry_on``) schedules a retry after ``base_s * factor**attempt``
    seconds (scaled by up to ``jitter`` deterministic extra); when the next
    sleep would push past ``deadline_s`` total, the policy gives up:
    ``retry_exhausted`` is published on ``bus`` (when given) and the last
    error is re-raised.  Non-transient errors propagate immediately.

    ``clock`` (a SimClock) keeps both the sleeps and the deadline on
    simulated time; without one, wall time is used.
    """
    now = clock.now if clock is not None else time.monotonic
    sleep = clock.sleep if clock is not None else time.sleep
    start = now()
    attempt = 0
    while True:
        try:
            return op()
        except retry_on as err:
            wait = base_s * factor ** attempt
            wait *= 1.0 + jitter * _jitter_frac(what, attempt, seed)
            attempt += 1
            if now() + wait > start + deadline_s:
                if bus is not None:
                    bus.publish(E.RETRY_EXHAUSTED, what=what,
                                attempts=attempt,
                                elapsed_s=now() - start, error=repr(err))
                raise
            sleep(wait)


def retry_deadline(deadline_s: float, **kwargs):
    """Partial-application helper: a reusable policy with fixed options."""
    def call(op: Callable, *, what: str = "op", seed: int = 0):
        return with_backoff(op, deadline_s, what=what, seed=seed, **kwargs)
    return call
