"""Shared capped-exponential-backoff-with-jitter helper.

Every connector retry site used to roll its own ``min(0.05 * 2**n, cap)``
sleep (or worse, a bare counter).  This module is the one implementation:
deterministic when seeded (chaos tests replay identical schedules),
metrics-friendly — callers report the delay they are about to sleep
through ``report_retry`` on the connector subject, which exports attempt
counts and cumulative backoff seconds — and it offers two jitter modes:

  proportional (default)
      delay scaled by a uniform factor in [1-jitter, 1+jitter].  Keeps
      the schedule close to the deterministic exponential — right for
      pacing loops like the device monitor's re-probe cadence.
  full (``full_jitter=True``)
      delay drawn uniform from [0, ceiling].  Proportional jitter keeps
      every sleeper within ±jitter of the SAME exponential, so workers
      that fail together retry together — against a shared broker that
      is a synchronized thundering herd.  Full jitter (the AWS
      "FullJitter" policy) decorrelates them; connector retry sites use
      this mode with a per-worker seed.

``max_elapsed`` bounds the TOTAL backoff a retry sequence may spend:
once the cumulative returned delays reach it, ``exhausted()`` flips True
and ``next_delay()`` returns only the remaining budget (eventually 0.0).
Retry loops check ``exhausted()`` instead of hand-counting attempts, so
a slow-failing dependency cannot stretch 5 attempts into minutes.
"""

from __future__ import annotations

import random
from typing import Iterator, Optional


class Backoff:
    """Capped exponential backoff with jitter and an elapsed-time cap.

    ceiling(attempt) = min(cap, base * factor**attempt); the returned
    delay is the ceiling jittered proportionally (default) or drawn
    uniform from [0, ceiling] (``full_jitter=True``).  ``jitter=0``
    with the default mode gives the exact deterministic schedule.
    """

    def __init__(
        self,
        *,
        base: float = 0.05,
        cap: float = 5.0,
        factor: float = 2.0,
        jitter: float = 0.25,
        full_jitter: bool = False,
        max_elapsed: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        if base <= 0 or cap <= 0 or factor < 1.0:
            raise ValueError("base/cap must be > 0 and factor >= 1")
        if not (0.0 <= jitter < 1.0):
            raise ValueError("jitter must be in [0, 1)")
        if max_elapsed is not None and max_elapsed <= 0:
            raise ValueError("max_elapsed must be > 0")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self.full_jitter = full_jitter
        self.max_elapsed = max_elapsed
        self.attempt = 0
        self.elapsed = 0.0  # sum of delays handed out since last reset
        self._rng = random.Random(seed)

    def next_delay(self) -> float:
        """The delay for the current attempt; advances the attempt count
        and charges the returned delay against ``max_elapsed``."""
        ceiling = min(self.cap, self.base * self.factor ** self.attempt)
        self.attempt += 1
        if self.full_jitter:
            delay = self._rng.uniform(0.0, ceiling)
        elif self.jitter:
            delay = ceiling * (
                1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
            )
        else:
            delay = ceiling
        if self.max_elapsed is not None:
            delay = min(delay, max(0.0, self.max_elapsed - self.elapsed))
        self.elapsed += delay
        return delay

    def peek_delay(self) -> float:
        """The un-jittered ceiling the next next_delay() draws from."""
        return min(self.cap, self.base * self.factor ** self.attempt)

    def exhausted(self) -> bool:
        """True once the cumulative handed-out delay has consumed the
        ``max_elapsed`` budget (always False without one)."""
        return (
            self.max_elapsed is not None
            and self.elapsed >= self.max_elapsed
        )

    def reset(self) -> None:
        """Call after a success so the next failure starts a fresh
        sequence from ``base`` with a full ``max_elapsed`` budget."""
        self.attempt = 0
        self.elapsed = 0.0

    def delays(self, max_attempts: int) -> Iterator[float]:
        """At most ``max_attempts`` delays, stopping early when the
        elapsed-time budget runs out (retry-loop sugar)."""
        for _ in range(max_attempts):
            if self.exhausted():
                return
            yield self.next_delay()
