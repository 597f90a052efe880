"""Shared retry with jittered exponential backoff.

Replaces the server layer's bare one-shot `urlopen(req, timeout=30)`
calls: a transient upstream blip (connection reset, brief 5xx, DNS
hiccup) retries with full jitter instead of failing the whole tick,
while a genuinely down upstream still fails fast enough for the caller's
fallback (and trips its CircuitBreaker, which then short-circuits the
retries entirely).

Defaults (overridable per call site via constructor args): ATTEMPTS
total attempts (1 = no retry), BASE_MS the first backoff ceiling, MAX_MS
the per-sleep ceiling, DEADLINE_MS a wall-clock budget for the whole
call chain past which no retry starts (0 = off).

Jitter is "full jitter" (sleep ~ U[0, min(max, base * 2^k)]); the rng
and sleep are injectable so the chaos harness replays deterministic
schedules and tests never actually sleep.

A copy of kmamiz_tpu/resilience/retry.py without the environment knobs
(the JAX package's KMAMIZ_RETRY_*; here module constants at their
defaults). Each retry counts as `retry.<name>` in resilience/metrics.py.
"""
from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

from kmamiz_tpu_torch.resilience import metrics

logger = logging.getLogger("kmamiz_tpu_torch.resilience.retry")

ATTEMPTS = 2
BASE_MS = 100.0
MAX_MS = 2000.0
DEADLINE_MS = 0.0


class Retrier:
    """Callable wrapper: ``Retrier("zipkin").call(fn)`` runs fn up to
    `attempts` times, sleeping a jittered exponential backoff between
    failures. The last failure re-raises unchanged."""

    def __init__(
        self,
        name: str,
        attempts: Optional[int] = None,
        base_ms: Optional[float] = None,
        max_ms: Optional[float] = None,
        deadline_ms: Optional[float] = None,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        now: Callable[[], float] = time.monotonic,
    ) -> None:
        self.name = name
        self.attempts = max(1, ATTEMPTS if attempts is None else attempts)
        self.base_ms = BASE_MS if base_ms is None else base_ms
        self.max_ms = MAX_MS if max_ms is None else max_ms
        self.deadline_ms = DEADLINE_MS if deadline_ms is None else deadline_ms
        self.retry_on = retry_on
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self._now = now

    def backoff_ms(self, attempt: int) -> float:
        """Full-jitter backoff before attempt `attempt` (1-based retry
        index): U[0, min(max_ms, base_ms * 2^(attempt-1))]."""
        ceiling = min(self.max_ms, self.base_ms * (2 ** (attempt - 1)))
        return self._rng.uniform(0.0, ceiling)

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn(*args, **kwargs) with retries. Exceptions outside
        `retry_on` (e.g. BreakerOpenError) propagate immediately —
        retrying into an open breaker would just burn the backoff."""
        start = self._now()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as err:
                if attempt >= self.attempts:
                    raise
                if (
                    self.deadline_ms > 0
                    and (self._now() - start) * 1000.0 >= self.deadline_ms
                ):
                    logger.debug(
                        "%s: retry deadline exhausted after %d attempts",
                        self.name,
                        attempt,
                    )
                    raise
                delay_ms = self.backoff_ms(attempt)
                logger.debug(
                    "%s: attempt %d/%d failed (%s: %s), retrying in %.0f ms",
                    self.name,
                    attempt,
                    self.attempts,
                    type(err).__name__,
                    err,
                    delay_ms,
                )
                metrics.incr(f"retry.{self.name}")
                self._sleep(delay_ms / 1000.0)
