"""Fault tolerance of the port's upstream calls.

The part of kmamiz_tpu/resilience/ that the store and the operator use:
per-upstream circuit breakers (`breaker.py`) and the jittered-backoff
`Retrier` (`retry.py`), both standard library only. The quarantine, the
ingest WAL, the tick watchdog and the counters of `metrics.py` join with
the slices that port them.
"""
from kmamiz_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerOpenError,
    CircuitBreaker,
    get_breaker,
)
from kmamiz_tpu_torch.resilience.retry import Retrier  # noqa: F401
