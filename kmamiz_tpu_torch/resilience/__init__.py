"""Fault tolerance of the port: stay up and stay correct under faults.

Counterpart of kmamiz_tpu/resilience/, standard library only:

1. poison-input quarantine (`quarantine.py`): malformed raw ingest
   payloads divert to a bounded on-disk directory with a reason code
   while the ingest goes on with the rest;
2. retry and circuit breakers (`retry.py`, `breaker.py`) around the
   upstream calls of the Zipkin client, the store and the operator;
3. the tick watchdog (`watchdog.py`): a deadline on each DP tick, past
   which the DP server serves its last good payload marked stale;
4. crash recovery (`wal.py`): an fsynced ingest WAL that a restarted
   processor replays through `ingest_raw_window` to the same graph.

`chaos.py` injects the faults deterministically; `metrics.py` keeps the
counters that /health's `resilience` section reports, as cells of the
telemetry registry that GET /metrics renders.
"""
from kmamiz_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerOpenError,
    CircuitBreaker,
    breaker_states,
    get_breaker,
)
from kmamiz_tpu_torch.resilience.metrics import resilience_summary  # noqa: F401
from kmamiz_tpu_torch.resilience.quarantine import Quarantine, classify_payload  # noqa: F401
from kmamiz_tpu_torch.resilience.retry import Retrier  # noqa: F401
from kmamiz_tpu_torch.resilience.wal import IngestWAL  # noqa: F401
from kmamiz_tpu_torch.resilience.watchdog import (  # noqa: F401
    TickDeadlineExceeded,
    TickWatchdog,
)
