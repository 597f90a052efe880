"""graftscope: the port's self-tracing telemetry.

Counterpart of kmamiz_tpu/telemetry/. The parts:

- `registry`  — the unified metrics registry (counters / gauges /
  fixed-bucket histograms, preallocated handles, Prometheus text
  exposition at `GET /metrics`).
- `tracing`   — per-tick span traces in a ring, exported as Zipkin v2
  JSON at `GET /debug/traces`; the processor can re-ingest its own
  export (self-trace).
- `device`    — the card's memory and arena gauges, the hand-written
  kernels' launches, and the on-demand `POST /debug/profile`
  torch.profiler capture.
- `slo`       — the rolling SLO scorecard.
- `freshness` — the arrival-to-visible watermark of each tick.
- `profiling` — graftprof: the lock-free host event ring, native
  parse/merge contention counters, device attribution, and the
  SLO-breach flight recorder (`GET /debug/graftprof`).
- `fleetscrape` — the fleet's workers' /metrics pages merged into one.

`KMAMIZ_TELEMETRY=0` disables span capture; the metrics registry stays
live regardless (the resilience counters and `/timings` ride on it).
Importing the package registers every scrape callback.
"""
from kmamiz_tpu_torch.telemetry import device, freshness, profiling  # noqa: F401  (scrape callbacks, hooks)
from kmamiz_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry  # noqa: F401
from kmamiz_tpu_torch.telemetry.slo import SCORECARD, TENANTS  # noqa: F401
from kmamiz_tpu_torch.telemetry.tracing import TRACER, phase_span  # noqa: F401


def reset_for_tests() -> None:
    """Zero all metric values (keeping registered handles live), drop
    buffered traces, clear the scorecard windows (process-wide and per
    tenant), the freshness window and the profiler planes."""
    REGISTRY.reset_for_tests()
    TRACER.reset_for_tests()
    SCORECARD.reset_for_tests()
    TENANTS.reset_for_tests()
    freshness.reset_for_tests()
    profiling.reset_for_tests()
