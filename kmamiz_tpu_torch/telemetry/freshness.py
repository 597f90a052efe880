"""Freshness plane: span-arrival -> forecast-visible latency.

A copy of kmamiz_tpu/telemetry/freshness.py. Every tick stamps its window
with an arrival watermark when its prepare stage starts
(processor.prepare_tick) and observes the elapsed wall when the tick's
response — the forecast-visible state — is assembled
(processor.finish_tick). The plane measures end-to-end freshness through
parse/upload -> merge -> score whether the serial tick or the stream
engine's micro-tick (server/stream.py) drove the window; the stream's
overlap shows up here as the p99 dropping toward one stage's cost.

Surfaces:

- rolling percentile snapshot (`snapshot()`) — the DP's `/timings`
  "freshness" key;
- Prometheus: `kmamiz_freshness_ms` histogram + observation counter,
  plus scrape-time p50/p95/p99 gauges refreshed via the registry's
  callback hook (the same pull-gauge idiom as telemetry/device.py).
"""
import threading
from collections import deque

from kmamiz_tpu_torch.telemetry.registry import REGISTRY
from kmamiz_tpu_torch.telemetry.slo import percentile

#: rolling sample window — sized like the SLO scorecard's tick window:
#: big enough for stable tails over a bench curve, small enough that a
#: burst's degradation ages out within one curve
WINDOW = 4096

_lock = threading.Lock()
_samples: deque = deque(maxlen=WINDOW)

_HIST = REGISTRY.histogram(
    "kmamiz_freshness_ms",
    "span-arrival to forecast-visible latency per tick (ms)",
)
_OBSERVED = REGISTRY.counter(
    "kmamiz_freshness_observations_total",
    "ticks that carried an arrival watermark",
)
_P50 = REGISTRY.gauge(
    "kmamiz_freshness_ms_p50", "rolling freshness p50 (ms)"
)
_P95 = REGISTRY.gauge(
    "kmamiz_freshness_ms_p95", "rolling freshness p95 (ms)"
)
_P99 = REGISTRY.gauge(
    "kmamiz_freshness_ms_p99", "rolling freshness p99 (ms)"
)


def observe(freshness_ms: float) -> None:
    """Record one tick's arrival->visible latency."""
    with _lock:
        _samples.append(float(freshness_ms))
    _HIST.observe(freshness_ms)
    _OBSERVED.inc()


def snapshot() -> dict:
    """Rolling-window percentile summary (the /timings payload shape)."""
    with _lock:
        vals = sorted(_samples)
    return {
        "samples": len(vals),
        "freshness_ms_p50": round(percentile(vals, 0.50), 3),
        "freshness_ms_p95": round(percentile(vals, 0.95), 3),
        "freshness_ms_p99": round(percentile(vals, 0.99), 3),
        "freshness_ms_max": round(vals[-1], 3) if vals else 0.0,
    }


def _refresh_gauges() -> None:
    snap = snapshot()
    _P50.set(snap["freshness_ms_p50"])
    _P95.set(snap["freshness_ms_p95"])
    _P99.set(snap["freshness_ms_p99"])


REGISTRY.register_callback(_refresh_gauges)


def reset_for_tests() -> None:
    with _lock:
        _samples.clear()
