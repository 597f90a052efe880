"""The continuous profiler of the serving plane (graftprof).

Counterpart of kmamiz_tpu/telemetry/profiling/. Three attribution planes
plus a crash-box, all bounded and all off the hot path:

- `events` — the lock-free host event ring (per-phase 4-tuples) and the
  hot path's clocks.
- `native_counters` — the native library's parse/merge contention
  counters (per-shard parse ns, merge lock-wait ns, claim contention,
  intern probe stats) as registry families and per-tick ring deltas.
- `device_attr` — the compile-cause log (empty in the port), the device
  memory timeline, and the torch.profiler capture join back to the
  hand-written kernels.
- `recorder` — the SLO-breach flight recorder (a watchdog trip or a
  breaker opening freezes the last N ticks of evidence).
- `report` — profile condensation, text rendering and per-phase
  regression diffing (`GET /debug/graftprof`).
"""
from __future__ import annotations

from kmamiz_tpu_torch.telemetry.profiling import device_attr, events, native_counters, recorder, report

__all__ = [
    "device_attr",
    "events",
    "native_counters",
    "recorder",
    "report",
    "reset_for_tests",
]


def reset_for_tests() -> None:
    """Clear every profiler plane (wired into telemetry.reset_for_tests)."""
    events.reset_for_tests()
    native_counters.reset_for_tests()
    device_attr.reset_for_tests()
    recorder.reset_for_tests()
