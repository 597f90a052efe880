"""Process-wide resilience counters, one lock-guarded store.

Counterpart of kmamiz_tpu/resilience/metrics.py with its names: the
flat counters (`incr`/`get`: ingestDropped, quarantined and
quarantined.<reason>, dpFallback, walRecords, walAppendErrors,
walReplays, retry.<name>, stlgtFoldErrors), the scheduler's per-job
failure streaks, the tick watchdog's trips and last-good tick, and
`resilience_summary`, the `resilience` section of GET /health.

The JAX module backs these names with cells of its telemetry registry,
which GET /metrics renders as Prometheus text. The port's registry and
/metrics come with its telemetry; they will back these same names, and
until then the cells are plain integers under this module's lock.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_LOCK = threading.Lock()

#: flat counters by name
_COUNTERS: Dict[str, int] = {}

#: per-scheduler-job failure tracking: name -> {consecutiveFailures,
#: totalFailures, lastError, lastFailureAt}
_JOBS: Dict[str, dict] = {}


def _fresh_watchdog() -> dict:
    return {
        "trips": 0,
        "byReason": {},
        "lastTripReason": None,
        "lastTripAt": None,
        "lastGoodVersion": None,
        "lastGoodLabelEpoch": None,
        "lastGoodAt": None,
        "staleServes": 0,
    }


#: watchdog state: trips, per-reason counts, last trip, last-good tick
_WATCHDOG: Dict[str, object] = _fresh_watchdog()


def _wall_ms() -> float:
    return time.time() * 1000.0


def incr(name: str, by: int = 1) -> int:
    """Bump a named counter; returns the new value."""
    with _LOCK:
        value = _COUNTERS.get(name, 0) + by
        _COUNTERS[name] = value
    return value


def get(name: str) -> int:
    with _LOCK:
        return _COUNTERS.get(name, 0)


def job_failed(name: str, err: BaseException, now_ms: Optional[float] = None) -> None:
    """Record one scheduled-job failure: the consecutive-failure streak
    and the last error make a job that fails every fire visible in
    /health, not only in the log."""
    with _LOCK:
        entry = _JOBS.setdefault(
            name,
            {
                "consecutiveFailures": 0,
                "totalFailures": 0,
                "lastError": None,
                "lastFailureAt": None,
            },
        )
        entry["consecutiveFailures"] += 1
        entry["totalFailures"] += 1
        entry["lastError"] = f"{type(err).__name__}: {err}"[:500]
        entry["lastFailureAt"] = now_ms if now_ms is not None else _wall_ms()


def job_succeeded(name: str) -> None:
    """Reset a job's consecutive-failure streak (its history remains)."""
    with _LOCK:
        entry = _JOBS.get(name)
        if entry is not None:
            entry["consecutiveFailures"] = 0


def reset_job_streaks(names=None) -> None:
    """Drop the failure state of `names`, or of every job: a (re)started
    scheduler begins its jobs from a clean slate, so a streak left by an
    earlier instance does not report the new jobs as failing."""
    with _LOCK:
        if names is None:
            _JOBS.clear()
            return
        for n in names:
            _JOBS.pop(n, None)


def job_states() -> Dict[str, dict]:
    with _LOCK:
        return {name: dict(entry) for name, entry in _JOBS.items()}


def watchdog_tripped(reason: str, now_ms: Optional[float] = None) -> None:
    with _LOCK:
        _WATCHDOG["trips"] = int(_WATCHDOG["trips"]) + 1
        by = _WATCHDOG["byReason"]
        by[reason] = by.get(reason, 0) + 1
        _WATCHDOG["lastTripReason"] = reason
        _WATCHDOG["lastTripAt"] = now_ms if now_ms is not None else _wall_ms()


def note_last_good(version: int, label_epoch: int, now_ms: Optional[float] = None) -> None:
    """Record the (graph version, label epoch) of the newest successful
    tick: the payload the degraded path serves."""
    with _LOCK:
        _WATCHDOG["lastGoodVersion"] = int(version)
        _WATCHDOG["lastGoodLabelEpoch"] = int(label_epoch)
        _WATCHDOG["lastGoodAt"] = now_ms if now_ms is not None else _wall_ms()


def note_stale_serve() -> None:
    with _LOCK:
        _WATCHDOG["staleServes"] = int(_WATCHDOG["staleServes"]) + 1


def watchdog_state(now_ms: Optional[float] = None) -> dict:
    with _LOCK:
        out = dict(_WATCHDOG)
        out["byReason"] = dict(_WATCHDOG["byReason"])
    if out["lastGoodAt"] is not None:
        now = now_ms if now_ms is not None else _wall_ms()
        out["lastGoodAgeMs"] = max(0.0, round(now - out["lastGoodAt"], 1))
    return out


def resilience_summary() -> dict:
    """The `resilience` payload of the health handler: breaker states,
    quarantine totals, watchdog and last-good, job streaks, and the flat
    counters."""
    from kmamiz_tpu_torch.resilience.breaker import breaker_states
    from kmamiz_tpu_torch.resilience.quarantine import quarantine_stats

    with _LOCK:
        counters = {name: v for name, v in _COUNTERS.items() if v}
    return {
        "breakers": breaker_states(),
        "quarantine": quarantine_stats(),
        "watchdog": watchdog_state(),
        "jobs": job_states(),
        "counters": counters,
        "ingestDropped": counters.get("ingestDropped", 0),
        "dpFallback": counters.get("dpFallback", 0),
    }


def reset_for_tests() -> None:
    """Zero every counter and state (test isolation only)."""
    with _LOCK:
        _COUNTERS.clear()
        _JOBS.clear()
        _WATCHDOG.clear()
        _WATCHDOG.update(_fresh_watchdog())
