"""Process-wide resilience counters, backed by the telemetry registry.

Counterpart of kmamiz_tpu/resilience/metrics.py with its names: the flat
counters (`incr`/`get`: ingestDropped, quarantined and
quarantined.<reason>, dpFallback, walRecords, walAppendErrors,
walReplays, retry.<name>, stlgtFoldErrors), the scheduler's per-job
failure streaks, the tick watchdog's trips and last-good tick, and
`resilience_summary`, the `resilience` section of GET /health.

The flat counters are registry handles (telemetry/registry.py):
`incr("ingestDropped")` bumps the same Counter that `GET /metrics`
renders as `kmamiz_ingest_dropped_total`, `quarantined` is
`kmamiz_quarantined_total`, a stale serve `kmamiz_stale_serves_total`
(the SLO scorecard's own handles), the rest ride
`kmamiz_resilience_total{counter}`, and a watchdog trip bumps
`kmamiz_watchdog_trips_total` — so /metrics, /health and /timings read
the same cells. Known names get module-scope handles; unknown names
(retry.*, quarantined.*) register once on first use. Job streaks and
watchdog trip metadata stay structured dicts (they carry strings and
timestamps), mirrored into `kmamiz_job_*` gauges at scrape time.

A watchdog trip is an SLO breach: it also freezes the profiler's flight
artifact (telemetry/profiling/recorder.py, debounced, never raising).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from kmamiz_tpu_torch.telemetry import slo as _slo
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.profiling import recorder
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

_LOCK = threading.Lock()

#: generic flat counters ride one labeled family...
_FAM = REGISTRY.counter_family(
    "kmamiz_resilience_total", "Flat resilience counters", ("counter",)
)
#: ...except the SLO-scorecard counters, which alias the scorecard's own
#: handles so rate numerators match /metrics exactly
_HANDLES: Dict[str, object] = {
    "ingestDropped": _slo.INGEST_DROPPED,
    "quarantined": _slo.QUARANTINED,
    "dpFallback": _FAM.handle("dpFallback"),
    "walRecords": _FAM.handle("walRecords"),
    "walAppendErrors": _FAM.handle("walAppendErrors"),
    "walReplays": _FAM.handle("walReplays"),
}

_WATCHDOG_TRIPS = REGISTRY.counter("kmamiz_watchdog_trips_total", "Tick watchdog trips")

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
    }


#: watchdog state: trips, per-reason counts, last trip, last-good tick
_WATCHDOG: Dict[str, object] = _fresh_watchdog()


def _handle(name: str):
    h = _HANDLES.get(name)
    if h is None:
        with _LOCK:
            h = _HANDLES.get(name)
            if h is None:
                # cold first-use registration (retry.*, quarantined.*);
                # cached, so steady state is a dict hit
                h = _FAM.handle(name)  # graftlint: disable=hot-path-metric-label -- first-use registration, cached in _HANDLES thereafter
                _HANDLES[name] = h
    return h


def incr(name: str, by: int = 1) -> int:
    """Bump a named counter; returns the new value."""
    h = _handle(name)
    h.inc(by)
    return int(h.value)


def get(name: str) -> int:
    h = _HANDLES.get(name)
    return int(h.value) if h is not None else 0


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
        entry["lastFailureAt"] = now_ms if now_ms is not None else prof_events.wall_ms()


def job_succeeded(name: str) -> None:
    """Reset a job's consecutive-failure streak (its history remains)."""
    with _LOCK:
        entry = _JOBS.get(name)
        if entry is not None:
            entry["consecutiveFailures"] = 0


def reset_job_streaks(names=None, prefix=None) -> None:
    """Drop the failure state of `names`, of every job under `prefix` (a
    tenant's ``<tenant>/`` namespace), or of every job: a (re)started
    scheduler begins its jobs from a clean slate, so a streak left by an
    earlier instance does not report the new jobs as failing."""
    with _LOCK:
        if names is None and prefix is None:
            _JOBS.clear()
            return
        for n in names or ():
            _JOBS.pop(n, None)
        if prefix is not None:
            for n in [n for n in _JOBS if n.startswith(prefix)]:
                del _JOBS[n]


def job_states() -> Dict[str, dict]:
    with _LOCK:
        return {name: dict(entry) for name, entry in _JOBS.items()}


def watchdog_tripped(reason: str, now_ms: Optional[float] = None) -> None:
    _WATCHDOG_TRIPS.inc()
    with _LOCK:
        _WATCHDOG["trips"] = int(_WATCHDOG["trips"]) + 1
        by = _WATCHDOG["byReason"]
        by[reason] = by.get(reason, 0) + 1
        _WATCHDOG["lastTripReason"] = reason
        _WATCHDOG["lastTripAt"] = now_ms if now_ms is not None else prof_events.wall_ms()
    # a trip is an SLO breach: freeze the profiler's evidence
    recorder.record("watchdog", reason)


def note_last_good(version: int, label_epoch: int, now_ms: Optional[float] = None) -> None:
    """Record the (graph version, label epoch) of the newest successful
    tick: the payload the degraded path serves."""
    with _LOCK:
        _WATCHDOG["lastGoodVersion"] = int(version)
        _WATCHDOG["lastGoodLabelEpoch"] = int(label_epoch)
        _WATCHDOG["lastGoodAt"] = now_ms if now_ms is not None else prof_events.wall_ms()


def note_stale_serve() -> None:
    # the handle the SLO scorecard's stale-serve rate reads
    _slo.STALE_SERVES.inc()


def watchdog_state(now_ms: Optional[float] = None) -> dict:
    with _LOCK:
        out = dict(_WATCHDOG)
        out["byReason"] = dict(_WATCHDOG["byReason"])
    out["staleServes"] = int(_slo.STALE_SERVES.value)
    if out["lastGoodAt"] is not None:
        now = now_ms if now_ms is not None else prof_events.wall_ms()
        out["lastGoodAgeMs"] = max(0.0, round(now - out["lastGoodAt"], 1))
    return out


def resilience_summary() -> dict:
    """The `resilience` payload of the health handler: breaker states,
    quarantine totals, watchdog and last-good, job streaks, and the flat
    counters."""
    from kmamiz_tpu_torch.resilience.breaker import breaker_states
    from kmamiz_tpu_torch.resilience.quarantine import quarantine_stats, tenant_quarantine_stats

    with _LOCK:
        counters = {name: int(h.value) for name, h in _HANDLES.items() if h.value}
    return {
        "breakers": breaker_states(),
        "quarantine": quarantine_stats(),
        "tenantQuarantine": tenant_quarantine_stats(),
        "watchdog": watchdog_state(),
        "jobs": job_states(),
        "counters": counters,
        "ingestDropped": counters.get("ingestDropped", 0),
        "dpFallback": counters.get("dpFallback", 0),
    }


def _scrape_jobs() -> None:
    """Scrape-time mirror of the job streak dicts into gauges."""
    for name, entry in job_states().items():
        _JOB_STREAK.handle(name).set(entry["consecutiveFailures"])
        _JOB_FAILS.handle(name).set(entry["totalFailures"])


_JOB_STREAK = REGISTRY.gauge_family(
    "kmamiz_job_consecutive_failures", "Scheduler job failure streak", ("job",)
)
_JOB_FAILS = REGISTRY.gauge_family(
    "kmamiz_job_failures_total", "Scheduler job total failures", ("job",)
)
REGISTRY.register_callback(_scrape_jobs)


def reset_for_tests() -> None:
    """Zero every counter and state (test isolation only). The counter
    cells are the telemetry registry's, so its reset zeroes both views."""
    REGISTRY.reset_for_tests()
    with _LOCK:
        _JOBS.clear()
        _WATCHDOG.clear()
        _WATCHDOG.update(_fresh_watchdog())
