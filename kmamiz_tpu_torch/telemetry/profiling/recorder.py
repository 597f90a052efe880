"""SLO-breach flight recorder: freeze the evidence when serving degrades.

Counterpart of kmamiz_tpu/telemetry/profiling/recorder.py. When the tick
watchdog trips (resilience/metrics.watchdog_tripped) or an upstream
circuit breaker opens (resilience/breaker.py), `record(trigger)`
snapshots the last N ticks of host events, the span-trace ring, the SLO
scorecard rows (process-wide and per tenant), the native counters, the
compile-cause log and the device memory timeline into one JSON artifact
(kind "kmamiz-flight") under ``KMAMIZ_PROF_FLIGHT_DIR`` — the crash-box an
operator opens *after* the incident, instead of trying to reproduce it.

Discipline: `record` never raises (it is a diagnostic on the resilience
layer's own failure paths, not the device path), debounces trigger
storms (``KMAMIZ_PROF_FLIGHT_DEBOUNCE_S``; breaker flaps would otherwise
write hundreds of artifacts), keeps bounded retention
(``KMAMIZ_PROF_FLIGHT_MAX`` newest artifacts survive) and writes
atomically (tmp + rename) so a reader never sees a torn file.

The debounce reads `clock` (time.monotonic), which a test replaces with
a fake clock: the JAX package's debounce test, on the real clock, can
lose its window to a slow host.

The JAX recorder's per-caller namespaces (the soak harness's
``flight-<namespace>-*.json``, with their own debounce and retention)
wait for that harness.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import re
import threading
import time
from typing import Callable, Optional

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.telemetry import slo, tracing
from kmamiz_tpu_torch.telemetry.profiling import device_attr, events, native_counters

logger = logging.getLogger("kmamiz_tpu_torch.telemetry.profiling")

ARTIFACT_KIND = "kmamiz-flight"
ARTIFACT_VERSION = 1

#: the debounce's monotonic clock, in seconds (injectable)
clock: Callable[[], float] = time.monotonic

_lock = threading.Lock()
_last_dump: Optional[float] = None
_seq = itertools.count(1)

_SAFE_TRIGGER = re.compile(r"[^A-Za-z0-9_.-]+")
#: an artifact's name: flight-<epoch ms>-<seq>-<slug>.json
_NAME = re.compile(r"^flight-\d{13}-.*\.json$")


def build_artifact(trigger: str, detail: str = "") -> dict:
    """The flight artifact dict (separate from I/O so tests and
    /debug/graftprof can inspect it without touching disk)."""
    keep = config.prof_flight_ticks()
    return {
        "kind": ARTIFACT_KIND,
        "version": ARTIFACT_VERSION,
        "trigger": trigger,
        "detail": detail,
        "wall_s": round(events.wall_ms() / 1000.0, 3),
        "flight_ticks": keep,
        "events": [list(e) for e in events.snapshot(last_ticks=keep)],
        "traces": [
            {
                "traceId": tb.trace_id,
                "wallUs": tb.wall_us,
                "status": tb.status,
                "spans": [list(s) for s in tb.spans],
            }
            for tb in tracing.TRACER.traces()[-keep:]
        ],
        "scorecard": slo.SCORECARD.snapshot(),
        "tenants": slo.TENANTS.snapshot(),
        "native": native_counters.counters(),
        "compileLog": device_attr.compile_log(),
        "hbmTimeline": device_attr.hbm_timeline(),
    }


def record(trigger: str, detail: str = "", force: bool = False) -> Optional[str]:
    """Dump a flight artifact; returns its path, or None when skipped
    (profiling off, debounced) or failed. NEVER raises — the trigger
    sites are the resilience layer's own failure paths."""
    try:
        return _record(trigger, detail, force)
    except Exception as exc:  # noqa: BLE001 - the recorder must not re-fail a failure path
        logger.warning("flight recorder dump failed: %s", exc)
        return None


def _record(trigger: str, detail: str, force: bool) -> Optional[str]:
    global _last_dump
    events.refresh_from_env()
    if not events.prof_enabled() and not force:
        return None
    now = clock()
    with _lock:
        if not force and _last_dump is not None and (now - _last_dump) < config.prof_flight_debounce_s():
            return None
        _last_dump = now
        seq = next(_seq)
    artifact = build_artifact(trigger, detail)
    out_dir = config.prof_flight_dir()
    os.makedirs(out_dir, exist_ok=True)
    slug = _SAFE_TRIGGER.sub("-", trigger) or "trigger"
    path = os.path.join(out_dir, f"flight-{int(events.wall_ms()):013d}-{seq:04d}-{slug}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(artifact, f, separators=(",", ":"))
    os.replace(tmp, path)
    _prune(out_dir)
    return path


def _prune(out_dir: str) -> None:
    """Bounded retention: keep the newest KMAMIZ_PROF_FLIGHT_MAX
    artifacts (their timestamped names sort chronologically)."""
    try:
        names = sorted(n for n in os.listdir(out_dir) if _NAME.match(n))
    except OSError:
        return
    keep = config.prof_flight_max()
    for stale in names[:-keep] if len(names) > keep else []:
        try:
            os.remove(os.path.join(out_dir, stale))
        except OSError:
            pass


def reset_for_tests() -> None:
    global _seq, _last_dump
    with _lock:
        _last_dump = None
        _seq = itertools.count(1)
