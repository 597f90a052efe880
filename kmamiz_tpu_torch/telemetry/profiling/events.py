"""The profiler's host event ring: lock-free per-phase time attribution.

A copy of kmamiz_tpu/telemetry/profiling/events.py. Every tick phase
(and every native parse/merge delta, via the per-tick hooks) appends one
4-tuple event — ``(name, tick_id, end_ns, dur_ns)`` — into a
PREALLOCATED ring. An append is one ``itertools.count`` bump (GIL-atomic)
plus one slot store; there is no lock, no allocation beyond the tuple,
and no formatting on the hot path. Readers (`snapshot`, the flight
recorder, `/debug/graftprof`) tolerate in-flight overwrites — an event
ring is telemetry, not a WAL.

Gate: ``KMAMIZ_PROF`` (default ON), re-read once per tick by
`note_tick_start` — never per event — so tests and operators flip it
without a restart and the disabled cost is one module-bool check. Ring
capacity: ``KMAMIZ_PROF_RING`` (default 4096 events).

This module also exports the hot path's clocks `now_ns` / `now_ms` /
`wall_ms`: every clock read of the tick, the ingest and the resilience
layer goes through them, so they stay greppable and swappable in one
place.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.telemetry.slo import percentile

Event = Tuple[str, int, int, int]  # (name, tick_id, end_ns, dur_ns)

# root-event names: the per-tick wall-clock denominators of the
# attribution report (report.py) — everything else is an attributed phase
ROOT_EVENTS = ("dp-tick", "dp-ingest")
# native counter-delta events (native_counters.poll): they overlap the
# host phase spans that contain them, so attribution must NOT sum them
NATIVE_EVENTS = ("native-merge", "native-merge-lockwait")
# port-only spans that run beside the tick's own thread (the cluster
# fetch on a thread of its own): they overlap the phases of that thread,
# so attribution must not sum them either
OVERLAP_EVENTS = ("fetch_cluster_state",)


# -- the hot path's clocks ---------------------------------------------------


def now_ns() -> int:
    """Monotonic ns — the hot path's clock."""
    return time.perf_counter_ns()


def now_ms() -> float:
    """Monotonic ms for hot-path wall accounting."""
    return time.perf_counter() * 1000.0


def wall_ms() -> float:
    """Epoch ms for hot-path domain stamps (dedup windows, stale age)."""
    return time.time() * 1000.0


# -- the ring ----------------------------------------------------------------

_enabled = config.prof_enabled()
_ring: List[Optional[Event]] = [None] * config.prof_ring()
_idx = itertools.count()
_tick_seq = itertools.count(1)
_cur_tick = 0

_hook_lock = threading.Lock()
_tick_end_hooks: List[Callable[[int], None]] = []


def prof_enabled() -> bool:
    """The cached KMAMIZ_PROF gate (refreshed per tick, default ON)."""
    return _enabled


def refresh_from_env() -> None:
    """Re-read KMAMIZ_PROF. Called once per tick by note_tick_start."""
    global _enabled
    _enabled = config.prof_enabled()


def emit(name: str, dur_ns: int) -> None:
    """Append one event (hot path: one counter bump + one slot store)."""
    if not _enabled:
        return
    ring = _ring
    ring[next(_idx) % len(ring)] = (
        name,
        _cur_tick,
        time.perf_counter_ns(),
        int(dur_ns),
    )


def on_tick_end(fn: Callable[[int], None]) -> None:
    """Register a per-tick hook (native counter poll, device memory
    sample). Runs at tick close only — never per event."""
    with _hook_lock:
        if fn not in _tick_end_hooks:
            _tick_end_hooks.append(fn)


def note_tick_start() -> int:
    """Open a tick: refresh the env gate, advance the tick id."""
    global _cur_tick
    refresh_from_env()
    if _enabled:
        _cur_tick = next(_tick_seq)
    return _cur_tick


def note_tick_end(root_name: str, dur_ns: int) -> None:
    """Close a tick: emit its root event, run the per-tick hooks."""
    if not _enabled:
        return
    emit(root_name, dur_ns)
    with _hook_lock:
        hooks = list(_tick_end_hooks)
    for fn in hooks:
        try:
            fn(_cur_tick)
        except Exception:  # noqa: BLE001 - a broken hook must not break ticks
            pass


# -- cold-path readers -------------------------------------------------------


def snapshot(last_ticks: Optional[int] = None) -> List[Event]:
    """The ring's events, oldest first; optionally only the last N tick
    ids (the flight recorder's freeze window)."""
    evs = [e for e in list(_ring) if e is not None]
    evs.sort(key=lambda e: e[2])
    if last_ticks and evs:
        hi = max(e[1] for e in evs)
        lo = hi - int(last_ticks) + 1
        evs = [e for e in evs if e[1] >= lo]
    return evs


def phase_durations_ms(
    events: Optional[List[Event]] = None,
) -> Dict[str, List[float]]:
    """Per-name duration samples (ms) from the ring (or a given list)."""
    out: Dict[str, List[float]] = {}
    for name, _tick, _end, dur_ns in events if events is not None else snapshot():
        out.setdefault(name, []).append(dur_ns / 1e6)
    return out


def phase_p95_ms(name: str) -> float:
    """p95 of one phase's ring samples (0.0 when absent)."""
    durs = sorted(phase_durations_ms().get(name, []))
    return round(percentile(durs, 0.95), 3)


def phase_percentile_ms(name: str, q: float) -> float:
    """Arbitrary-quantile variant of phase_p95_ms."""
    durs = sorted(phase_durations_ms().get(name, []))
    return round(percentile(durs, q), 3)


def reset_for_tests() -> None:
    global _ring, _idx, _tick_seq, _cur_tick
    _ring = [None] * config.prof_ring()
    _idx = itertools.count()
    _tick_seq = itertools.count(1)
    _cur_tick = 0
    refresh_from_env()
