"""Self-profiling: per-tick step timing + optional torch.profiler traces.

Counterpart of kmamiz_tpu/core/profiling.py. The reference's
self-profiling is one uniqueId->start-time latency map logged per
realtime tick (ServiceOperator.ts:43,76-81) and debug-level counts in the
Rust DP (data_processor.rs:111-118); this module gives the port real step
timing and profiler traces:

- `StepTimer` — named phase timings with running mean/max, cheap enough
  to wrap every DP tick; `summary()` feeds the DP's `/timings` and
  `GET /health/timings`, and each phase also lands in the
  `kmamiz_step_phase_ms{phase}` histogram;
- `trace()` — a context manager that captures a torch.profiler session
  (CPU activity, and CUDA activity when the process has a card) of the
  block it wraps into KMAMIZ_PROFILE_DIR when that is set (a no-op
  otherwise), at most KMAMIZ_PROFILE_COUNT times a process, so a
  production tick can be profiled by setting one env var. It writes a
  Chrome trace (`<dir>/<label>/<epoch ms>.pt.trace.json`).

Only one profiler session runs at a time in a process: `trace_guard` is
shared with telemetry/device.py's on-demand capture.
"""
from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
from typing import Dict, Iterator

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

#: phase-duration histograms: the same numbers as the /timings means, but
#: with buckets, so /metrics gets percentiles. One handle per phase name,
#: created on first use and cached (phase names are a small fixed
#: vocabulary)
_PHASE_HIST = REGISTRY.histogram_family(
    "kmamiz_step_phase_ms", "DP step-timer phase wall time (ms)", ("phase",)
)


class StepTimer:
    """Running per-phase wall-time stats (count / mean / max, in ms)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}
        self._hists: Dict[str, object] = {}

    def _fold(self, name: str, elapsed_ms: float) -> None:
        with self._lock:
            entry = self._stats.setdefault(name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            entry["count"] += 1
            entry["total_ms"] += elapsed_ms
            entry["max_ms"] = max(entry["max_ms"], elapsed_ms)
            hist = self._hists.get(name)
            if hist is None:
                # first use of a phase name only; cached thereafter
                hist = _PHASE_HIST.handle(name)
                self._hists[name] = hist
        hist.observe(elapsed_ms)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = prof_events.now_ms()
        try:
            yield
        finally:
            self._fold(name, prof_events.now_ms() - start)

    def record(self, name: str, elapsed_ms: float) -> None:
        """Fold an externally measured duration into the same stats shape
        as phase(): where the region is already timed for its own
        accounting (uploads) or runs on a worker thread whose wall time
        would double-count an enclosing phase."""
        self._fold(name, elapsed_ms)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": entry["count"],
                    "mean_ms": entry["total_ms"] / max(entry["count"], 1),
                    "max_ms": entry["max_ms"],
                }
                for name, entry in self._stats.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: process-wide timer used by the DP tick; importable anywhere
step_timer = StepTimer()

logger = logging.getLogger("kmamiz_tpu_torch.profiling")

#: one profiler session at a time, process-wide (trace() and
#: telemetry.device.capture_profile)
trace_guard = threading.Lock()
_traces_left = -1  # -1 = cap not yet read from the environment


def profiler_session():
    """A torch.profiler session (not yet entered) of the CPU activity and,
    in a process with a card, the CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextlib.contextmanager
def trace(label: str = "kmamiz") -> Iterator[None]:
    """Capture a torch.profiler session of the block when
    KMAMIZ_PROFILE_DIR is set.

    Profiler sessions cannot overlap, so only the first concurrent caller
    captures; the rest proceed unprofiled. At most KMAMIZ_PROFILE_COUNT
    traces (default 8) are captured per process: the DP tick fires every
    few seconds forever, and unbounded captures would fill the profile
    volume. A profiler that fails to start or to write its trace never
    fails the tick it wraps: it logs, and no later tick captures.
    """
    global _traces_left
    profile_dir = config.profile_dir()
    if not profile_dir or _traces_left == 0:
        yield
        return
    if not trace_guard.acquire(blocking=False):
        yield
        return
    try:
        if _traces_left < 0:  # first capture: read the cap once
            _traces_left = config.profile_count()
        if _traces_left == 0:  # re-check under the lock: a concurrent
            yield  # caller may have spent the last slot after our pre-check
            return
        _traces_left -= 1
        capture = None
        try:
            capture = profiler_session()
            capture.__enter__()
        except Exception as err:  # noqa: BLE001 - a diagnostic never fails the tick
            capture = None
            _traces_left = 0
            logger.warning("profiler capture failed, disabling: %s", err)

        def close(exc_info):
            global _traces_left
            if capture is None:
                return
            try:
                capture.__exit__(*exc_info)
                out = os.path.join(profile_dir, label)
                os.makedirs(out, exist_ok=True)
                capture.export_chrome_trace(os.path.join(out, f"{int(prof_events.wall_ms())}.pt.trace.json"))
            except Exception as err:  # noqa: BLE001 - a diagnostic never fails the tick
                _traces_left = 0
                logger.warning("profiler capture teardown failed, disabling: %s", err)

        try:
            yield
        except BaseException:
            close(sys.exc_info())
            raise
        else:
            close((None, None, None))
    finally:
        trace_guard.release()
