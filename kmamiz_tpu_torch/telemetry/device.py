"""Device telemetry: the card's memory gauges, the kernels' launch
counters and the on-demand torch.profiler capture.

Counterpart of kmamiz_tpu/telemetry/device.py. Three sources, read at
scrape time (never on the tick):

- the memory statistics of the card a processor runs on
  (`track_device`, called by a processor on a CUDA device):
  `torch.cuda.memory_stats(device)`'s `allocated_bytes.all.current` and
  `.peak` and the card's total memory, as `kmamiz_device_bytes_in_use`,
  `_peak` and `_limit`. A CPU processor registers no card, and those
  gauges are not rendered;
- tracked arena sizes: device-resident subsystems (the graph store's
  edge columns, its staged windows, its scorer tables) report their
  allocation sizes via `track_arena`, exported per arena as
  `kmamiz_arena_bytes{arena=...}`;
- the hand-written kernels' launch counters (`<wrapper>.launches` of
  ops/segment_stats.py and ops/sparse.py), mirrored as
  `kmamiz_program_calls_total{program=<kernel wrapper>}`, the family the
  JAX package fills from its program registry. PyTorch compiles nothing
  per shape on the port's paths, so the JAX package's
  `kmamiz_program_compiles_total` and `_compile_ms_total` are not
  rendered.

Profiling: `capture_profile(duration_ms)` runs a torch.profiler session
(CPU activity, and CUDA activity when the process has a card) for
`POST /debug/profile` — one session at a time process-wide, sharing
core/profiling.py's guard — and writes its Chrome trace under
`KMAMIZ_PROFILE_DIR` (or an explicit directory). A capture costs the
serving process more than its window: once a profiler session has run,
later kernel launches of the same process take longer on the host (the
port's chip runs measured it; PERF.md section 7).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from kmamiz_tpu_torch.config import profile_dir, profile_max_s
from kmamiz_tpu_torch.core import profiling as core_profiling
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

_ARENA_BYTES = REGISTRY.gauge_family(
    "kmamiz_arena_bytes",
    "Tracked device-resident allocation bytes per arena",
    ("arena",),
)
_PROGRAM_CALLS = REGISTRY.gauge_family(
    "kmamiz_program_calls_total",
    "Hand-written kernel launches, per kernel wrapper",
    ("program",),
)

_arena_sources: Dict[str, Callable[[], float]] = {}
_arena_handles: Dict[str, object] = {}
_arena_lock = threading.Lock()

# the card whose memory the device gauges read, and those gauges: set by
# the first processor on a CUDA device
_device = None
_device_gauges: Optional[tuple] = None


def track_arena(name: str, size_fn: Callable[[], float]) -> None:
    """Register a pull source for one arena's byte size. Called at init
    scope by the owning subsystem; `size_fn` runs only at scrape time."""
    with _arena_lock:
        _arena_sources[name] = size_fn
        if name not in _arena_handles:
            _arena_handles[name] = _ARENA_BYTES.handle(name)


def track_device(device) -> None:
    """Register the card of a processor on a CUDA device (a torch.device)
    as the source of the device memory gauges; a CPU device registers
    nothing."""
    global _device, _device_gauges
    if device.type != "cuda":
        return
    with _arena_lock:
        _device = device
        if _device_gauges is None:
            _device_gauges = (
                REGISTRY.gauge("kmamiz_device_bytes_in_use", "Device bytes in use (memory_stats)"),
                REGISTRY.gauge("kmamiz_device_bytes_peak", "Peak device bytes in use (memory_stats)"),
                REGISTRY.gauge("kmamiz_device_bytes_limit", "Device memory limit (total memory)"),
            )


def device_memory_stats() -> Optional[dict]:
    """bytes_in_use / peak_bytes_in_use / bytes_limit of the registered
    card (the JAX memory_stats keys), or None when no processor runs on
    a card."""
    device = _device
    if device is None:
        return None
    import torch

    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


def kernel_launches() -> Dict[str, int]:
    """Launches of each hand-written kernel wrapper in this process (CPU
    calls take the plain versions and count nothing)."""
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import sparse

    return {
        fn.__name__: int(fn.launches)
        for fn in (
            ss.segment_stats,
            sparse.fused_sddmm_spmm,
            sparse.fused_sddmm_spmm_grad_edges,
            sparse.fused_sddmm_spmm_grad_rows,
        )
    }


def _collect() -> None:
    with _arena_lock:
        items = list(_arena_sources.items())
    for name, fn in items:
        _arena_handles[name].set(float(fn()))
    for name, n in kernel_launches().items():
        _PROGRAM_CALLS.handle(name).set(n)
    stats = device_memory_stats()
    if stats:
        in_use, peak, limit = _device_gauges
        in_use.set(stats["bytes_in_use"])
        peak.set(stats["peak_bytes_in_use"])
        limit.set(stats["bytes_limit"])


REGISTRY.register_callback(_collect)


# -- on-demand profiler capture (POST /debug/profile) --------------------

_PROFILES = REGISTRY.counter(
    "kmamiz_profile_captures_total", "On-demand torch.profiler captures"
)


def capture_profile(duration_ms: int, out_dir: Optional[str] = None) -> dict:
    """Capture a torch.profiler session for `duration_ms` (clamped to
    KMAMIZ_PROFILE_MAX_S) and write its Chrome trace
    (`capture-<epoch ms>.pt.trace.json`) to `out_dir` (default
    `KMAMIZ_PROFILE_DIR`, else ./kmamiz-data/profiles). Blocks the caller
    for the window; whatever the process runs meanwhile (a tick another
    thread serves) is recorded, and `window_ms` says when (epoch ms).

    One profiler session at a time, process-wide: the guard is shared
    with `core.profiling.trace`. A busy guard answers ``busy: True`` —
    the server maps it to 409; so does a capture that failed, with its
    error."""
    target = out_dir or profile_dir() or os.path.join("kmamiz-data", "profiles")
    duration_ms = max(1, min(int(duration_ms), int(profile_max_s() * 1000)))
    if not core_profiling.trace_guard.acquire(blocking=False):
        return {"ok": False, "busy": True, "error": "capture already in progress"}
    try:
        os.makedirs(target, exist_ok=True)
        path = os.path.join(target, f"capture-{int(prof_events.wall_ms())}.pt.trace.json")
        with core_profiling.profiler_session() as prof:
            start_ms = prof_events.wall_ms()
            time.sleep(duration_ms / 1000.0)
            end_ms = prof_events.wall_ms()
        prof.export_chrome_trace(path)
        _PROFILES.inc()
        return {
            "ok": True,
            "dir": target,
            "trace": path,
            "duration_ms": duration_ms,
            # the epoch ms the session's window opened and closed at
            "window_ms": [round(start_ms, 3), round(end_ms, 3)],
        }
    except OSError as exc:  # an unwritable capture directory
        return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    finally:
        core_profiling.trace_guard.release()
